"""The train cells laid out as the JAX package's rules lay them out.

The attention's query offset: ``attention_chunked`` and
``attention_reference`` on rows ``k:`` of q at ``q_offset = k`` equal rows
``k:`` of the whole call (causal, window, softcap, GQA; chunks that do and
do not divide the rows). Ulysses attention (``attn_seq``): the reduced
gemma2-2b (a window of 16, small enough to cross ranks) and starcoder2-7b,
whose 4 heads do not divide an 8-way model axis, on gloo 1x8: each rank's
attention runs on its own S/8 query rows at their absolute positions, and
the loss, every gradient, the prefill and 4 decode steps equal the
unsharded port and the JAX package (``torch_mesh_cases.check_families``).
grok-1-314b's experts 2D-sharded over (data, model) on gloo 2x2 (groups
of 16 tokens, so that the groups split over data): the same parity, and
no rank allocates an expert matrix wider than one layer's slice gathered
over data (the FSDP gather), so never a whole one; and its adafactor step
divides each rank's own block of a factored leaf (no allocation larger
than a rank's largest shard), equal to the unsharded step. And gemma2-2b's
backward on another thread, with no sharding scope bound, as a card's
autograd engine runs it: each rematerialised block recomputes under the
forward's scope (``sharding.scoped``), so the same gradients.
"""
import numpy as np
import pytest
import torch

from repro_torch.models.attention import (attention_chunked,
                                          attention_reference)
from torch_mesh_cases import check_families, check_family
from repro_torch.configs import get_config
from repro_torch.models.transformer import init_model
from repro_torch.train import optim
from repro_torch.train.tree import leaves, unflatten
from torch_mesh_workers import (adafactor_worker, attn_rows_worker,
                                expert_alloc_worker, spawn,
                                thread_backward_worker)

# (B, S, H, Hkv, Dh, causal, window, softcap, chunk_q, chunk_kv, offset)
OFFSET_CASES = [
    (2, 32, 4, 2, 16, True, 0, 0.0, 8, 8, 8),  # causal, chunks divide
    (2, 32, 4, 2, 16, True, 5, 20.0, 8, 8, 16),  # window and softcap
    (2, 32, 4, 2, 16, True, 5, 20.0, 8, 8, 12),  # 20 rows: 8 does not divide
    (1, 24, 6, 3, 8, True, 7, 0.0, 6, 8, 6),  # G = 2
    (2, 32, 4, 4, 16, False, 0, 0.0, 4, 16, 16),  # non-causal, MHA
    (2, 30, 4, 1, 8, True, 3, 30.0, 6, 10, 18),  # MQA, chunk_kv 10
]


@pytest.mark.parametrize("case", OFFSET_CASES)
def test_query_offset_rows_equal_the_whole_call_s(case):
    B, S, H, Hkv, Dh, causal, window, softcap, cq, ckv, k = case
    gen = torch.Generator().manual_seed(k)
    q = torch.randn((B, S, H, Dh), generator=gen)
    kk, v = (torch.randn((B, S, Hkv, Dh), generator=gen) for _ in "kv")
    kw = dict(causal=causal, window=window, softcap=softcap)
    for fn, chunks in ((attention_chunked, dict(chunk_q=cq, chunk_kv=ckv)),
                       (attention_reference, {})):
        whole = fn(q, kk, v, **kw, **chunks)
        rows = fn(q[:, k:], kk, v, **kw, **chunks, q_offset=k)
        np.testing.assert_allclose(rows.numpy(), whole[:, k:].numpy(),
                                   rtol=1e-5, atol=1e-6,
                                   err_msg=f"{fn.__name__} {case}")
    # offset 0 is the call without one, bit for bit
    assert torch.equal(attention_chunked(q, kk, v, **kw, chunk_q=cq,
                                         chunk_kv=ckv, q_offset=0),
                       attention_chunked(q, kk, v, **kw, chunk_q=cq,
                                         chunk_kv=ckv))


def test_heads_indivisible_archs_attend_their_own_query_rows_on_1x8(
        tmp_path):
    S = 32
    got = check_families(("gemma2-2b", "starcoder2-7b"), tmp_path,
                         mesh_shape=(1, 8), timeout=240,
                         worker=attn_rows_worker, seq=S,
                         reduced={"gemma2-2b": {"sliding_window": 16}})
    for out in got:
        # (rows, offset) of every call on rank r: train, its remat, prefill
        assert out["attn_rows"] == [[(S // 8, r * S // 8)]
                                    for r in range(8)]


def test_grok_experts_2d_sharded_match_without_whole_matrices(tmp_path):
    E, d, f = 8, 128, 32
    got = check_family("grok-1-314b", tmp_path, seq=32,
                       worker=expert_alloc_worker,
                       reduced={"moe": {"group_size": 16, "d_ff_expert": f}})
    local = {(E, d // 2, f // 2), (E, f // 2, d // 2)}
    gathered = {(E, d, f // 2), (E, f // 2, d)}  # one layer's, over data
    dims = {d, d // 2, f, f // 2}
    for allocs in got["allocs"]:
        shaped = {s for s in map(tuple, allocs) if len(s) == 3
                  and s[0] == E and {s[1], s[2]} <= dims
                  and (s[1] in (d, d // 2)) != (s[2] in (d, d // 2))}
        assert shaped <= local | gathered, shaped
        assert gathered <= shaped, shaped


def test_ulysses_backward_on_the_engine_s_thread_matches(tmp_path):
    """The reduced gemma2-2b on 1x4 (q split by its sequence: attn_seq
    takes the model axis before the heads), its backward on another
    thread, where no sharding scope is bound (``thread_backward_worker``):
    the calling thread's gradients bit for bit. Without the forward's
    scope the recompute laid its activations out otherwise and saved
    other tensors, which the checkpoint refuses."""
    path = str(tmp_path / "grads.pt")
    spawn(thread_backward_worker, 4, "gemma2-2b", (1, 4), path, timeout=120)
    here, there = torch.load(path)
    assert len(here) == len(there)
    for i, (a, b) in enumerate(zip(here, there)):
        assert torch.equal(a, b), (i, float((a - b).abs().max()))


def test_adafactor_step_divides_each_rank_s_own_block(tmp_path):
    """One adafactor step of the reduced grok-1-314b on 2x2 (d_model 256
    and a vocabulary of 1,024, so that a factored leaf gathered along one
    axis, the experts' (8, 256, 64) or the embedding's (1,024, 128), is
    larger than any rank's shard): no rank allocates more than its largest
    local shard of a param or a moment, and the params after the step
    equal the unsharded step's (fp32; the moments' means summed across
    ranks in another order: rtol = atol = 1e-6)."""
    cfg = get_config("grok-1-314b").reduced(d_model=256, vocab_size=1024)
    params = init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    grads = [torch.randn(x.shape, generator=gen) * 1e-2
             for x in leaves(params)]
    path = str(tmp_path / "adafactor.pt")
    torch.save({"cfg": cfg, "params": params, "grads": unflatten(
        params, grads)}, path)
    spawn(adafactor_worker, 4, path, timeout=120)
    out = torch.load(path + ".out", weights_only=False)
    largest = max(int(np.prod(s)) for s in out["local"])
    for allocs in out["allocs"]:
        assert max(int(np.prod(s)) for s in allocs) <= largest, (
            [s for s in allocs if int(np.prod(s)) > largest], largest)
    want = [x.clone() for x in leaves(params)]
    opt = optim.make_optimizer("adafactor", 1e-2)
    opt.step(grads, opt.init(want), want)
    for i, (g, w) in enumerate(zip(leaves(out["params"]), want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=f"leaf {i}")
