"""flash-decode on a KV cache split along its sequence (``kv_seq``), as
the JAX package's dry run splits it where the KV heads do not divide the
model axis: each rank runs the kernel's plain version over its own
positions and the partial outputs are combined by their log-sum-exps
(``kernels.ops.combine_partials``). Held: the plain version's
log-sum-exp against a direct one; random splits of S combined against the
whole (shards with no visible position, windows, softcap, an int8 cache);
the sharded call on gloo meshes of 2 and 8 CPU ranks against the
unsharded port and the JAX package (fp32, rtol = atol = 1e-5), with every
collective it issues smaller than a rank's slice of the cache. The
committed dry run's records of such cells are held in
``test_torch_dryrun.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import quantize_kv_rows
from torch_mesh_workers import seq_decode_worker, spawn

B, S, DH = 5, 128, 16
# row 1 ends in the first 16 positions, row 2's window [62, 71) spans two
# 16-position shards, row 3 has one position, row 4's length runs past S
LENS = np.array([128, 5, 71, 1, 130], np.int32)
# (H, Hkv, int8 cache, softcap, window)
CASES = ((8, 2, False, 20.0, 9), (4, 4, False, 0.0, 0), (8, 2, True, 0.0, 9),
         (6, 3, False, 20.0, 0))


def _inputs(h, hkv, int8, seed):
    rng = np.random.default_rng(seed)
    t = {"q": rng.standard_normal((B, h, DH)).astype(np.float32),
         "k": rng.standard_normal((B, S, hkv, DH)).astype(np.float32),
         "v": rng.standard_normal((B, S, hkv, DH)).astype(np.float32),
         "lens": LENS}
    t = {k: torch.from_numpy(v) for k, v in t.items()}
    if int8:
        t["k"], t["k_scale"] = quantize_kv_rows(t["k"])
        t["v"], t["v_scale"] = quantize_kv_rows(t["v"])
    return t


def _direct_lse(t, softcap, window):
    """Each query row's logsumexp over its visible positions, written out
    from the definition (float64)."""
    q, k = t["q"].double(), t["k"].double()
    if "k_scale" in t:
        k = k * t["k_scale"][..., None].double()
    h, hkv = q.shape[1], k.shape[2]
    k = k.repeat_interleave(h // hkv, dim=2)
    logits = torch.einsum("bhd,bshd->bhs", q, k) / np.sqrt(DH)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    pos = torch.arange(S)[None]
    lens = t["lens"].long()[:, None]
    lo = (lens - window).clamp_min(0) if window else torch.zeros_like(lens)
    vis = (pos >= lo) & (pos < lens)
    return torch.logsumexp(logits.masked_fill(~vis[:, None], -np.inf), -1)


@pytest.mark.parametrize("case", CASES)
def test_plain_lse_and_random_splits_combine_to_the_whole(case):
    h, hkv, int8, softcap, window = case
    t = _inputs(h, hkv, int8, 0)
    kw = {"softcap": softcap, "window": window}
    sc = {n: t[n] for n in ("k_scale", "v_scale") if n in t}
    whole, lse = ref.decode_attention_ref(t["q"], t["k"], t["v"], t["lens"],
                                          return_lse=True, **kw, **sc)
    want = _direct_lse(t, softcap, window)
    assert torch.isfinite(want).all()
    np.testing.assert_allclose(lse.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(
        whole.numpy(), ops.decode_attention(t["q"], t["k"], t["v"],
                                            t["lens"], **kw, **sc).numpy())
    rng = np.random.default_rng(1)
    for _ in range(4):
        cuts = [0, *sorted(rng.choice(np.arange(1, S), 4, replace=False)), S]
        outs, lses = [], []
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            o, s = ops._decode_seq_shard(
                t["q"], t["k"][:, lo:hi], t["v"][:, lo:hi], t["lens"],
                window, lo, softcap, *(sc[n][:, lo:hi] if sc else None
                                       for n in ("k_scale", "v_scale")),
                "ref")
            empty = s == -np.inf
            assert torch.equal(o[empty], torch.zeros_like(o[empty]))
            outs.append(o)
            lses.append(s)
        lses = torch.stack(lses)
        assert (lses == -np.inf).any()  # some shard sees no position
        w = torch.exp(lses - lses.max(0).values)
        got = (w[..., None] * torch.stack(outs)).sum(0) / w.sum(0)[..., None]
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=str(cuts))
        np.testing.assert_allclose(torch.logsumexp(lses, 0).numpy(),
                                   lse.numpy(), rtol=1e-5, atol=1e-5)


def test_plain_lse_of_a_row_with_no_visible_position():
    t = _inputs(4, 2, False, 2)
    lens = torch.tensor([0, 3, 0, 9, 1], dtype=torch.int32)
    out, lse = ref.decode_attention_ref(t["q"], t["k"], t["v"], lens,
                                        return_lse=True)
    assert torch.equal(lse[lens == 0], torch.full((2, 4), -np.inf))
    assert not out[lens == 0].any() and torch.isfinite(lse[lens > 0]).all()


@pytest.mark.parametrize("world", [2, 8])
def test_sequence_split_decode_matches_unsharded_and_jax(world, tmp_path):
    path = str(tmp_path / "seq.pt")
    cases = []
    for i, (h, hkv, int8, softcap, window) in enumerate(CASES):
        cases.append((_inputs(h, hkv, int8, 10 + i),
                      {"softcap": softcap, "window": window}))
    torch.save(cases, path)
    spawn(seq_decode_worker, world, path, timeout=90)
    got = torch.load(path + ".out", weights_only=False)
    for (t, kw), (out, placements, calls, largest), case in zip(cases, got,
                                                               CASES):
        sc = {n: t[n] for n in ("k_scale", "v_scale") if n in t}
        want = ops.decode_attention(t["q"], t["k"], t["v"], t["lens"], **kw,
                                    **sc)
        jwant = jops.decode_attention(
            *(jnp.asarray(t[n].numpy()) for n in ("q", "k", "v", "lens")),
            impl="ref", **kw, **{n: jnp.asarray(x.numpy())
                                 for n, x in sc.items()})
        msg = f"world {world} case {case}"
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=msg)
        np.testing.assert_allclose(out.numpy(), np.asarray(jwant),
                                   rtol=1e-5, atol=1e-5, err_msg=msg)
        heads = case[0] % world == 0
        assert placements == ["R", "S(1)" if heads else "R"], msg
        slice_bytes = sum(t[n].numel() * t[n].element_size() for n in
                          ("k", "v", "k_scale", "v_scale") if n in t) / world
        kinds = {kind for kind, n in calls.items() if n}
        assert kinds <= {"all-reduce", "all-gather"}, (msg, calls)
        assert calls["all-reduce"] == 2, (msg, calls)
        assert max(largest.values()) < slice_bytes, (msg, largest)
