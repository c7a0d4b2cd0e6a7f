"""The paper's own workload sized and placed for real: the deepwalk-web1b
SGNS train step (``launch.dryrun``: ``graph_state``, ``GraphPairs``,
``graph_step``) from a config of V = 2^10 nodes, D = 16, K = 3 and B = 256
pairs (the deepwalk config, changed; the arguments laid out as
``build_graph_cell`` lays out the dry run's from it), 3 steps on a 2x2
gloo mesh under the cell's rules (the node tables' rows and the pairs
split over both axes).

Held against the port's step with no mesh and against the JAX package's
step composed from the same numpy tables and pairs (``batch_loss(...,
"ref")`` + ``adam(0.025)`` + ``apply_updates``, as its dry run composes
the cell), within rtol = atol = 1e-6: every step's loss, and the tables
and both Adam moments after the last step. The mesh's sums run in another
order (each rank's partial loss, the row gradients summed into each
rank's shard), so not bit for bit. Against the JAX package the tables are
held where Adam's denominator is not near its eps (see that test). Also:
the chunked init gives rank (d, m) block d x 2 + m of the one-device table
bit for bit; step 1's loss is (K + 1) ln 2 (``emb_out`` starts at zero);
no rank allocates a tensor of a whole table's size.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.skipgram.model import batch_loss as jbatch_loss
from repro.train import optim as joptim
from repro_torch.configs.deepwalk_web import CONFIG as DW_CONFIG
from repro_torch.launch import dryrun
from repro_torch.skipgram.model import batch_loss, init_rows
from repro_torch.train import optim
from torch_mesh_workers import graph_cell_worker, sliced_dtensor_worker, \
    spawn

CFG = dataclasses.replace(DW_CONFIG, n_nodes=1 << 10, dim=16, n_neg=3,
                          global_batch=256)
STEPS = 3
TOL = 1e-6


def _close(got, want, msg):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=msg)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("graph") / "cell.pt")
    torch.save({"cfg": CFG, "steps": STEPS}, path)
    spawn(graph_cell_worker, 4, (2, 2), path, timeout=120)
    return torch.load(path + ".out", weights_only=False)


def _port_run(cfg=CFG, steps=STEPS):
    """The port's graph step with no mesh on the CPU -> (metrics, params,
    state, [(the pairs, and the params and moments as numpy before it) for
    every step])."""
    step = dryrun.graph_step(optim.make_optimizer("adam", dryrun.GRAPH_LR),
                             metrics=True)
    params, state = dryrun.graph_state(cfg, device="cpu")
    pairs = dryrun.GraphPairs(cfg, device="cpu")
    metrics, before = [], []
    for s in range(steps):
        tree = {"params": params, "mu": state[0].mu, "nu": state[0].nu}
        before.append(({k: v.numpy().copy() for k, v in pairs(s).items()},
                       {t: {k: v.numpy().copy() for k, v in x.items()}
                        for t, x in tree.items()}))
        params, state, m = step(params, state, pairs(s))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, params, state, before


@pytest.fixture(scope="module")
def port_run():
    return _port_run()


def test_graph_cell_on_2x2_matches_the_unsharded_step(mesh_run, port_run):
    metrics, params, state, _ = port_run
    for s, (got, want) in enumerate(zip(mesh_run["metrics"], metrics)):
        for key in ("loss", "grad_norm"):
            _close(got[key], want[key], f"step {s + 1} {key}")
    got = mesh_run["state"]
    for name in ("emb_in", "emb_out"):
        _close(got["params"][name], params[name], name)
        _close(got["mu"][name], state[0].mu[name], f"mu {name}")
        _close(got["nu"][name], state[0].nu[name], f"nu {name}")


def test_graph_cell_on_2x2_matches_the_jax_step(mesh_run, port_run):
    """The JAX package's step from the port's initial tables (the same
    chunked draw) and the port's pairs: ``batch_loss`` with the plain
    SGNS loss, ``adam(0.025)``, ``apply_updates``. Run on for 3 steps:
    every loss and both moments of the 2x2 run. Each step once more from
    the port's state before it (its step with no mesh, which the 2x2 run
    equals everywhere): the loss, both gradients, and the moments
    everywhere; the tables where ``sqrt(v_hat) > 100 eps`` or no gradient
    reached the entry. Adam's ``g / (sqrt(v) + eps)`` moves an entry whose
    gradient sum cancels to ~1e-10 by up to lr x 1e-3 when the two
    packages sum its terms in another order, and such an entry's move
    reaches the other table's gradients in the next step, so the tables of
    runs left to go on apart are not held entry by entry
    (``test_torch_sgns.test_train_steps_match_jax`` holds them alike)."""
    metrics, params, state, before = port_run
    V, D = CFG.n_nodes, CFG.dim
    jopt = joptim.adam(dryrun.GRAPH_LR)

    @jax.jit
    def jstep(p, s, b):
        loss, grads = jax.value_and_grad(lambda q: jbatch_loss(
            q, b["centers"], b["contexts"], b["negatives"], "ref"))(p)
        updates, s = jopt.update(grads, s, p)
        return joptim.apply_updates(p, updates), s, loss, grads

    jp = {"emb_in": jnp.asarray(init_rows(0, V, V, D, 0,
                                          device="cpu").numpy()),
          "emb_out": jnp.zeros((V, D), jnp.float32)}
    js = jopt.init(jp)
    for s, (b, _) in enumerate(before):
        jp, js, loss, _ = jstep(jp, js, b)
        _close(mesh_run["metrics"][s]["loss"], loss, f"step {s + 1} loss")
    got = mesh_run["state"]
    for name in ("emb_in", "emb_out"):
        _close(got["mu"][name], js[0].mu[name], f"mu {name} vs jax")
        _close(got["nu"][name], js[0].nu[name], f"nu {name} vs jax")

    ws = {k: v.clone().requires_grad_() for k, v in params.items()}
    for s, (b, tree) in enumerate(before):
        after = before[s + 1][1] if s + 1 < len(before) else {
            "params": {k: v.numpy() for k, v in params.items()},
            "mu": {k: v.numpy() for k, v in state[0].mu.items()},
            "nu": {k: v.numpy() for k, v in state[0].nu.items()}}
        js = jopt.init(tree["params"])
        js = (js[0]._replace(count=jnp.int32(s), mu=tree["mu"],
                             nu=tree["nu"]), *js[1:])
        jp, js, loss, jgrads = jstep(tree["params"], js, b)
        _close(metrics[s]["loss"], loss, f"step {s + 1} loss")
        for k, w in ws.items():
            w.data = torch.from_numpy(tree["params"][k])
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        grads = torch.autograd.grad(batch_loss(
            ws, tb["centers"], tb["contexts"], tb["negatives"]),
            list(ws.values()))
        c2 = 1 - 0.999 ** (s + 1)
        for name, g in zip(ws, grads):
            _close(g, jgrads[name], f"step {s + 1} grad {name}")
            _close(after["mu"][name], js[0].mu[name], f"step {s + 1} mu")
            _close(after["nu"][name], js[0].nu[name], f"step {s + 1} nu")
            nu = np.asarray(js[0].nu[name])
            ok = (np.sqrt(nu / c2) > 100 * 1e-8) | (nu == 0)
            assert ok.mean() > 0.9, (s, name, ok.mean())
            _close(after["params"][name][ok], np.asarray(jp[name])[ok],
                   f"step {s + 1} {name}")


def test_chunked_init_gives_each_rank_its_rows_of_the_whole_table(mesh_run):
    V, D = CFG.n_nodes, CFG.dim
    whole = init_rows(0, V, V, D, 0, device="cpu")
    n = V // 4
    seen = set()
    for ((d, m), lo, rows), _, _ in mesh_run["ranks"]:
        blk = d * 2 + m  # data-major, as the JAX package lays a dim over
        assert lo == blk * n, ((d, m), lo)  # ("data", "model")
        assert torch.equal(rows, whole[blk * n:(blk + 1) * n]), (d, m)
        seen.add(blk)
    assert seen == {0, 1, 2, 3}
    # any range draws the same bits, across chunk boundaries too
    assert torch.equal(init_rows(5, 300, V, D, 0, device="cpu"),
                       whole[5:300])
    # the init's law: uniform(-0.5, 0.5) / D
    assert float(whole.abs().max()) <= 0.5 / D


def test_real_run_is_laid_out_as_the_dry_run_s_cell(mesh_run):
    """On every rank the real run's params, Adam state and pairs have the
    global shapes, dtypes, placements and local shapes of the arguments
    ``build_graph_cell`` builds for the dry run from the same config."""
    assert [as_cell for _, _, as_cell in mesh_run["ranks"]] == [True] * 4


def test_step_one_loss_is_k_plus_one_ln_2(mesh_run):
    """``emb_out`` starts at zero, so every pair's loss is -log sigmoid(0)
    for its context and each of its K negatives: (K + 1) ln 2, on the mesh
    (K = 3) and at the deepwalk config's K = 5 (6 ln 2) with no mesh."""
    assert mesh_run["metrics"][0]["loss"] == pytest.approx(
        (CFG.n_neg + 1) * math.log(2), rel=1e-6)
    five = dataclasses.replace(CFG, n_neg=DW_CONFIG.n_neg)
    metrics, *_ = _port_run(five, steps=1)
    assert DW_CONFIG.n_neg == 5
    assert metrics[0]["loss"] == pytest.approx(6 * math.log(2), rel=1e-6)


def test_no_rank_allocates_a_whole_table(mesh_run):
    """Init, pairs and 3 steps (lookups, their backward, Adam): no tensor
    a rank allocates holds as many entries as one node table (V x D), and
    the largest holds the rank's shard of one."""
    table = CFG.n_nodes * CFG.dim
    for (coord, _, _), shapes, _ in mesh_run["ranks"]:
        sizes = [math.prod(s) for s in shapes]
        assert max(sizes) < table, (coord, max(sizes), table)
        assert table // 4 in sizes, coord


def test_pairs_are_drawn_alike_and_spread_the_hot_rows():
    """``GraphPairs``: the same step gives the same ids; ids in [0, V);
    the 16 most frequent centers fall on every rank's quarter of the rows;
    the negatives' law is flatter than the pairs' (its top id's share is
    smaller)."""
    V = CFG.n_nodes
    a, b = (dryrun.GraphPairs(CFG, device="cpu") for _ in range(2))
    x, y = a(2), b(2)
    assert all(torch.equal(x[k], y[k]) for k in x)
    assert not torch.equal(a(3)["centers"], x["centers"])
    for k, v in x.items():
        assert v.dtype == torch.int32 and 0 <= int(v.min()) <= int(v.max()) \
            < V, k
    assert x["negatives"].shape == (CFG.global_batch, CFG.n_neg)
    big = dataclasses.replace(CFG, global_batch=1 << 16)
    z = dryrun.GraphPairs(big, device="cpu")(0)
    hot = torch.bincount(z["centers"].long(), minlength=V).topk(16).indices
    assert set((hot // (V // 4)).tolist()) == {0, 1, 2, 3}
    share = [torch.bincount(z[k].reshape(-1).long(), minlength=V).max()
             / z[k].numel() for k in ("centers", "negatives")]
    assert share[1] < share[0]


@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_sliced_step_on_a_dtensor_s_local_shard_keeps_the_bits(name,
                                                                tmp_path):
    """``optim``'s elementwise step slices a DTensor leaf's local shard
    above ``SLICE_BYTES`` (patched to 2 rows of the (64, 16) table's
    (16, 16) shard): three steps on 2x2 give the params and moments of the
    step without slices bit for bit, the table (rows over both axes) and
    a stacked leaf split over model taken in several slices. A sliced step
    on the state of ``init`` (each rank's moments whole, not its shards')
    raises rather than read the moments' wrong rows."""
    gen = torch.Generator().manual_seed(3)
    shapes = {"table": (64, 16), "stack": (6, 8, 12), "norm": (12,)}
    params = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    grads = [{k: torch.randn(s, generator=gen) for k, s in shapes.items()}
             for _ in range(3)]
    path = str(tmp_path / "sliced.pt")
    torch.save({"name": name, "params": params, "grads": grads,
                "small": 2 * 16 * 4}, path)
    spawn(sliced_dtensor_worker, 4, path, timeout=90)
    (p1, m1, v1, n1), (p2, m2, v2, n2), raised = torch.load(
        path + ".out", weights_only=False)
    assert raised is not None and "not laid out" in raised, raised
    assert n1 == {"table": 1, "stack": 1, "norm": 1}
    assert n2["table"] == 8 and n2["stack"] == 6 and n2["norm"] == 1
    for a, b in ((p1, p2), (m1, m2), (v1, v2)):
        for k in shapes:
            assert torch.equal(a[k], b[k]), k
