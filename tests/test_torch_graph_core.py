"""The port's graph containers, generators, k-core and propagation against
the JAX package's, on the same seeds and inputs.

Generators, CSR arrays and ELL tables must be byte-identical (both draw
from numpy's ``default_rng``); core numbers exactly equal to the peeling
oracle and to ``core_numbers_jax``; the propagation's ``torch`` backend
within 1e-5 of the ``jax`` backend (fp32 sums in another order).
"""
import numpy as np
import pytest
import torch

from repro.core import kcore as jkcore
from repro.core import propagation as jprop
from repro.graph import datasets as jdatasets
from repro.graph import generators as jgen
from repro_torch.core import kcore, propagation
from repro_torch.graph import datasets, generators

GENERATORS = [
    ("barabasi_albert", (200, 3)),
    ("barabasi_albert_varying", (300, 4.0)),
    ("erdos_renyi", (150, 400)),
    ("powerlaw_cluster", (120, 3, 0.3)),
    ("stochastic_block_model", ([30, 40], 0.3, 0.02)),
]


def _graphs():
    return [
        generators.barabasi_albert_varying(300, 4.0, seed=1),
        generators.erdos_renyi(200, 600, seed=2),
        generators.powerlaw_cluster(150, 4, 0.5, seed=3),
        datasets.load("tiny", seed=0),
    ]


@pytest.mark.parametrize("name,args", GENERATORS)
@pytest.mark.parametrize("seed", [0, 5])
def test_generators_are_byte_identical(name, args, seed):
    got = getattr(generators, name)(*args, seed=seed)
    want = getattr(jgen, name)(*args, seed=seed)
    assert got.n_nodes == want.n_nodes
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert got.indices.dtype == want.indices.dtype
    np.testing.assert_array_equal(got.edge_list(), want.edge_list())


@pytest.mark.parametrize("name", ["tiny", "cora-like"])
def test_dataset_presets_are_byte_identical(name):
    got, want = datasets.load(name, seed=0), jdatasets.load(name, seed=0)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)


@pytest.mark.parametrize("max_width", [None, 5])
def test_ell_tables_are_byte_identical(max_width):
    g = generators.barabasi_albert_varying(300, 4.0, seed=4)
    jg = jgen.barabasi_albert_varying(300, 4.0, seed=4)
    got = g.to_ell(max_width, seed=7, device="cpu")
    want = jg.to_ell(max_width, seed=7)
    assert got.neighbours.dtype == torch.int32
    np.testing.assert_array_equal(got.neighbours.numpy(),
                                  np.asarray(want.neighbours))
    np.testing.assert_array_equal(got.degrees.numpy(),
                                  np.asarray(want.degrees))
    assert got.width == want.width
    np.testing.assert_array_equal(got.mask().numpy(), np.asarray(want.mask()))


@pytest.mark.parametrize("gi", range(4))
@pytest.mark.parametrize("impl", ["ref", "count"])
def test_core_numbers_torch_equals_oracles(gi, impl):
    g = _graphs()[gi]
    jg = jgen.Graph(g.n_nodes, g.indptr, g.indices)
    host = kcore.core_numbers_host(g)
    np.testing.assert_array_equal(host, jkcore.core_numbers_host(jg))
    got = kcore.core_numbers_torch(g.to_ell(device="cpu"), impl=impl)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), host)
    want = np.asarray(jkcore.core_numbers_jax(jg.to_ell(), impl=impl))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("gi", range(4))
def test_rounds_and_shell_peels_match_jax(gi):
    g = _graphs()[gi]
    src = np.repeat(np.arange(g.n_nodes), np.diff(g.indptr))
    dst = g.indices.astype(np.int64)
    got = kcore.core_numbers_rounds(g.n_nodes, src, dst)
    np.testing.assert_array_equal(
        got, jkcore.core_numbers_rounds(g.n_nodes, src, dst))
    np.testing.assert_array_equal(got, kcore.core_numbers_host(g))
    hi = max(int(got.max()) // 2, 1)
    peel = got <= hi
    inner = peel[src] & peel[dst]
    deg = g.degrees()
    shell = kcore.core_numbers_shell_peel(
        g.n_nodes, src[inner], dst[inner], peel, deg, hi)
    jshell = jkcore.core_numbers_shell_peel(
        g.n_nodes, src[inner], dst[inner], peel, deg, hi)
    assert shell[1] == jshell[1]
    np.testing.assert_array_equal(shell[0], jshell[0])


def test_core_numbers_torch_capped_table_is_a_lower_bound():
    g = generators.barabasi_albert_varying(300, 4.0, seed=6)
    capped = kcore.core_numbers_torch(g.to_ell(4, device="cpu")).numpy()
    assert (capped <= kcore.core_numbers_host(g)).all()


def _propagation_case(seed=0, dim=16, n=300):
    g = generators.barabasi_albert_varying(n, 4.0, seed=seed)
    core = kcore.core_numbers_host(g)
    k0 = max(2, kcore.degeneracy(core) // 2)
    rng = np.random.default_rng(seed)
    emb = np.zeros((g.n_nodes, dim), np.float32)
    emb[core >= k0] = rng.normal(size=(int((core >= k0).sum()), dim))
    return g, core, k0, emb


@pytest.mark.parametrize("seed", [0, 1])
def test_propagation_torch_backend_matches_jax_backend(seed):
    # small: the JAX backend dispatches one eager scatter per shell sweep
    g, core, k0, emb = _propagation_case(seed, n=120)
    jg = jgen.Graph(g.n_nodes, g.indptr, g.indices)
    got = propagation.propagate(g, core, k0, emb, n_iters=4,
                                backend="torch", device="cpu")
    want = jprop.propagate(jg, core, k0, emb, n_iters=4, backend="jax")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the k0-core rows are never touched
    np.testing.assert_array_equal(got[core >= k0], emb[core >= k0])


def test_propagation_scipy_backend_is_a_copy():
    g, core, k0, emb = _propagation_case(2)
    jg = jgen.Graph(g.n_nodes, g.indptr, g.indices)
    np.testing.assert_array_equal(
        propagation.propagate(g, core, k0, emb, n_iters=10),
        jprop.propagate(jg, core, k0, emb, n_iters=10),
    )


def test_propagation_torch_backend_converges_to_exact_shell_solve():
    g, core, k0, emb = _propagation_case(3, dim=4)
    k = propagation.propagation_schedule(core, k0)[0]
    got = propagation.propagate(g, core, k0, emb, n_iters=300,
                                backend="torch", device="cpu")
    exact = propagation.solve_shell_exact(g, core, k, emb)
    shell = core == k
    np.testing.assert_allclose(got[shell], exact[shell], rtol=1e-3,
                               atol=1e-3)


def test_cuda_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: nothing to refuse")
    g = generators.barabasi_albert_varying(100, 3.0, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        g.to_ell()
    g2, core, k0, emb = _propagation_case(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        propagation.propagate(g2, core, k0, emb, backend="torch")
