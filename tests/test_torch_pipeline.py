"""The port's offline pipeline (split -> k-core -> CoreWalk -> walks -> SGNS
-> propagation -> link-prediction F1) against the JAX package's.

Deterministic stages must match exactly: splits byte for byte, walk plans,
the noise CDF of the same walks, ``n_walks_run`` and ``n_sgns_steps``.
Random stages (walks, pair sampling, init) draw from torch generators, not
threefry, so they match in structure and in distribution: visit frequencies
within 0.004 of the JAX walks' (about four standard errors of the
difference at 256,000 visits per side), and F1 within a band of the JAX
F1: 0.25 on ``tiny``, whose split holds some 18 test pairs (one pair
moves F1 by about 0.05), and 0.1 on ``cora-like``, an Erdős–Rényi graph
whose F1 sits near chance at these settings. The logistic fit agrees within 1e-4 on the same features, the
torch propagation backend with the scipy one within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import corewalk as jcorewalk
from repro.core import kcore as jkcore
from repro.core.pipeline import EmbedConfig as JEmbedConfig
from repro.core.pipeline import embed_graph as jembed_graph
from repro.eval import linkpred as jlinkpred
from repro.graph import datasets as jdatasets
from repro.graph import splits as jsplits
from repro.skipgram import corpus as jcorpus
from repro.skipgram.trainer import SGNSConfig as JSGNSConfig
from repro.walks import engine as jengine
from repro_torch.core import corewalk, kcore, propagation
from repro_torch.core.pipeline import EmbedConfig, embed_graph
from repro_torch.eval import linkpred
from repro_torch.graph import datasets, generators, splits
from repro_torch.graph.csr import Graph
from repro_torch.launch import tables
from repro_torch.skipgram import corpus
from repro_torch.skipgram.trainer import SGNSConfig
from repro_torch.walks import engine

F1_BAND = {"tiny": 0.25, "cora-like": 0.1}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("name", ["tiny", "cora-like"])
@pytest.mark.parametrize("seed", [0, 1])
def test_splits_and_plans_are_identical(name, seed):
    sp = splits.make_link_split(datasets.load(name), 0.1, seed=seed)
    jsp = jsplits.make_link_split(jdatasets.load(name), 0.1, seed=seed)
    for a, b in ((sp.train_graph.indptr, jsp.train_graph.indptr),
                 (sp.train_graph.indices, jsp.train_graph.indices),
                 (sp.pos_edges, jsp.pos_edges), (sp.neg_edges, jsp.neg_edges)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    core = kcore.core_numbers_host(sp.train_graph)
    for mine, theirs in (
        (corewalk.corewalk_plan(core, 15), jcorewalk.corewalk_plan(core, 15)),
        (corewalk.deepwalk_plan(len(core), 15, pad_to=64),
         jcorewalk.deepwalk_plan(len(core), 15, pad_to=64)),
    ):
        assert mine.n_real == theirs.n_real
        np.testing.assert_array_equal(mine.roots, theirs.roots)
        np.testing.assert_array_equal(mine.per_node, theirs.per_node)


def _assert_steps_valid(g, walks):
    for w in np.asarray(walks):
        for a, b in zip(w[:-1], w[1:]):
            assert g.has_edge(int(a), int(b)) or (a == b and g.degrees()[a] == 0)


@pytest.mark.parametrize("kind", ["uniform", "node2vec"])
def test_walks_are_paths_and_hold_at_dead_ends(kind):
    g = generators.barabasi_albert(120, 3, seed=0)
    # two isolated nodes (3 and 4) beside a path
    dead = Graph.from_edges(6, np.array([[0, 1], [1, 2], [2, 5]]))
    for graph in (g, dead):
        roots = torch.arange(graph.n_nodes, dtype=torch.int32).repeat(3)
        ell = graph.to_ell(device="cpu")
        if kind == "uniform":
            w = engine.random_walks(ell, roots, 12, _gen(0))
        else:
            w = engine.node2vec_walks(ell, roots, 12, _gen(0), p=0.5, q=2.0)
        assert w.shape == (len(roots), 12) and w.dtype == torch.int32
        assert torch.equal(w[:, 0], roots)
        _assert_steps_valid(graph, w)
    assert (w[roots == 3] == 3).all() and (w[roots == 4] == 4).all()


@pytest.mark.parametrize("kind", ["uniform", "node2vec"])
def test_visit_frequencies_match_jax(kind):
    g = datasets.load("tiny")
    jg = jdatasets.load("tiny")
    roots = np.repeat(np.arange(g.n_nodes, dtype=np.int32), 200)
    if kind == "uniform":
        mine = engine.random_walks(g.to_ell(device="cpu"),
                                   torch.from_numpy(roots), 20, _gen(1))
        theirs = jengine.random_walks(jg.to_ell(), jnp.asarray(roots), 20,
                                      jax.random.PRNGKey(1))
    else:
        mine = engine.node2vec_walks(g.to_ell(device="cpu"),
                                     torch.from_numpy(roots), 20, _gen(1),
                                     p=0.5, q=2.0)
        theirs = jengine.node2vec_walks(jg.to_ell(), jnp.asarray(roots), 20,
                                        jax.random.PRNGKey(1), p=0.5, q=2.0)
    f_mine = np.bincount(mine.numpy().ravel(), minlength=g.n_nodes)
    f_theirs = np.bincount(np.asarray(theirs).ravel(), minlength=g.n_nodes)
    n = roots.size * 20
    assert np.abs(f_mine / n - f_theirs / n).max() < 0.004


def test_node2vec_return_bias():
    """p << 1 makes immediate backtracking much more likely than p >> 1
    (as ``tests/unit/test_walks.py``)."""
    ell = generators.barabasi_albert(80, 3, seed=1).to_ell(device="cpu")
    roots = torch.full((4096,), 5, dtype=torch.int32)
    back = {}
    for p, tag in [(0.05, "low"), (20.0, "high")]:
        w = engine.node2vec_walks(ell, roots, 3, _gen(2), p=p, q=1.0)
        back[tag] = float((w[:, 2] == w[:, 0]).float().mean())
    assert back["low"] > back["high"] + 0.2


def test_noise_cdf_matches_jax_on_the_same_walks():
    jg = jdatasets.load("tiny")
    plan = jcorewalk.corewalk_plan(jkcore.core_numbers_host(jg), 6, pad_to=32)
    jc = jcorpus.build_corpus(jg.to_ell(), plan, 10, jax.random.PRNGKey(3),
                              chunk=100)
    cdf = corpus.noise_cdf(torch.tensor(np.asarray(jc.walks)),
                           plan.n_real, jg.n_nodes)
    assert cdf.dtype == np.float32
    assert cdf.tobytes() == np.asarray(jc.noise_cdf).tobytes()


def test_sampled_contexts_stay_in_the_window():
    window, length = 4, 10
    w, i, j = corpus.sample_positions(_gen(4), 20000, window, length, 7,
                                      "cpu")
    off = (j - i).abs()
    assert ((w >= 0) & (w < 7)).all()
    assert ((off >= 1) & (off <= window)).all()
    assert ((j >= 0) & (j < length)).all()
    # reflection: from position 0 every context lies after the center
    assert (j[i == 0] > 0).all() and (j[i == length - 1] < length - 1).all()
    assert set(off.tolist()) == set(range(1, window + 1))
    g = datasets.load("tiny")
    c = corpus.build_corpus(g.to_ell(device="cpu"),
                            corewalk.deepwalk_plan(g.n_nodes, 5), length,
                            _gen(5))
    centers, contexts, negatives = corpus.sample_batch(
        c, _gen(6), batch=50000, window=window, n_neg=5)
    assert negatives.shape == (50000, 5)
    assert all(t.max() < g.n_nodes and t.min() >= 0
               for t in (centers, contexts, negatives))
    probs = np.diff(np.concatenate([[0.0], c.noise_cdf.numpy()]))
    freq = np.bincount(negatives.numpy().ravel(), minlength=g.n_nodes)
    assert np.abs(freq / negatives.numel() - probs).max() < 0.003


def test_logistic_fit_matches_jax():
    rng = np.random.default_rng(7)
    sp = splits.make_link_split(datasets.load("cora-like"), 0.1, seed=0)
    pairs, labels = sp.eval_arrays()
    emb = rng.standard_normal((sp.train_graph.n_nodes, 12)).astype(np.float32)
    emb[pairs[labels == 1, 0], :4] += 0.5  # some signal in the positives
    order = np.random.default_rng(0).permutation(len(pairs))
    tr, te = order[: int(0.6 * len(pairs))], order[int(0.6 * len(pairs)):]
    X = np.concatenate([emb[pairs[:, 0]], emb[pairs[:, 1]]], axis=1)
    X = (X - X[tr].mean(0)) / (X[tr].std(0) + 1e-8)
    w, b = linkpred.fit_logreg(torch.from_numpy(X[tr]),
                               torch.from_numpy(labels[tr]))
    jp = jlinkpred._fit_logreg(jnp.asarray(X[tr]), jnp.asarray(labels[tr]))
    np.testing.assert_allclose(w.numpy(), np.asarray(jp["w"]), atol=1e-4)
    assert abs(float(b) - float(jp["b"])) < 1e-4
    pred_t = (X[te] @ w.numpy() + float(b) > 0).astype(np.int32)
    pred_j = (X[te] @ np.asarray(jp["w"]) + float(jp["b"]) > 0).astype(np.int32)
    assert (pred_t != pred_j).sum() <= 1
    y = labels[te].astype(np.int32)
    lp = linkpred.evaluate_link_prediction(emb, pairs, labels, seed=0,
                                           device="cpu")
    jlp = jlinkpred.evaluate_link_prediction(emb, pairs, labels, seed=0)
    assert lp.f1 == linkpred.f1_score(y, pred_t)
    assert jlp.f1 == linkpred.f1_score(y, pred_j)
    assert (lp.n_train, lp.n_test) == (jlp.n_train, jlp.n_test)


def _settings(method, k0, seed=0):
    sg = dict(dim=32, batch=1024, epochs=0.4, impl="ref", seed=seed)
    common = dict(method=method, k0=k0, n_walks=8, walk_length=16,
                  prop_iters=25, seed=seed)
    return (EmbedConfig(sgns=SGNSConfig(**sg), prop_backend="torch",
                        device="cpu", **common),
            JEmbedConfig(sgns=JSGNSConfig(**sg), **common))


@pytest.mark.parametrize("name,method,kcore_row", [
    ("tiny", "deepwalk", False), ("tiny", "corewalk", False),
    ("tiny", "deepwalk", True), ("cora-like", "deepwalk", True),
])
def test_embed_graph_matches_jax(name, method, kcore_row):
    """At ``tests/integration/test_paper_pipeline.py``'s settings: the same
    corpus size and step count, F1 within the band, and the k-core row's
    torch propagation equal to the scipy one on the same base embeddings."""
    sp = splits.make_link_split(datasets.load(name), 0.1, seed=0)
    jsp = jsplits.make_link_split(jdatasets.load(name), 0.1, seed=0)
    core = kcore.core_numbers_host(sp.train_graph)
    k0 = max(2, kcore.degeneracy(core) // 2) if kcore_row else None
    cfg, jcfg = _settings(method, k0)
    res = embed_graph(sp.train_graph, cfg)
    jres = jembed_graph(jsp.train_graph, jcfg)
    assert (res.n_walks_run, res.n_sgns_steps) == (jres.n_walks_run,
                                                   jres.n_sgns_steps)
    assert res.degeneracy == jres.degeneracy
    np.testing.assert_array_equal(res.core, jres.core)
    assert np.isfinite(res.embeddings).all() and np.isfinite(res.final_loss)
    assert set(res.times) == set(jres.times)
    pairs, labels = sp.eval_arrays()
    f1 = linkpred.evaluate_link_prediction(res.embeddings, pairs, labels,
                                           seed=0, device="cpu").f1
    jf1 = jlinkpred.evaluate_link_prediction(jres.embeddings, pairs, labels,
                                             seed=0).f1
    assert abs(f1 - jf1) <= F1_BAND[name], (f1, jf1)
    if kcore_row:
        host = propagation.propagate(sp.train_graph, core, k0, res.embeddings,
                                     n_iters=25, backend="scipy")
        np.testing.assert_allclose(res.embeddings, host, rtol=1e-5, atol=1e-5)
        # shells filled (a component cut off below k0 stays 0, as in JAX)
        assert (np.linalg.norm(res.embeddings, axis=1)[core < k0] > 0).mean() \
            > 0.99


def test_tables_entry_point_on_tiny(capsys):
    """The port's table entry point on the CPU: the JAX harness's row and
    CSV formats, and per row the corpus size and step count of the JAX
    pipeline on the same split and settings."""
    rows = tables.main(["--device", "cpu", "--table", "tiny", "--quick"])
    out = capsys.readouterr().out
    s, models = tables.table("tiny", quick=True)
    assert len(rows) == len(models) == 3
    assert out.count("table_tiny_f10_") == 3 and "speedup x" in out
    g = datasets.load("tiny")
    jg = jdatasets.load("tiny")
    sp = jsplits.make_link_split(jg, s.frac_removed, seed=0)
    core = kcore.core_numbers_host(g)
    for row, (label, method, k0f) in zip(rows, models):
        k0 = tables.k0_of(core, k0f)
        jres = jembed_graph(sp.train_graph, JEmbedConfig(
            method=method, k0=k0, n_walks=s.n_walks,
            walk_length=s.walk_length, prop_iters=s.prop_iters,
            sgns=JSGNSConfig(dim=s.dim, window=s.window, n_neg=s.n_neg,
                             batch=s.batch, epochs=s.epochs, impl="ref")))
        assert row["model"] == (label if k0 is None else f"{k0}-core ({label})")
        assert (row["n_walks_run"], row["sgns_steps"]) == (
            jres.n_walks_run, jres.n_sgns_steps)
        assert 0 <= row["f1"] <= 100 and np.isfinite(row["final_loss"])
