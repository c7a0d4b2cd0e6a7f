"""The port's sharding layer against the JAX package's, exactly, with no
devices: both packages' logical rules evaluated over a mesh of names and
sizes (JAX's ``AbstractMesh``, the port's ``MeshShape``).

For the 10 LM archs and deepwalk-web1b on both production meshes, every
cell of the JAX dry run's sweep (each arch's overrides plus the dry run's
``cell_overrides``): every leaf of the params, optimizer state (train),
batch and cache (decode) gets the same per-dim mesh axes from the port's
``spec_for`` as from the JAX package's, the same per-device shape as
``NamedSharding.shard_shape``, and so the cell's per-device argument bytes
are equal to the byte. The logical-name trees (model, cache, optimizer,
batch) are equal as trees of tuples. Also: a ``meta`` build has a real
build's shapes and dtypes, the DTensor placements of a dim split over two
mesh axes, ``constrain`` / the kernel wrappers outside a mesh, and the SSM
and hybrid families sharded on 2x2 gloo ranks against the unsharded port
and the JAX package (``torch_mesh_cases.check_family``).
"""
import functools
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import REGISTRY as JREGISTRY
from repro.configs import get_config as jget_config
from repro.configs import shapes as jshapes
from repro.distributed import sharding as jsh
from repro.models import transformer as jtf
from repro.train import optim as joptim
from repro_torch.configs import (GRAPH_REGISTRY, REGISTRY, SHARDING_OVERRIDES,
                                 get_config, sharding_overrides)
from repro_torch.configs import shapes
from repro_torch.configs.deepwalk_web import CONFIG as DW
from repro_torch.distributed import sharding as sh
from repro_torch.launch.dryrun import cell_overrides
from repro_torch.models import transformer as tf
from repro_torch.train import optim
from repro_torch.train.tree import leaves, leaves_up_to
from torch_mesh_cases import check_family

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _jax_dryrun():
    """The JAX dry-run module, imported without keeping the 512-device flag
    it sets at import (this process's JAX keeps the suite's devices)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as m
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return m


def _plain(tree):
    """NamedTuples as tuples, recursively (both packages' AdamState)."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return tuple(_plain(v) for v in tree)
    if isinstance(tree, tuple) and not all(
            isinstance(x, (str, type(None))) for x in tree):
        return tuple(_plain(v) for v in tree)
    return tree


@functools.lru_cache(maxsize=None)
def _jax_avals(arch):
    cfg = jget_config(arch)
    params = jax.eval_shape(lambda: jtf.init_model(jax.random.PRNGKey(0),
                                                   cfg))
    opt = joptim.make_optimizer(cfg.optimizer, 1e-4)
    return params, jax.eval_shape(opt.init, params)


@functools.lru_cache(maxsize=None)
def _port_meta(arch):
    cfg = get_config(arch)
    params = tf.init_model(cfg, None, device="meta")
    opt = optim.make_optimizer(cfg.optimizer, 1e-4)
    return params, opt.init(params)


def _jax_args(arch, shape_name):
    """[(avals tree, names tree)] of a cell's arguments, JAX side."""
    if arch == DW.name:
        V, D, K, B = DW.n_nodes, DW.dim, DW.n_neg, DW.global_batch
        sds = jax.ShapeDtypeStruct
        p = {"emb_in": sds((V, D), np.float32), "emb_out": sds((V, D),
                                                             np.float32)}
        ps = {"emb_in": ("vocab", None), "emb_out": ("vocab", None)}
        o = jax.eval_shape(joptim.adam(0.025).init, p)
        b = {"centers": sds((B,), np.int32), "contexts": sds((B,), np.int32),
             "negatives": sds((B, K), np.int32)}
        bs = {"centers": ("batch",), "contexts": ("batch",),
              "negatives": ("batch", None)}
        return [(p, ps), (o, joptim.adam_state_specs(ps)), (b, bs)]
    cfg = jget_config(arch)
    shape = jshapes.SHAPES[shape_name]
    params, opt = _jax_avals(arch)
    ps = jtf.model_specs(cfg)
    out = [(params, ps)]
    if shape.kind == "train":
        out.append((opt, joptim.optimizer_state_specs(cfg.optimizer, params,
                                                      ps)))
        (b,) = jshapes.input_specs(cfg, shape)
        out.append((b, jshapes.batch_logical_names(cfg, train=True)))
    elif shape.kind == "prefill":
        (b,) = jshapes.input_specs(cfg, shape)
        out.append((b, jshapes.batch_logical_names(cfg, train=False)))
    else:
        cache, tok = jshapes.input_specs(cfg, shape)
        out += [(cache, jtf.cache_specs(cfg)), (tok, ("batch", None))]
    return out


def _port_args(arch, shape_name):
    if arch == DW.name:
        V, D, K, B = DW.n_nodes, DW.dim, DW.n_neg, DW.global_batch
        m = lambda *s, dt=torch.float32: torch.empty(  # noqa: E731
            s, dtype=dt, device="meta")
        p = {"emb_in": m(V, D), "emb_out": m(V, D)}
        ps = {"emb_in": ("vocab", None), "emb_out": ("vocab", None)}
        o = optim.make_optimizer("adam", 0.025).init(p)
        b = {"centers": m(B, dt=torch.int32),
             "contexts": m(B, dt=torch.int32),
             "negatives": m(B, K, dt=torch.int32)}
        bs = {"centers": ("batch",), "contexts": ("batch",),
              "negatives": ("batch", None)}
        return [(p, ps), (o, optim.adam_state_specs(ps)), (b, bs)]
    cfg = get_config(arch)
    shape = shapes.SHAPES[shape_name]
    params, opt = _port_meta(arch)
    ps = tf.model_specs(cfg)
    out = [(params, ps)]
    if shape.kind == "train":
        out.append((opt, optim.optimizer_state_specs(cfg.optimizer, params,
                                                     ps)))
        (b,) = shapes.input_specs(cfg, shape)
        out.append((b, shapes.batch_logical_names(cfg, train=True)))
    elif shape.kind == "prefill":
        (b,) = shapes.input_specs(cfg, shape)
        out.append((b, shapes.batch_logical_names(cfg, train=False)))
    else:
        cache, tok = shapes.input_specs(cfg, shape)
        out += [(cache, tf.cache_specs(cfg)), (tok, ("batch", None))]
    return out


def _jax_leaves(avals, names):
    flat, tdef = jax.tree.flatten(avals)
    return list(zip(flat, tdef.flatten_up_to(names)))


def _cells():
    out = []
    for mesh in MESHES:
        for arch in sorted(REGISTRY) + [DW.name]:
            out.append((arch, mesh))
    return out


@pytest.mark.parametrize("arch,mesh", _cells())
def test_layout_parity_every_cell(arch, mesh):
    """Specs, per-device shapes and per-device argument bytes of every
    shape of one arch on one production mesh, exactly as the JAX
    package's."""
    jdr = _jax_dryrun()
    shape_t, axes = MESHES[mesh]
    amesh = AbstractMesh(shape_t, axes)
    pmesh = sh.MeshShape(shape_t, axes)
    model_axis = dict(zip(axes, shape_t))["model"]
    names = ["train_4k"] if arch == DW.name else list(shapes.SHAPES)
    n_cells = 0
    for shape_name in names:
        if arch != DW.name:
            ok, _ = shapes.shape_supported(get_config(arch),
                                           shapes.SHAPES[shape_name])
            if not ok:
                continue
        over = cell_overrides(arch, shape_name, model_axis)
        assert over == jdr.cell_overrides(arch, shape_name, model_axis)
        jbytes = pbytes = 0
        for (javals, jnames), (pvals, pnames) in zip(
                _jax_args(arch, shape_name), _port_args(arch, shape_name)):
            jl = _jax_leaves(javals, jnames)
            pl = list(zip(leaves(pvals), leaves_up_to(pvals, pnames)))
            assert len(jl) == len(pl)
            for (ja, jn), (pa, pn) in zip(jl, pl):
                assert tuple(jn) == tuple(pn)
                if isinstance(pa, int):  # an optimizer count
                    assert ja.shape == () and ja.dtype == np.int32
                    jbytes += 4
                    pbytes += 4
                    continue
                assert tuple(ja.shape) == tuple(pa.shape)
                assert np.dtype(ja.dtype).itemsize == pa.element_size()
                with jsh.sharding_scope(amesh, **over):
                    jspec = jsh.spec_for(ja.shape, jn)
                with sh.sharding_scope(pmesh, **over):
                    pspec = sh.spec_for(pa.shape, pn)
                assert tuple(jspec) == pspec, (shape_name, jn)
                jloc = NamedSharding(amesh, jspec).shard_shape(ja.shape)
                ploc = sh.local_shape(pa.shape, pspec, pmesh)
                assert tuple(jloc) == ploc, (shape_name, jn)
                jbytes += int(np.prod(jloc)) * np.dtype(ja.dtype).itemsize
                pbytes += int(np.prod(ploc)) * pa.element_size()
        assert pbytes == jbytes, shape_name
        n_cells += 1
    assert n_cells == (1 if arch == DW.name else
                       4 - (get_config(arch).family not in ("ssm", "hybrid")))


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_spec_trees_equal_the_jax_package(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert tf.model_specs(cfg) == jtf.model_specs(jcfg)
    assert tf.cache_specs(cfg) == jtf.cache_specs(jcfg)
    for train in (True, False):
        assert shapes.batch_logical_names(cfg, train=train) == \
            jshapes.batch_logical_names(jcfg, train=train)
    params, _ = _port_meta(arch)
    jparams, _ = _jax_avals(arch)
    for name in ("adamw", "adafactor", "sgd"):
        assert _plain(optim.optimizer_state_specs(
            name, params, tf.model_specs(cfg))) == _plain(
            joptim.optimizer_state_specs(name, jparams,
                                         jtf.model_specs(jcfg)))


def test_registries_and_overrides_are_the_jax_package_s():
    from repro.configs import GRAPH_REGISTRY as JGRAPH
    from repro.configs import SHARDING_OVERRIDES as JOVER
    from repro.configs import sharding_overrides as jover
    assert set(REGISTRY) == set(JREGISTRY)
    assert SHARDING_OVERRIDES == JOVER
    for name in list(REGISTRY) + [DW.name, "nope"]:
        assert sharding_overrides(name) == jover(name)
    assert {k: vars(v) for k, v in GRAPH_REGISTRY.items()} == \
        {k: vars(v) for k, v in JGRAPH.items()}
    assert shapes.SHAPES == {k: shapes.ShapeSpec(**vars(v))
                             for k, v in jshapes.SHAPES.items()}
    assert sh.default_rules(False) == jsh.default_rules(False)
    assert sh.default_rules(True) == jsh.default_rules(True)


@pytest.mark.parametrize("arch", ["qwen3-4b", "moonshot-v1-16b-a3b",
                                  "zamba2-7b", "seamless-m4t-large-v2"])
def test_meta_build_has_the_real_build_shapes(arch):
    """A meta build draws nothing and has a real build's leaves: the same
    paths, shapes and dtypes (the reduced preset, real on the CPU)."""
    cfg = get_config(arch).reduced()
    real = tf.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    meta = tf.init_model(cfg, None, device="meta")
    from repro_torch.train.tree import leaf_paths
    r, m = leaf_paths(real), leaf_paths(meta)
    assert [p for p, _ in r] == [p for p, _ in m]
    for (_, a), (_, b) in zip(r, m):
        assert b.is_meta and a.shape == b.shape and a.dtype == b.dtype
    cache = tf.init_cache(cfg, 2, 16, 8, device="cpu")
    mcache = shapes.cache_specs_avals(cfg, 2, 16, 8)
    assert {k: (v.shape, v.dtype) for k, v in cache.items()} == \
        {k: (v.shape, v.dtype) for k, v in mcache.items()}


def test_spec_for_fallback_and_duplicate_axis():
    mesh = sh.MeshShape((2, 16, 16), ("pod", "data", "model"))
    assert sh.spec_for((4, 4), ("batch", "mlp")) == ()  # outside a scope
    with sh.sharding_scope(mesh, vocab=("data", "model")):
        # a dim over two axes; a second dim asking for a used axis loses it
        assert sh.spec_for((512, 32), ("vocab", "mlp")) == (
            ("data", "model"), None)
        assert sh.spec_for((64, 8), ("batch", "heads")) == (
            ("pod", "data"), None)  # 8 heads do not divide 16: replicated
        assert sh.local_shape((64, 8), (("pod", "data"), None), mesh) == (
            2, 8)
    from torch.distributed.tensor import Replicate, Shard
    assert sh.placements_for((("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert sh.placements_for((None,), mesh) == [Replicate()] * 3
    one = sh.MeshShape((1, 4), ("data", "model"))  # one rank splits nothing
    assert sh.placements_for(("data", "model"), one) == [Replicate(),
                                                         Shard(1)]
    with pytest.raises(ValueError):
        sh.placements_for((("model", "data"),), mesh)


def test_constrain_and_kernels_outside_a_mesh_are_unchanged():
    x = torch.randn(2, 3, 4)
    assert sh.constrain(x, "batch", "seq", "act_embed") is x
    with sh.sharding_scope(sh.MeshShape((2, 2), ("data", "model"))):
        assert sh.constrain(x, "batch", "seq", "act_embed") is x
    from repro_torch.kernels import ops
    q = torch.randn(2, 4, 16)
    k = torch.randn(2, 8, 2, 16)
    lens = torch.tensor([3, 8])
    assert torch.equal(ops.decode_attention(q, k, k, lens),
                       ops.decode_attention(q, k, k, lens, impl="ref"))


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_family_sharded_on_2x2_matches(arch, tmp_path):
    check_family(arch, tmp_path)
