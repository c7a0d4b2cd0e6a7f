"""The sharded-equals-unsharded check of one LM family, shared by the
port's mesh tests: the same numpy parameters and batch go through the JAX
package (jitted on the CPU), the unsharded port, and the port on a gloo
mesh of CPU ranks (``torch_mesh_workers.family_worker``). Held, after
``full_tensor()``: the loss, every gradient of ``loss_fn``, the prefill's
logits and cache, ``NEW`` greedy decode steps' logits and the final cache.

Tolerances. Sharded against unsharded: fp32 ``rtol=1e-5, atol=1e-5``
everywhere (a reduction split across ranks sums in another order, so not
bitwise); ints equal. Against the JAX package: the loss, logits and caches
at the same 1e-5, the gradients at 1e-4 x their leaf's largest magnitude,
as the port's single-device parity tests hold them (XLA fuses the
backward's sums in another order).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtf
from repro.models.steps import loss_fn as jloss_fn
from repro.models.steps import make_decode_step as jmake_decode_step
from repro.models.steps import make_prefill_step as jmake_prefill_step
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import cell_overrides
from repro_torch.models import transformer
from torch_mesh_workers import (NEW, S, batch_for, families_worker,
                                family_worker, run_port, serve_batch, spawn)

TOL = 1e-5


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _close(got, want, msg, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=msg)


def _check_cache(got, want, msg):
    assert set(got) == set(want), msg
    for key in want:
        w = np.asarray(want[key])
        if w.dtype in (np.int8, np.int32, np.int64):
            np.testing.assert_array_equal(np.asarray(got[key]), w,
                                          err_msg=f"{msg} {key}")
        else:
            _close(got[key], w, f"{msg} {key}")


def _run_jax(jcfg, jparams, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.value_and_grad(
        lambda p: jloss_fn(p, jb, jcfg), has_aux=True)(jparams)
    logits, cache = jax.jit(jmake_prefill_step(
        jcfg, max_len=batch["tokens"].shape[1] + NEW))(
        jparams, serve_batch(jb))
    out = {"loss": loss, "grads": jax.tree.leaves(grads), "prefill": logits,
           "prefill_cache": jax.tree.map(np.asarray, cache)}
    decode = jax.jit(jmake_decode_step(jcfg))
    steps = []
    for _ in range(NEW):
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        logits, cache = decode(jparams, cache, tok)
        steps.append(logits)
    out["decode"], out["cache"] = steps, cache
    return out


def _reduced(config, changes):
    """``config.reduced()`` with ``changes``; a dict changes the fields of
    that sub-config (``{"moe": {"group_size": 16}}``), each package's
    own."""
    cfg = config.reduced()
    return dataclasses.replace(cfg, **{
        k: dataclasses.replace(getattr(cfg, k), **v) if isinstance(v, dict)
        else v for k, v in changes.items()})


def check_family(arch, tmp_path, mesh_shape=(2, 2), timeout=150.0,
                 serve_overrides=None, worker=family_worker, seq=S,
                 reduced=None):
    """The port's ``arch`` (the reduced preset, with ``reduced``'s changes
    in both packages: ``_reduced``) on a ``mesh_shape`` (data, model) gloo
    mesh against itself unsharded and against the JAX package, on ``seq``
    tokens a row: training under the dry run's train-cell rules, prefill
    and decode under its decode-cell rules (or ``serve_overrides``), each
    rank running ``worker`` (``family_worker`` or one that wraps it).
    Returns the sharded run's results."""
    return check_families((arch,), tmp_path, mesh_shape, timeout,
                          serve_overrides, worker, seq,
                          {arch: reduced or {}})[0]


def check_families(archs, tmp_path, mesh_shape=(2, 2), timeout=150.0,
                   serve_overrides=None, worker=family_worker, seq=S,
                   reduced=None):
    """``check_family`` of each of ``archs`` (``reduced``: {arch: its
    changes}), their sharded runs in one spawn of the ranks, one after
    another."""
    model = mesh_shape[1]
    cases, runs = [], []
    for arch in archs:
        changes = (reduced or {}).get(arch, {})
        jcfg = _reduced(jget_config(arch), changes)
        cfg = _reduced(get_config(arch), changes)
        jparams = jtf.init_model(jax.random.PRNGKey(0), jcfg)
        params = transformer.from_jax_params(
            jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        batch = batch_for(cfg, S=seq)
        path = str(tmp_path / f"{arch}.pt")
        torch.save({"cfg": cfg, "params": params, "batch": {
            k: torch.from_numpy(v) for k, v in batch.items()}}, path)
        cases.append((arch, jcfg, jparams, cfg, params, batch, path))
        runs.append((path, cell_overrides(arch, "train_4k", model),
                     serve_overrides or cell_overrides(arch, "decode_32k",
                                                       model)))
    spawn(families_worker, mesh_shape[0] * mesh_shape[1], mesh_shape, runs,
          worker, timeout=timeout)
    return [_check(arch, torch.load(path + ".out", weights_only=False),
                   run_port(cfg, params, batch),
                   _run_jax(jcfg, jparams, batch))
            for arch, jcfg, jparams, cfg, params, batch, path in cases]


def _check(arch, got, ref, want):
    """The sharded run's results ``got`` against the unsharded port's
    ``ref`` and the JAX package's ``want``; returns ``got``."""
    _close(got["loss"], ref["loss"], f"{arch} loss")
    _close(got["loss"], want["loss"], f"{arch} loss vs jax")
    assert len(got["grads"]) == len(ref["grads"]) == len(want["grads"])
    for i, (g, r, w) in enumerate(zip(got["grads"], ref["grads"],
                                      want["grads"])):
        _close(g, r, f"{arch} grad {i}")
        w = np.asarray(w)
        np.testing.assert_allclose(
            _np(g), w, rtol=1e-4, atol=1e-4 * max(1.0, np.abs(w).max()),
            err_msg=f"{arch} grad {i} vs jax")
    for name in ("prefill",):
        _close(got[name], ref[name], f"{arch} {name}")
        _close(got[name], want[name], f"{arch} {name} vs jax")
    _check_cache(got["prefill_cache"], ref["prefill_cache"],
                 f"{arch} prefill cache")
    _check_cache(got["prefill_cache"], want["prefill_cache"],
                 f"{arch} prefill cache vs jax")
    for i, (g, r, w) in enumerate(zip(got["decode"], ref["decode"],
                                      want["decode"])):
        _close(g, r, f"{arch} decode {i}")
        _close(g, w, f"{arch} decode {i} vs jax")
    _check_cache(got["cache"], ref["cache"], f"{arch} cache")
    _check_cache(got["cache"], want["cache"], f"{arch} cache vs jax")
    return got
