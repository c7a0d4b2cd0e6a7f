"""The port's SGNS loss, gradients, autograd wiring and train step against
the JAX package's, on the same numpy inputs.

Tolerances: the loss 1e-6 in fp32 (fp32 dots summed in another order) and
2e-2 in bf16 (as ``tests/kernels/test_sgns.py``); gradients 1e-6 absolute
(they are O(1e-2) here) with 1e-5 relative; a train step's loss, both
gradient tables and the parameters after Adam 1e-6. The CUDA kernels run
only on the card (``tests/test_torch_cuda.py``); here the autograd
``Function`` is wired to the plain callables, which checks the same
plumbing: the saved inputs, the stride-0 ``dout`` of a ``.mean()`` and the
gradient dtypes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import corewalk as jcorewalk
from repro.graph import datasets as jdatasets
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.skipgram import corpus as jcorpus
from repro.skipgram import model as jmodel
from repro.train import optim as joptim
from repro_torch.kernels import ops, ref, sgns
from repro_torch.skipgram import model
from repro_torch.skipgram.trainer import loss_and_grads
from repro_torch.train import optim

SHAPES = [(8, 128, 5), (32, 128, 1), (64, 256, 8), (16, 150, 5),
          (256, 128, 20)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(b, d, k, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.3).astype(np.float32)
            for s in ((b, d), (b, d), (b, k, d))]


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("b,d,k", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sgns_loss_matches_jax(b, d, k, dtype):
    j_in, t_in = _both(_inputs(b, d, k), dtype)
    tol = DTYPES[dtype][2]
    got = ops.sgns_loss(*t_in)  # auto on CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == (b,)
    for want in (jref.sgns_loss_ref(*j_in),
                 jops.sgns_loss(*j_in, impl="pallas_interpret")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("b,d,k", [(8, 128, 5), (16, 150, 3), (7, 1, 15)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sgns_grads_match_jax_and_autograd(b, d, k, dtype):
    arrays = _inputs(b, d, k, seed=1)
    dout = np.random.default_rng(2).standard_normal(b).astype(np.float32)
    j_in, t_in = _both(arrays, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    got = ref.sgns_grads_ref(*t_in, torch.from_numpy(dout))
    want = jref.sgns_grads_ref(*j_in, jnp.asarray(dout))
    leaves = [t.clone().requires_grad_() for t in t_in]
    ref.sgns_loss_ref(*leaves).backward(torch.from_numpy(dout))
    for g, w, leaf, t in zip(got, want, leaves, t_in):
        assert g.dtype == t.dtype and g.shape == t.shape
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=tol, atol=tol / 10)
        np.testing.assert_allclose(g.float().numpy(),
                                   leaf.grad.float().numpy(),
                                   rtol=tol, atol=tol / 10)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sgns_function_wired_to_the_plain_callables(dtype):
    """``SGNSLoss`` (the wiring the CUDA path uses) with the plain fwd/bwd:
    the backward of ``.mean()`` gets a contiguous fp32 dout, and the
    gradients match autograd of the plain loss in the inputs' dtype."""
    _, t_in = _both(_inputs(9, 150, 5, seed=3), dtype)
    seen = []

    def bwd(c, x, n, dout):
        seen.append((dout.dtype, dout.is_contiguous(), dout.stride()))
        return ref.sgns_grads_ref(c, x, n, dout)

    leaves = [t.clone().requires_grad_() for t in t_in]
    loss = ops.SGNSLoss.apply(*leaves, ref.sgns_loss_ref, bwd)
    loss.mean().backward()
    assert seen == [(torch.float32, True, (1,))]
    plain = [t.clone().requires_grad_() for t in t_in]
    ref.sgns_loss_ref(*plain).mean().backward()
    tol = DTYPES[dtype][2]
    for a, b in zip(leaves, plain):
        assert a.grad.dtype == a.dtype
        torch.testing.assert_close(a.grad.float(), b.grad.float(), rtol=tol,
                                   atol=tol / 100)
    torch.testing.assert_close(loss, ref.sgns_loss_ref(*t_in))


def test_sgns_cuda_impl_refuses_cpu_tensors():
    _, t_in = _both(_inputs(4, 8, 2), "float32")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.sgns_loss(*t_in, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        sgns.sgns_bwd_cuda(*t_in, torch.ones(4))
    with pytest.raises(ValueError, match="unknown impl"):
        ops.sgns_loss(*t_in, impl="pallas")


@pytest.fixture(scope="module")
def jax_corpus():
    g = jdatasets.load("tiny")
    plan = jcorewalk.deepwalk_plan(g.n_nodes, 4)
    return jcorpus.build_corpus(g.to_ell(), plan, 12, jax.random.PRNGKey(0))


@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax(jax_corpus, steps):
    """Train steps from JAX ``init_params`` on ids from JAX ``_sample``.

    Each step starts from the JAX parameters and Adam state, carried across
    by ``from_jax_params``, and checks: the loss and both gradient tables;
    Adam applied to the JAX gradients (the optimizer alone: parameters and
    moments); and the port's whole step on its own gradients. Adam's
    ``g / (sqrt(v) + eps)`` amplifies a gradient difference near eps (an
    entry whose sum cancels to 1e-9 moves by up to lr * 1e-3 when the two
    sums differ only in their order), so that last check covers the entries
    with ``sqrt(v_hat) > 100 eps`` and each step restarts from the JAX state.
    """
    dim, batch, window, n_neg, lr = 16, 96, 4, 5, 0.025
    c = jax_corpus
    jparams = jmodel.init_params(c.n_nodes, dim, jax.random.PRNGKey(1))
    jopt, topt = joptim.adam(lr), optim.adam(lr)
    jstate = jopt.init(jparams)
    for s in range(steps):
        tparams, tstate = model.from_jax_params(
            jax.tree.map(np.asarray, jparams),
            jax.tree.map(np.asarray, jstate), device="cpu")
        assert tstate.count == s
        ids = jcorpus._sample(c.walks, c.noise_cdf, jax.random.PRNGKey(10 + s),
                              batch, window, n_neg, c.length, c.n_real)
        jloss, jgrads = jax.value_and_grad(jmodel.batch_loss)(
            jparams, *ids, "ref")
        upd, jstate = jopt.update(jgrads, jstate, jparams)
        jparams = joptim.apply_updates(jparams, upd)
        tloss, tgrads = loss_and_grads(
            tparams, *(torch.tensor(np.asarray(i)).long() for i in ids))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6,
                                   atol=1e-6)
        from_j = {k: torch.tensor(np.asarray(g)) for k, g in jgrads.items()}
        upd_j, state_j = topt.update(from_j, tstate, tparams)
        after_j = optim.apply_updates(tparams, upd_j)
        upd_t, state_t = topt.update(tgrads, tstate, tparams)
        after_t = optim.apply_updates(tparams, upd_t)
        c2 = 1 - 0.999 ** (s + 1)
        for k in ("emb_in", "emb_out"):
            want = np.asarray(jparams[k])
            np.testing.assert_allclose(tgrads[k].numpy(),
                                       np.asarray(jgrads[k]), rtol=1e-6,
                                       atol=1e-6)
            np.testing.assert_allclose(after_j[k].numpy(), want, rtol=1e-6,
                                       atol=1e-6)
            for mine, theirs in ((state_j.mu, jstate[0].mu),
                                 (state_j.nu, jstate[0].nu)):
                np.testing.assert_allclose(mine[k].numpy(),
                                           np.asarray(theirs[k]), rtol=1e-6,
                                           atol=1e-12)
            ok = np.sqrt(state_t.nu[k].numpy() / c2) > 1e-6
            assert ok.any() or (s == 0 and k == "emb_in")  # emb_out is 0
            np.testing.assert_allclose(after_t[k].numpy()[ok], want[ok],
                                       rtol=1e-6, atol=1e-6)
    assert float(jnp.abs(jgrads["emb_in"]).max()) > 0 or steps == 1


# ------------------------------------------- the backward kernel's algorithm


def _fma(a, b, c):
    """fp32 fused multiply-add: the product is exact in fp64, one rounding
    (up to a rare double rounding, well inside the tolerances)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _sigmoid(z):
    return (np.float32(1) / (np.float32(1) + np.exp(-z))).astype(np.float32)


def bwd_plan(d):
    """What ``csrc/sgns.cu`` launches for fp32 rows of width d <= 1024 on
    16-byte aligned tensors: V elements a vector (4, else 2, else 1), the
    smallest lane group G in {8, 16, 32} at which a lane holds at most 12
    elements, else G = 32 with up to 32; returns (V, G, vectors a lane)."""
    v = 4 if d % 4 == 0 else 2 if d % 2 == 0 else 1
    nvec = d // v
    for g in (8, 16, 32):
        if -(-nvec // g) * v <= 12:
            return v, g, 12 // v
    return v, 32, 32 // v


def model_sgns_bwd(c, x, n, dout, chunk=2):
    """The backward kernel step for step, fp32, one example per lane group:
    lane l holds the vectors l, l + G, ... of each row (zeros past D), its
    partial dots run over its vectors in order, a butterfly over the G
    lanes sums them; dx = dpos c and dc = dpos x; the negatives come
    ``chunk`` rows at a time (a tail when K % chunk != 0), their dots reduced
    together, then for q in order dn_q = dneg_q c and dc += dneg_q n_q,
    compensated (Kahan)."""
    b, k, d = n.shape
    v, g, per_lane = bwd_plan(d)
    vec = np.arange(g)[:, None] + g * np.arange(per_lane)[None, :]
    live = vec < d // v  # (G, vectors)
    idx = (vec[..., None] * v + np.arange(v)).clip(max=d - 1)  # (G, I, V)
    live = np.broadcast_to(live[..., None], idx.shape)

    def lanes(rows):  # (..., D) -> (..., G, I, V), zeros past D
        return np.where(live, rows[..., idx], np.float32(0))

    def dot(a, bb):  # the lanes' partial sums, then the butterfly
        s = np.zeros(a.shape[:-3] + (g,), np.float32)
        for i in range(per_lane):
            for e in range(v):
                s = _fma(a[..., i, e], bb[..., i, e], s)
        o = g // 2
        while o:
            s = (s + s[..., np.arange(g) ^ o]).astype(np.float32)
            o //= 2
        assert (s == s[..., :1]).all()  # every lane holds the same sum
        return s[..., :1, None, None]

    cl, xl = lanes(c), lanes(x)
    gd = dout.astype(np.float32)[:, None, None, None]
    dpos = ((_sigmoid(dot(cl, xl)) - np.float32(1)) * gd).astype(np.float32)
    dxl = (dpos * cl).astype(np.float32)
    acc = (dpos * xl).astype(np.float32)
    err = np.zeros_like(acc)
    dnl = np.zeros((b, k) + cl.shape[1:], np.float32)
    for q0 in range(0, k, chunk):
        qs = range(q0, min(q0 + chunk, k))
        rows = [lanes(n[:, q]) for q in qs]
        sums = [dot(r, cl) for r in rows]
        for q, r, s in zip(qs, rows, sums):
            w = (_sigmoid(s) * gd).astype(np.float32)
            dnl[:, q] = (w * cl).astype(np.float32)
            y = _fma(w, r, -err)
            t = (acc + y).astype(np.float32)
            err = ((t - acc) - y).astype(np.float32)
            acc = t

    def rows_of(lanes_arr):  # (..., G, I, V) -> (..., D)
        out = np.zeros(lanes_arr.shape[:-3] + (d,), np.float32)
        out[..., idx[live]] = lanes_arr[..., live]
        return out

    return rows_of(acc), rows_of(dxl), rows_of(dnl)


@pytest.mark.parametrize("d", [1, 7, 150, 256])
@pytest.mark.parametrize("k", [1, 5, 13, 2048])
def test_sgns_bwd_kernel_model_matches_plain_and_jax(d, k):
    """The model of the backward kernel against ``ref.sgns_grads_ref`` and
    the JAX package's ``sgns_grads_ref``, fp32, within 1e-5 (rtol and atol:
    the logits' sums run in another order). At K = 2,048 |dc| reaches about
    80; the model's compensated sum is within 1e-7 x that of an fp64 sum,
    the plain versions' fp32 sums within 1e-6 x, inside the rtol."""
    b = 3 if k == 2048 else 11
    c, x, n = _inputs(b, d, k, seed=d + k)
    dout = np.random.default_rng(k).standard_normal(b).astype(np.float32)
    got = model_sgns_bwd(c, x, n, dout)
    want_t = ref.sgns_grads_ref(*(torch.from_numpy(a) for a in (c, x, n)),
                                torch.from_numpy(dout))
    want_j = jref.sgns_grads_ref(*(jnp.asarray(a) for a in (c, x, n)),
                                 jnp.asarray(dout))
    for g, wt, wj in zip(got, want_t, want_j):
        np.testing.assert_allclose(g, wt.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g, np.asarray(wj), rtol=1e-5, atol=1e-5)


def test_sgns_bwd_plan_lane_groups():
    """The lane-group rule at the widths the smoke and the tests use."""
    assert bwd_plan(150) == (2, 16, 6)  # 10 elements a lane, 2 examples
    assert bwd_plan(256) == (4, 32, 3)  # 8 elements a lane
    assert bwd_plan(7) == (1, 8, 12)
    assert bwd_plan(1) == (1, 8, 12)
    assert bwd_plan(1024) == (4, 32, 8)  # 32 elements a lane


def test_sgns_loss_takes_2048_negatives_like_jax():
    """``ops.sgns_loss`` (the plain version on CPU tensors) at K = 2,048
    against the JAX package's Pallas kernels in interpret mode: the loss
    within 1e-5 relative (2,049 softplus terms summed in another order),
    the gradients of sum(loss * dout) within 1e-5."""
    b, d, k = 4, 16, 2048
    arrays = _inputs(b, d, k, seed=9)
    dout = np.random.default_rng(9).standard_normal(b).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    loss = ops.sgns_loss(*leaves)
    (loss * torch.from_numpy(dout)).sum().backward()

    def jloss(*a):
        return jnp.sum(jops.sgns_loss(*a, impl="pallas_interpret")
                       * jnp.asarray(dout))

    j_in = [jnp.asarray(a) for a in arrays]
    want = jops.sgns_loss(*j_in, impl="pallas_interpret")
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    for leaf, wg in zip(leaves, jax.grad(jloss, argnums=(0, 1, 2))(*j_in)):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(wg),
                                   rtol=1e-5, atol=1e-5)
