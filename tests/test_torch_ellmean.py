"""A plain PyTorch model of the ELL mean's CUDA kernel, step by step.

``csrc/ellmean.cu`` runs only on the card, so its design is modelled here
on the CPU: the scan of a row's ``valid`` bytes in the aligned 16-byte
words that cover it (a row starts at any byte, its stride being L), the
set slots listed in slot order by a prefix count over the lanes, ``idx``
read at those slots only, the units a lane holds by D (``ellmean.
lane_plan``), the gathers of up to 4 rows added in slot order, one pass
over the slots up to the 512-column strip, and each path's summation order
(the warp-per-row kernel's slot order; the row-split kernel's entries dealt
to 8 warps and their partial sums added in warp order). The model is held
to ``ref.ell_mean_ref``, the JAX package's ``ell_mean_ref`` and its Pallas
kernel in interpret mode within 1e-6 (fp32 sums in another order); the
path rule (``ellmean.path_rule``) at its edges. The card tests
(``tests/test_torch_cuda.py``) hold the kernel itself to the plain version
and the library's choices to these.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ellmean, ops, ref

PASS = 32 * 16 * 4 - 16  # slots a warp-per-row pass lists (4 words a lane)
RUN = 256  # slots a row-split warp lists a pass
WARPS = 8
SMS = 132  # an H100's SMs


def list_set_slots(mem, lo, hi, words_a_lane):
    """The scan of bytes ``mem[lo:hi)``: lane ``lane`` loads word
    ``k * 32 + lane`` of the aligned 16-byte words from ``lo - lo % 16``
    (only words that start below ``hi``), masks the bytes outside
    ``[lo, hi)``, counts its set bytes, and writes their offsets from
    ``lo`` at its exclusive prefix count over the lanes (plus the earlier
    loads' totals). Returns the list, which is in slot order."""
    assert hi - lo <= 512 * words_a_lane - 15
    base = lo - lo % 16
    word = base + 16 * torch.arange(words_a_lane * 32).view(-1, 32)
    addr = word[..., None] + torch.arange(16)  # (load k, lane, byte)
    loaded = (word < hi)[..., None].expand_as(addr)
    assert not loaded.any() or int(addr[loaded].max()) < len(mem)
    got = mem[addr.clamp(max=len(mem) - 1)] != 0
    bits = got & loaded & (addr >= lo) & (addr < hi)
    out = torch.full((words_a_lane * 512,), -1, dtype=torch.long)
    n = 0
    for k in range(words_a_lane):
        count = bits[k].sum(1)
        at = n + torch.cumsum(count, 0) - count  # exclusive prefix count
        for lane in range(32):
            for i, b in enumerate(torch.nonzero(bits[k, lane]).flatten()):
                out[at[lane] + i] = addr[k, lane, b] - lo
        n += int(count.sum())
    return out[:n]


def columns(d, w, u):
    """Each strip's columns as the lanes hold them: unit ``c0 + u' * 32 +
    lane``, elements ``W`` a unit; the strip is 32 x U units."""
    du = d // w
    strips = []
    for c0 in range(0, du, 32 * u):
        cols = [(c0 + k * 32 + lane) * w + e for k in range(u)
                for lane in range(32) for e in range(w)
                if c0 + k * 32 + lane < du]
        strips.append(torch.tensor(sorted(cols)))
    return strips


def model(mem, start, l, idx, emb, path, addresses=(0, 0)):
    """The kernel's output (fp32) for the (N, L) ``valid`` rows stored in
    ``mem`` from byte ``start`` (row r from ``start + r * L``), ``idx``
    and ``emb``, on ``path``; ``addresses`` are emb's and out's base
    addresses, which choose the load width."""
    n, d = idx.shape[0], emb.shape[1]
    w, u = ellmean.lane_plan(d, emb.element_size(), *addresses)
    assert d % w == 0
    g = 4 if u * w <= 8 else 2  # rows in flight
    strips = columns(d, w, u)
    assert torch.equal(torch.cat(strips), torch.arange(d))  # once each
    assert len(strips) == 1 or d > 512  # one pass up to the strip limit
    e32 = emb.float()
    out = torch.zeros((n, d))
    for r in range(n):
        rv = start + r * l
        for cols in strips:  # a strip scans the row again
            if path == "warp-per-row":
                acc, cnt = torch.zeros(len(cols)), 0
                for j0 in range(0, l, PASS):
                    slots = j0 + list_set_slots(mem, rv + j0,
                                                rv + min(l, j0 + PASS), 4)
                    src = idx[r, slots]  # idx at the set slots only
                    cnt += len(src)
                    for g0 in range(0, len(src), g):  # g rows at once
                        for s in src[g0:g0 + g]:  # added in slot order
                            acc += e32[s, cols]
                out[r, cols] = acc / max(cnt, 1)
            else:
                part = torch.zeros((WARPS, len(cols)))
                total = 0
                for p0 in range(0, l, WARPS * RUN):
                    lists = []
                    for wp in range(WARPS):
                        j0 = p0 + wp * RUN
                        j1 = min(l, j0 + RUN)
                        if j0 >= l:
                            continue
                        if path == "row-split":  # valid first, then idx
                            slots = j0 + list_set_slots(mem, rv + j0,
                                                        rv + j1, 1)
                        else:  # idx with valid at every slot: the set
                            # bytes of each 32-slot group in lane order
                            slots = j0 + torch.nonzero(
                                mem[rv + j0:rv + j1] != 0).flatten()
                        lists.append(idx[r, slots])
                    src = torch.cat(lists)  # warp order: slot order
                    for e in range(len(src)):  # entry e to warp e % 8
                        part[e % WARPS] += e32[src[e], cols]
                    total += len(src)
                acc = torch.zeros(len(cols))
                for wp in range(WARPS):  # partial sums in warp order
                    acc += part[wp]
                out[r, cols] = acc / max(total, 1)
    return out


def _inputs(n, l, m, d, start, seed, p=0.3):
    """Rows of ``valid`` stored in a byte buffer from ``start`` with a word
    of slack after them: row 0 empty; row 1 every slot valid where L <= 17,
    else a third of them (an fp32 sum of 1,082 terms, in any fixed order,
    drifts ~1.5e-6 from the exact mean: the card tests hold full rows of
    1,082 to 1e-5); the rest ``p`` of their slots."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, m, (n, l)).astype(np.int32)
    valid = rng.random((n, l)) < p
    valid[0] = False
    valid[1] = True if l <= 17 else rng.random(l) < 1 / 3
    emb = rng.standard_normal((m, d)).astype(np.float32)
    mem = torch.zeros(start + n * l + 16, dtype=torch.uint8)
    mem[start:start + n * l] = torch.from_numpy(valid.reshape(-1)).byte()
    return idx, valid, emb, mem


# (N, L, D, the first row's byte offset, the share of valid slots)
CASES = [(5, 1, 1, 0, 0.5), (5, 15, 2, 3, 0.3), (5, 17, 3, 13, 0.3),
         (4, 1082, 150, 7, 0.004), (4, 17, 256, 1, 0.3),
         (4, 15, 300, 0, 0.3), (3, 17, 600, 9, 0.3),
         (3, 1082, 600, 4, 0.01)]


@pytest.mark.parametrize("n,l,d,start,p", CASES)
@pytest.mark.parametrize("path", ellmean.PATHS)
def test_kernel_model_matches_plain_and_jax(n, l, d, start, p, path):
    idx, valid, emb, mem = _inputs(n, l, 40, d, start, n + l + d, p)
    got = model(mem, start, l, torch.from_numpy(idx), torch.from_numpy(emb),
                path)
    assert not got[0].any()  # the empty row is 0
    want = ref.ell_mean_ref(torch.from_numpy(idx), torch.from_numpy(valid),
                            torch.from_numpy(emb))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    jax_want = jref.ell_mean_ref(jnp.asarray(idx), jnp.asarray(valid),
                                 jnp.asarray(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_want),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,l,d,start,p", [CASES[1], CASES[3], CASES[6]])
def test_kernel_model_matches_pallas_interpret(n, l, d, start, p):
    """The warp-per-row model adds each column in slot order from 0, as the
    Pallas kernel adds its left-packed entries."""
    idx, valid, emb, mem = _inputs(n, l, 40, d, start, n + l + d, p)
    want = jops.ell_mean(jnp.asarray(idx), jnp.asarray(valid),
                         jnp.asarray(emb), impl="pallas_interpret")
    got = model(mem, start, l, torch.from_numpy(idx), torch.from_numpy(emb),
                "warp-per-row")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("start", [0, 1, 7, 15])
def test_scan_lists_set_slots_in_order(start):
    """The word-covering scan of a row at any byte offset lists exactly its
    set slots, in slot order, none of its neighbours' (which are set)."""
    rng = np.random.default_rng(start)
    l = 1082
    row = rng.random(l) < 0.05
    row[[0, l - 1]] = True
    mem = torch.ones(start + l + 32, dtype=torch.uint8)  # neighbours set
    mem[start:start + l] = torch.from_numpy(row).byte()
    got = list_set_slots(mem, start, start + l, 4)
    assert torch.equal(got, torch.from_numpy(np.flatnonzero(row)))
    runs = [j0 + list_set_slots(mem, start + j0, start + min(l, j0 + RUN), 1)
            for j0 in range(0, l, RUN)]
    assert torch.equal(torch.cat(runs), got)


@pytest.mark.parametrize("d,es,addresses,plan", [
    (1, 4, (0, 0), (1, 1)), (2, 4, (0, 0), (2, 1)), (3, 4, (0, 0), (1, 1)),
    (128, 4, (0, 0), (4, 1)), (150, 4, (0, 0), (2, 3)),
    (150, 4, (600, 0), (2, 3)),  # an odd row of D = 150: 8-byte aligned
    (128, 4, (4, 0), (1, 4)),  # emb off its 16 bytes: one element a load
    (6, 4, (24, 0), (2, 1)), (256, 4, (0, 0), (4, 2)),
    (300, 4, (0, 0), (4, 3)), (512, 4, (0, 0), (4, 4)),
    (511, 4, (0, 0), (1, 16)), (600, 4, (0, 0), (4, 4)),  # two strips
    (8, 2, (0, 0), (8, 1)), (8, 2, (16, 2), (1, 1)), (150, 2, (0, 0), (1, 8)),
    (512, 2, (0, 0), (8, 2))])
def test_lane_plan(d, es, addresses, plan):
    """The widest load the addresses and the row stride allow, and the
    fewest units a lane that cover a row in one 512-column strip."""
    assert ellmean.lane_plan(d, es, *addresses) == plan


def test_path_rule_edges():
    """The row-split kernel below 8 x SMs rows of at least 256 slots (the
    flush's N = 64 and the propagation's shells of up to 1,055 rows), and
    there the scan that reads ``idx`` with ``valid`` up to 2^18 slots (the
    flush); the warp-per-row kernel from 1,056 rows (shell 2's 10,474) and
    for short rows (the large shape's L = 32)."""
    warp, split, with_idx = ellmean.PATHS
    rule = ellmean.path_rule
    assert rule(64, 1766, SMS) == with_idx and rule(922, 1082, SMS) == split
    assert rule(8 * SMS - 8, 256, SMS) == split
    assert rule(1, 256, SMS) == with_idx
    assert rule(1024, 256, SMS) == with_idx == rule(1, 1 << 18, SMS)
    assert rule(1025, 256, SMS) == split == rule(1, (1 << 18) + 1, SMS)
    for n, l in ((8 * SMS - 7, 256), (8 * SMS, 1082), (10474, 1082),
                 (1 << 18, 32), (64, 255), (0, 1082)):
        assert rule(n, l, SMS) == warp, (n, l)


def test_ops_ell_mean_on_the_cpu_is_the_plain_version():
    """On CPU tensors the entry point is the plain version, whatever the
    kernel's paths: the model's inputs give the plain version's bits."""
    idx, valid, emb, _ = _inputs(6, 17, 40, 150, 0, 3)
    args = (torch.from_numpy(idx), torch.from_numpy(valid),
            torch.from_numpy(emb))
    assert torch.equal(ops.ell_mean(*args), ref.ell_mean_ref(*args))
