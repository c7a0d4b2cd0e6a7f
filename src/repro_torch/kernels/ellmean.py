"""ELL neighbour mean: the wrapper of the CUDA kernel ``csrc/ellmean.cu``.

The Hopper counterpart of the Pallas kernel ``ell_mean_pallas``
(``src/repro/kernels/ellmean.py:79``): ``out[i] = mean(emb[idx[i, j]] for
valid j)``, empty rows 0, fp32 accumulation, output in emb's dtype, the
(N, L, D) gather never materialised. The kernel reads ``idx``/``valid``
directly, so unlike the TPU path there is no left-pack.

It is bound by memory: the bytes the inputs need (``cost.ell_mean``) are
``valid`` whole, ``idx`` at the valid slots only, each distinct gathered
row once and the output. So a warp scans ``valid`` in aligned 16-byte
words, lists the set slots in slot order and reads ``idx`` there only,
and gathers with the widest load that the addresses and the row stride
allow (:func:`lane_plan`), up to 4 rows in flight, in one pass over a
row's slots up to 512 columns. Many rows take a warp per row; few long
rows (fewer than 8 an SM, at least 256 slots) a block per row, which
reads ``idx`` with ``valid`` at every slot where the whole table is small
(at most 2^18 slots: one dependent read fewer). :func:`path_rule` is the
source's rule, measured on an H100 in the source's header;
:func:`path_of` asks the library. Every path keeps the kernel's
summation order, so fp32 outputs keep their bits. The plain version is
``ref.ell_mean_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, cost

__all__ = ["ell_mean_cuda", "row_split", "path_of", "path_rule", "lane_plan",
           "units", "launches", "warp_launches", "split_launches", "PATHS",
           "LANE_UNITS", "LANE_FLOATS"]

launches = 0  # kernel launches since the last reset (a plain count)
warp_launches = 0  # of them, the warp-per-row kernel's
split_launches = 0  # and the row-split kernel's (either scan)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the source's paths, by their codes: a warp per row; a block per row,
# scanning valid first or reading idx with valid at every slot
PATHS = ("warp-per-row", "row-split", "row-split-idx")
WARPS = 8  # warps a block: rows of the warp-per-row kernel
WITH_IDX_SLOTS = 1 << 18  # the row-split kernel reads idx with valid below
LANE_FLOATS = 16  # fp32 sums a lane holds: strips of 32 x 16 columns
LANE_UNITS = (1, 2, 3, 4, 8, 16)  # the units a lane may hold (built widths)


def path_rule(n: int, l: int, sms: int) -> str:
    """The source's rule (``path_rule`` in ``csrc/ellmean.cu``): the
    row-split kernel where the warp-per-row kernel would start fewer blocks
    than the card has SMs and a row has at least 8 x 32 slots, reading
    ``idx`` with ``valid`` where the (N, L) table has at most
    ``WITH_IDX_SLOTS`` slots; else a warp per row."""
    if n <= 0 or (n + WARPS - 1) // WARPS >= sms or l < 32 * WARPS:
        return PATHS[0]
    return PATHS[2] if n * l <= WITH_IDX_SLOTS else PATHS[1]


def lane_plan(d: int, element_size: int, *addresses: int):
    """(W, U): the elements a load takes and the units a lane holds for rows
    of ``d`` elements of ``element_size`` bytes (4 fp32, 2 bf16) at these
    base addresses, as the source chooses them (``unit_width``,
    ``lane_units``). W is the widest of 16 bytes (fp32 D % 4, bf16 D % 8),
    8 bytes (fp32 D % 2) or one element that every address and the row
    stride allow; U the fewest of ``LANE_UNITS`` whose 32 lanes cover the
    row in one strip, at most ``LANE_FLOATS / W`` (then strips)."""
    a = 0
    for x in addresses:
        a |= x
    if element_size == 4:
        w = 4 if d % 4 == 0 and a % 16 == 0 else \
            2 if d % 2 == 0 and a % 8 == 0 else 1
    else:
        w = 8 if d % 8 == 0 and a % 16 == 0 else 1
    need, most = -(-(d // w) // 32), LANE_FLOATS // w
    u = next((u for u in LANE_UNITS if need <= u <= most), most)
    return w, u


def _fn():
    lib = build.library("ellmean")
    fn = lib.ell_mean_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, i, i, i, i,
                       ctypes.POINTER(i), i, p]
        fn.restype = ctypes.c_int
    return lib, fn


def path_of(n: int, l: int, device) -> str:
    """The path (one of ``PATHS``) an (N, L) launch on ``device`` (a CUDA
    device) takes, as the library's rule gives it. Launches nothing."""
    lib = build.library("ellmean")
    fn = lib.ell_mean_path
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    path = ctypes.c_int(0)
    build.check(lib, fn(n, l, torch.device(device).index or 0,
                        ctypes.byref(path)), "ell_mean path")
    return PATHS[path.value]


def row_split(n: int, l: int, device) -> bool:
    """Whether an (N, L) launch on ``device`` takes the row-split kernel (a
    block per row) rather than a warp per row. Launches nothing."""
    return path_of(n, l, device) != PATHS[0]


def units(emb: torch.Tensor, out: torch.Tensor):
    """(W, U) as the library chooses them for this ``emb`` and ``out`` (the
    card's twin of :func:`lane_plan`). Launches nothing."""
    lib = build.library("ellmean")
    fn = lib.ell_mean_units
    if fn.argtypes is None:
        i, p = ctypes.c_int, ctypes.c_void_p
        fn.argtypes = [i, i, p, p, ctypes.POINTER(i), ctypes.POINTER(i)]
        fn.restype = ctypes.c_int
    w, u = ctypes.c_int(0), ctypes.c_int(0)
    build.check(lib, fn(emb.shape[1], _DTYPES[emb.dtype], emb.data_ptr(),
                        out.data_ptr(), ctypes.byref(w), ctypes.byref(u)),
                "ell_mean units")
    return w.value, u.value


def ell_mean_cuda(idx: torch.Tensor, valid: torch.Tensor,
                  emb: torch.Tensor, *, path: str | None = None
                  ) -> torch.Tensor:
    """idx: (N, L) int32; valid: (N, L) bool; emb: (M, D) float32/bfloat16,
    all contiguous on one CUDA device -> (N, D) in emb's dtype. Valid
    entries must index rows of ``emb``. ``path``: None for the source's
    rule, or one of ``PATHS`` to force it (measurement and tests)."""
    global launches, warp_launches, split_launches
    build.require(emb, "emb", tuple(_DTYPES), 2)
    build.require(idx, "idx", (torch.int32,), 2, emb.device)
    build.require(valid, "valid", (torch.bool,), 2, emb.device)
    if valid.shape != idx.shape:
        raise ValueError(
            f"valid {tuple(valid.shape)} != idx {tuple(idx.shape)}"
        )
    if path is not None and path not in PATHS:
        raise ValueError(f"path must be None or one of {PATHS}, got {path}")
    n, l = idx.shape
    d = emb.shape[1]
    out = torch.empty((n, d), dtype=emb.dtype, device=emb.device)
    lib, fn = _fn()
    taken = ctypes.c_int(-1)
    code = fn(idx.data_ptr(), valid.data_ptr(), emb.data_ptr(),
              out.data_ptr(), n, l, d, _DTYPES[emb.dtype],
              -1 if path is None else PATHS.index(path),
              ctypes.byref(taken), emb.device.index,
              build.stream_of(emb.device))
    build.check(lib, code, "ell_mean kernel")
    if n and d:  # the C side launches nothing for an empty output
        launches += 1
        if taken.value:
            split_launches += 1
        else:
            warp_launches += 1
        cost.reckon(cost.ell_mean, idx, valid, emb)
    return out
