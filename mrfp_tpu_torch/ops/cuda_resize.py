"""Bilinear and nearest resizes, forward and backward: the CUDA kernels'
wrappers and their plain PyTorch versions.

- ``csrc/resize_bilinear.cu`` replaces mrfp_tpu/ops/pallas_resize.py::
  resize_bilinear_fused (forward) and its custom VJP ``_rb_bwd``. On the TPU
  that kernel serves only the ASPP image-pool broadcast; the decoder and
  logit upsamples take einsum forms chosen for TPU lane padding. The
  function is the same at every site, so on the card these kernels serve
  them all.
- ``csrc/resize_nearest.cu`` replaces ``resize_nearest_fused`` and its
  custom VJP ``_rn_bwd``: every OC-branch stage.

Each function takes the per-axis tables of ``ops.resize`` (``BilinearTaps``
or ``NearestTable``) on the tensor's device: a whole axis, or the band
table of a band of output rows (spatial parallelism), which the kernels
take as any other table; the forward plans are made from the global axis
and the band (``NearestTable.spec``, the bilinear forward's ``spec_y``). A CUDA wrapper launches its
kernel or raises; the plain versions are the reference the tests and
``chip_smoke.py`` hold the kernels against. Every version sums in fp32 and
rounds once to the tensor's dtype.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mrfp_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor, got {t.device}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {t.dtype}")
    if t.dim() != 4 or not t.is_contiguous():
        raise ValueError(f"{what} takes an NCHW-contiguous tensor, got shape "
                         f"{tuple(t.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# --- bilinear -----------------------------------------------------------------

def resize_bilinear_plain(x: torch.Tensor, ty, tx) -> torch.Tensor:
    """Gather + lerp over the tap tables, in fp32, W-mix first then the H
    taps (the kernel's order), rounded once to ``x.dtype``."""
    xf = x.float()
    fx = tx.frac
    xw = xf[..., tx.idx0.long()] * (1 - fx) + xf[..., tx.idx1.long()] * fx
    fy = ty.frac[:, None]
    out = xw[:, :, ty.idx0.long()] * (1 - fy) + xw[:, :, ty.idx1.long()] * fy
    return out.to(x.dtype)


def resize_bilinear_bwd_plain(g: torch.Tensor, ty, tx, h: int, w: int) -> torch.Tensor:
    """The transpose of the forward: fp32 ``index_add_`` of the weighted
    cotangent over the W taps, then over the H taps; rounded once."""
    gf = g.float()
    n, c, oh, _ow = gf.shape
    fx = tx.frac
    gw = gf.new_zeros((n, c, oh, w))
    gw.index_add_(3, tx.idx0.long(), gf * (1 - fx))
    gw.index_add_(3, tx.idx1.long(), gf * fx)
    fy = ty.frac[:, None]
    gx = gf.new_zeros((n, c, h, w))
    gx.index_add_(2, ty.idx0.long(), gw * (1 - fy))
    gx.index_add_(2, ty.idx1.long(), gw * fy)
    return gx.to(g.dtype)


# the banded forward (csrc/resize_bilinear.cu): output elements a block aims
# at, its threads at most, and its shared memory at most (48 KB: no opt-in,
# and four blocks fit an SM)
BILINEAR_FWD_ELEMS = 16384
BILINEAR_FWD_THREADS = 256
BILINEAR_FWD_SMEM_CAP = 48 * 1024


class BilinearFwdPlan(NamedTuple):
    """The banded forward's launch: ``vec`` values a store moves (16 bytes'
    worth, or 1 on the scalar route); ``band`` output rows and ``cols``
    output columns a block takes (a whole row unless one does not fit);
    ``stage_rows`` input rows and ``in_cols`` input columns a block reads at
    most, each row kept raw in ``raw_pitch`` 16-byte granules and W-mixed in
    ``cols`` fp32 values; ``threads`` (along a row, across rows); ``smem``
    bytes."""
    vec: int
    band: int
    stage_rows: int
    cols: int
    in_cols: int
    raw_pitch: int
    threads: Tuple[int, int]
    smem: int


def bilinear_band_span(i0: np.ndarray, i1: np.ndarray, band: int) -> int:
    """The most inputs one block of ``band`` consecutive outputs reads along
    an axis (the blocks tile the outputs from 0): ``i1`` of its last output
    minus ``i0`` of its first, plus one. Both tables are monotone."""
    starts = np.arange(0, i0.size, band)
    ends = np.minimum(starts + band, i0.size) - 1
    return int((i1[ends] - i0[starts]).max()) + 1


def bilinear_fwd_smem_bytes(stage_rows: int, cols: int, raw_pitch: int) -> int:
    """Shared memory of the banded forward: each staged row raw, in 16-byte
    granules, and W-mixed, in fp32 (the kernel checks its launch against
    the same sum)."""
    return stage_rows * (16 * raw_pitch + 4 * cols)


@functools.lru_cache(maxsize=None)
def bilinear_fwd_plan(h: int, w: int, oh: int, ow: int, itemsize: int,
                      aligned: bool, band_y: Optional[Tuple[int, int]] = None
                      ) -> BilinearFwdPlan:
    """Plan the banded forward of an (h, w) -> (oh, ow) resize: the vector
    route for an ``aligned`` output whose rows are whole 16-byte vectors,
    else the scalar route; about ``BILINEAR_FWD_ELEMS`` outputs a band, as
    many rows as keep its shared memory within the budget; column tiles
    (halved until they fit) only where a one-row band of whole rows does
    not fit. With ``band_y = (o0, o1)`` the launch computes those output
    rows of the global (h -> oh) resize, from their band table."""
    # the tables' own rule; resize imports this module, so not at load
    from mrfp_tpu_torch.ops.resize import bilinear_ac_weights, bilinear_band_weights
    if band_y is None:
        iy0, iy1, _ = bilinear_ac_weights(h, oh)
    else:
        iy0, iy1, _ = bilinear_band_weights(h, oh, band_y)
        oh = iy0.size
    ix0, ix1, _ = bilinear_ac_weights(w, ow)

    def layout(band, cols):
        rows, in_cols = bilinear_band_span(iy0, iy1, band), bilinear_band_span(ix0, ix1, cols)
        pitch = (in_cols * itemsize + 15) // 16 + 1  # a segment may start mid-granule
        return rows, in_cols, pitch, bilinear_fwd_smem_bytes(rows, cols, pitch)

    vec = 16 // itemsize
    if ow % vec or not aligned:
        vec = 1
    cap = BILINEAR_FWD_SMEM_CAP
    band = max(1, min(oh, BILINEAR_FWD_ELEMS // ow))
    while band > 1 and layout(band, ow)[3] > cap:
        band -= 1
    cols = ow
    while layout(band, cols)[3] > cap:
        cols //= 2
        if vec > 1:
            cols = cols // vec * vec
            if cols == 0:  # a tile of one vector does not fit: scalar tiles
                vec, cols = 1, 1
    rows, in_cols, pitch, smem = layout(band, cols)
    groups = cols // vec
    tx = -(-groups // -(-groups // BILINEAR_FWD_THREADS))  # the groups split evenly
    ty = max(1, BILINEAR_FWD_THREADS // tx)
    return BilinearFwdPlan(vec, band, rows, cols, in_cols, pitch, (tx, ty), smem)


def resize_bilinear_cuda(x: torch.Tensor, ty, tx, spec_y=None) -> torch.Tensor:
    """Launch the forward kernel on a CUDA tensor; raises if it cannot.
    ``spec_y``: None, or ``(in_full, out_full, (o0, o1))`` when ``ty`` is
    the band table of output rows ``[o0, o1)`` of an ``in_full ->
    out_full`` resize (the plan is made from it)."""
    lib = _build.load_library()
    _check(x, "resize_bilinear_cuda")
    n, c, h, w = x.shape
    if (h, w) != (ty.lo0.numel(), tx.lo0.numel()):
        raise ValueError(f"input {tuple(x.shape)} does not match the tables "
                         f"({ty.lo0.numel()}, {tx.lo0.numel()})")
    oh, ow = ty.idx0.numel(), tx.idx0.numel()
    out = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device)
    in_full, out_full, band_y = (h, oh, None) if spec_y is None else spec_y
    plan = bilinear_fwd_plan(in_full, w, out_full, ow, x.element_size(),
                             out.data_ptr() % 16 == 0, band_y)
    with torch.cuda.device(x.device):
        err = lib.mrfp_resize_bilinear(
            x.data_ptr(), out.data_ptr(), ty.idx0.data_ptr(), ty.idx1.data_ptr(),
            ty.frac.data_ptr(), tx.idx0.data_ptr(), tx.idx1.data_ptr(),
            tx.frac.data_ptr(), n * c, h, w, oh, ow, plan.vec, plan.band, plan.stage_rows,
            plan.cols, plan.in_cols, plan.raw_pitch, *plan.threads, plan.smem,
            _DTYPES[x.dtype], _stream(x))
    _build.check(err, "resize_bilinear")
    _build.LAUNCHES["resize_bilinear"] += 1
    return out


class BilinearBwdPlan(NamedTuple):
    """The backward's launch. ``route``: "sum" (a 1x1 input: a warp sums
    each cotangent plane), "staged" (the banded kernel) or "direct" (not
    even one input row of one column fits: one thread per input element,
    from device memory). On the staged route: ``vec`` cotangent values a
    load (16 bytes' worth where ``ow`` is a whole number of them, else 1),
    ``band`` input rows and ``cols`` input columns a block, at most
    ``in_cols`` cotangent columns a tile reads, ``t_pitch`` fp32 values a
    row of its H-mixed stage, ``smem`` bytes; elsewhere 0."""
    route: str
    vec: int
    band: int
    cols: int
    in_cols: int
    t_pitch: int
    smem: int


def bilinear_bwd_span(lo0: np.ndarray, hi0: np.ndarray, lo1: np.ndarray, hi1: np.ndarray,
                      band: int) -> int:
    """The most outputs one block of ``band`` consecutive inputs reads along
    an axis in the backward: from the lower range start of its first input
    to the higher range end of its last (the ranges ``[lo, hi)`` of each
    tap are monotone)."""
    starts = np.arange(0, lo0.size, band)
    ends = np.minimum(starts + band, lo0.size) - 1
    return int((np.maximum(hi0[ends], hi1[ends])
                - np.minimum(lo0[starts], lo1[starts])).max())


# the staged backward: (input row, cotangent granule) sums a block aims at
# (its shared memory has the forward's cap, kBandSmemCap in the C entry)
BILINEAR_BWD_ITEMS = 768


def bilinear_bwd_pitch(in_cols: int, itemsize: int) -> int:
    """The fp32 values a row of the staged backward's H-mixed stage keeps:
    ``in_cols`` cotangent values from any lead into a 16-byte granule, in
    whole granules' worth (a thread takes one; the kernel checks the
    same)."""
    per_word = 16 // itemsize
    return (in_cols + 2 * per_word - 1) // per_word * per_word


@functools.lru_cache(maxsize=None)
def bilinear_bwd_plan(h: int, w: int, oh: int, ow: int, itemsize: int) -> BilinearBwdPlan:
    """Plan the backward of an (h, w) -> (oh, ow) resize: the plane sum for
    a 1x1 input; else the banded kernel, loading 16 bytes of cotangent at a
    time where its rows are whole 16-byte words (one value at a time
    elsewhere); a block takes whole rows (column tiles, halved until one
    row's stage fits, only for rows too wide) and about
    ``BILINEAR_BWD_ITEMS`` (row, 16 bytes of columns) sums; the direct
    kernel where not even one column fits."""
    if h == 1 and w == 1:
        return BilinearBwdPlan("sum", 0, 0, 0, 0, 0, 0)
    from mrfp_tpu_torch.ops.resize import bilinear_ac_weights, inverse_ranges
    rx = [r for i in bilinear_ac_weights(w, ow)[:2] for r in inverse_ranges(i, w)]
    vec = 16 // itemsize
    if ow % vec:
        vec = 1
    cap = BILINEAR_FWD_SMEM_CAP
    cols = w
    while 4 * bilinear_bwd_pitch(bilinear_bwd_span(*rx, cols), itemsize) > cap:
        cols //= 2
        if cols == 0:
            return BilinearBwdPlan("direct", 0, 0, 0, 0, 0, 0)
    in_cols = bilinear_bwd_span(*rx, cols)
    pitch = bilinear_bwd_pitch(in_cols, itemsize)
    band = max(1, min(h, BILINEAR_BWD_ITEMS * 16 // (pitch * itemsize), cap // (4 * pitch)))
    return BilinearBwdPlan("staged", vec, band, cols, in_cols, pitch, 4 * band * pitch)


_BWD_ROUTES = {"sum": 0, "staged": 1, "direct": 2}


def resize_bilinear_bwd_cuda(g: torch.Tensor, ty, tx, h: int, w: int) -> torch.Tensor:
    """Launch the backward kernel on the contiguous CUDA cotangent ``g``;
    returns the (N, C, h, w) input gradient in ``g``'s dtype."""
    lib = _build.load_library()
    _check(g, "resize_bilinear_bwd_cuda")
    n, c, oh, ow = g.shape
    if (oh, ow) != (ty.idx0.numel(), tx.idx0.numel()):
        raise ValueError(f"cotangent {tuple(g.shape)} does not match the tables "
                         f"({ty.idx0.numel()}, {tx.idx0.numel()})")
    gx = torch.empty((n, c, h, w), dtype=g.dtype, device=g.device)
    plan = bilinear_bwd_plan(h, w, oh, ow, g.element_size())
    with torch.cuda.device(g.device):
        err = lib.mrfp_resize_bilinear_bwd(
            g.data_ptr(), gx.data_ptr(), ty.frac.data_ptr(), ty.lo0.data_ptr(),
            ty.hi0.data_ptr(), ty.lo1.data_ptr(), ty.hi1.data_ptr(),
            tx.frac.data_ptr(), tx.lo0.data_ptr(), tx.hi0.data_ptr(),
            tx.lo1.data_ptr(), tx.hi1.data_ptr(), n * c, h, w, oh, ow,
            _BWD_ROUTES[plan.route], plan.vec, plan.band, plan.cols, plan.in_cols,
            plan.t_pitch, plan.smem, _DTYPES[g.dtype], _stream(g))
    _build.check(err, "resize_bilinear_bwd")
    _build.LAUNCHES["resize_bilinear_bwd"] += 1
    return gx


# --- nearest ------------------------------------------------------------------

def resize_nearest_plain(x: torch.Tensor, ty, tx) -> torch.Tensor:
    """``x[:, :, iy][:, :, :, ix]`` by indexing: a copy, exact in any dtype."""
    return x[:, :, ty.idx.long()][..., tx.idx.long()]


def resize_nearest_bwd_plain(g: torch.Tensor, ty, tx, h: int, w: int) -> torch.Tensor:
    """Sum-scatter of the cotangent: fp32 (fp64 for fp64) ``index_add_``
    over the W table, then the H table; rounded once. An input no output
    reads gets 0."""
    gf = g.to(torch.promote_types(g.dtype, torch.float32))
    n, c, oh, _ow = gf.shape
    gw = gf.new_zeros((n, c, oh, w)).index_add_(3, tx.idx.long(), gf)
    gx = gf.new_zeros((n, c, h, w)).index_add_(2, ty.idx.long(), gw)
    return gx.to(g.dtype)


# the staged nearest forward (csrc/resize_nearest.cu): output elements a
# block aims at, and its shared memory at most (no opt-in)
NEAREST_FWD_ELEMS = 8192
NEAREST_FWD_SMEM_CAP = 48 * 1024


class NearestFwdPlan(NamedTuple):
    """The staged forward's launch: ``band`` output rows a block (0: the
    direct kernel), ``stage_rows`` input rows its stage holds at most,
    ``smem`` bytes."""
    band: int
    stage_rows: int
    smem: int


def nearest_fwd_smem_bytes(ow: int, band: int, stage_rows: int, w: int,
                           itemsize: int) -> int:
    """Shared memory of the staged forward (its ``fwd_layout``, which the
    kernel checks the launch against): the ix table and a band's row
    offsets (ints), ``stage_rows`` input rows and ``band`` output rows, each
    element buffer with one vector of slack, each from a 16-byte boundary."""
    vec = 16 // itemsize
    out = -(-(-(-4 * (ow + band) // 16) * 16 + (stage_rows * w + vec - 1) * itemsize)
            // 16) * 16
    return out + (band * ow + vec - 1) * itemsize


@functools.lru_cache(maxsize=None)
def nearest_fwd_plan(spec_y: tuple, w: int, ow: int, itemsize: int) -> NearestFwdPlan:
    """Plan the staged forward for the H table built from ``spec_y`` (a
    ``NearestTable.spec``), input width ``w`` and output width ``ow``: about
    ``NEAREST_FWD_ELEMS`` outputs a band, as many rows as keep the tables,
    the band's input rows and its outputs within the budget; the direct
    kernel (band 0) where not even one row fits."""
    from mrfp_tpu_torch.ops.resize import nearest_index
    iy = nearest_index(*spec_y)
    if iy.size == 0 or ow == 0:  # nothing to launch
        return NearestFwdPlan(0, 0, 0)
    band = max(1, min(iy.size, NEAREST_FWD_ELEMS // ow))
    while True:
        rows = bilinear_band_span(iy, iy, band)
        smem = nearest_fwd_smem_bytes(ow, band, rows, w, itemsize)
        if smem <= NEAREST_FWD_SMEM_CAP:
            return NearestFwdPlan(band, rows, smem)
        if band == 1:
            return NearestFwdPlan(0, 0, 0)
        band -= 1


def resize_nearest_cuda(x: torch.Tensor, ty, tx) -> torch.Tensor:
    """Launch the nearest forward kernel on a CUDA tensor; raises if it cannot."""
    lib = _build.load_library()
    _check(x, "resize_nearest_cuda")
    n, c, h, w = x.shape
    if (h, w) != (ty.lo.numel(), tx.lo.numel()):
        raise ValueError(f"input {tuple(x.shape)} does not match the tables "
                         f"({ty.lo.numel()}, {tx.lo.numel()})")
    oh, ow = ty.idx.numel(), tx.idx.numel()
    out = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device)
    plan = nearest_fwd_plan(ty.spec, w, ow, x.element_size())
    with torch.cuda.device(x.device):
        err = lib.mrfp_resize_nearest(
            x.data_ptr(), out.data_ptr(), ty.idx.data_ptr(), tx.idx.data_ptr(),
            n * c, h, w, oh, ow, plan.band, plan.stage_rows, plan.smem, _DTYPES[x.dtype],
            _stream(x))
    _build.check(err, "resize_nearest")
    _build.LAUNCHES["resize_nearest"] += 1
    return out


# the staged nearest backward (csrc/resize_nearest.cu): input elements a
# block aims at, and its shared-memory budget in bytes
NEAREST_BWD_ELEMS = 4096
NEAREST_BWD_SMEM_CAP = 96 * 1024


def nearest_bwd_smem_bytes(w: int, rows: int, max_run: int, ow: int, itemsize: int) -> int:
    """Shared memory the staged backward is launched with for ``rows``
    input rows a block: the column and row tables (8 bytes an entry), the
    block's input elements, the staged run of at most ``rows * max_run``
    cotangent rows, and 64 bytes for the alignment of the tables' end and
    the vector of slack each element buffer keeps (at most 56 bytes; the
    kernel checks the sum against its ``bwd_layout``)."""
    return 8 * w + 8 * rows + rows * w * itemsize + rows * max_run * ow * itemsize + 64


def nearest_bwd_rows_per_block(w: int, ow: int, max_run_y: int, max_run_x: int,
                               itemsize: int) -> int:
    """Input rows each block of the staged backward takes: about
    ``NEAREST_BWD_ELEMS`` elements, as many as fit the budget. 0, and the
    shape takes the direct kernel, when a range of either table is longer
    than two (the staged kernel's sums take at most two terms an axis) or
    not even one row fits."""
    if max_run_y > 2 or max_run_x > 2:
        return 0
    want = max(1, NEAREST_BWD_ELEMS // max(w, 1))
    fit = (NEAREST_BWD_SMEM_CAP - nearest_bwd_smem_bytes(w, 0, max_run_y, ow, itemsize)) \
        // (8 + (w + max_run_y * ow) * itemsize)
    return max(0, min(want, fit))


def resize_nearest_bwd_cuda(g: torch.Tensor, ty, tx, h: int, w: int) -> torch.Tensor:
    """Launch the nearest backward kernel on the contiguous CUDA cotangent
    ``g``; returns the (N, C, h, w) input gradient in ``g``'s dtype."""
    lib = _build.load_library()
    _check(g, "resize_nearest_bwd_cuda")
    n, c, oh, ow = g.shape
    if (oh, ow) != (ty.idx.numel(), tx.idx.numel()):
        raise ValueError(f"cotangent {tuple(g.shape)} does not match the tables "
                         f"({ty.idx.numel()}, {tx.idx.numel()})")
    gx = torch.empty((n, c, h, w), dtype=g.dtype, device=g.device)
    item = g.element_size()
    rows = nearest_bwd_rows_per_block(w, ow, ty.max_run, tx.max_run, item)
    smem = nearest_bwd_smem_bytes(w, rows, ty.max_run, ow, item) if rows else 0
    with torch.cuda.device(g.device):
        err = lib.mrfp_resize_nearest_bwd(
            g.data_ptr(), gx.data_ptr(), ty.lo.data_ptr(), ty.hi.data_ptr(),
            tx.lo.data_ptr(), tx.hi.data_ptr(), n * c, h, w, oh, ow, rows, ty.max_run,
            tx.max_run, smem, _DTYPES[g.dtype], _stream(g))
    _build.check(err, "resize_nearest_bwd")
    _build.LAUNCHES["resize_nearest_bwd"] += 1
    return gx
