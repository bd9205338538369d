"""Bilinear align_corners=True and nearest resizes with PyTorch's semantics, NCHW.

The reference upsamples with ``F.interpolate(mode='bilinear',
align_corners=True)`` (network/mynn.py:114-119): source coordinate
``dst * (in-1)/(out-1)``. The OC branch calls ``F.interpolate`` with no
mode, so it is nearest (deepv3.py:320-327): with ``scale_factor=s`` the
output is ``floor(in*s)`` and ``src = floor(dst/s)``; with ``size=`` it is
``src = floor(dst*in/out)`` (mrfp_tpu/ops/resize.py:48-63).

Every index table is computed on the host in float64 numpy, with the JAX
package's rules, and cached on the device per (input size, output size or
scale, rule, device), so no call rebuilds one. Both kinds of table are
monotone, so the inputs that one input index feeds form a contiguous range
of outputs: the tables carry that ``[lo, hi)`` range per input index, which
is what the backward kernels walk.

Both resizes are ``torch.autograd.Function``s. On a CUDA tensor the forward
and the backward are the hand-written kernels (``ops/cuda_resize.py``); on a
CPU tensor, their plain PyTorch versions. A resize to the input's own size
returns the input itself, with no Function and no launch. The bilinear
forward goes through the registered op ``mrfp::resize_bilinear``
(``ops/library.py``) on every device, so a live forward and an exported
one take the same route; the op builds its tables itself. A byte count of
a step (``cli.plan``) takes each resize as one op, its map in and its map
out, whichever version runs (``_resize``).

No table is built under a fake mode (``torch.export``'s tracing): a fake
table cached here would be handed to every later live call at its shape.
Building one there raises.

Under spatial parallelism (``core/mesh.py::bands``) a resize computes this
rank's band of the output rows of the global resize. Its H table is the
global table's rows ``[o0, o1)`` of that band, rebased to the first input
row they read; that many input rows are fetched from their owners
(``parallel/dist.py::rows_from_group``), and the kernels run on the band
as on any map. The band table is never the table of a resize of the band
to its share: a scale or ``align_corners``' ``(in-1)/(out-1)`` applied to
a band reads other rows. The ``[lo, hi)`` ranges the backward kernels walk
are those of the band table.

``row_mix`` and ``take_rows`` are the counterparts of the JAX package's
layout-preserving row mix (``ops/cuda_row_mix.py``). ``take_rows`` reads
its one-hot P as a table built on the host and cached like the index
tables. No resize routes through them, as none does in the JAX package
unless it is asked to.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mrfp_tpu_torch.core.mesh import Bands, active_bands
from mrfp_tpu_torch.ops import cuda_resize, cuda_row_mix
from mrfp_tpu_torch.parallel.dist import rows_from_group

# the open byte count (``cli.plan``'s ``OpBytes``), if any: ``_resize``
# hands it each kernel or plain resize whole
_BYTES = None


class BilinearTaps(NamedTuple):
    """One axis of a bilinear resize, on the device: the two source taps and
    the weight of the second (int32, int32, float32; one entry per output),
    for each tap the output range ``[lo, hi)`` that reads each input index
    (int32; one entry per input)."""
    idx0: torch.Tensor
    idx1: torch.Tensor
    frac: torch.Tensor
    lo0: torch.Tensor
    hi0: torch.Tensor
    lo1: torch.Tensor
    hi1: torch.Tensor


class NearestTable(NamedTuple):
    """One axis of a nearest resize, on the device: the source index per
    output and the output range ``[lo, hi)`` per input (int32); on the host,
    ``max_run``, the longest of those ranges (it picks the backward kernel
    and bounds the run of cotangent rows the staged one takes per block),
    and ``spec``, the ``(in_size, rule, arg)`` the table was built from (the
    forward kernel's plan is made from it)."""
    idx: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    max_run: int
    spec: Tuple[int, str, object]


@functools.lru_cache(maxsize=None)
def bilinear_ac_weights(in_size: int, out_size: int):
    """(idx0, idx1, frac) for align_corners=True bilinear along one axis."""
    if out_size == 1:
        src = np.zeros(1, dtype=np.float64)
    else:
        src = np.arange(out_size, dtype=np.float64) * ((in_size - 1) / (out_size - 1))
    idx0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    idx1 = np.minimum(idx0 + 1, in_size - 1)
    frac = (src - idx0).astype(np.float32)
    return idx0, idx1, frac


def nearest_out_size(in_hw: Tuple[int, int], scale: Tuple[float, float]) -> Tuple[int, int]:
    """Output size for torch F.interpolate(scale_factor=...): floor(in*s)."""
    return (int(np.floor(in_hw[0] * scale[0])), int(np.floor(in_hw[1] * scale[1])))


def _nearest_idx_from_scale(in_size: int, scale: float) -> np.ndarray:
    out = int(np.floor(in_size * scale))
    # torch nearest with explicit scale: src = floor(dst / scale)
    idx = np.floor(np.arange(out, dtype=np.float64) / np.float64(scale))
    return np.clip(idx.astype(np.int64), 0, in_size - 1)


def _nearest_idx_from_size(in_size: int, out_size: int) -> np.ndarray:
    # torch nearest with explicit size: src = floor(dst * in/out)
    idx = np.floor(np.arange(out_size, dtype=np.float64) * (in_size / out_size))
    return np.clip(idx.astype(np.int64), 0, in_size - 1)


def bilinear_band_rows(in_size: int, out_size: int, o0: int, o1: int) -> Tuple[int, int]:
    """The input rows ``[lo, hi)`` that the output rows ``[o0, o1)`` of an
    align_corners resize read (both taps; the tables are monotone)."""
    i0, i1, _ = bilinear_ac_weights(in_size, out_size)
    return int(i0[o0]), int(i1[o1 - 1]) + 1


@functools.lru_cache(maxsize=None)
def bilinear_band_weights(in_size: int, out_size: int, band: Tuple[int, int]):
    """(idx0, idx1, frac) of the output rows ``band = (o0, o1)`` of the
    global (in_size -> out_size) axis, the indices rebased to the first
    input row they read."""
    o0, o1 = band
    i0, i1, f = bilinear_ac_weights(in_size, out_size)
    lo = int(i0[o0])
    return i0[o0:o1] - lo, i1[o0:o1] - lo, f[o0:o1]


def nearest_band_rows(in_size: int, rule: str, arg, o0: int, o1: int) -> Tuple[int, int]:
    """The input rows ``[lo, hi)`` that the output rows ``[o0, o1)`` of a
    nearest resize read."""
    idx = nearest_index(in_size, rule, arg)
    return int(idx[o0]), int(idx[o1 - 1]) + 1


def inverse_ranges(idx: np.ndarray, in_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """For a monotone source-index table: ``lo[i], hi[i]`` such that
    ``idx[o] == i`` exactly for ``lo[i] <= o < hi[i]`` (empty when no output
    reads ``i``)."""
    if np.any(np.diff(idx) < 0):
        raise ValueError("index table is not monotone")
    inputs = np.arange(in_size)
    return (np.searchsorted(idx, inputs, side="left"),
            np.searchsorted(idx, inputs, side="right"))


def _i32(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32), device=device)


def _refuse_fake_mode(what: str) -> None:
    """Raise when a table would be built under a fake mode (a trace): it
    would be a fake tensor, cached for the live calls that follow."""
    if torch._guards.detect_fake_mode() is not None:
        raise RuntimeError(f"{what}: a device table cannot be built while tracing; a traced "
                           f"resize must go through a registered op (ops/library.py)")


_TAPS: Dict[tuple, BilinearTaps] = {}
_NEAREST: Dict[tuple, NearestTable] = {}


def bilinear_taps(in_size: int, out_size: int, device: torch.device,
                  band: Optional[Tuple[int, int]] = None) -> BilinearTaps:
    """The device tables of one bilinear axis, cached per (in, out, band,
    device); with ``band = (o0, o1)``, the band table of those output rows
    (``bilinear_band_weights``), whose input is the rows it reads."""
    key = (in_size, out_size, band, str(device))
    taps = _TAPS.get(key)
    if taps is None:
        _refuse_fake_mode("bilinear_taps")
        if band is None:
            i0, i1, f = bilinear_ac_weights(in_size, out_size)
            rows = in_size
        else:
            i0, i1, f = bilinear_band_weights(in_size, out_size, band)
            rows = int(i1[-1]) + 1
        lo0, hi0 = inverse_ranges(i0, rows)
        lo1, hi1 = inverse_ranges(i1, rows)
        taps = BilinearTaps(_i32(i0, device), _i32(i1, device),
                            torch.as_tensor(f, device=device),
                            _i32(lo0, device), _i32(hi0, device),
                            _i32(lo1, device), _i32(hi1, device))
        _TAPS[key] = taps
    return taps


def nearest_index(in_size: int, rule: str, arg,
                  band: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """The source index per output of one nearest axis; ``rule`` is "scale"
    (``arg`` = the scale factor) or "size" (``arg`` = the output size). With
    ``band = (o0, o1)``: those outputs' indices, rebased to the first input
    row they read."""
    if rule == "scale":
        idx = _nearest_idx_from_scale(in_size, float(arg))
    elif rule == "size":
        idx = _nearest_idx_from_size(in_size, int(arg))
    else:
        raise ValueError(f"rule must be 'scale' or 'size', got {rule!r}")
    if band is None:
        return idx
    idx = idx[band[0]:band[1]]
    return idx - idx[0]


def nearest_table(in_size: int, rule: str, arg, device: torch.device,
                  band: Optional[Tuple[int, int]] = None) -> NearestTable:
    """The device tables of one nearest axis (rules as ``nearest_index``),
    cached per (in, arg, rule, band, device); with ``band``, the band table
    of those output rows, whose input is the rows they read."""
    key = (in_size, rule, arg, band, str(device))
    table = _NEAREST.get(key)
    if table is None:
        _refuse_fake_mode("nearest_table")
        spec = (in_size, rule, arg) + ((band,) if band is not None else ())
        idx = nearest_index(*spec)
        rows = in_size if band is None else int(idx[-1]) + 1
        lo, hi = inverse_ranges(idx, rows)
        table = NearestTable(_i32(idx, device), _i32(lo, device), _i32(hi, device),
                             int((hi - lo).max(initial=0)), spec)
        _NEAREST[key] = table
    return table


def check_impl(impl: Optional[str]) -> None:
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")


def _use_kernel(x: torch.Tensor, impl: Optional[str]) -> bool:
    """The kernel serves every tensor off the CPU; ``impl="plain"`` forces
    the plain version (kernel-vs-plain comparisons only)."""
    check_impl(impl)
    return impl is None and x.device.type != "cpu"


def _resize(fn, x: torch.Tensor, *args) -> torch.Tensor:
    """``fn(x, *args)``: a resize's kernel or its plain version. An open
    byte count takes the call as one op (the plain version's gathers are
    not the kernel's traffic)."""
    if _BYTES is None:
        return fn(x, *args)
    return _BYTES.unit(fn, x, *args)


def _h_taps(h: int, out_h: int, band: Optional[Tuple[int, int, int]], device) -> BilinearTaps:
    """The H table of a resize to ``out_h`` rows: the global one, or with
    ``band = (in_full, out_full, o0)`` the band table of output rows
    ``[o0, o0 + out_h)``."""
    if band is None:
        return bilinear_taps(h, out_h, device)
    in_full, out_full, o0 = band
    return bilinear_taps(in_full, out_full, device, (o0, o0 + out_h))


class ResizeBilinear(torch.autograd.Function):
    """Bilinear resize: the forward is the registered op (the kernel on the
    card, the plain version on the CPU) or, for ``impl="plain"``, the plain
    version; the backward is the kernel or the plain version by the same
    rule. The gradient comes back in the input's dtype. ``band``: None, or
    ``(in_full, out_full, o0)``: ``x`` is the input rows that the output
    rows ``[o0, o0 + out_h)`` of the global resize read."""

    @staticmethod
    def forward(ctx, x, out_h: int, out_w: int, impl: Optional[str],
                band: Optional[Tuple[int, int, int]] = None):
        ctx.args = (_use_kernel(x, impl), x.shape[2], x.shape[3], out_h, out_w, band)
        if impl == "plain":
            return cuda_resize.resize_bilinear_plain(
                x, _h_taps(x.shape[2], out_h, band, x.device),
                bilinear_taps(x.shape[3], out_w, x.device))
        if band is None:
            return torch.ops.mrfp.resize_bilinear(x, out_h, out_w)
        return torch.ops.mrfp.resize_bilinear(x, out_h, out_w, *band)

    @staticmethod
    def backward(ctx, g):
        kernel, h, w, oh, ow, band = ctx.args
        ty, tx = _h_taps(h, oh, band, g.device), bilinear_taps(w, ow, g.device)
        g = g.contiguous()  # the ASPP broadcast's gradient arrives through torch.cat
        fn = (cuda_resize.resize_bilinear_bwd_cuda if kernel
              else cuda_resize.resize_bilinear_bwd_plain)
        return _resize(fn, g, ty, tx, h, w), None, None, None, None


class ResizeNearest(torch.autograd.Function):
    """Nearest resize with a kernel forward and a kernel backward."""

    @staticmethod
    def forward(ctx, x, ty: NearestTable, tx: NearestTable, kernel: bool):
        ctx.tables = (ty, tx, kernel, x.shape[2], x.shape[3])
        fn = cuda_resize.resize_nearest_cuda if kernel else cuda_resize.resize_nearest_plain
        return _resize(fn, x, ty, tx)

    @staticmethod
    def backward(ctx, g):
        ty, tx, kernel, h, w = ctx.tables
        fn = (cuda_resize.resize_nearest_bwd_cuda if kernel
              else cuda_resize.resize_nearest_bwd_plain)
        return _resize(fn, g.contiguous(), ty, tx, h, w), None, None, None


def _band_input(x: torch.Tensor, bands: Bands, h: int, oh: int, reads,
                whole: bool) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """The input rows that this rank's band of the ``oh`` output rows reads
    (``reads(o0, o1) -> (lo, hi)``), and that band: sliced from ``x`` where
    every rank holds the whole input (``whole``), else fetched from the
    rows' owners."""
    outs = bands.every(oh)
    rows = [reads(o0, o1) for o0, o1 in outs]
    if whole:
        lo, hi = rows[bands.index]
        return x[:, :, lo:hi], outs[bands.index]
    return (rows_from_group(x, h, [r[0] for r in rows], [r[1] for r in rows], bands.group),
            outs[bands.index])


def resize_bilinear_align_corners(x: torch.Tensor, size: Tuple[int, int],
                                  impl: Optional[str] = None,
                                  replicated: bool = False) -> torch.Tensor:
    """Resize NCHW ``x`` to ``size`` = (oh, ow); returns ``x`` itself when the
    size is unchanged (as mrfp_tpu/ops/resize.py:195-196 does).

    In a spatial scope (``core/mesh.py``) ``x`` is this rank's band and
    ``size`` the global size, and the result is this rank's band of the
    global resize; with ``replicated``, ``x`` is the whole map, held by
    every rank (the ASPP image pool's 1x1 map).

    ``impl="plain"`` forces the plain version on any device. It exists only
    so that tests and ``chip_smoke.py`` can hold the kernel against it.
    """
    if x.dim() != 4:
        raise ValueError(f"expected NCHW, got shape {tuple(x.shape)}")
    oh, ow = int(size[0]), int(size[1])
    bands = active_bands()
    if bands is None:
        h, w = x.shape[2], x.shape[3]
        if (h, w) == (oh, ow):
            return x
        return ResizeBilinear.apply(x, oh, ow, impl)
    w = x.shape[3]
    h = x.shape[2] if replicated else bands.height(x.shape[2], w)
    if (h, w) == (oh, ow) and not replicated:
        return x
    bands.add(oh, ow)
    xr, (o0, o1) = _band_input(x, bands, h, oh,
                               lambda a, b: bilinear_band_rows(h, oh, a, b), replicated)
    return ResizeBilinear.apply(xr, o1 - o0, ow, impl, (h, oh, o0))


def row_mix(x: torch.Tensor, p: torch.Tensor, dim: int,
            impl: Optional[str] = None) -> torch.Tensor:
    """``out = P @ x`` along dim 2 (H) or 3 (W) of NCHW ``x``, for an fp32
    (out, in) ``P``; fp32 sums rounded once to ``x.dtype``
    (mrfp_tpu/ops/pallas_resize.py::row_mix_pallas). On the card P is
    compacted into the kernel's table first, a launch of its own. The
    kernel's output carries no gradient, as the Pallas call's does not:
    ``take_rows`` is the differentiable form."""
    if _use_kernel(x, impl):
        return cuda_row_mix.row_mix_cuda(x, p, dim)
    with torch.autocast(x.device.type, enabled=False):
        return cuda_row_mix.row_mix_plain(x, p, dim)


_ONEHOT: Dict[tuple, torch.Tensor] = {}
_ONEHOT_TABLES: Dict[tuple, cuda_row_mix.RowTable] = {}


def _onehot_np(idx: Tuple[int, ...], in_size: int, transpose: bool) -> np.ndarray:
    a = np.zeros((len(idx), in_size), np.float32)
    a[np.arange(len(idx)), list(idx)] = 1.0
    return a.T.copy() if transpose else a


def onehot_rows(idx: Tuple[int, ...], in_size: int, device, transpose: bool = False
                ) -> torch.Tensor:
    """The fp32 (len(idx), in_size) selection matrix with ``P[o, idx[o]] = 1``
    (or its transpose), cached on the device."""
    key = (idx, in_size, transpose, str(device))
    p = _ONEHOT.get(key)
    if p is None:
        _refuse_fake_mode("onehot_rows")
        p = torch.as_tensor(_onehot_np(idx, in_size, transpose), device=device)
        _ONEHOT[key] = p
    return p


def onehot_table(idx: Tuple[int, ...], in_size: int, device, transpose: bool = False
                 ) -> cuda_row_mix.RowTable:
    """The kernel's table of ``onehot_rows(idx, in_size, device, transpose)``,
    built on the host and cached on the device under the same key, so no
    call of ``take_rows`` compacts P on the card."""
    key = (idx, in_size, transpose, str(device))
    table = _ONEHOT_TABLES.get(key)
    if table is None:
        _refuse_fake_mode("onehot_table")
        table = cuda_row_mix.row_table(_onehot_np(idx, in_size, transpose), device)
        _ONEHOT_TABLES[key] = table
    return table


def _take(x: torch.Tensor, idx: Tuple[int, ...], in_size: int, dim: int,
          impl: Optional[str], transpose: bool) -> torch.Tensor:
    """``x`` mixed with the one-hot P of ``idx`` (or its transpose): the
    kernel with the cached table, or the plain version with the matrix."""
    if _use_kernel(x, impl):
        return cuda_row_mix.row_mix_table_cuda(
            x, onehot_table(idx, in_size, x.device, transpose), dim)
    with torch.autocast(x.device.type, enabled=False):
        return cuda_row_mix.row_mix_plain(x, onehot_rows(idx, in_size, x.device, transpose),
                                          dim)


class TakeRows(torch.autograd.Function):
    """``x.index_select(dim, idx)`` as a row mix with the one-hot P; the
    backward mixes the cotangent with P transposed (sums in fp32, rounded
    once), as the TPU kernel's custom VJP does."""

    @staticmethod
    def forward(ctx, x, idx: Tuple[int, ...], dim: int, impl: Optional[str]):
        ctx.args = (idx, dim, impl, x.shape[dim])
        return _take(x, idx, x.shape[dim], dim, impl, transpose=False)

    @staticmethod
    def backward(ctx, g):
        idx, dim, impl, in_size = ctx.args
        return _take(g.contiguous(), idx, in_size, dim, impl, transpose=True), None, None, None


def take_rows(x: torch.Tensor, idx: Tuple[int, ...], dim: int,
              impl: Optional[str] = None) -> torch.Tensor:
    """Differentiable ``x.index_select(dim, idx)`` along H (2) or W (3) of
    NCHW ``x`` through the row-mix kernel
    (mrfp_tpu/ops/pallas_resize.py::take_rows). ``idx``: a tuple of ints."""
    idx = tuple(int(i) for i in idx)
    if not all(0 <= i < x.shape[dim] for i in idx):
        raise ValueError(f"take_rows: an index lies outside [0, {x.shape[dim]})")
    return TakeRows.apply(x, idx, dim, impl)


def nearest_input(x: torch.Tensor, size: Optional[Tuple[int, int]] = None,
                  scale: Optional[Tuple[float, float]] = None
                  ) -> Optional[Tuple[torch.Tensor, NearestTable, NearestTable]]:
    """What a nearest resize of NCHW ``x`` (``resize_nearest``'s rules) reads:
    None for a resize by ``size`` to the input's own size, else the input
    (outside a spatial scope ``x`` itself; inside one, the rows this rank's
    band of the output reads, fetched from their owners), its H table (the
    band table inside a scope) and its W table."""
    if (size is None) == (scale is None):
        raise ValueError("pass exactly one of size= or scale=")
    if x.dim() != 4:
        raise ValueError(f"expected NCHW, got shape {tuple(x.shape)}")
    bands = active_bands()
    w = x.shape[3]
    h = x.shape[2] if bands is None else bands.height(x.shape[2], w)
    if size is not None:
        size = (int(size[0]), int(size[1]))
        if (h, w) == size:
            return None
        rule_y, arg_y, rule_x, arg_x = "size", size[0], "size", size[1]
    else:
        rule_y, arg_y, rule_x, arg_x = "scale", float(scale[0]), "scale", float(scale[1])
    tx = nearest_table(w, rule_x, arg_x, x.device)
    if bands is None:
        return x, nearest_table(h, rule_y, arg_y, x.device), tx
    oh = len(nearest_index(h, rule_y, arg_y))
    bands.add(oh, tx.idx.numel())
    xr, band = _band_input(x, bands, h, oh,
                           lambda a, b: nearest_band_rows(h, rule_y, arg_y, a, b), False)
    return xr, nearest_table(h, rule_y, arg_y, x.device, band), tx


def resize_nearest(x: torch.Tensor, size: Optional[Tuple[int, int]] = None,
                   scale: Optional[Tuple[float, float]] = None,
                   impl: Optional[str] = None) -> torch.Tensor:
    """Nearest resize of NCHW ``x`` matching torch F.interpolate defaults.

    Exactly one of ``size`` / ``scale`` must be given; the source-index rule
    differs between the two (module docstring). With ``size`` equal to the
    input's size it returns ``x`` itself (mrfp_tpu/ops/resize.py:136-137).
    ``impl="plain"`` as for the bilinear resize.
    """
    read = nearest_input(x, size, scale)
    if read is None:
        return x
    xr, ty, tx = read
    return ResizeNearest.apply(xr, ty, tx, _use_kernel(x, impl))
