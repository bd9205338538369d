"""The fused OC-branch stage (``csrc/oc_stage.cu``): the CUDA wrappers and
the plain PyTorch version of each.

One stage after its conv is nearest resize -> train-mode BatchNorm (fp32
statistics) -> ReLU -> cast, and the kernels fuse it, forward and backward:
they replace mrfp_tpu/ops/pallas_resize.py::resize_nearest_fused with its
custom VJP ``_rn_bwd`` together with the XLA-fused ``_bn_relu`` of
mrfp_tpu/perturb/oc_branch.py:121-127. The source note says how.

- ``oc_stage_stats_*``: the per-channel count-weighted moments of the conv
  output ``y`` over the resize's tables, which are the resized map's
  moments, taken in fp64: ``stats`` (4, C) = the mean, M2, ``1 / sqrt(M2 /
  count + eps)`` and the count, rounded once to fp32 (fp64 for an fp64 map,
  plain version only), and ``local`` (2, C), the fp64 mean and M2 that
  processes combine (``global_stats``).
- ``oc_stage_apply_*``: ``relu((y[iy, ix] - mean) * invstd * w + b)`` in
  ``y``'s dtype, written in each memory format of ``layouts``
  (``torch.channels_last`` and/or ``torch.contiguous_format``).
- ``oc_stage_bwd_*``: the input gradient from the cotangents of those
  outputs (None where an output took none): pass 1 the sums ``(sum g, sum g
  x_hat)`` per channel in fp64, summed over ``group``, then pass 2.
- ``oc_stage_layout_cuda``: a map moved between NCHW and channels-last (a
  cast and an added map on the way), at the branch's NCHW edges.

A kernel reads ``y`` channels-last (``nhwc``) and writes its outputs and
its input gradient channels-last; a CUDA wrapper launches its kernels or
raises. The plain versions take any layout: the reference the tests and
``chip_smoke.py`` hold the kernels against.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from mrfp_tpu_torch.nn.norms import global_moments
from mrfp_tpu_torch.ops import _build
from mrfp_tpu_torch.ops.cuda_resize import resize_nearest_bwd_plain, resize_nearest_plain
from mrfp_tpu_torch.parallel.dist import Group, all_reduce_sum

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NHWC, NCHW = torch.channels_last, torch.contiguous_format
# blocks an SM of the two kernels that leave one partial a block
PARTIAL_BLOCKS_PER_SM = 4


def _dense(t: torch.Tensor, layout) -> bool:
    return t.permute(0, 2, 3, 1).is_contiguous() if layout == NHWC else t.is_contiguous()


def nhwc(t: torch.Tensor) -> torch.Tensor:
    """``t`` (N, C, H, W) whose memory is NHWC-dense: ``t`` itself where it
    is, else a copy."""
    if _dense(t, NHWC):
        return t
    return t.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)


def replica_counts(ty, tx, dtype) -> torch.Tensor:
    """(h, w): how many outputs of the resize read each input pixel."""
    return (ty.hi - ty.lo).to(dtype)[:, None] * (tx.hi - tx.lo).to(dtype)[None, :]


def _channels(t: torch.Tensor) -> torch.Tensor:
    return t[None, :, None, None]


# --- plain versions -----------------------------------------------------------

def _stats(mean: torch.Tensor, m2: torch.Tensor, count, eps: float, dtype) -> torch.Tensor:
    """``stats`` from fp64 moments: invstd in fp64, all rounded once."""
    invstd = 1 / torch.sqrt(m2 / count + eps)
    return torch.stack([mean, m2, invstd, torch.zeros_like(mean) + count]).to(dtype)


def global_stats(count: int, local: torch.Tensor, group: Group, eps: float,
                 dtype) -> torch.Tensor:
    """``stats`` of the global batch from each rank's fp64 ``local`` moments:
    one ``all_reduce`` and Chan's rule in fp64 (``nn.norms.global_moments``),
    rounded once, so the ranks round the numbers one process would."""
    n, mean, m2 = global_moments(count, local[0], local[1], group)
    return _stats(mean, m2, n, eps, dtype)


def oc_stage_stats_plain(y: torch.Tensor, ty, tx, count: int, eps: float):
    """The count-weighted moments in fp64, in the corrected two passes (the
    first mean's rounding comes back as the mean of the deviations):
    ``(stats, local)``, the statistics rounded once to fp32 (kept fp64 for
    an fp64 map), the exact moments correctly rounded, which the kernel's
    fp64 sums round to too, and the fp64 mean and M2."""
    f = torch.promote_types(y.dtype, torch.float32)
    yd, cw = y.double(), replica_counts(ty, tx, torch.float64)
    mean = (yd * cw).sum((0, 2, 3)) / count
    d = yd - _channels(mean)
    s_d = (d * cw).sum((0, 2, 3))
    m2 = (d.square() * cw).sum((0, 2, 3)) - s_d.square() / count
    mean = mean + s_d / count
    return _stats(mean, m2, count, eps, f), torch.stack([mean, m2])


def _bn_relu(yf: torch.Tensor, stats: torch.Tensor, weight, bias):
    """(x_hat, z = (y - mean) * (invstd * w) + b), per channel, each
    operation rounded on its own (the kernels round them so)."""
    f = stats.dtype
    d = yf - _channels(stats[0])
    return d * _channels(stats[2]), d * _channels(stats[2] * weight.to(f)) + _channels(bias.to(f))


def oc_stage_apply_plain(y: torch.Tensor, stats: torch.Tensor, weight, bias, ty, tx,
                         layouts: Sequence) -> List[torch.Tensor]:
    _xh, z = _bn_relu(resize_nearest_plain(y, ty, tx).to(stats.dtype), stats, weight, bias)
    out = torch.relu(z).to(y.dtype)
    return [out.contiguous(memory_format=fmt) for fmt in layouts]


def oc_stage_bwd_plain(grads: Sequence[Optional[torch.Tensor]], y: torch.Tensor,
                       stats: torch.Tensor, weight, bias, ty, tx, group: Group) -> torch.Tensor:
    """G: the cotangents summed over each source's replicas in fp32, masked
    by its BN output; the sums ``sum(g)`` and ``sum(g x_hat)`` in fp64,
    rounded once to fp32 (as the kernel's); then ``a ((G - c sum(g) / M) -
    (c x_hat) sum(g x_hat) / M)``, rounded once to ``y``'s dtype. Cotangents of two outputs are
    first summed in fp32 and rounded once to ``y``'s dtype, as the
    transposition kernel sums them (and as autograd summed the gradients of
    one map read twice)."""
    f = stats.dtype
    given = [t for t in grads if t is not None]
    g = given[0].to(f) if len(given) == 1 else sum(t.to(f) for t in given).to(y.dtype).to(f)
    big_g = resize_nearest_bwd_plain(g, ty, tx, y.shape[2], y.shape[3])
    xh, z = _bn_relu(y.to(f), stats, weight, bias)
    big_g = torch.where(z > 0, big_g, torch.zeros_like(big_g))
    gd = big_g.double()
    sums = torch.stack([gd.sum((0, 2, 3)), (gd * xh.double()).sum((0, 2, 3))])
    sums = all_reduce_sum(sums, group).to(f)
    rep = replica_counts(ty, tx, f)
    k1, k2 = (_channels(s / stats[3]) for s in sums)
    dx = _channels(stats[2] * weight.to(f)) * (big_g - rep * k1 - rep * xh * k2)
    return dx.to(y.dtype)


# --- CUDA wrappers ------------------------------------------------------------

def _check(y: torch.Tensor, what: str) -> None:
    if not y.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor, got {y.device}")
    if y.dtype not in _DTYPES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {y.dtype}")
    if y.dim() != 4 or not _dense(y, NHWC):
        raise ValueError(f"{what} takes an NHWC-dense (N, C, H, W) map, got shape "
                         f"{tuple(y.shape)}, strides {y.stride()}")


def _pack(*maps: Optional[torch.Tensor]) -> int:
    """Channels an access moves: 16 bytes' worth (8 bf16, 4 fp32) where the
    channel count is a multiple and every pointer 16-byte aligned, else 1."""
    y = maps[0]
    wide = 16 // y.element_size()
    if y.shape[1] % wide == 0 and all(t.data_ptr() % 16 == 0 for t in maps if t is not None):
        return wide
    return 1


def _block_threads(packs: int) -> int:
    """The kernels' block: a whole number of packs' threads, about 256
    (``block_threads`` in the source)."""
    return packs if packs >= 256 else packs * (256 // packs)


def _parts(y: torch.Tensor, rows: int, width: int, pack: int) -> int:
    """Blocks of a kernel that leaves one partial a block: as many as hold
    work, at most ``PARTIAL_BLOCKS_PER_SM`` an SM. A run is 2 pixels of
    16-byte packs, 8 of single values (``run_of`` in the source)."""
    packs = y.shape[1] // pack
    run = 2 if pack > 1 else 8
    slots = rows * -(-width // run)
    per_block = _block_threads(packs) // packs
    sms = torch.cuda.get_device_properties(y.device).multi_processor_count
    return max(1, min(PARTIAL_BLOCKS_PER_SM * sms, -(-slots // per_block)))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def oc_stage_stats_cuda(y: torch.Tensor, ty, tx, count: int, eps: float):
    """Launch the statistics kernel and its fold: ``stats`` (4, C) fp32 and
    ``local`` (2, C) fp64."""
    lib = _build.load_library()
    _check(y, "oc_stage_stats_cuda")
    n, c, h, w = y.shape
    if (h, w) != (ty.lo.numel(), tx.lo.numel()) or n * h * w == 0:
        raise ValueError(f"map {tuple(y.shape)} does not match the tables "
                         f"({ty.lo.numel()}, {tx.lo.numel()}) or is empty")
    pack = _pack(y)
    parts = _parts(y, n * h, w, pack)
    part = torch.empty(parts * (1 + 2 * c), dtype=torch.float64, device=y.device)
    stats = torch.empty((4, c), dtype=torch.float32, device=y.device)
    local = torch.empty((2, c), dtype=torch.float64, device=y.device)
    with torch.cuda.device(y.device):
        err = lib.mrfp_oc_stage_stats(
            y.data_ptr(), ty.lo.data_ptr(), ty.hi.data_ptr(), tx.lo.data_ptr(), tx.hi.data_ptr(),
            part.data_ptr(), parts, n, h, w, c, float(count), eps, stats.data_ptr(),
            local.data_ptr(), _DTYPES[y.dtype], pack, _stream(y))
    _build.check(err, "oc_stage_stats")
    _build.LAUNCHES["oc_stage_stats"] += 1
    return stats, local


def _empty(layout, n: int, c: int, h: int, w: int, dtype, device) -> torch.Tensor:
    if layout == NHWC:
        return torch.empty((n, h, w, c), dtype=dtype, device=device).permute(0, 3, 1, 2)
    return torch.empty((n, c, h, w), dtype=dtype, device=device)


def oc_stage_layout_cuda(x: torch.Tensor, layout, dtype=None,
                         add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` (N, C, H, W), dense in the other layout, rewritten dense in
    ``layout`` (``NHWC`` or ``NCHW``) by the transposition kernel, cast to
    ``dtype`` (``x``'s by default), plus ``add`` (dense in ``layout``, of
    ``dtype``) where given: summed in fp32, rounded once."""
    lib = _build.load_library()
    dtype = x.dtype if dtype is None else dtype
    if not x.is_cuda or x.dtype not in _DTYPES or dtype not in _DTYPES:
        raise ValueError(f"oc_stage_layout_cuda takes float32 or bfloat16 CUDA maps, got "
                         f"{x.dtype} on {x.device} to {dtype}")
    n, c, h, w = x.shape
    if not _dense(x, NHWC if layout == NCHW else NCHW):
        raise ValueError(f"oc_stage_layout_cuda: the map is not dense in the layout it leaves "
                         f"(strides {x.stride()})")
    out = _empty(layout, n, c, h, w, dtype, x.device)
    if add is not None and (add.dtype != dtype or add.shape != x.shape
                            or not _dense(add, layout)):
        raise ValueError("oc_stage_layout_cuda: the added map must be dense in the layout "
                         "written, of its dtype and shape")
    rows, cols = (c, h * w) if layout == NHWC else (h * w, c)
    with torch.cuda.device(x.device):
        err = lib.mrfp_oc_stage_layout(x.data_ptr(), _ptr(add), out.data_ptr(), n, rows, cols,
                                       _DTYPES[x.dtype], _DTYPES[dtype], _stream(x))
    _build.check(err, "oc_stage_layout")
    _build.LAUNCHES["oc_stage_layout"] += 1
    return out


def oc_stage_apply_cuda(y: torch.Tensor, stats: torch.Tensor, weight, bias, ty, tx,
                        layouts: Sequence, identity: bool = False) -> List[torch.Tensor]:
    """Launch the apply kernel (a channels-last output), then the
    transposition for an NCHW one: one output per entry of ``layouts`` (at
    most one of each format). ``identity``: the tables are the identity (the
    kernel then carries no resize's name)."""
    lib = _build.load_library()
    _check(y, "oc_stage_apply_cuda")
    n, c, h, w = y.shape
    if (h, w) != (ty.lo.numel(), tx.lo.numel()):
        raise ValueError(f"map {tuple(y.shape)} does not match the tables "
                         f"({ty.lo.numel()}, {tx.lo.numel()})")
    if not layouts or len(set(layouts)) != len(layouts) or not set(layouts) <= {NHWC, NCHW}:
        raise ValueError(f"layouts must name channels_last and/or contiguous_format once, got "
                         f"{layouts}")
    oh, ow = ty.idx.numel(), tx.idx.numel()
    out = _empty(NHWC, n, c, oh, ow, y.dtype, y.device)
    pack = _pack(y, out)
    with torch.cuda.device(y.device):
        err = lib.mrfp_oc_stage_apply(
            y.data_ptr(), out.data_ptr(), stats.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            ty.idx.data_ptr(), tx.idx.data_ptr(), n, h, w, c, oh, ow, int(identity),
            _DTYPES[y.dtype], pack, _stream(y))
    _build.check(err, "oc_stage_apply")
    _build.LAUNCHES["oc_stage"] += 1
    return [out if fmt == NHWC else oc_stage_layout_cuda(out, NCHW) for fmt in layouts]


def oc_stage_bwd_cuda(grads: Sequence[Optional[torch.Tensor]], layouts: Sequence,
                      y: torch.Tensor, stats: torch.Tensor, weight, bias, ty, tx, group: Group,
                      identity: bool = False) -> torch.Tensor:
    """Launch the backward: an NCHW cotangent transposed (and summed with a
    channels-last one) into one channels-last cotangent, then pass 1 and
    its fold, the sums' ``all_reduce`` over ``group`` where it has more than
    one process, pass 2. ``grads``: the cotangent of each output (of
    ``layouts``), None where it took none; returns the NHWC input gradient
    in ``y``'s dtype."""
    lib = _build.load_library()
    _check(y, "oc_stage_bwd_cuda")
    n, c, h, w = y.shape
    oh, ow = ty.idx.numel(), tx.idx.numel()
    by = {fmt: g for g, fmt in zip(grads, layouts) if g is not None}
    if not by:
        raise ValueError("oc_stage_bwd_cuda: no output took a cotangent")
    for g in by.values():
        if tuple(g.shape) != (n, c, oh, ow) or g.dtype != y.dtype:
            raise ValueError(f"cotangent {tuple(g.shape)} {g.dtype} does not match the output "
                             f"({n}, {c}, {oh}, {ow}) {y.dtype}")
    dy = None if NHWC not in by else nhwc(by[NHWC])
    if NCHW in by:
        dy = oc_stage_layout_cuda(by[NCHW].contiguous(), NHWC, add=dy)
    dx = _empty(NHWC, n, c, h, w, y.dtype, y.device)
    pack = _pack(y, dy, dx)
    parts = _parts(y, n * h, w, pack)
    part = torch.empty(2 * parts * c, dtype=torch.float64, device=y.device)
    sums = torch.empty((2, c), dtype=torch.float64, device=y.device)
    short = int(max(ty.max_run, tx.max_run) <= 2)

    def launch(passes: int) -> None:
        with torch.cuda.device(y.device):
            err = lib.mrfp_oc_stage_bwd(
                dy.data_ptr(), y.data_ptr(), stats.data_ptr(), weight.data_ptr(),
                bias.data_ptr(), ty.lo.data_ptr(), ty.hi.data_ptr(), tx.lo.data_ptr(),
                tx.hi.data_ptr(), part.data_ptr(), parts,
                sums.data_ptr(), dx.data_ptr(), n, h, w, c, oh, ow, int(identity), short,
                passes, _DTYPES[y.dtype], pack, _stream(y))
        _build.check(err, "oc_stage_bwd")

    if group.size == 1:
        launch(3)
    else:
        launch(1)
        all_reduce_sum(sums, group)
        launch(2)
    _build.LAUNCHES["oc_stage_bwd"] += 1
    return dx
