"""One stage of the OC branch after its conv: nearest resize, train-mode
BatchNorm with fp32 batch statistics, ReLU, cast back to the map's dtype.

``oc_stage`` is the stage. On a CUDA tensor it is one
``torch.autograd.Function`` (``OCStage``) over the fused kernels of
``ops/cuda_oc_stage.py``: the statistics come from the pre-resize map,
weighted by how often the resize repeats each pixel (the resized map's
moments exactly), the resize is a gather inside the apply kernel, and the
backward saves only the map in its dtype and the per-channel statistics.
The kernels read and write channels-last maps; ``layouts`` names the
memory formats the stage writes its output in (``torch.channels_last``
for a conv that follows, ``torch.contiguous_format`` for an NCHW add, or
both), and the Function returns one output per entry.

On a CUDA tensor with ``impl="plain"`` the same Function runs the kernels'
plain versions (``kernel=False``): the same arithmetic in tensor
operations, its sums in fp64 and rounded once, as the kernels take theirs,
so the two agree in their statistics to the last bit and a train step
through either moves alike (kernel-vs-plain comparisons only). On a CPU
tensor the stage is the composition the reference writes: ``resize_nearest``
-> ``batch_norm_train`` on the fp32 map -> ReLU -> cast
(``oc_stage_plain``), NCHW, whose output serves every layout; the tests
hold the plain versions to it.

Across processes the statistics are the global batch's, as
``batch_norm_train``'s: each rank's count-weighted fp64 ``(n, mean, M2)``
go through ``nn.norms.global_moments`` (one ``all_reduce``, Chan's rule)
and the backward's two fp64 sums through ``all_reduce_sum``, over
``norm_group()``, each rounded only after, so the ranks round one
process's numbers.
Under spatial parallelism the stage runs on the rows its band of the
output reads, with the band table of the global resize
(``ops.resize.nearest_input``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from mrfp_tpu_torch.nn.norms import batch_norm_train, norm_group
from mrfp_tpu_torch.ops import cuda_oc_stage
from mrfp_tpu_torch.ops.cuda_oc_stage import NCHW, NHWC
from mrfp_tpu_torch.ops.resize import _use_kernel, nearest_input, nearest_table, resize_nearest

EPS = 1e-5


class OCStage(torch.autograd.Function):
    """The fused stage on ``y`` with the tables ``ty``, ``tx`` (whole, or a
    band's): the kernels (``kernel``) or their plain versions. Returns a
    tuple, one output per entry of ``layouts``; the input gradient comes
    back channels-last where the kernels ran. ``identity``: the resize is
    the identity (its tables are), which only the kernels' names note."""

    @staticmethod
    def forward(ctx, y, weight, bias, ty, tx, layouts: Tuple, kernel: bool,
                identity: bool = False, eps: float = EPS):
        group = norm_group()
        count = y.shape[0] * ty.idx.numel() * tx.idx.numel()
        if kernel:
            y, weight, bias = cuda_oc_stage.nhwc(y), weight.float(), bias.float()
            stats, local = cuda_oc_stage.oc_stage_stats_cuda(y, ty, tx, count, eps)
        else:
            stats, local = cuda_oc_stage.oc_stage_stats_plain(y, ty, tx, count, eps)
        if group.size > 1:
            stats = cuda_oc_stage.global_stats(count, local, group, eps, stats.dtype)
        if kernel:
            outs = cuda_oc_stage.oc_stage_apply_cuda(y, stats, weight, bias, ty, tx, layouts,
                                                     identity)
        else:
            outs = cuda_oc_stage.oc_stage_apply_plain(y, stats, weight, bias, ty, tx, layouts)
        ctx.save_for_backward(y, stats, weight, bias)
        ctx.args = (ty, tx, layouts, kernel, identity, group)
        ctx.set_materialize_grads(False)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        y, stats, weight, bias = ctx.saved_tensors
        ty, tx, layouts, kernel, identity, group = ctx.args
        dx = None
        if ctx.needs_input_grad[0] and any(g is not None for g in grads):
            if kernel:
                dx = cuda_oc_stage.oc_stage_bwd_cuda(grads, layouts, y, stats, weight, bias,
                                                     ty, tx, group, identity)
            else:
                dx = cuda_oc_stage.oc_stage_bwd_plain(grads, y, stats, weight, bias, ty, tx,
                                                      group)
        return dx, None, None, None, None, None, None, None, None


class _ToChannelsLast(torch.autograd.Function):
    """An NCHW map rewritten channels-last in ``dtype`` by the transposition
    kernel; its gradient goes back the same way, in the map's own dtype."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = x.dtype
        return cuda_oc_stage.oc_stage_layout_cuda(x, NHWC, dtype)

    @staticmethod
    def backward(ctx, g):
        return cuda_oc_stage.oc_stage_layout_cuda(cuda_oc_stage.nhwc(g), NCHW, ctx.dtype), None


def to_channels_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` (N, C, H, W, on the card) as a channels-last map for a conv:
    ``x`` itself where it is one, else through the transposition kernel, cast
    on the way to the dtype autocast gives the conv (the stem features
    enter the OC branch so)."""
    if x.permute(0, 2, 3, 1).is_contiguous():
        return x
    dtype = x.dtype
    if x.is_cuda and torch.is_autocast_enabled("cuda") and x.dtype == torch.float32:
        dtype = torch.get_autocast_dtype("cuda")
    return _ToChannelsLast.apply(x.contiguous(), dtype)


def oc_stage_plain(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   size: Optional[Tuple[int, int]] = None,
                   scale: Optional[Tuple[float, float]] = None,
                   impl: Optional[str] = None, eps: float = EPS) -> torch.Tensor:
    """relu(bn(resize_nearest(y))), the reference's per-layer pattern: the BN
    in fp32 (fp64 for fp64 maps) with the global batch's moments, the
    result cast to ``y``'s dtype."""
    y = resize_nearest(y, size=size, scale=scale, impl=impl)
    yf = batch_norm_train(y.to(torch.promote_types(y.dtype, torch.float32)), weight, bias,
                          eps=eps)
    return F.relu(yf).to(y.dtype)


def oc_stage(y: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             size: Optional[Tuple[int, int]] = None,
             scale: Optional[Tuple[float, float]] = None, impl: Optional[str] = None,
             layouts: Sequence = (NCHW,)) -> Tuple[torch.Tensor, ...]:
    """The stage on ``y`` (the conv's output; exactly one of ``size`` and
    ``scale``, ``resize_nearest``'s rules): one output per entry of
    ``layouts``. Off the CPU ``OCStage``, through the kernels or, with
    ``impl="plain"``, their plain versions (kernel-vs-plain comparisons
    only); on the CPU the composition."""
    layouts = tuple(layouts)
    if y.device.type == "cpu":
        return (oc_stage_plain(y, weight, bias, size, scale, impl),) * len(layouts)
    kernel = _use_kernel(y, impl)
    read = nearest_input(y, size, scale)
    if read is None:  # the identity: this rank's own rows
        h, w = y.shape[2], y.shape[3]
        return OCStage.apply(y, weight, bias, nearest_table(h, "size", h, y.device),
                             nearest_table(w, "size", w, y.device), layouts, kernel, True)
    xr, ty, tx = read
    return OCStage.apply(xr, weight, bias, ty, tx, layouts, kernel, False)
