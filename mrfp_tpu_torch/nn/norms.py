"""Norm layers and the per-block ``iw`` factory (network/Resnet.py:79-113).

torch's own layers have the semantics the JAX package copies
(mrfp_tpu/nn/norms.py): BatchNorm2d with eps 1e-5, momentum 0.1 and the
unbiased running variance; InstanceNorm2d with per-sample statistics and no
running buffers. The port covers every iw code: 0 (none), 1 and 2
(``InstanceWhitening``: a non-affine InstanceNorm whose output the block
also hands to the ISW/IRW whitening loss, ``collects_map``), 3 (non-affine
InstanceNorm), 4 (affine InstanceNorm) and 5 (``SwitchWhiten2d``, grouped
switchable whitening); codes 1-3 carry no parameters.

The instance norms take their variance in two passes, as torch's
``InstanceNorm2d`` does; the JAX package takes it in one
(mrfp_tpu/nn/norms.py:97-98). On a map whose spread is small beside its
mean the two differ (ROADMAP C1 is that difference in BatchNorm);
``tests/test_torch_resnet_family.py`` holds the port to JAX on maps where
they do not and shows where they do.

Train-mode BatchNorm takes its moments over the global batch, as the JAX
package's does under a sharded batch: with more than one process
(``parallel/dist.py``) ``GlobalBatchNorm2d`` and ``batch_norm_train`` run
``_GlobalBatchNorm``, whose forward combines the ranks' exact moments and
whose backward sums ``(sum dy, sum dy * x_hat)`` over the ranks. In a single
process both are torch's own BatchNorm, call for call. InstanceNorm is per
sample and stays local. ``SwitchWhiten2d``'s batch (BW) mean and
covariance are the global batch's in the same way (``_GlobalMeanCov``, the
reference's ``SyncMeanCov``), and its instance and layer statistics stay
local to the sample.

Under spatial parallelism (``core/mesh.py``) a map is split into bands of
rows over the spatial group. BatchNorm's moments over the world are then
still the global batch's. A map that every rank of the spatial group holds
whole (the ASPP image pool's 1x1 map, inside ``Bands.replicated_maps``)
reduces over the data group only (``norm_group``). InstanceNorm's
per-sample statistics span the bands: ``InstanceNorm2d`` combines the
ranks' ``(n, mean, M2)`` over the spatial group, forward and backward, in
train and in eval mode. ``SwitchWhiten2d``'s BW statistics, combined over
the world by ``_GlobalMeanCov``, are then the global batch's too, since
the bands partition each image's pixels; its per-sample IW mean and
covariance and LN mean and variance combine over the spatial group as
``InstanceNorm2d``'s do (``_band_moments``), in train and in eval mode.

Under tensor parallelism (``core/mesh.py``) a rank holds a slice of the
channels of the batch its model group shares. BatchNorm and InstanceNorm
are per channel, so they run on the slice with no model-group
collective, and BatchNorm's moments reduce over the replica group (the
ranks that share the model index, whose samples and bands partition the
global batch), or over the data group for a replicated map; a norm that
``weights.shard_model`` left whole runs on the whole map its whole conv
made. ``SwitchWhiten2d`` whitens groups of 16 channels: where M divides
the group count each rank whitens its own groups (BW statistics over the
replica group, IW ones local, LN ones combined over the model group);
where it does not, a group straddles two ranks, and every rank whitens
the gathered map whole (its running buffers whole, as ``tp_spec`` leaves
them) and keeps its slice. An ISW/IRW layer hands the whitening loss its
map gathered whole (``collect_map``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mrfp_tpu_torch.core.mesh import Channels, active_bands, active_channels, current_mesh
from mrfp_tpu_torch.parallel.dist import (Group, all_gather_rows, all_reduce_sum,
                                          all_reduce_sum_grad, copy_to_group)
from mrfp_tpu_torch.utils.profiling import span

IW_NONE, IW_W1, IW_W2, IW_IN, IW_IN_AFFINE, IW_SW = 0, 1, 2, 3, 4, 5


def _channels(t: torch.Tensor) -> torch.Tensor:
    return t[None, :, None, None]


def norm_group() -> Group:
    """The processes a train-mode BatchNorm reduces over: the replica group
    (the world without a model axis), or the data group for a map that
    every rank of the spatial group holds whole
    (``Bands.replicated_maps``)."""
    bands = active_bands()
    if bands is not None and bands.replicated:
        return bands.mesh.data
    return current_mesh().replica


def chan_combine(n_k: torch.Tensor, mean_k: torch.Tensor, m2_k: torch.Tensor):
    """Chan's combination of the per-channel ``(n, mean, M2)`` of K parts,
    stacked on dim 0: the whole's count, mean and ``M2 = sum M2_k + sum
    n_k (mean_k - mean)^2``."""
    n = n_k.sum(0)
    # the parts' means as offsets from the first's: small terms, no
    # rounding at the mean's own magnitude
    mean = mean_k[0] + (n_k * (mean_k - mean_k[0])).sum(0) / n
    m2 = m2_k.sum(0) + (n_k * (mean_k - mean).square()).sum(0)
    return n, mean, m2


def global_moments(n_l, mean_l: torch.Tensor, m2_l: torch.Tensor, group: Group):
    """The per-channel ``(n, mean, M2)`` over every process of ``group``
    from this rank's: its row of a zero ``(group size, 3, C)`` buffer, one
    ``all_reduce``, then ``chan_combine``. ``n`` comes back as a (C,)
    tensor."""
    buf = mean_l.new_zeros((group.size, 3, mean_l.shape[0]))
    buf[group.rank, 0] = n_l
    buf[group.rank, 1] = mean_l
    buf[group.rank, 2] = m2_l
    return chan_combine(*all_reduce_sum(buf, group).unbind(1))


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm of NCHW ``x`` over the batches of every process.

    Forward: each rank takes its local ``(n, mean, M2)`` per channel in two
    passes, in fp32 (fp64 for fp64 input), and ``global_moments`` combines
    every rank's (one ``all_reduce``, Chan's rule) into the global mean and
    ``M2 = sum M2_k + sum n_k (mean_k - mean)^2``. No ``E[x^2] - E[x]^2`` is
    taken, so a channel whose spread is small beside its mean keeps its
    variance (ROADMAP C1); the output is ``(x - mean) * scale + bias``,
    centred before it is scaled, for the same reason. It is in ``x``'s
    dtype.

    Backward: ``dx = w * invstd / n * (n dy - sum dy - x_hat sum(dy x_hat))``
    with both sums all-reduced; the weight's and bias's gradients are the
    local sums, which the step's gradient all-reduce adds up.

    Also returns the global mean and unbiased variance (no gradient) for
    the running statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, group: Group):
        f = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(f)
        c = x.shape[1]
        n_l = x.numel() // c
        # the corrected two-pass moments: the first mean's rounding comes
        # back as the mean of the deviations
        mean_l = xf.mean(dim=(0, 2, 3))
        d = xf - _channels(mean_l)
        s_d = d.sum(dim=(0, 2, 3))
        mean_l = mean_l + s_d / n_l
        m2_l = d.square().sum(dim=(0, 2, 3)) - s_d.square() / n_l
        n, mean, m2 = global_moments(n_l, mean_l, m2_l, group)
        invstd = torch.rsqrt(m2 / n + eps)
        scale = invstd if weight is None else invstd * weight.to(f)
        out = (xf - _channels(mean)) * _channels(scale)  # centred first, as torch's
        out = (out if bias is None else out + _channels(bias.to(f))).to(x.dtype)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.group = group
        unbiased = m2 / (n - 1).clamp_min(1)
        ctx.mark_non_differentiable(mean, unbiased)
        return out, mean, unbiased

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        f = invstd.dtype
        xhat = (x.to(f) - _channels(mean)) * _channels(invstd)
        dyf = dy.to(f)
        local = torch.stack([dyf.sum(dim=(0, 2, 3)), (dyf * xhat).sum(dim=(0, 2, 3))])
        sum_dy, sum_dy_xhat = all_reduce_sum(local.clone(), ctx.group)
        scale = invstd if weight is None else invstd * weight.to(f)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = _channels(scale / n) * (_channels(n) * dyf - _channels(sum_dy)
                                         - xhat * _channels(sum_dy_xhat))
            dx = dx.to(x.dtype)
        dw = local[1].to(weight.dtype) if ctx.needs_input_grad[1] else None
        db = local[0].to(weight.dtype) if ctx.needs_input_grad[2] else None
        return dx, dw, db, None, None


def batch_norm_train(x: torch.Tensor, weight: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor], running_mean: Optional[torch.Tensor] = None,
                     running_var: Optional[torch.Tensor] = None, momentum: float = 0.1,
                     eps: float = 1e-5) -> torch.Tensor:
    """Train-mode BatchNorm of NCHW ``x`` with the global batch's moments
    (over ``norm_group()``); the running buffers, when given, move by
    ``momentum`` toward the global mean and unbiased variance, as torch's
    do. In a single process this is ``F.batch_norm(..., training=True)``."""
    group = norm_group()
    if group.size == 1:
        return F.batch_norm(x, running_mean, running_var, weight, bias, training=True,
                            momentum=momentum, eps=eps)
    out, mean, var = _GlobalBatchNorm.apply(x, weight, bias, eps, group)
    if running_mean is not None:
        with torch.no_grad():
            running_mean.mul_(1 - momentum).add_(mean.to(running_mean.dtype), alpha=momentum)
            running_var.mul_(1 - momentum).add_(var.to(running_var.dtype), alpha=momentum)
    return out


class GlobalBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode moments are the global batch's
    (``batch_norm_train``); in a single process, or in eval mode, it is
    ``nn.BatchNorm2d`` itself. Its state_dict is ``nn.BatchNorm2d``'s."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or norm_group().size == 1:
            return super().forward(x)
        if self.num_batches_tracked is not None:
            self.num_batches_tracked.add_(1)
        m = self.momentum if self.momentum is not None else \
            1.0 / float(self.num_batches_tracked)
        return batch_norm_train(x, self.weight, self.bias, self.running_mean,
                                self.running_var, m, self.eps)


def batch_norm(features: int, momentum: float = 0.1) -> nn.BatchNorm2d:
    """BatchNorm2d, eps 1e-5; ``momentum`` in torch's convention (MNASNet's
    is 1 - 0.9997, mrfp_tpu/nn/mnasnet.py:27)."""
    return GlobalBatchNorm2d(features, eps=1e-5, momentum=momentum)


def batch_norm_from_stats(bn: nn.BatchNorm2d, y: torch.Tensor, s1: torch.Tensor,
                          s2: torch.Tensor, n: int) -> torch.Tensor:
    """Train-mode ``bn`` on ``y`` with the moments taken from the fp32
    per-channel sums ``s1 = sum(y)``, ``s2 = sum(y^2)`` over ``n`` values
    (a producer's statistics epilogue, ``ops/dot_stats.py``), as the JAX
    package's ``BatchNorm(stats=...)`` does (mrfp_tpu/nn/norms.py:43-69):
    mean = s1/n and the one-pass var = s2/n - mean^2. With more than one
    process the sums and ``n`` are first summed over ``norm_group()`` (one
    differentiable ``all_reduce``), so the moments are the global batch's.
    The running statistics move as torch's do (momentum, unbiased var *
    n/(n-1), ``num_batches_tracked``), in ``bn``'s own buffers; the
    normalisation is fp32, cast to ``y``'s dtype. The gradient reaches
    ``y``, ``s1`` and ``s2``."""
    group = norm_group()
    if group.size > 1:
        s1, s2, n = all_reduce_sum_grad(torch.stack([s1, s2, torch.full_like(s1, n)]), group)
        unbias = n / (n - 1).clamp_min(1)
    else:
        unbias = n / max(n - 1, 1)
    mean = s1 / n
    var = s2 / n - mean * mean
    if bn.track_running_stats:
        with torch.no_grad():
            bn.num_batches_tracked.add_(1)
            m = bn.momentum if bn.momentum is not None else 1.0 / float(bn.num_batches_tracked)
            bn.running_mean.mul_(1 - m).add_(mean, alpha=m)
            bn.running_var.mul_(1 - m).add_(var * unbias, alpha=m)
    inv = torch.rsqrt(var + bn.eps)
    shift = -mean * inv
    if bn.affine:
        inv = inv * bn.weight
        shift = bn.bias - mean * inv
    yf = y.to(torch.promote_types(y.dtype, torch.float32))
    out = yf * inv[None, :, None, None] + shift[None, :, None, None]
    return out.to(y.dtype)


def _band_moments(xs: torch.Tensor, counts, group: Group, cross: bool):
    """The mean and ``M2`` over the last axis of ``xs`` (..., L) whose
    positions are split over ``group``, ``counts`` every rank's L in rank
    order: each rank's own in the corrected two passes, gathered by one
    differentiable ``all_reduce`` (``all_gather_rows``) and combined by
    Chan's rule. ``cross``: ``M2`` is the centred sum of ``d d^T`` (..., c,
    c) over (..., c, L), else of ``d^2``. Returns (mean, M2, the total
    count)."""
    n_l = xs.shape[-1]
    mean_l = xs.mean(-1)
    d = xs - mean_l[..., None]
    s_d = d.sum(-1)
    mean_l = mean_l + s_d / n_l
    if cross:
        m2_l = (torch.matmul(d, d.transpose(-1, -2))
                - s_d[..., :, None] * s_d[..., None, :] / n_l)
    else:
        m2_l = d.square().sum(-1) - s_d.square() / n_l
    return _combine_moments(mean_l, m2_l, counts, group, cross)


def _combine_moments(mean_l: torch.Tensor, m2_l: torch.Tensor, counts, group: Group,
                     cross: bool):
    """Chan's combination over ``group`` of every rank's ``(mean, M2)`` over
    its ``counts[r]`` positions (``_band_moments``' second half): one
    differentiable ``all_reduce``. Returns (mean, M2, the total count)."""
    k = mean_l.numel()
    got = all_gather_rows(torch.cat([mean_l.reshape(-1), m2_l.reshape(-1)])[None], group)
    mean_k = got[:, :k].reshape((-1,) + tuple(mean_l.shape))
    m2_k = got[:, k:].reshape((-1,) + tuple(m2_l.shape))
    n_k = torch.tensor(counts, dtype=mean_l.dtype, device=mean_l.device).reshape(
        (-1,) + (1,) * mean_l.dim())
    total = sum(counts)
    # the ranks' means as offsets from rank 0's, as _GlobalBatchNorm's
    mean = mean_k[0] + (n_k * (mean_k - mean_k[0])).sum(0) / total
    dev = mean_k - mean
    if cross:
        m2 = m2_k.sum(0) + (n_k[..., None] * dev[..., :, None] * dev[..., None, :]).sum(0)
    else:
        m2 = m2_k.sum(0) + (n_k * dev.square()).sum(0)
    return mean, m2, total


class InstanceNorm2d(nn.InstanceNorm2d):
    """``nn.InstanceNorm2d`` (no running statistics; its state_dict) whose
    statistics, in a spatial scope (``core/mesh.py``), are the whole
    image's: each rank's band's per-sample, per-channel ``(n, mean, M2)``,
    in fp32 (fp64 for fp64 input), combined over the spatial group
    (``_band_moments``) into the mean and biased variance. The gradient
    reaches every rank's band through the gathered statistics. In train
    and in eval mode alike; the output is in ``x``'s dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bands = active_bands()
        if bands is None:
            return super().forward(x)
        f = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(f)
        h, w = bands.global_hw(x)
        per_rank = [(hi - lo) * w for lo, hi in bands.every(h)]
        mean, m2, total = _band_moments(xf.flatten(2), per_rank, bands.group, cross=False)
        out = (xf - mean[..., None, None]) * torch.rsqrt(m2 / total + self.eps)[..., None, None]
        if self.affine:
            out = out * _channels(self.weight.to(f)) + _channels(self.bias.to(f))
        return out.to(x.dtype)


def instance_norm_affine(features: int) -> nn.InstanceNorm2d:
    return InstanceNorm2d(features, eps=1e-5, affine=True)


class InstanceWhitening(InstanceNorm2d):
    """iw codes 1 and 2 (network/instance_whitening.py:5-16;
    mrfp_tpu/nn/norms.py:107-118): instance standardisation, non-affine,
    no running statistics. The block that owns it appends its output, the
    map before the ReLU, to the forward's ``w_arr`` list for the whitening
    loss (``collects_map``), whole: ``whole_features`` channels."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, affine=False)
        self.whole_features = features


def collects_map(module: Optional[nn.Module]) -> bool:
    """Whether ``module``'s output goes to the whitening loss's ``w_arr``."""
    return isinstance(module, InstanceWhitening)


def collect_map(w_arr: list, layer: InstanceWhitening, x: torch.Tensor) -> None:
    """Append ``layer``'s output ``x`` to ``w_arr``, whole: under a model
    axis gathered over the model group where ``x`` is this rank's slice
    (the loss and the statistics pass read its C x C covariance)."""
    chans = active_channels()
    w_arr.append(x if chans is None else chans.whole_of(x, layer.whole_features))


# SwitchWhiten's settings, make_iw_layer(5)'s (mrfp_tpu/nn/norms.py:244-246):
# groups of 16 channels, 5 Newton-Schulz steps, eps, running-stat momentum
SW_PERGROUP, SW_T, SW_EPS, SW_MOMENTUM = 16, 5, 1e-5, 0.99


class _GlobalMeanCov(torch.autograd.Function):
    """SwitchWhiten's BW statistics of the grouped fp32 map ``xg`` (n, g,
    c, L) over the batches of the processes of ``group`` (the replica
    group: the world without a model axis; under one, the ranks that hold
    the same channel groups of other samples or rows), the reference's
    ``SyncMeanCov``: the mean (g, c, 1) and the covariance (g, c, c) over
    the N*L positions of every rank, divided by their count.

    Forward: each rank takes its local ``(n, mean, M2)`` per group in the
    corrected two passes (``M2`` the centred sum of ``d d^T``), writes them
    into its row of a zero ``(group size, 1 + g*c + g*c*c)`` buffer, and
    one ``all_reduce`` gives every rank every row; Chan's combination, as
    ``_GlobalBatchNorm``'s, extended to the cross term, gives the global
    mean and ``M2 = sum M2_k + sum n_k (mean_k - mean)(mean_k - mean)^T``.
    No ``E[x x^T] - E[x] E[x]^T`` is taken, so a map whose spread is small
    beside its mean keeps its covariance.

    Backward: every rank's loss reads the global statistics, so their
    gradients are summed over the ranks (one ``all_reduce``), and then
    ``dx = ((G + G^T)(x - mean) + g_mean) / n``."""

    @staticmethod
    def forward(ctx, xg, group: Group):
        b, g, c, positions = xg.shape
        n_l = b * positions
        mean_l = xg.mean(dim=(0, 3))                                        # (g,c)
        d = xg - mean_l[..., None]
        s_d = d.sum(dim=(0, 3))
        mean_l = mean_l + s_d / n_l
        m2_l = (torch.matmul(d, d.transpose(-1, -2)).sum(0)
                - s_d[..., :, None] * s_d[..., None, :] / n_l)              # (g,c,c)
        gc = g * c
        buf = xg.new_zeros((group.size, 1 + gc + gc * c))
        buf[group.rank, 0] = n_l
        buf[group.rank, 1:1 + gc] = mean_l.reshape(-1)
        buf[group.rank, 1 + gc:] = m2_l.reshape(-1)
        all_reduce_sum(buf, group)
        n_k = buf[:, 0]
        mean_k = buf[:, 1:1 + gc].reshape(-1, g, c)
        m2_k = buf[:, 1 + gc:].reshape(-1, g, c, c)
        n = n_k.sum()
        # the ranks' means as offsets from rank 0's, as _GlobalBatchNorm's
        mean = mean_k[0] + (n_k[:, None, None] * (mean_k - mean_k[0])).sum(0) / n
        dev = mean_k - mean
        m2 = m2_k.sum(0) + (n_k[:, None, None, None] * dev[..., :, None]
                            * dev[..., None, :]).sum(0)
        mean = mean[..., None]
        ctx.save_for_backward(xg, mean, n)
        ctx.group = group
        return mean, m2 / n

    @staticmethod
    def backward(ctx, g_mean, g_cov):
        xg, mean, n = ctx.saved_tensors
        grads = all_reduce_sum(torch.cat([g_mean.reshape(-1), g_cov.reshape(-1)]), ctx.group)
        gm = grads[:g_mean.numel()].view_as(g_mean)
        gcov = grads[g_mean.numel():].view_as(g_cov)
        return (torch.matmul(gcov + gcov.transpose(-1, -2), xg - mean) + gm) / n, None


class SwitchWhiten2d(nn.Module):
    """(Sync)SwitchWhiten2d, grouped switchable whitening through
    Newton-Schulz (network/sync_switchwhiten.py:59-223;
    mrfp_tpu/nn/norms.py:119-228), NCHW. The channels split into groups of
    ``SW_PERGROUP``; each group's statistics blend by softmax weights:
    ``sw_type`` 2 = BW + IW, 3 = BW + IW + LN, 5 = BW + IW + BN + IN + LN.
    The blended covariance's inverse square root takes ``SW_T``
    Newton-Schulz steps, ``P = 1.5 P - 0.5 ((P @ P) @ P) @ cov_n``, in that
    association.

    As in JAX, everything runs in fp32 (fp64 for an fp64 model), autocast
    off, and the output is cast back to the input's dtype. The BW
    statistics divide by N*H*W, the IW ones by H*W, the LN variance is
    unbiased. With more than one process the BW statistics are the global
    batch's (``_GlobalMeanCov``), as the JAX package's are under a sharded
    batch. On a band of rows (``core/mesh.py``) the IW and LN statistics
    are the whole image's: each rank's ``(n, mean, M2)`` combine over the
    spatial group (``_band_moments``), divided by the global H*W (IW) and
    C*H*W - 1 (LN); the whitening matrix is then the same on every rank of
    the group, and each rank applies it to its band. In train mode the
    running statistics move as ``running = m * running + (1 - m) * batch``
    (m = ``SW_MOMENTUM``, 0.99: the opposite of BatchNorm's convention),
    without gradient; in eval mode they stand in for the batch's. The
    state_dict keys are the reference's: ``sw_mean_weight``,
    ``sw_var_weight`` (k,), ``weight``, ``bias`` (C,) and the buffers
    ``running_mean`` (g, c, 1) and ``running_cov`` (g, c, c). Under a
    model axis (``_whiten_slices``) ``weights.shard_model`` cuts the
    buffers by group, dim 0, where M divides g (JAX's rule cuts the last
    dim instead: the one placement of the port that differs from JAX's,
    ROADMAP C14, the layout its local compute needs, with the same bytes
    of ``running_cov`` a rank), and leaves them whole where it does not;
    ``num_features`` stays the whole C."""

    def __init__(self, features: int, sw_type: int = 2):
        super().__init__()
        if sw_type not in (2, 3, 5):
            raise ValueError(f"sw_type {sw_type} not in (2,3,5)")
        if features % SW_PERGROUP:
            raise ValueError(f"SwitchWhiten2d: {features} channels are no whole number of "
                             f"groups of {SW_PERGROUP} (the JAX package's reshape fails "
                             f"there too)")
        self.num_features, self.sw_type = features, sw_type
        g, c = features // SW_PERGROUP, SW_PERGROUP
        self.sw_mean_weight = nn.Parameter(torch.ones(sw_type))
        self.sw_var_weight = nn.Parameter(torch.ones(sw_type))
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(g, c, 1))
        self.register_buffer("running_cov", torch.eye(c).repeat(g, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        chans = active_channels()
        with torch.autocast(x.device.type, enabled=False):
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            if chans is None:
                return self._whiten(xf).to(x.dtype)
            return self._whiten_slices(xf, chans).to(x.dtype)

    def _whiten_slices(self, xf: torch.Tensor, chans: Channels) -> torch.Tensor:
        """The layer under a model axis (``core/mesh.py::Channels``). Where
        ``weights.shard_model`` cut the running buffers (M divides the group
        count) this rank whitens its own groups of its own slice: the BW
        statistics over the replica group, the IW ones local, the LN ones
        combined over the model group; the mixing weights enter through
        ``copy_to_group``, so their gradient sums the ranks' groups. Else a
        group straddles two ranks: every rank whitens the whole map alike
        (the running buffers whole, the cut weights gathered) and keeps its
        slice."""
        c = self.num_features
        if self.running_mean.shape[0] * SW_PERGROUP < c:
            if xf.shape[1] == c:
                xf = chans.own(xf)
            return self._whiten(xf, self._mixing(self.sw_mean_weight, chans),
                                self._mixing(self.sw_var_weight, chans), self.weight,
                                self.bias, chans.group)
        sliced = xf.shape[1] != c
        whole = lambda t, n: t if t.shape[0] == n else chans.vector(t)  # noqa: E731
        out = self._whiten(chans.whole_of(xf, c), whole(self.sw_mean_weight, self.sw_type),
                           whole(self.sw_var_weight, self.sw_type), whole(self.weight, c),
                           whole(self.bias, c))
        return chans.own(out) if sliced else out

    def _mixing(self, v: torch.Tensor, chans: Channels) -> torch.Tensor:
        """The whole mixing-weight vector of ``v`` (this rank's shard, cut
        where M divides ``sw_type``, or the whole), as the input of a
        computation each rank of the model group computes its part of."""
        return copy_to_group(v if v.shape[0] == self.sw_type else chans.vector(v), chans.group)

    def _whiten(self, xf: torch.Tensor, mean_weight: Optional[torch.Tensor] = None,
                var_weight: Optional[torch.Tensor] = None,
                weight: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
                across: Optional[Group] = None) -> torch.Tensor:
        """The layer on the fp32 (fp64) map ``xf``, with the layer's own
        parameters unless given. ``across``: the model group, whose ranks
        hold the other channels of each sample (the LN statistics combine
        over it)."""
        mean_weight = self.sw_mean_weight if mean_weight is None else mean_weight
        var_weight = self.sw_var_weight if var_weight is None else var_weight
        weight = self.weight if weight is None else weight
        bias = self.bias if bias is None else bias
        n, ch, h, w = xf.shape
        c = SW_PERGROUP
        g = ch // c
        k = self.sw_type
        xg = xf.reshape(n, g, c, h * w)
        eye = torch.eye(c, dtype=xf.dtype, device=xf.device)
        if self.training:
            replica = current_mesh().replica
            if replica.size > 1:
                mean_bn, cov_bn = _GlobalMeanCov.apply(xg, replica)
            else:
                mean_bn = xg.mean(dim=(0, 3))[..., None]                   # (g,c,1)
                xc = xg - mean_bn
                cov_bn = torch.matmul(xc, xc.transpose(-1, -2)).sum(0) / (n * h * w)
            with torch.no_grad():
                self.running_mean.mul_(SW_MOMENTUM).add_(mean_bn.detach(), alpha=1 - SW_MOMENTUM)
                self.running_cov.mul_(SW_MOMENTUM).add_(cov_bn.detach(), alpha=1 - SW_MOMENTUM)
        else:
            mean_bn, cov_bn = self.running_mean, self.running_cov
        bands = active_bands()
        if bands is None:
            mean_in = xg.mean(dim=3, keepdim=True)                          # (n,g,c,1)
            xin = xg - mean_in
            cov_in = torch.matmul(xin, xin.transpose(-1, -2)) / (h * w)     # (n,g,c,c)
        else:
            full_h = bands.height(h, w)
            per_rank = [(hi - lo) * w for lo, hi in bands.every(full_h)]
            mean_in, m2_in, total = _band_moments(xg, per_rank, bands.group, cross=True)
            mean_in, cov_in = mean_in[..., None], m2_in / total
        mean_bn = mean_bn.expand(n, g, c, 1)
        cov_bn = cov_bn.expand(n, g, c, c)
        if k in (3, 5):
            flat = xf.reshape(n, -1)
            if bands is None and across is None:
                mean_ln = flat.mean(dim=1)
                var_ln = flat.var(dim=1, unbiased=True)
            else:
                if bands is None:
                    mean_ln, m2_ln, total = _band_moments(flat, [flat.shape[1]] * across.size,
                                                          across, cross=False)
                else:
                    mean_ln, m2_ln, total = _band_moments(flat, [ch * v for v in per_rank],
                                                          bands.group, cross=False)
                    if across is not None:
                        mean_ln, m2_ln, total = _combine_moments(
                            mean_ln, m2_ln, [total] * across.size, across, cross=False)
                var_ln = m2_ln / (total - 1)
            mean_ln = mean_ln[:, None, None, None]                          # (n,1,1,1)
            var_ln = var_ln[:, None, None, None] * eye
        mw = torch.softmax(mean_weight, 0)
        vw = torch.softmax(var_weight, 0)
        if k == 2:
            mean = mw[0] * mean_bn + mw[1] * mean_in
            cov = vw[0] * cov_bn + vw[1] * cov_in + SW_EPS * eye
        elif k == 3:
            mean = mw[0] * mean_bn + mw[1] * mean_in + mw[2] * mean_ln
            cov = vw[0] * cov_bn + vw[1] * cov_in + vw[2] * var_ln + SW_EPS * eye
        else:
            var_bn = torch.diag_embed(torch.diagonal(cov_bn, dim1=-2, dim2=-1))
            var_in = torch.diag_embed(torch.diagonal(cov_in, dim1=-2, dim2=-1))
            mean = (mw[0] + mw[2]) * mean_bn + (mw[1] + mw[3]) * mean_in + mw[4] * mean_ln
            cov = (vw[0] * cov_bn + vw[1] * cov_in + vw[0] * var_bn + vw[1] * var_in
                   + vw[4] * var_ln + SW_EPS * eye)
        # Newton-Schulz for cov^(-1/2) (reference :206-215)
        r_tr = 1.0 / torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1)[..., None, None]
        cov_n = cov * r_tr
        p = eye.expand_as(cov)
        for _ in range(SW_T):
            p3 = torch.matmul(torch.matmul(p, p), p)
            p = 1.5 * p - 0.5 * torch.matmul(p3, cov_n)
        wm = p * torch.sqrt(r_tr)                                           # (n,g,c,c)
        out = torch.matmul(wm, xg - mean).reshape(n, ch, h, w)
        return out * _channels(weight) + _channels(bias)


# what make_iw_layer builds for a code other than 0
IW_LAYERS = (InstanceNorm2d, SwitchWhiten2d)


def apply_iw(layer: Optional[nn.Module], x: torch.Tensor, w_arr: Optional[list]) -> torch.Tensor:
    """``layer`` (from ``make_iw_layer``; None is the identity) on ``x``; a
    whitening map goes to ``w_arr`` when one is given
    (mrfp_tpu/nn/norms.py:250-260), whole (``collect_map``). The caller
    must not change the result in place. An iw layer runs in an
    ``isw.whiten`` span, the map's collection included; any other norm
    (a slot's BatchNorm for code 0) runs as it is."""
    if layer is None:
        return x
    if not isinstance(layer, IW_LAYERS):
        return layer(x)
    with span("isw.whiten"):
        x = layer(x)
        if w_arr is not None and collects_map(layer):
            collect_map(w_arr, layer, x)
        return x


def make_iw_layer(iw: int, features: int) -> Optional[nn.Module]:
    """The post-residual layer for an iw code (mrfp_tpu/nn/norms.py:231-247):
    0 -> None, 1/2 -> ``InstanceWhitening``, 3 -> non-affine IN, 4 -> affine
    IN, 5 -> ``SwitchWhiten2d`` (type 2, groups of 16, T 5, eps 1e-5,
    momentum 0.99)."""
    if iw == IW_NONE:
        return None
    if iw in (IW_W1, IW_W2):
        return InstanceWhitening(features)
    if iw == IW_IN:
        return InstanceNorm2d(features, eps=1e-5, affine=False)
    if iw == IW_IN_AFFINE:
        return instance_norm_affine(features)
    if iw == IW_SW:
        return SwitchWhiten2d(features, sw_type=2)
    raise ValueError(f"unknown iw code {iw}")
