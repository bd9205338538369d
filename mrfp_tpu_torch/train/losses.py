"""Losses of the train step (mrfp_tpu/train/losses.py), NCHW logits.

- ``cross_entropy``: torch nn.CrossEntropyLoss(ignore_index=255) with the
  mean over valid pixels (main.py:822), in fp32. One difference from
  ``F.cross_entropy``'s mean: a batch with no valid pixel gives 0, not NaN,
  because the sum is divided by ``max(count, 1)`` as in the JAX package
  (losses.py:39).
- ``batch_class_weights``: the per-batch class weights of
  ``--batch-weighting`` (losses.py:47-64).
- ``relaxed_multihot`` and ``relaxed_cross_entropy``: the border-relaxed CE
  of ``--jointwtborder`` (losses.py:100-181), with the multi-hot target
  built on the device from the int labels;
- ``instance_whitening_loss``: the ISW/IRW penalty of the zoo trainer
  (losses.py:67-97).

Every denominator over the batch (the valid-pixel count, the class
weights' sum, the relaxed CE's weight sum, the class histogram) is summed
over the processes first (``parallel/dist.py``), detached, as the JAX
package takes it over the global batch: each rank's loss is then its local
sum over the global denominator, and the ranks' losses add up to the
global batch's. The whitening loss's batch mean is taken the same way,
over the global sample count. With one process nothing changes.

Under spatial parallelism (``core/mesh.py``) the logits and labels are
this rank's band of rows: the numerators are the band's and the
denominators, summed over the world, the global batch's, since the bands
partition each image's pixels (the class histogram too). The relaxed
target fetches the label rows its windows read from the neighbours
(``parallel/dist.py::rows_from_group``). The whitening loss's per-sample
``f f^T`` is the band's product summed over the spatial group, and each
rank of the group enters a ``1/sp`` share of the per-sample terms, which
every rank of it computes alike.

Under tensor parallelism (``core/mesh.py``) the logits are whole on every
rank of a model group, which hold the same samples: every denominator
sums over the replica group (the ranks that share the model index), so
each model rank computes the same loss and no sample counts M times. The
whitening loss reads each map whole, as ``nn.norms.apply_iw`` hands it
over (gathered over the model group), and its batch count sums over the
replica group.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from mrfp_tpu_torch.core.mesh import active_bands, current_mesh
from mrfp_tpu_torch.parallel.dist import (Group, all_reduce_sum, all_reduce_sum_grad,
                                          rows_from_group)
from mrfp_tpu_torch.utils.profiling import span


def _batch() -> Group:
    """The ranks whose samples and bands make up the global batch: the
    replica group (the world without a model axis)."""
    return current_mesh().replica


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = 255,
                  class_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over valid pixels. ``logits`` (N, C, ...) in any float dtype
    (upcast to fp32; fp64 stays fp64), ``labels`` (N, ...) integer. With
    ``class_weights`` (C,), torch's weighted mean: each pixel's NLL scaled
    by w[y], divided by the sum of w[y] over valid pixels (floored at
    1e-8)."""
    labels = labels.long()
    valid = labels != ignore_index
    lf = logits.to(torch.promote_types(logits.dtype, torch.float32))
    if class_weights is not None:
        class_weights = class_weights.to(lf.dtype)
    total = F.cross_entropy(lf, labels, weight=class_weights,
                            ignore_index=ignore_index, reduction="sum")
    if class_weights is None:
        return total / all_reduce_sum(valid.sum(), _batch()).clamp_min(1)
    w = class_weights[torch.where(valid, labels, 0)] * valid
    return total / all_reduce_sum(w.sum().detach(), _batch()).clamp_min(1e-8)


def batch_class_weights(labels: torch.Tensor, num_classes: int,
                        ignore_index: int = 255) -> torch.Tensor:
    """(C,) fp32 weights from the batch's label histogram: with ``hist`` the
    class counts over valid pixels normalised to sum 1,
    ``w = (hist > 0) * (1 - hist) + 1`` (the JAX package's upper bound of
    1), so rare present classes approach 2 and absent ones get 1. Labels
    outside [0, C) are not counted. The counts are a scatter-add, so the
    device is never waited on."""
    labels = labels.long().reshape(-1)
    counted = (labels != ignore_index) & (labels >= 0) & (labels < num_classes)
    bins = torch.where(counted, labels, num_classes)
    counts = torch.zeros(num_classes + 1, dtype=torch.long, device=labels.device)
    counts.scatter_add_(0, bins, torch.ones_like(bins))
    hist = all_reduce_sum(counts, _batch())[:num_classes].float()
    hist = hist / hist.sum().clamp_min(1.0)
    return (hist > 0).float() * (1.0 - hist) + 1.0


def _label_rows(a: torch.Tensor, extra: int, fill: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows of the (N, H, W) class map ``a`` widened by ``extra`` rows
    above and below, ``fill`` outside the image, and which of them lie in
    it. On a band (``core/mesh.py``) the rows come from their owners, as
    fp32 (exact for class ids up to 2^24) cast back."""
    bands = active_bands()
    rows = a.shape[-2]
    if bands is None:
        g0, h = 0, rows
        ext = F.pad(a, (0, 0, extra, extra), value=fill)
    else:
        h = bands.height(rows, a.shape[-1])
        g0 = bands.rows(h)[0]
        every = bands.every(h)
        ext = rows_from_group(a[:, None].float(), h, [lo - extra for lo, _ in every],
                              [hi + extra for _, hi in every], bands.group,
                              float(fill))[:, 0].long()
    g = torch.arange(g0 - extra, g0 + rows + extra, device=a.device)
    return ext, (g >= 0) & (g < h)


def relaxed_multihot(labels: torch.Tensor, num_classes: int, ignore_index: int,
                     border: int, reduce_now: bool,
                     strict_classes: Optional[Sequence[int]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The border-relaxed multi-hot target of (N, H, W) int ``labels``: a
    pixel allows every class present within the (2b+1)^2 window around it,
    where b is ``border``, or ``border // 2`` once ``reduce_now``; pixels of
    ``strict_classes`` keep their exact one-hot; once ``reduce_now``, pixels
    on a 4-neighbour label boundary weigh 2. Ignore pixels count as class C
    and the window pads with it.

    Returns ``(allowed, weight)``: (N, C+1, H, W) bool (channel C is
    ignore) and (N, H, W) fp32 in {1, 2}. ``reduce_now`` is a host bool,
    so only the chosen window is built (the JAX package builds both and
    selects, one compiled program for the whole schedule). On a band of
    rows the target is the band's rows of the whole map's: the window and
    the boundary read the neighbours' label rows."""
    c = num_classes
    a = torch.where(labels == ignore_index, c, labels.long())
    b = border // 2 if reduce_now else border
    extra = max(b, int(reduce_now))
    ext, inside = _label_rows(a, extra, c)
    h, w = a.shape[-2], a.shape[-1]
    ap = F.pad(ext[:, extra - b:extra + h + b], (b, b), value=c)
    allowed = torch.zeros((a.shape[0], c + 1, h, w), dtype=torch.bool, device=a.device)
    for i in range(2 * b + 1):
        for j in range(2 * b + 1):
            allowed.scatter_(1, ap[:, None, i:i + h, j:j + w], True)
    if strict_classes:
        strict = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
        for k in strict_classes:  # compared on the device: no host copy, no sync
            strict |= a == k
        exact = torch.zeros_like(allowed).scatter_(1, a[:, None], True)
        allowed = torch.where(strict[:, None], exact, allowed)
    weight = torch.ones(a.shape, dtype=torch.float32, device=a.device)
    if reduce_now:
        # a row differs from the next only inside the image
        boundary = torch.zeros(ext.shape, dtype=torch.bool, device=a.device)
        dh = (ext[:, 1:, :] != ext[:, :-1, :]) & (inside[1:] & inside[:-1])[:, None]
        boundary[:, 1:, :] |= dh
        boundary[:, :-1, :] |= dh
        boundary = boundary[:, extra:extra + h]
        dw = a[:, :, 1:] != a[:, :, :-1]
        boundary[:, :, 1:] |= dw
        boundary[:, :, :-1] |= dw
        weight = torch.where(boundary, 2.0, weight)
    return allowed, weight


def relaxed_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
                          ignore_index: int, border: int, reduce_now: bool,
                          strict_classes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Border-relaxed CE: per valid pixel ``-log P(any allowed class)``, as a
    masked-logsumexp difference in fp32, each pixel scaled by its weight and
    the sum divided by ``max(sum of weights, 1)``. ``logits`` (N, C, H, W),
    taken in fp32 (fp64 logits in fp64). Equals ``cross_entropy`` at
    ``border=0``."""
    labels = labels.long()
    valid = labels != ignore_index
    allowed, weight = relaxed_multihot(labels, num_classes, ignore_index, border,
                                       reduce_now, strict_classes)
    lf = logits.to(torch.promote_types(logits.dtype, torch.float32))
    lse = torch.logsumexp(lf, dim=1)
    lse_allowed = torch.logsumexp(lf.masked_fill(~allowed[:, :num_classes], float("-inf")),
                                  dim=1)
    w = torch.where(valid, weight, 0.0)
    nll = torch.where(valid, lse - lse_allowed, 0.0)
    return (nll * w).sum() / all_reduce_sum(w.sum().detach(), _batch()).clamp_min(1.0)


def instance_whitening_loss(w_arr: Sequence[torch.Tensor],
                            mask_matrices: Optional[Sequence] = None,
                            margin: Union[float, Sequence[float]] = 0.0,
                            num_remove_cov: Optional[Sequence[float]] = None) -> torch.Tensor:
    """The ISW/IRW covariance penalty over the collected NCHW whitening
    maps (mrfp_tpu/train/losses.py:67-97): per map and sample,
    ``f_cor = f f^T / (HW - 1) + 1e-5 I`` over its (C, HW) view, the masked
    entries' absolute sum less the margin over the count of removed
    entries, clamped at 0, averaged over the batch (the global batch: with
    more than one process each rank's sum over the ranks' sample count);
    summed over the maps.
    ``mask_matrices`` (C x C arrays or tensors; None: the upper triangle),
    ``num_remove_cov`` (None: the mask's sum) and ``margin`` (a scalar, or
    one per map: with ``relax_denom`` > 0 each layer has its own) are per
    map. The per-sample product is ``torch.bmm`` in fp32 (fp64 for fp64
    maps) with autocast off; TF32 stays off as torch's matmul default
    leaves it.

    On bands of rows (``core/mesh.py``) each map is this rank's band: the
    product is summed over the spatial group (differentiable) and divided
    by the global H*W - 1; the batch mean's count is the data group's
    samples times ``sp``, since every rank of a spatial group computes
    the same terms, so that the replica group's sum of the ranks' losses,
    and of their gradients, takes each sample once. Under a model axis
    the maps are whole (``nn.norms.apply_iw`` gathers them), every rank of
    a model group computes the same loss, and the count sums over the
    replica group."""
    with span("isw.loss"):
        batch = _batch()
        bands = active_bands()
        total = count = None
        for i, w in enumerate(w_arr):
            n, c, h, wd = w.shape
            if bands is not None:
                h = bands.height(h, wd)
            with torch.autocast(w.device.type, enabled=False):
                f = w.to(torch.promote_types(w.dtype, torch.float32)).reshape(n, c, -1)
                prod = torch.bmm(f, f.transpose(1, 2))
                if bands is not None:
                    prod = all_reduce_sum_grad(prod, bands.group)
                cov = prod / (h * wd - 1)
            cov = cov + 1e-5 * torch.eye(c, dtype=cov.dtype, device=w.device)
            if mask_matrices is not None:
                mask = torch.as_tensor(mask_matrices[i], dtype=cov.dtype, device=w.device)
            else:
                mask = torch.triu(torch.ones((c, c), dtype=cov.dtype, device=w.device), 1)
            nrc = num_remove_cov[i] if num_remove_cov is not None else mask.sum()
            m = margin[i] if isinstance(margin, (list, tuple)) else margin
            off = (cov * mask).abs().sum(dim=(1, 2)) - m
            term = (off / nrc).clamp_min(0.0)
            if batch.size == 1:
                term = term.mean()
            else:
                if count is None:  # every map has the batch's samples
                    count = torch.full((), n, dtype=torch.int64, device=w.device)
                    if bands is None:
                        count = all_reduce_sum(count, batch)
                    else:
                        count = all_reduce_sum(count, bands.mesh.data) * bands.sp
                term = term.sum() / count
            total = term if total is None else total + term
        if total is None:
            return torch.zeros((), dtype=torch.float32)
        return total
