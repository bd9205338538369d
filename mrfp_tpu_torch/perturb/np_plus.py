"""NP+ — Normalization Perturbation Plus (deepv3.py:268-277), NCHW.

A port of mrfp_tpu/perturb/np_plus.py, as the JAX main path runs it (the
jnp form; its Pallas twin is unrouted there). Each sample's per-channel
spatial mean is rescaled by alpha ~ N(1, std) and shifted toward beta, whose
spread follows how far the channel means differ across the batch:

  feat_mean  = mean over (H, W)                        (B, C, 1, 1)
  mean_diff  = std over the batch of feat_mean, ddof 1 (1, C, 1, 1)
  mean_scale = mean_diff / max(mean_diff) * scale_mult
  beta       = 1 + beta_noise * mean_scale,  beta_noise ~ N(0, std)
  out        = alpha * feat - alpha * feat_mean + beta * feat_mean

in fp32, cast back to the input's dtype.

With more than one process (``parallel/dist.py``) the batch is the global
one, as under the JAX package's sharded batch: ``mean_diff`` is the std of
every rank's per-sample means, gathered by one differentiable
``all_reduce``, and the per-sample draws are drawn for the global batch
from the shared stream, each rank taking its own rows, so a run of N ranks
draws what one process draws on the same global batch.

Under spatial parallelism (``core/mesh.py``) the batch is the data group's
and each rank holds a band of rows: the per-sample means are a sum over the
band and the spatial group (differentiable) over the global H x W,
``mean_diff`` gathers over the data group, and the draws take the data
rank's rows, so the ranks of a spatial group apply the same alpha and beta.

Under tensor parallelism (``core/mesh.py::channels``) the map is this
rank's slice of the channels: the means and their spread over the batch
are per channel, the spread's maximum over the channels is taken on the
whole vector (gathered, its backward summed over the model group), and
the draws are drawn for every channel and sliced, so the ranks of a model
group apply one process's alpha and beta to their channels.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from mrfp_tpu_torch.core.mesh import active_bands, active_channels, current_mesh
from mrfp_tpu_torch.parallel.dist import all_gather_rows, all_reduce_sum_grad
from mrfp_tpu_torch.utils.profiling import span
from mrfp_tpu_torch.utils.transfer import to_device

Draws = Tuple[torch.Tensor, torch.Tensor]


def draw_np_plus(generator: torch.Generator, batch: int, channels: int,
                 device, std: float = 0.75) -> Draws:
    """(alpha, beta_noise), each (B, C, 1, 1) fp32, for this rank's ``batch``
    samples and ``channels``: drawn on the CPU from ``generator`` for the
    global batch of ``batch`` times the data axis's size (and, in a channel
    scope, for the whole map's channels), this rank's rows (and channels)
    copied to ``device`` without a sync."""
    mesh, chans = current_mesh(), active_channels()
    c0, c1, c = (0, channels, channels) if chans is None else chans.span(channels)
    shape = (batch * mesh.dp, c, 1, 1)
    with span("np_plus.draw"):
        alpha = 1.0 + std * torch.randn(shape, generator=generator)
        beta_noise = std * torch.randn(shape, generator=generator)
        rows = slice(mesh.data_index * batch, (mesh.data_index + 1) * batch)
        return (to_device(alpha[rows, c0:c1], device),
                to_device(beta_noise[rows, c0:c1], device))


def np_plus_coefficients(f32: torch.Tensor, noise: Union[torch.Generator, Draws],
                         std: float = 0.75, scale_mult: float = 1.5):
    """``(alpha, beta, feat_mean)``, each (B, C, 1, 1), for the float32 (or
    float64) NCHW map ``f32``; ``noise`` as for ``np_plus`` (injected draws
    are this rank's rows, and of the whole map's channels or this rank's)."""
    bands, chans = active_bands(), active_channels()
    if bands is None:
        feat_mean = f32.mean(dim=(2, 3), keepdim=True)
    else:
        h, w = bands.global_hw(f32)
        feat_mean = all_reduce_sum_grad(f32.sum(dim=(2, 3), keepdim=True),
                                        bands.group) / (h * w)
    # unbiased, as the reference, over the global batch's means
    mean_diff = all_gather_rows(feat_mean, current_mesh().data).std(dim=0, keepdim=True)
    peak = (mean_diff if chans is None else chans.shared(mean_diff)).max()
    mean_scale = mean_diff / peak * scale_mult
    if isinstance(noise, torch.Generator):
        noise = draw_np_plus(noise, f32.shape[0], f32.shape[1], f32.device, std)
    alpha, beta_noise = noise
    if chans is not None and alpha.shape[1] != f32.shape[1]:  # injected whole-map draws
        c0, c1, _ = chans.span(f32.shape[1])
        alpha, beta_noise = alpha[:, c0:c1], beta_noise[:, c0:c1]
    return alpha, 1.0 + beta_noise * mean_scale, feat_mean


def np_plus(feat: torch.Tensor, noise: Union[torch.Generator, Draws],
            std: float = 0.75, scale_mult: float = 1.5) -> torch.Tensor:
    """Apply NP+ to NCHW ``feat``. ``noise`` is a generator to draw from,
    or injected ``(alpha, beta_noise)`` of shape (B, C, 1, 1), the way the
    parity tests drive it (tests/torch_oracle.py::np_plus_injected)."""
    with span("np_plus", channels=feat.shape[1]):
        f32 = feat.to(torch.promote_types(feat.dtype, torch.float32))
        alpha, beta, feat_mean = np_plus_coefficients(f32, noise, std, scale_mult)
        out = alpha * f32 - alpha * feat_mean + beta * feat_mean
        return out.to(feat.dtype)
