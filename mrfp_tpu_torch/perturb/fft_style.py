"""Frequency-domain batch transforms: HPF / LPF / PHOT, on ``torch.fft``.

A port of mrfp_tpu/perturb/fft_style.py (the reference's dataset
transforms, dataloaders.py:24-79, run on the device). Each takes the NHWC
fp32 batch, before the step's NCHW permute, and transforms every image on
its own with an FFT over all three of H, W and C, as JAX's vmapped
``jnp.fft.fftn`` does; the shifts also run over all three axes:

- HPF zeroes the centred spectrum where ``d^2 <= r^2`` (keeps ``d^2 > r^2``);
- LPF keeps ``d^2 < r^2``, so both drop the ring at exactly ``r^2``;
- PHOT keeps the phase alone: ``ifftn(f / |f|) * 5 * 255``.

The real part of the inverse transform is the output. On the card this is
cuFFT, the JAX package having no Pallas kernel here.
"""

from __future__ import annotations

import torch

_DIMS = (1, 2, 3)  # H, W, C of an NHWC batch


def _dist2(h: int, w: int, device) -> torch.Tensor:
    """(h, w) squared distance from the centred spectrum's origin."""
    y = torch.arange(h, device=device)[:, None] - h // 2
    x = torch.arange(w, device=device)[None, :] - w // 2
    return y * y + x * x


def _masked(images: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    f = torch.fft.fftshift(torch.fft.fftn(images, dim=_DIMS), dim=_DIMS)
    f = f * keep.to(torch.float32)[None, :, :, None]
    out = torch.fft.ifftn(torch.fft.ifftshift(f, dim=_DIMS), dim=_DIMS)
    return out.real.to(torch.float32)


def hpf(images: torch.Tensor, radius: int = 16) -> torch.Tensor:
    """High-pass filter of an NHWC float batch (dataloaders.py:38-39)."""
    h, w = images.shape[1], images.shape[2]
    return _masked(images, _dist2(h, w, images.device) > radius * radius)


def lpf(images: torch.Tensor, radius: int = 16) -> torch.Tensor:
    """Low-pass filter of an NHWC float batch (dataloaders.py:72-73)."""
    h, w = images.shape[1], images.shape[2]
    return _masked(images, _dist2(h, w, images.device) < radius * radius)


def phot(images: torch.Tensor) -> torch.Tensor:
    """Phase-only transform of an NHWC float batch (dataloaders.py:47-56)."""
    f = torch.fft.fftn(images, dim=_DIMS)
    out = torch.fft.ifftn(f / f.abs(), dim=_DIMS)
    return (out * 5 * 255).real.to(torch.float32)


def apply_freq_transform(images: torch.Tensor, kind: str) -> torch.Tensor:
    """``kind`` ("hpf", "lpf" or "phot") of the NHWC fp32 batch ``images``."""
    fns = {"hpf": hpf, "lpf": lpf, "phot": phot}
    if kind not in fns:
        raise ValueError(f"freq_transform must be one of {sorted(fns)}, got {kind!r}")
    return fns[kind](images)
