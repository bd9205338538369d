"""The NP+ apply as one kernel (mrfp_tpu/ops/pallas_np_plus.py), NCHW.

``np_plus_apply(x, alpha, shift)`` computes ``x * alpha + shift`` with
(N, C, 1, 1) fp32 coefficients: the hand-written kernel on a CUDA tensor and
its plain version on a CPU tensor (``ops/cuda_np_plus.py``).
``normalization_perturbation_plus_fused`` is NP+ with that apply, the
counterpart of ``normalization_perturbation_plus_pallas``. As in the JAX
package it is a forward-only alternative: the train path's NP+
(``perturb/np_plus.py``) stays on plain torch ops, as ``np_plus_auto``
keeps the jnp form.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from mrfp_tpu_torch.ops import cuda_np_plus
from mrfp_tpu_torch.ops.resize import _use_kernel


def np_plus_apply(x: torch.Tensor, alpha: torch.Tensor, shift: torch.Tensor,
                  impl: Optional[str] = None) -> torch.Tensor:
    """``x * alpha + shift`` in fp32, rounded once to ``x.dtype``."""
    if _use_kernel(x, impl):
        return cuda_np_plus.np_plus_apply_cuda(x, alpha, shift)
    return cuda_np_plus.np_plus_apply_plain(x, alpha, shift)


def normalization_perturbation_plus_fused(noise: Union[torch.Generator,
                                                       Tuple[torch.Tensor, torch.Tensor]],
                                          feat: torch.Tensor, std: float = 0.75,
                                          scale_mult: float = 1.5,
                                          impl: Optional[str] = None) -> torch.Tensor:
    """NP+ on NCHW ``feat``: ``alpha * feat + (beta - alpha) * feat_mean``,
    with the statistics in fp32 and the apply in one kernel. ``noise`` is a
    generator to draw ``(alpha, beta_noise)`` from, or the injected pair of
    shape (B, C, 1, 1) (``perturb/np_plus.py`` documents both)."""
    # the statistics are the perturbation layer's; imported here so that this
    # primitive does not depend on model code at load (as pallas_np_plus.py)
    from mrfp_tpu_torch.perturb.np_plus import np_plus_coefficients
    alpha, beta, feat_mean = np_plus_coefficients(feat.float(), noise, std, scale_mult)
    return np_plus_apply(feat, alpha, (beta - alpha) * feat_mean, impl)
