"""Gradient reversal (deepv3.py:128-149; mrfp_tpu/nn/grad_reversal.py):
the identity forward, ``-alpha * grad`` backward. Defined but unused in the
reference forward; kept for capability parity."""

from __future__ import annotations

import torch


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha: float):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.alpha * g, None


def grad_reverse(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """``x`` unchanged; the gradient that reaches ``x`` is ``-alpha`` times
    the one that arrives."""
    return _GradReverse.apply(x, alpha)
