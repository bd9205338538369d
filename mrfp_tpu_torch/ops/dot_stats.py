"""The fused 1x1-conv + BatchNorm-statistics product and its opt-in switch
(mrfp_tpu/ops/pallas_dot_stats.py).

``dot_with_stats(x, w)`` returns ``(y, s1, s2)``: ``y = w @ x`` per sample
of NCHW ``x`` (N, Cin, H, W) with ``w`` (Cout, Cin), in ``x``'s dtype, and
the fp32 per-channel sums of the rounded ``y`` and of its square over
(N, H, W). A train-mode BatchNorm takes its moments from those sums
(``nn.norms.batch_norm_from_stats``) instead of reading ``y`` again.

It is a ``torch.autograd.Function``. The forward is the hand-written kernel
on a CUDA tensor and its plain version on a CPU tensor (``ops/cuda_dot_stats.py``),
by the rule of ``ops.resize._use_kernel``. The backward is the JAX
package's ``_bwd``: the sums' cotangents fold into ``dY = dy + ds1 + 2 y ds2``
(fp32), then ``dx = dY @ w`` and ``dw = dY @ x^T`` are plain products on
either device, in the operands' dtype with fp32 accumulation.

Under data parallelism the sums are this process's: the BN sums them over
the processes (``nn.norms.batch_norm_from_stats``) before it uses them; the
kernel is the same.

``bn_stats_fusion(impl)`` is the switch the train step enters, with its own
``impl``, when ``cfg.train.fuse_bn_stats`` is set, so ``impl="plain"``
reaches the fused 1x1s as it reaches the resizes.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch

from mrfp_tpu_torch.ops import cuda_dot_stats
from mrfp_tpu_torch.ops.resize import _use_kernel, check_impl

FUSION_OFF = object()
_FUSION = contextvars.ContextVar("mrfp_torch_bn_stats_fusion", default=FUSION_OFF)


@contextlib.contextmanager
def bn_stats_fusion(impl: Optional[str] = None):
    """While active, train-mode bottleneck 1x1 conv + BN pairs go through
    ``dot_with_stats`` with ``impl``."""
    check_impl(impl)
    token = _FUSION.set(impl)
    try:
        yield
    finally:
        _FUSION.reset(token)


def bn_stats_fusion_impl():
    """The ``impl`` the active fusion was entered with, or ``FUSION_OFF``."""
    return _FUSION.get()


class DotWithStats(torch.autograd.Function):
    """Kernel (or plain) forward; the JAX package's backward."""

    @staticmethod
    def forward(ctx, x, w, kernel: bool):
        if kernel:
            y, s1, s2 = cuda_dot_stats.dot_with_stats_cuda(x, w)
        else:
            with torch.autocast(x.device.type, enabled=False):
                y, s1, s2 = cuda_dot_stats.dot_with_stats_plain(x, w)
        ctx.save_for_backward(x, w, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, ds1, ds2):
        x, w, y = ctx.saved_tensors
        n, cin, h, wd = x.shape
        cout = w.shape[0]
        f = torch.promote_types(x.dtype, torch.float32)
        with torch.autocast(x.device.type, enabled=False):
            d = (dy.to(f) + ds1.to(f)[None, :, None, None]
                 + 2.0 * y.to(f) * ds2.to(f)[None, :, None, None])
            d = d.to(x.dtype).reshape(n, cout, h * wd)
            dx = torch.matmul(w.t(), d).reshape(n, cin, h, wd)
            dw = torch.einsum("nmj,nkj->mk", d, x.reshape(n, cin, h * wd))
        return dx, dw.to(w.dtype), None


def dot_with_stats(x: torch.Tensor, w: torch.Tensor, impl: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, s1, s2)`` for NCHW ``x`` and (Cout, Cin) ``w`` of one dtype.
    ``impl="plain"`` forces the plain version (kernel-vs-plain checks)."""
    return DotWithStats.apply(x, w, _use_kernel(x, impl))
