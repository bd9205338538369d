"""The port's kernels as operators registered with ``torch.library``.

``mrfp::resize_bilinear(Tensor x, int out_h, int out_w, int full_h=0,
int full_oh=0, int row0=0) -> Tensor`` is the bilinear align_corners
forward (``ops/resize.py``). With ``full_h`` > 0 it computes the output
rows ``[row0, row0 + out_h)`` of the global ``full_h -> full_oh`` resize
from ``x``, the input rows they read (a band under spatial parallelism);
with the defaults, the whole resize. Registered, the kernel
is one node of a traced graph: ``torch.export`` records the op, where it
would otherwise trace the plain version's gathers or call the ctypes
wrapper on a fake tensor, and an exported program (``serving.py``) runs the
hand-written kernel when it is loaded on the card.

- On CUDA tensors: the kernel (``cuda_resize.resize_bilinear_cuda``); it
  counts ``LAUNCHES["resize_bilinear"]`` and raises where it cannot launch.
- On CPU tensors: the plain version.
- Under tracing (fake tensors): the output's shape alone. The fake
  implementation also serves the meta device, and a meta tensor outside a
  trace takes the kernel's route, as every tensor off the CPU does (the
  tests stand a meta tensor in for a card): it gets the kernel or an error,
  never a shape-only result.

The tap tables are built here, inside the real implementations, so a trace
never builds one: a table made under a fake mode would be a fake tensor,
cached for every later live call at that shape. The op sees the dtype that
reaches it: no autocast rule is registered, as none is for the live call.

Only this op is registered. The nearest resize, the bilinear backward and
the other kernels run in no exported graph yet; an exported train or OC
path would register them the same way.

``load_exported`` imports this module (through ``mrfp_tpu_torch.ops``)
before it deserialises an artifact: a program that names ``mrfp::`` ops
loads only where they are registered.
"""

from __future__ import annotations

import torch

from mrfp_tpu_torch.ops import cuda_resize
from mrfp_tpu_torch.ops.resize import bilinear_taps

def _taps(x: torch.Tensor, out_h: int, out_w: int, full_h: int, full_oh: int, row0: int):
    ty = (bilinear_taps(x.shape[2], out_h, x.device) if full_h <= 0 else
          bilinear_taps(full_h, full_oh, x.device, (row0, row0 + out_h)))
    return ty, bilinear_taps(x.shape[3], out_w, x.device)


def _kernel(x: torch.Tensor, out_h: int, out_w: int, full_h: int, full_oh: int,
            row0: int) -> torch.Tensor:
    spec_y = None if full_h <= 0 else (full_h, full_oh, (row0, row0 + out_h))
    return cuda_resize.resize_bilinear_cuda(
        x, *_taps(x, out_h, out_w, full_h, full_oh, row0), spec_y)


@torch.library.custom_op("mrfp::resize_bilinear", mutates_args=(), device_types="cuda")
def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int, full_h: int = 0,
                    full_oh: int = 0, row0: int = 0) -> torch.Tensor:
    """Bilinear align_corners resize of NCHW ``x`` to (out_h, out_w), or to
    the band ``[row0, row0 + out_h)`` of a ``full_h -> full_oh`` resize: the
    kernel (``csrc/resize_bilinear.cu``)."""
    return _kernel(x, out_h, out_w, full_h, full_oh, row0)


@resize_bilinear.register_kernel("cpu")
def _resize_bilinear_cpu(x: torch.Tensor, out_h: int, out_w: int, full_h: int = 0,
                         full_oh: int = 0, row0: int = 0) -> torch.Tensor:
    return cuda_resize.resize_bilinear_plain(x, *_taps(x, out_h, out_w, full_h, full_oh, row0))


@resize_bilinear.register_fake
def _resize_bilinear_fake(x: torch.Tensor, out_h: int, out_w: int, full_h: int = 0,
                          full_oh: int = 0, row0: int = 0) -> torch.Tensor:
    if torch._guards.detect_fake_mode(x) is None:  # a meta tensor, not a trace
        return _kernel(x, out_h, out_w, full_h, full_oh, row0)
    return x.new_empty((x.shape[0], x.shape[1], out_h, out_w))
