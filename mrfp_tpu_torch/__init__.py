"""mrfp_tpu_torch — the MRFP eval path in PyTorch, with CUDA kernels for Hopper.

A port of ``mrfp_tpu`` (JAX on a TPU), which stays beside it as the
reference. This package imports ``torch`` and never ``jax``.

Layout: every tensor inside the port is NCHW-contiguous, PyTorch's habit,
and the hand-written kernels take that layout. The model's public
``forward`` takes NCHW float images and returns NCHW logits; the evaluator
casts the uint8 NHWC wire format to float NCHW on the device.

- ``mrfp_tpu_torch.ops``     bilinear resize and confusion matrix: CUDA
                             kernels (``csrc/``) with plain PyTorch versions
- ``mrfp_tpu_torch.nn``      conv/pool helpers, norms, ResNet, DeepLabV3+ heads
- ``mrfp_tpu_torch.models``  the MRFP eval forward (plain DeepLabV3+)
- ``mrfp_tpu_torch.weights`` state_dict from the JAX tree; reference .pth loader
- ``mrfp_tpu_torch.train``   the streaming-mIoU evaluator
- ``mrfp_tpu_torch.cli``     ``python -m mrfp_tpu_torch.cli.eval``
"""

__version__ = "0.1.0"
