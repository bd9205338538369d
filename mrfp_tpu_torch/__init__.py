"""mrfp_tpu_torch — MRFP in PyTorch, with CUDA kernels for Hopper.

A port of ``mrfp_tpu`` (JAX on a TPU), which stays beside it as the
reference. This package imports ``torch`` and never ``jax``.

Layout: every tensor inside the port is NCHW-contiguous, PyTorch's habit,
and the hand-written kernels take that layout. The model's public
``forward`` takes NCHW float images and returns NCHW logits; the evaluator
casts the uint8 NHWC wire format to float NCHW on the device.

- ``mrfp_tpu_torch.ops``     bilinear and nearest resizes (forward and
                             backward), the confusion matrix and the
                             fused-statistics kernels: CUDA kernels
                             (``csrc/``) with plain PyTorch versions; the
                             bilinear forward as the registered op
                             ``mrfp::resize_bilinear``
- ``mrfp_tpu_torch.nn``      conv/pool helpers, norms, ResNet, DeepLabV3+ heads
- ``mrfp_tpu_torch.perturb`` NP+ and the frozen random OC branch
- ``mrfp_tpu_torch.models``  the MRFP+ forward: eval, and train with the gates
- ``mrfp_tpu_torch.weights`` state_dict from the JAX tree; reference .pth loader
- ``mrfp_tpu_torch.core``    the config tree and the per-step random streams
- ``mrfp_tpu_torch.data``    synthetic data and the training loader
- ``mrfp_tpu_torch.train``   loss, SGD state, the step, the loop,
                             checkpoints, the streaming-mIoU evaluator
- ``mrfp_tpu_torch.serving`` the ``torch.export`` artifact of the eval forward
- ``mrfp_tpu_torch.metrics`` the reference-named metrics surface
- ``mrfp_tpu_torch.utils``   watchdog, metric sinks (JSONL, TensorBoard
                             events), meters, spans and the trace exporter
- ``mrfp_tpu_torch.cli``     ``python -m mrfp_tpu_torch.cli.`` ``eval``,
                             ``train``, ``export``, ``visualize``,
                             ``supervise``, ``bench_input``, ``shape_census``
"""

__version__ = "0.1.0"
