"""Host-to-device copies that do not make the host wait."""

from __future__ import annotations

import numpy as np
import torch

from mrfp_tpu_torch.utils.profiling import span


def to_device(t, device) -> torch.Tensor:
    """Copy a host tensor (or numpy array) to ``device`` without a sync: on
    CUDA from pinned memory with ``non_blocking=True`` (PyTorch's pinned
    allocator keeps the host buffer alive until the copy has run); on the
    CPU the tensor itself. Each call is an ``h2d`` span that counts the
    ``bytes`` copied and the bytes ``pinned`` on the way, where the source
    was pageable."""
    with span("h2d") as s:
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(t))
        device = torch.device(device)
        size = t.numel() * t.element_size()
        s.add(bytes=size, pinned=0)
        if device.type != "cuda":
            return t.to(device)
        if not t.is_pinned():
            t = t.pin_memory()
            s.add(pinned=size)
        return t.to(device, non_blocking=True)
