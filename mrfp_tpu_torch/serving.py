"""Deployment artifacts (mrfp_tpu/serving.py): an eval forward frozen by
``torch.export`` with its weights inside, and a JSON manifest, in one file
that a serving host loads without the model's code or its checkpoint.

File layout (one file, ``.pt2x``), framed as the JAX package's ``.mrfpx``:

    8 bytes   magic b"MRFPTPT1"
    4 bytes   little-endian manifest length N
    N bytes   UTF-8 JSON manifest (shapes, dtypes, device, torch version,
              the registered ops the program calls)
    rest      the ``torch.export.save`` blob

The magic is this package's own, so neither package's loader takes the
other's file. The program calls the port's kernels as registered ops
(``mrfp::resize_bilinear``, ``ops/library.py``): ``load_exported`` imports
their registration, and nothing else of the port, before it deserialises.
An artifact holds its weights on the device it was exported on, and loads
only where that device type is present: a CUDA artifact never falls back to
the CPU. A float32 artifact runs with TF32 off, whatever the process's
switches say (``full_fp32``).
"""

from __future__ import annotations

import contextlib
import io
import json
import struct
from typing import Callable, Dict, Tuple, Union

import torch

MAGIC = b"MRFPTPT1"


def save_exported(path: str, exported_program, manifest: Dict) -> None:
    """Write a ``torch.export.ExportedProgram`` and its manifest to ``path``."""
    buf = io.BytesIO()
    torch.export.save(exported_program, buf)
    meta = json.dumps(manifest).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(meta)))
        f.write(meta)
        f.write(buf.getbuffer())


def read_manifest(path: str) -> Tuple[Dict, int]:
    """The manifest of the artifact at ``path`` and the offset of its blob;
    raises ValueError for a file that is not this package's artifact."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != MAGIC:
            hint = " (a JAX .mrfpx artifact: load it with mrfp_tpu.serving)" \
                if magic == b"MRFPXPT1" else ""
            raise ValueError(f"{path}: not an mrfp_tpu_torch artifact (magic {magic!r}, "
                             f"expected {MAGIC!r}){hint}")
        (n,) = struct.unpack("<I", f.read(4))
        return json.loads(f.read(n).decode()), 12 + n


def load_exported(path: str, device: Union[str, torch.device, None] = None
                  ) -> Tuple[Callable, Dict]:
    """Load an artifact; returns ``(fn, manifest)``. ``fn(images)`` runs the
    frozen forward where its weights were exported (``cuda:0`` or the CPU):
    images as the manifest's ``input`` says, float32 logits out.

    ``device`` (default: the manifest's device type) is the type the caller
    serves on; it must be the artifact's. A CUDA artifact is refused where
    no CUDA device is available, and a CPU one is not moved to a card."""
    manifest, offset = read_manifest(path)
    kind = manifest["device_type"]
    want = torch.device(device if device is not None else kind).type
    if want != kind:
        raise ValueError(f"{path} was exported for {kind} ({manifest['device']}), not for "
                         f"{want}: export it again with --device {want}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported for cuda ({manifest['device']}), and "
                           f"torch.cuda.is_available() is False")
    import mrfp_tpu_torch.ops  # noqa: F401  (registers the mrfp:: ops the program calls)
    with open(path, "rb") as f:
        f.seek(offset)
        module = torch.export.load(io.BytesIO(f.read())).module()
    precision = full_fp32 if manifest.get("compute_dtype") == "float32" \
        else contextlib.nullcontext

    def fn(images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), precision():
            return module(images)

    return fn, manifest


@contextlib.contextmanager
def full_fp32():
    """TF32 off for cuDNN and matmuls while the block runs (the switches
    are the process's; they are put back after). A float32 artifact runs
    so, as the port's fp32 path does: the program does not carry the
    switches, and cuDNN's default, TF32 convolutions, would move its
    logits far beyond the eval tolerance."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def registered_ops(exported_program) -> list:
    """The ``mrfp::`` ops an exported program calls, by qualified name, its
    sub-graphs (an autocast region) included."""
    return sorted({op_name(n) for n in graph_nodes(exported_program)
                   if op_name(n).startswith("mrfp::")})


def graph_nodes(exported_program) -> list:
    """Every ``call_function`` node of an exported program, in its
    sub-graphs too."""
    return [n for gm in exported_program.graph_module.modules()
            if isinstance(gm, torch.fx.GraphModule)
            for n in gm.graph.nodes if n.op == "call_function"]


def op_name(node) -> str:
    """``namespace::name`` of an op node's target (its overload dropped),
    else the target's string."""
    schema = getattr(node.target, "_schema", None)
    return schema.name if schema is not None else str(node.target)
