"""Serving export, PyTorch port (mrfp_tpu/cli/export.py): a checkpoint
becomes one self-contained artifact, the eval forward frozen by
``torch.export`` with the weights inside (``mrfp_tpu_torch/serving.py``).

    python -m mrfp_tpu_torch.cli.export --device cuda --ckpt runs/<name> \
        --out model.pt2x --height 1024 --width 2048 [--batch 1] \
        [--dtype bfloat16] [--wire uint8] [--check]

    python -m mrfp_tpu_torch.cli.export --device cpu --height 64 --width 64 \
        --check --out /tmp/m.pt2x

``--ckpt`` takes what ``cli.eval --ckpt`` takes (a reference ``.pth``, or a
``step_<N>.pt`` or run directory of the port's ``cli.train`` or
``cli.train_zoo``); without it the weights are seeded random ones.
``--arch`` or ``--wt-layer`` (with ``--use-dsn``, on by default) exports the
zoo's ``DeepV3Plus``, as ``cli.eval`` selects it; its eval forward goes
through the same ``mrfp::resize_bilinear`` op. The artifact maps images of one fixed
shape, NHWC, raw 0..255 (``--wire uint8``: the cast and permute happen
inside the program, as in ``train/evaluator.py``; ``--wire float32`` for
callers that feed floats), to float32 NCHW logits. ``--dtype bfloat16``
runs the forward under autocast, as ``cli.eval --dtype bfloat16`` does;
float32 runs with TF32 off. The three bilinear resizes are the registered
op ``mrfp::resize_bilinear``, so the artifact runs the hand-written kernel
on the card. ``--check`` loads the written file and requires its logits on
a seeded random batch to equal the live forward's bit for bit; on the card
it runs with ``torch.backends.cudnn.deterministic`` set, and says so.
``--device cuda`` exits non-zero when no CUDA device is present; an
artifact exported on one device type loads only on that type.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from mrfp_tpu_torch.cli.eval import add_zoo_args


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="mrfp_tpu_torch serving export")
    p.add_argument("--ckpt", default=None,
                   help="reference .pth, or a step_<N>.pt or run directory of the "
                        "port's cli.train (default: seeded random weights)")
    p.add_argument("--trunk", default="resnet-50")
    p.add_argument("--variant", default="D16")
    add_zoo_args(p)
    p.add_argument("--out", required=True, help="output artifact path (.pt2x)")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16",
                   help="compute dtype inside the artifact (bfloat16: autocast); the "
                        "logits are float32 either way")
    p.add_argument("--wire", choices=["uint8", "float32"], default="uint8",
                   help="input dtype of the artifact's signature")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the artifact's weights live and it runs")
    p.add_argument("--check", action="store_true",
                   help="load the written file and require it to reproduce the live "
                        "forward bit for bit on a seeded random batch")
    return p.parse_args(argv)


class ServingForward(nn.Module):
    """The artifact's function: NHWC images, raw 0..255, in the wire dtype
    -> float32 NCHW logits of the eval-mode ``model``, under a bf16
    autocast where ``autocast`` is set."""

    def __init__(self, model: nn.Module, autocast: bool):
        super().__init__()
        self.model = model.eval()
        self.autocast = autocast

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2).float().contiguous()
        amp = (torch.autocast(x.device.type, dtype=torch.bfloat16) if self.autocast
               else contextlib.nullcontext())
        with amp:
            return self.model(x).float()


def random_batch(shape, wire: str, device) -> torch.Tensor:
    """The check's seeded batch (the JAX export's draw): integers 0..255 for
    the uint8 wire, uniform floats in [0, 255) for the float32 one."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, shape).astype(np.uint8) if wire == "uint8" \
        else rng.uniform(0, 255, shape).astype(np.float32)
    return torch.from_numpy(x).to(device)


def model_manifest(args) -> dict:
    """What the artifact's model is: MRFP's trunk and variant, or the zoo's
    arch or trunk and variant, ``wt_layer`` and DSN head."""
    if args.arch is None and args.wt_layer is None:
        return {"trunk": args.trunk, "variant": args.variant}
    return {"zoo": args.arch or "DeepV3Plus", "trunk": args.trunk, "variant": args.variant,
            "wt_layer": list(args.wt_layer or (0,) * 7), "use_dsn": bool(args.use_dsn)}


def export_program(forward: ServingForward, example: torch.Tensor):
    """``torch.export`` of ``forward`` at ``example``'s fixed shape."""
    with torch.no_grad():
        return torch.export.export(forward, (example,))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Returns ``{"out", "export_s", "mb", "manifest"}`` (and ``"check"``,
    the check's note, with ``--check``)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False "
                         "(use --device cpu to export for the CPU)")
    device = torch.device(args.device)
    if args.dtype == "float32" and device.type == "cuda":
        # fp32 means full fp32: cuDNN convs default to TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    from mrfp_tpu_torch.cli.eval import load_model
    from mrfp_tpu_torch.models.deepv3_zoo import arch_trunk
    from mrfp_tpu_torch.serving import registered_ops, save_exported

    if args.arch:
        args.trunk, args.variant = arch_trunk(args.arch)
    forward = ServingForward(load_model(args, device), autocast=args.dtype == "bfloat16")
    shape = (args.batch, args.height, args.width, 3)
    example = torch.zeros(shape, dtype=getattr(torch, args.wire), device=device)
    t0 = time.perf_counter()
    program = export_program(forward, example)
    export_s = time.perf_counter() - t0
    out_shape = [args.batch, forward.model.final2[0].out_channels, args.height, args.width]
    manifest = {
        "format": "mrfp-torch-export-v1",
        "model": model_manifest(args),
        "input": {"shape": list(shape), "dtype": args.wire, "layout": "NHWC",
                  "pixel_scale": "raw 0..255"},
        "output": {"shape": out_shape, "dtype": "float32", "layout": "NCHW",
                   "semantics": "per-class logits"},
        "compute_dtype": args.dtype,
        "device_type": device.type,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "torch": torch.__version__,
        "ops": registered_ops(program),
        "ckpt": args.ckpt or "random-init",
    }
    save_exported(args.out, program, manifest)
    mb = os.path.getsize(args.out) / 1e6
    # the wire dtype is part of the artifact's contract: say it, not only in
    # the manifest
    logging.info("wrote %s (%s, wire=%s, dtype=%s, device=%s, ops=%s): %.1f MB, exported "
                 "in %.2f s", args.out, shape, args.wire, args.dtype, manifest["device"],
                 manifest["ops"], mb, export_s)
    result = {"out": args.out, "export_s": export_s, "mb": mb, "manifest": manifest}
    if args.check:
        result["check"] = check_artifact(args.out, forward, random_batch(shape, args.wire, device))
        logging.info("check ok: %s", result["check"])
    print(args.out)
    return result


def check_artifact(path: str, forward: ServingForward, x: torch.Tensor) -> str:
    """Load ``path`` and require its logits on ``x`` to equal ``forward``'s
    bit for bit (atol 0); returns what was checked. On the card both run
    with cuDNN deterministic, so that both pick the same algorithms."""
    from mrfp_tpu_torch.serving import load_exported
    fn, manifest = load_exported(path)
    cuda = x.device.type == "cuda"
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = saved or cuda
    try:
        got = fn(x)
        with torch.no_grad():
            want = forward(x)
    finally:
        torch.backends.cudnn.deterministic = saved
    if got.shape != want.shape or got.dtype != torch.float32 or not torch.equal(got, want):
        err = (got.float() - want.float()).abs().max().item() if got.shape == want.shape \
            else float("nan")
        raise AssertionError(f"{path}: the artifact's logits {tuple(got.shape)} {got.dtype} "
                             f"differ from the live forward's {tuple(want.shape)}: max abs "
                             f"difference {err:.3e} (atol 0)")
    return (f"artifact == live forward bit for bit on {manifest['input']['shape']} "
            f"{manifest['input']['dtype']}, compute {manifest['compute_dtype']}"
            + (", cudnn.deterministic" if cuda else ""))


if __name__ == "__main__":
    main()
