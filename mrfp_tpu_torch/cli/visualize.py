"""Qualitative prediction dumps, PyTorch port (mrfp_tpu/cli/visualize.py):
image / colourised prediction / colourised ground truth triplets as PNGs
(the decode_segmap usage of utils_main.py:28-63).

    python -m mrfp_tpu_torch.cli.visualize --device cuda --ckpt runs/<name> \
        --data-root /data --domain cityscapes --out ./viz --n 8

    python -m mrfp_tpu_torch.cli.visualize --device cpu --synthetic --n 2

``--ckpt`` takes what ``cli.eval --ckpt`` takes; without it the weights are
seeded random ones. ``--dtype bfloat16`` runs the forward under autocast.
``--device cuda`` exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import contextlib
import os
from typing import Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="mrfp_tpu_torch prediction dumps")
    p.add_argument("--ckpt", default=None,
                   help="reference .pth, or a step_<N>.pt or run directory of the "
                        "port's cli.train (default: seeded random weights)")
    p.add_argument("--data-root", default="/data")
    p.add_argument("--domain", default="cityscapes")
    p.add_argument("--out", default="./viz")
    p.add_argument("--n", type=int, default=8)
    p.add_argument("--trunk", default="resnet-50")
    p.add_argument("--variant", default="D16")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-hw", type=int, nargs=2, default=(256, 512),
                   metavar=("H", "W"), help="H W of the synthetic images")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Writes ``NNN_image.png``, ``NNN_pred.png`` and ``NNN_gt.png`` per
    image into ``--out``; returns the number of triplets."""
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False "
                         "(use --device cpu to run the plain versions on the CPU)")
    device = torch.device(args.device)
    if args.dtype == "float32" and device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    from PIL import Image

    from mrfp_tpu_torch.cli.eval import load_model
    from mrfp_tpu_torch.data.label_maps import decode_segmap

    model = load_model(args, device)
    if args.synthetic:
        from mrfp_tpu_torch.data import SyntheticDataset
        ds = SyntheticDataset(length=args.n, hw=tuple(args.synthetic_hw))
    else:
        from mrfp_tpu_torch.data.datasets import DATASETS, VAL_SPLITS, domain_root
        ds = DATASETS[args.domain](root=domain_root(args.data_root, args.domain),
                                   split=VAL_SPLITS[args.domain], train=False)
    amp = (torch.autocast(device.type, dtype=torch.bfloat16) if args.dtype == "bfloat16"
           else contextlib.nullcontext())
    os.makedirs(args.out, exist_ok=True)
    n = min(args.n, len(ds))
    for i in range(n):
        sample = ds[i]
        img = np.asarray(sample["image"], np.float32)
        lbl = np.asarray(sample["label"], np.int32)
        x = torch.from_numpy(img).to(device).permute(2, 0, 1)[None].contiguous()
        with torch.inference_mode(), amp:
            pred = model(x).argmax(dim=1)[0].cpu().numpy()
        Image.fromarray(img.astype(np.uint8)).save(os.path.join(args.out, f"{i:03d}_image.png"))
        Image.fromarray(decode_segmap(pred.astype(np.uint8))).save(
            os.path.join(args.out, f"{i:03d}_pred.png"))
        Image.fromarray(decode_segmap(lbl.astype(np.uint8))).save(
            os.path.join(args.out, f"{i:03d}_gt.png"))
    print(f"wrote {n * 3} PNGs to {args.out}")
    return n


if __name__ == "__main__":
    main()
