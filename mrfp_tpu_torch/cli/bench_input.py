"""Input-pipeline throughput of the port's loader (mrfp_tpu/cli/bench_input.py);
no device needed.

    python -m mrfp_tpu_torch.cli.bench_input [--images 64] [--batch-size 16] \
        [--num-workers 8]

Builds a synthetic on-disk GTAV-layout tree at the source's resolution
(1914x1052 RGB PNGs and label PNGs, the decode load the reference trainer
reads), then measures the images/s of the full train pipeline (decode ->
flip/jitter -> scale and crop to 768x768 -> blur -> collate) through the
port's ``TrainLoader`` (``data/loader.py``) in each of its worker modes:
in the main process (``--num-workers`` 0) and in worker processes. The
clock covers one whole epoch from the loader's ``iter``, the workers'
start-up included: the loader starts them anew each epoch, as a training
epoch does, so a short tree understates the steady rate. The rate the train step consumes is the step's images/s
(``cli.train``'s ``train/images_per_sec``); the loader must beat it to
keep the card fed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Optional, Sequence

import numpy as np


def build_tree(root: str, n: int, hw=(1052, 1914), seed: int = 0) -> None:
    """``n`` images and labels under ``root/{images,labels}/train``: up to 8
    distinct random ones, encoded once and copied under the other names
    (the decode cost of a read stays real)."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    for sub in ("images/train", "labels/train"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    h, w = hw
    for i in range(n):
        img_path = os.path.join(root, f"images/train/{i:05d}.png")
        lbl_path = os.path.join(root, f"labels/train/{i:05d}.png")
        if i < 8:
            Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(img_path)
            Image.fromarray(rng.integers(0, 35, (h, w), dtype=np.uint8)).save(lbl_path)
        else:
            shutil.copyfile(os.path.join(root, f"images/train/{i % 8:05d}.png"), img_path)
            shutil.copyfile(os.path.join(root, f"labels/train/{i % 8:05d}.png"), lbl_path)


def measure(dataset, batch_size: int, num_workers: int) -> float:
    """Images/s of one epoch of ``TrainLoader``, its workers' start-up
    included."""
    from mrfp_tpu_torch.data.loader import TrainLoader
    loader = TrainLoader(dataset, batch_size, seed=1, num_workers=num_workers)
    if len(loader) == 0:
        raise ValueError(f"{len(dataset)} images make no batch of {batch_size}")
    n_img = 0
    t0 = time.perf_counter()
    for batch in loader:
        n_img += batch["image"].shape[0]
    return n_img / (time.perf_counter() - t0)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description="input-pipeline throughput")
    p.add_argument("--images", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--root", default=None, help="existing tree (default: build a temporary one)")
    p.add_argument("--keep", action="store_true")
    args = p.parse_args(argv)

    from mrfp_tpu_torch.data.datasets import GTAV

    root = args.root or tempfile.mkdtemp(prefix="mrfp_loader_bench_")
    try:
        if args.root is None:
            t0 = time.perf_counter()
            build_tree(root, args.images)
            print(f"built {args.images}-image tree in {time.perf_counter() - t0:.1f}s at {root}")
        ds = GTAV(root=root, split="train", train=True, base_size=768, crop_size=768)
        results = {}
        for mode, workers in (("main", 0), ("process", args.num_workers)):
            ips = measure(ds, args.batch_size, workers)
            results[mode] = ips
            print(f"{mode:8s}: {ips:6.1f} img/s ({workers} workers, bs{args.batch_size})")
        out = {"metric": "gtav_768_train_pipeline_img_per_sec",
               "unit": "images/sec", **results}
        print(json.dumps(out))
        return out
    finally:
        if args.root is None and not args.keep:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
