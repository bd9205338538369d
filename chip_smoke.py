#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``mrfp_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile DIR]

Builds the CUDA kernels from ``mrfp_tpu_torch/csrc/``, holds each against
its plain PyTorch version at the shapes the eval path gives it, runs the
full R50-D16 model at 1024x2048 through the kernels and through the plain
versions, then drives the eval entry point (``mrfp_tpu_torch.cli.eval``) on
synthetic 1024x2048 images in float32 and bfloat16 and checks that both
kernels were launched there. Any failure raises and exits non-zero; the
last line of stdout is the JSON verdict, printed only when every phase
passed. With ``--profile DIR`` it also writes a torch.profiler kernel table
of one fp32 forward to DIR.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
H, W = 1024, 2048

# (name, N, C, in_hw, out_hw): every bilinear resize of the eval forward
RESIZE_SHAPES = [
    ("cityscapes aspp broadcast", 1, 256, (1, 1), (64, 128)),
    ("cityscapes decoder upsample", 1, 256, (64, 128), (256, 512)),
    ("cityscapes logit upsample", 1, 19, (256, 512), (1024, 2048)),
    ("mapillary aspp broadcast", 1, 256, (1, 1), (96, 96)),
    ("mapillary decoder upsample", 1, 256, (96, 96), (384, 384)),
    ("mapillary logit upsample", 1, 19, (384, 384), (1536, 1536)),
]
# in = 1, identity axis, out = 1 on either axis, odd sizes
EDGE_RESIZES = [((1, 1), (6, 10)), ((7, 9), (7, 15)), ((7, 9), (1, 5)),
                ((7, 9), (11, 1)), ((13, 1), (27, 3))]
# assert_close bounds: fp32 both sides lerp in fp32 (FMA contraction may
# differ); bf16 both lerp in fp32 and round once, so about one bf16 ulp
TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=1e-2, rtol=8e-3)}


def median_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median of ``runs`` single-call CUDA-event timings."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_report() -> str:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {name} (count {torch.cuda.device_count()}); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(f"nvidia-smi: {smi}")
    return name


def phase_build():
    from mrfp_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {_build.library_path().name} in {time.perf_counter() - t0:.3f} s")


def phase_resize(gen) -> dict:
    from mrfp_tpu_torch.ops.resize import resize_bilinear_align_corners as resize
    worst, ms, plain_ms = 0.0, 0.0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for name, n, c, (h, w), size in RESIZE_SHAPES:
            x = torch.randn((n, c, h, w), generator=gen).to("cuda", dtype)
            got = resize(x, size)
            ref = resize(x, size, impl="plain")
            torch.cuda.synchronize()
            torch.testing.assert_close(got, ref, **TOL[dtype])
            err = (got.float() - ref.float()).abs().max().item()
            worst = max(worst, err)
            k_ms = median_ms(lambda: resize(x, size))
            p_ms = median_ms(lambda: resize(x, size, impl="plain"))
            if dtype == torch.float32 and name.startswith("cityscapes"):
                ms, plain_ms = ms + k_ms, plain_ms + p_ms
            gb = (got.numel() + x.numel()) * got.element_size() / 1e9
            print(f"resize_bilinear {str(dtype)[6:]} {name} ({n},{c},{h},{w})->{size}: "
                  f"max_abs_err {err:.3e}; kernel {k_ms:.4f} ms "
                  f"({gb / k_ms * 1e3:.0f} GB/s), plain {p_ms:.4f} ms")
        for (h, w), size in EDGE_RESIZES:
            x = torch.randn((2, 5, h, w), generator=gen).to("cuda", dtype)
            got, ref = resize(x, size), resize(x, size, impl="plain")
            torch.testing.assert_close(got, ref, **TOL[dtype])
            worst = max(worst, (got.float() - ref.float()).abs().max().item())
        print(f"resize_bilinear {str(dtype)[6:]} edge cases {EDGE_RESIZES}: match")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_hist(gen) -> dict:
    from mrfp_tpu_torch.ops.hist import confusion_matrix_update as update
    out = {}
    for c, shape in ((19, (2, H, W)), (128, (1 << 20,))):
        pred = torch.randint(0, c, shape, generator=gen)
        junk = torch.rand(shape, generator=gen)
        pred[junk < 0.01] = c + 3       # out-of-range preds are dropped
        pred[junk > 0.99] = -1
        label = torch.randint(0, c, shape, generator=gen)
        label[torch.rand(shape, generator=gen) < 0.1] = 255  # ignore
        pred, label = pred.cuda(), label.to(torch.uint8).cuda()
        got = update(torch.zeros(c, c, dtype=torch.int32, device="cuda"), pred, label, c)
        ref = update(torch.zeros(c, c, dtype=torch.int32, device="cuda"), pred, label, c,
                     impl="plain")
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"confusion matrix C={c}: kernel != plain, "
                                 f"{(got - ref).abs().sum().item()} counts apart")
        hist = torch.zeros(c, c, dtype=torch.int32, device="cuda")
        k_ms = median_ms(lambda: update(hist, pred, label, c))
        p_ms = median_ms(lambda: update(hist, pred, label, c, impl="plain"))
        print(f"confusion_matrix C={c} pred/label {tuple(shape)}: exactly equal "
              f"({got.sum().item()} counted); kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        if c == 19:
            out = {"max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms}
    return out


def phase_model(gen, profile_dir) -> None:
    from mrfp_tpu_torch.models import build_mrfp
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_mrfp("cuda", generator=torch.Generator().manual_seed(0))
    x = (torch.rand((1, 3, H, W), generator=gen) * 255).cuda()
    with torch.inference_mode():
        got = model(x)
        ref = model(x, impl="plain")
        torch.cuda.synchronize()
        if got.shape != (1, 19, H, W) or not torch.isfinite(got).all():
            raise AssertionError(f"logits: shape {tuple(got.shape)}, finite "
                                 f"{bool(torch.isfinite(got).all())}")
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
        agree = (got.argmax(1) == ref.argmax(1)).float().mean().item()
        if agree < 0.9999:
            raise AssertionError(f"argmax agreement {agree} < 0.9999")
        err = (got - ref).abs().max().item()
        k_ms = median_ms(lambda: model(x), runs=5, warmup=1)
        p_ms = median_ms(lambda: model(x, impl="plain"), runs=5, warmup=1)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            b_ms = median_ms(lambda: model(x), runs=5, warmup=1)
        print(f"model R50-D16 1x3x{H}x{W}: kernel vs plain max_abs_err {err:.3e} "
              f"(|logits| max {got.abs().max().item():.3e}), argmax agreement {agree}; "
              f"forward fp32 kernel path {k_ms:.3f} ms, plain path {p_ms:.3f} ms, "
              f"bf16 autocast kernel path {b_ms:.3f} ms")
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                model(x)
                torch.cuda.synchronize()
            table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=30)
            Path(profile_dir).mkdir(parents=True, exist_ok=True)
            (Path(profile_dir) / "profile_fp32_forward.txt").write_text(table)
            print(f"profile: {Path(profile_dir) / 'profile_fp32_forward.txt'}")


def phase_entry_point() -> dict:
    from mrfp_tpu_torch.cli import eval as cli_eval
    from mrfp_tpu_torch.ops import LAUNCHES, reset_launches
    reset_launches()  # the comparisons above launched too; count only this phase
    for dtype in ("float32", "bfloat16"):
        before = dict(LAUNCHES)
        results = cli_eval.main([
            "--device", "cuda", "--synthetic", "--synthetic-hw", str(H), str(W),
            "--domains", "cityscapes", "--max-images", "4", "--dtype", dtype])
        launched = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        r = results["cityscapes"]
        print(f"cli.eval {dtype}: launches {launched}; mean_iu {r['mean_iu']:.6f} "
              f"acc {r['acc']:.6f} fwavacc {r['fwavacc']:.6f}; "
              f"{r['images_per_s']:.3f} images/s end to end")
        if min(launched.values()) <= 0:
            raise AssertionError(f"cli.eval {dtype}: a kernel was not launched: {launched}")
        if r["images"] != 4 or r["pixels"] != 4 * H * W:
            raise AssertionError(f"cli.eval {dtype}: scored {r['images']} images, "
                                 f"{r['pixels']} pixels; expected 4, {4 * H * W}")
        if not all(math.isfinite(r[k]) and 0.0 <= r[k] <= 1.0
                   for k in ("mean_iu", "acc", "fwavacc")):
            raise AssertionError(f"cli.eval {dtype}: metrics out of range: {r}")
    return dict(LAUNCHES)


def main(argv=None) -> None:
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--profile", default=None, metavar="DIR")
    args = args.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    import mrfp_tpu_torch
    if Path(mrfp_tpu_torch.__file__).resolve().parent.parent != ROOT:
        raise SystemExit(f"chip_smoke: mrfp_tpu_torch comes from "
                         f"{mrfp_tpu_torch.__file__}, not from this checkout")
    kind = phase_report()
    phase_build()
    gen = torch.Generator().manual_seed(0)
    resize = phase_resize(gen)
    hist = phase_hist(gen)
    phase_model(gen, args.profile)
    launches = phase_entry_point()
    kernels = [
        dict(name="resize_bilinear", route="cuda",
             source="mrfp_tpu_torch/csrc/resize_bilinear.cu",
             replaces="mrfp_tpu/ops/pallas_resize.py:264",
             launches=launches["resize_bilinear"], **resize),
        dict(name="confusion_matrix", route="cuda",
             source="mrfp_tpu_torch/csrc/confusion_matrix.cu",
             replaces="mrfp_tpu/ops/pallas_hist.py:50",
             launches=launches["confusion_matrix"], **hist),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
