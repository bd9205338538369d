#!/usr/bin/env python3
"""Times the port's kernels and end-to-end paths for several checkouts, in
turn, on one CUDA card: the way to compare a change with its parent.

    python3 chip_compare.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (``.`` for this one; a parent
unpacked with ``git archive`` into a git-ignored directory). Each runs in a
process of its own, which builds that checkout's kernels and imports its
``chip_smoke.py`` helpers, and prints one line: the device time
(CUDA-graph replay) of the bilinear forward and backward at the five bf16
train resizes, of the nearest forward at the seven bf16 OC-branch resizes
and of the NP+ apply at the two NP+ sites, each with its sum; of one
``confusion_matrix_update`` at the eval shape (C=19, 2x1024x2048, int64
pred and uint8 label, as the eval path gives them) on uniform noise and on
this checkout's run-structured map, the same map for every root; of
``row_mix_cuda`` (compaction and mix) on a dense random (231, 192) P at
the bf16 enc1 shape along H and along W, beside its plain version; the bf16
batch-8 768x768 train step, unfused and fused, gates on and off; and the
fp32 1x3x1024x2048 eval forward (medians of 7 single-call CUDA-event
timings). Give the roots as parent, change, change, parent to see the
spread beside the difference.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys


def _one(root: str) -> str:
    import dataclasses

    import torch

    sys.path.insert(0, root)
    import chip_smoke as c
    from mrfp_tpu_torch.cli.train import build_state
    from mrfp_tpu_torch.models import build_mrfp
    from mrfp_tpu_torch.models.mrfp import PerturbArgs
    from mrfp_tpu_torch.ops import _build, cuda_np_plus, cuda_resize
    from mrfp_tpu_torch.ops.resize import bilinear_taps, nearest_table
    from mrfp_tpu_torch.perturb.np_plus import draw_np_plus
    from mrfp_tpu_torch.train.step import train_step

    if not _build.__file__.startswith(root):
        raise SystemExit(f"chip_compare: {_build.__file__} is not under {root}")
    _build.load_library()
    out = []
    g = torch.Generator(device="cuda").manual_seed(0)
    total = 0.0
    for name, n, ch, (h, w), size in c.BILINEAR_TRAIN_SHAPES[:5]:
        x = torch.randn((n, ch, h, w), device="cuda", generator=g).to(torch.bfloat16)
        ty, tx = bilinear_taps(h, size[0], x.device), bilinear_taps(w, size[1], x.device)
        if not torch.equal(cuda_resize.resize_bilinear_cuda(x, ty, tx),
                           cuda_resize.resize_bilinear_plain(x, ty, tx)):
            out.append(f"{name} NOT EQUAL to plain")
        ms = c.device_ms(lambda: cuda_resize.resize_bilinear_cuda(x, ty, tx), calls=10)
        total += ms
        out.append(f"{name.removeprefix('train ')} {ms:.4f}")
        del x
    out.append(f"resize_bilinear five-shape sum {total:.4f}")
    total = 0.0
    for name, n, ch, (h, w), size in c.BILINEAR_TRAIN_SHAPES[:5]:
        gy = torch.randn((n, ch, *size), device="cuda", generator=g).to(torch.bfloat16)
        ty, tx = bilinear_taps(h, size[0], gy.device), bilinear_taps(w, size[1], gy.device)
        total += c.device_ms(lambda: cuda_resize.resize_bilinear_bwd_cuda(gy, ty, tx, h, w),
                             calls=10)
        del gy
    out.append(f"resize_bilinear_bwd five-shape sum {total:.4f}")
    total = 0.0
    for name, ch, (h, w), rule in c.NEAREST_SHAPES:
        (rule_name, arg), = rule.items()
        x = torch.randn((c.TRAIN_N, ch, h, w), device="cuda", generator=g).to(torch.bfloat16)
        ty = nearest_table(h, rule_name, arg[0], x.device)
        tx = nearest_table(w, rule_name, arg[1], x.device)
        if not torch.equal(cuda_resize.resize_nearest_cuda(x, ty, tx),
                           cuda_resize.resize_nearest_plain(x, ty, tx)):
            out.append(f"{name} NOT EQUAL to plain")
        total += c.device_ms(lambda: cuda_resize.resize_nearest_cuda(x, ty, tx), calls=10)
        del x
    out.append(f"resize_nearest seven-shape sum {total:.4f}")
    total = 0.0
    for ch in (64, 256):
        side = c.CROP // 4
        x = torch.randn((c.TRAIN_N, ch, side, side), device="cuda", generator=g).to(torch.bfloat16)
        alpha = torch.randn((c.TRAIN_N, ch, 1, 1), device="cuda", generator=g)
        total += c.device_ms(lambda: cuda_np_plus.np_plus_apply_cuda(x, alpha, alpha))
        del x
    out.append(f"np_plus_apply two-site sum {total:.4f}")
    torch.cuda.empty_cache()

    # the maps come from this file's checkout, so every root counts the same pixels
    from mrfp_tpu_torch.ops.hist import confusion_matrix_update
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_maps", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                        "chip_smoke.py"))
    maps = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(maps)
    gen = torch.Generator().manual_seed(0)
    hist = torch.zeros(19, 19, dtype=torch.int32, device="cuda")
    for name, (label, pred) in (("uniform", maps._uniform_map(gen, (2, c.H, c.W), 19)),
                                ("run-structured", maps.run_structured_map(gen, (2, c.H, c.W),
                                                                           19))):
        label, pred = label.cuda(), pred.cuda()
        ms = c.device_ms(lambda: confusion_matrix_update(hist, pred, label, 19))
        out.append(f"confusion_matrix {name} {ms:.4f}")
        del label, pred

    # row_mix_cuda's general-P path (compaction, then the mix) on a dense
    # random P at the enc1 shape, beside its plain version (one fp32 matmul)
    from mrfp_tpu_torch.ops import cuda_row_mix
    _, ch, (h, w), _ = c.NEAREST_SHAPES[0]
    x = torch.randn((c.TRAIN_N, ch, h, w), device="cuda", generator=g).to(torch.bfloat16)
    for dim in (2, 3):
        p = torch.randn((231, (h, w)[dim - 2]), device="cuda", generator=g)
        ms = [c.device_ms(lambda: fn(x, p, dim), calls=10)
              for fn in (cuda_row_mix.row_mix_cuda, cuda_row_mix.row_mix_plain)]
        out.append(f"row_mix dense P along {'HW'[dim - 2]} {ms[0]:.4f} (plain {ms[1]:.4f})")
    del x

    gen = torch.Generator().manual_seed(0)
    torch.backends.cudnn.allow_tf32 = True
    cfg8 = c._train_cfg(c.TRAIN_N, "bfloat16")
    cfg8f = cfg8.replace(train=dataclasses.replace(cfg8.train, fuse_bn_stats=True))
    state = build_state(cfg8, torch.device("cuda"))
    img, lbl = c._batch(gen, c.TRAIN_N)
    draws = torch.Generator().manual_seed(1)
    np0 = draw_np_plus(draws, c.TRAIN_N, 64, "cuda")
    np1 = draw_np_plus(draws, c.TRAIN_N, 256, "cuda")
    for gates in ((True, True, True), (False, False, False)):
        p = PerturbArgs(*gates, np0, np1)
        for cfg, label in ((cfg8, "unfused"), (cfg8f, "fused")):
            ms = c.median_ms(lambda: train_step(state, img, lbl, cfg, perturb=p),
                             runs=7, warmup=2)
            out.append(f"step {label} gates {'on' if gates[0] else 'off'} {ms:.3f}")
    del state
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_mrfp("cuda", generator=torch.Generator().manual_seed(0))
    x = (torch.rand((1, 3, c.H, c.W), generator=gen) * 255).cuda()
    with torch.inference_mode():
        out.append(f"eval fp32 forward {c.median_ms(lambda: model(x), runs=7, warmup=2):.3f}")
    return "; ".join(out)


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print(f"{argv[1]}: {_one(os.path.abspath(argv[1]))} (ms)", flush=True)
        return 0
    if not argv:
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    for root in argv:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], check=True,
                       timeout=1200)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
