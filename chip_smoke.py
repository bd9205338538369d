#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``mrfp_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile DIR]

Builds the CUDA kernels from ``mrfp_tpu_torch/csrc/`` and drives both paths
of the port.

Eval: holds the bilinear and confusion-matrix kernels against their plain
PyTorch versions at the eval shapes (the bilinear forward exactly, naming
its route: 16-byte vector stores or scalar; the confusion matrix exactly,
on uniform noise and on a run-structured map like a real label map, for
every dtype pair it reads natively, and one launch a call), runs the full R50-D16 model at
1024x2048 through the kernels and through the plain versions, then drives
``mrfp_tpu_torch.cli.eval`` on synthetic 1024x2048 images in float32 and
bfloat16 and checks that both kernels were launched there.

Train: holds the nearest-resize kernels (forward and backward) against their
plain versions, exactly, at the seven OC-branch resizes of a batch-8
768x768 step and at edge cases (empty ranges, widths 1, 7, 9, h = 1, a
partial last block), and the bilinear forward (exactly) and backward at
the train and eval shapes and an odd width (the forward's scalar route), the
backward also at every edge shape and from an offset view; takes one
full-width MRFP+ step (all gates on, the same draws) through the kernels
and through the plain versions and compares loss and gradients; times the
bf16 batch-8 step with the gates on and off; then drives
``mrfp_tpu_torch.cli.train`` for 6 steps and resumes it to 8, checking that
every resize kernel was launched there, and evaluates that run's checkpoint
with ``mrfp_tpu_torch.cli.eval --ckpt``.

Fused OC stage (``phase_oc_stage``): holds the fused stage's kernels
(``csrc/oc_stage.cu``: statistics, apply, both backward passes, the NCHW
transposition) against their plain versions at the eight stages of the
batch-16 768x768 step in bf16 (enc4 in both layouts), in fp32, on a band
table, with odd channels and long ranges, and the stem features' cast into
channels-last exactly; times each stage beside its bytes bound, its plain
versions and the chain it replaced, and each stage's conv NCHW against
channels-last.

Fused statistics (``cfg.train.fuse_bn_stats``): holds dot_with_stats
against its plain version at the 15 shapes of the step's 36 bottleneck 1x1s
and at ragged shapes, naming for each the kernel that ran (tensor-core or
CUDA-core), and the row mix (take_rows' tables at the OC shapes and edge cases,
exactly; a general dense P within its bound), the channel sums and the NP+
apply at the OC and NP+ shapes; drives the public functions of those three (no train or eval path
runs them); takes one fp32 fused step through the kernels, through the plain
versions and unfused, and times the bf16 fused step beside the unfused one;
then drives one bf16 batch-8 fused step and counts its 36 dot_with_stats
launches, all on the tensor-core kernel. Every kernel's line carries its bound on this card and the time
of the PyTorch call that computes the same function, single-call and on the
device (a CUDA-graph replay, no host time; a profiler trace for bincount,
which no graph can capture).

Training extras and accumulation: holds the nearest kernel at the DSN
label shape, (8,1,768,768) fp32 -> 48x48, against its plain version and
``F.interpolate`` (exactly), and the resize kernels at the microbatch shapes
of ``--accum-steps 2`` (the DSN map, the five train bilinear resizes and
the seven OC nearest ones at batch 4); takes the step with every extra (the
DSN head, the border-relaxed CE with its window full and halved, batch
class weights, HPF) through the kernels and through the plain versions
from one state, in fp32 at batch 2 (loss and gradients) and in bf16 at
batch 8 (loss, and gradients beside a second plain step's and one whose
resize transposes round another way), then times the
bf16 step with either window beside the default step; drives ``cli.train
--accum-steps 2 --use-dsn`` with the bf16 momentum, resumes it and prints
its peak device memory beside the unaccumulated run's; and runs the
``SlidingEvaluator`` on a 1024x2048 image, which must launch the
confusion-matrix kernel and predict what its plain path predicts. Every
resize call of those three paths must be at a shape that a phase held
against the plain version (the eval phase holds the tile shapes).

Serving and the run tools (``phase_serving``, after the model phase):
``cli.export`` freezes the eval forward at 1x1024x2048 with a uint8 wire,
in fp32 (TF32 off) and bf16 autocast, each with its bit-exact ``--check``
(cuDNN deterministic), and prints the export's seconds and the artifact's
MB; the live and the loaded fp32 forward are timed in turns in one
process; a fresh process loads the fp32 artifact through
``mrfp_tpu_torch.serving`` alone (no module of models, nn, perturb or train
imported), times 20 forwards beside the live forward, launches the bilinear
kernel 3 times a forward through ``mrfp::resize_bilinear`` and holds its
logits to the live model's within 1e-4; ``cli.visualize`` writes 2
triplets; ``cli.train --snapshot-every 2`` runs 24 bf16 r18-D32 batch-2 steps,
prints each snapshot's host-copy seconds and bytes, reads ``tb/`` back
with the port's reader and resumes; ``cli.bench_input`` prints the
loader's images/s beside the rate that run's step consumed.

The ResNet family and the zoo (``phase_trunks``, ``phase_cli_train_zoo``):
each of the nine ResNet trunks in MRFP runs the fp32 eval forward at
1x1024x2048 and one bf16 step at 2x768x768 (the baseline step for
resnet-101, whose deep stem the OC branch cannot read), kernel path against
plain path, after the resize kernels are held at that batch; then
``cli.train_zoo`` trains the zoo recipe at the JAX CLI's defaults (r18-D32,
``wt_layer`` 0022200, the ISW loss and its statistics phase, bf16, batch 16,
768x768) for 6 counted steps, and ``cli.eval`` and ``cli.export --check``
take its checkpoint at 1024x2048; the zoo step's time, images/s and peak
memory are timed in process.

The zoo's other trunks and SwitchWhiten (``phase_zoo_trunks``): after the
resizes of their paths are held (layer1 at 1/8 for ShuffleNetV2,
MobileNetV2 and MNASNet; layer4 at 1/32 for SE-ResNeXt), each of
MobileNetV2, ShuffleNetV2, MNASNet 0.5/1.0 and SE-ResNeXt-50/101 in the
zoo's DeepV3Plus at D16 runs the fp32 eval forward at 1x3x1024x2048 and
one bf16 zoo step at 2x768x768 (the ISW loss where the trunk has iw
slots), kernel path against plain path; then the zoo recipe with
SwitchWhiten (iw code 5 in the stem and layers 1-2) is timed at batch 16,
768x768, and its ``cli.export --check`` runs at 1024x2048. Its kernel
paths' launches are counted.

Data parallelism (``phase_data_parallel``): two ranks, each a process of
its own, share the card through gloo and take an fp32 step (TF32 off, the
damped fixture) and the bf16 recipe's step on their halves of a global
batch, against one process on the whole batch and a control that moves
the input by a rounding step; the ranks must end bit-identical, and every
resize call of theirs must be at a held shape. Then ``cli.train
--num-processes 1 --coordinator-address`` trains two steps through an NCCL
process group (NCCL refuses two ranks on one card).

The zoo on several processes (``phase_zoo_data_parallel``): two ranks
share the card through gloo as above and take the statistics pass (rank
0's masks broadcast) and one zoo step of DeepR50V3PlusD with ISW in slots
2-3 and SwitchWhiten in slot 4 (the global batch's BatchNorm and
SwitchWhiten statistics) on their halves of a global batch of 768x768
images, in fp32 (TF32 off, the damped fixture, 4 images: every gradient
checked) and in bf16 (8 images), against one process on the whole batch
with the same masks and draws and a control that moves the input by a
rounding step; the bf16 step's collectives are counted
(``parallel/audit.py``). Then ``cli.plan`` reports the MRFP+ R50-D16 launch
of global batch 8 on 2 ranks, whose all-reduce bill must be the one
``phase_data_parallel`` counted, and ``cli.train_zoo --num-processes 1``
trains two steps through NCCL.

Spatial parallelism (``phase_spatial_parallel``): two ranks share the card
through gloo as above, and each takes its band of every image's rows: the
MRFP+ step (R50-D16, 768x768) in fp32 (TF32 off, the damped fixture, batch
2: the loss and every gradient) and in bf16 (batch 8: the loss, the
statistics' moves, each rank's peak memory and its collectives a step,
halo rows apart from statistics), and the fp32 eval forward at
1x3x1024x2048 and ``SegEvaluator`` over two synthetic images, against one
process on whole images; every band resize table of those runs is held
against its plain version first. Then ``cli.eval --spatial-parallel 2``
against ``cli.eval``.

Tensor parallelism (``phase_model_parallel``): two ranks share the card
through gloo as above, each holding half the channels of every conv
kernel, BN and momentum tensor and gathering every conv's input over the
model group: the MRFP+ step (R50-D16, 768x768) in fp32 (TF32 off, the
damped fixture, batch 2: the loss and every gradient against its own
control) and in bf16 (batch 4: the loss, the ranks bit-identical, each
rank's state bytes and peak memory beside one process's, its collectives
equal to ``cli.plan --model-parallel 2``'s bill), the fused bf16 step
(``dot_with_stats`` on Cout/2 rows), and the checkpoint written at M = 2
loaded into one process, whose fp32 eval logits at 1x3x1024x2048 must be
the ranks' sharded forward's; every resize and ``dot_with_stats`` call of
the ranks is held at a model rank's shapes first.

The zoo on channel slices (``phase_zoo_model_parallel``): two ranks share
the card through gloo and split DeepR50V3PlusD (ISW in slots 2-3 with the
whitening loss and its statistics pass, SwitchWhiten in slot 4, the DSN
head, 768x768): fp32 (batch 2: the masks equal, the loss and every
gradient against one process) and bf16 (batch 4, or 2 where the card
lacks the memory: the loss, the ranks bit-identical, state bytes, peak
and collectives beside one process's), the checkpoint written at M = 2
loaded into one process, the validation's confusion matrix; every resize
of the ranks held at a model rank's shapes. Beside them
``cli.train_zoo --model-parallel 2 --num-processes 2`` takes 2 steps and a
validation, its ranks' replicated tensors bit-identical after them.

Any failure raises and exits non-zero; the last line of stdout is the JSON
verdict, printed only when every phase passed. With ``--profile DIR`` it
also writes torch.profiler kernel tables of one fp32 eval forward, of
one bf16 train step, unfused and fused, and of one SwitchWhiten layer's
forward and backward to DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
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
# in = 1, identity axis, out = 1 on either axis, odd sizes; rows too wide
# for one block's shared memory, which the forward cuts into column tiles
# (of whole vectors, and of single values where a vector's taps span the
# whole 100000-wide input)
EDGE_RESIZES = [((1, 1), (6, 10)), ((7, 9), (7, 15)), ((7, 9), (1, 5)),
                ((7, 9), (11, 1)), ((13, 1), (27, 3)), ((3, 4), (5, 30000)),
                ((3, 100000), (2, 8))]
# The bilinear forward's kernel rounds each product and sum as its plain
# version does, so the two must be exactly equal. Its backward sums in
# another order than the plain version's index_add_: assert_close bounds of
# about one bf16 ulp (the fp32 bound is in phase_bilinear_train)
TOL = {torch.bfloat16: dict(atol=1e-2, rtol=8e-3)}

# the train recipe: batch 8 at 768x768 (the stem output is 8x64x192x192)
TRAIN_N, CROP = 8, 768
# (name, C, in_hw, rule): every nearest resize of the OC branch in that step
# (dec1 resizes 384 to 384: the identity, no launch)
NEAREST_SHAPES = [
    ("enc1 x1.205", 64, (192, 192), {"scale": (1.205, 1.205)}),
    ("enc2 x1.2", 64, (231, 231), {"scale": (1.2, 1.2)}),
    ("enc3 x1.2", 128, (277, 277), {"scale": (1.2, 1.2)}),
    ("enc4 to 384", 256, (332, 332), {"size": (384, 384)}),
    ("dec2 x0.838", 64, (384, 384), {"scale": (0.838, 0.838)}),
    ("dec3 x0.798", 64, (321, 321), {"scale": (0.798, 0.798)}),
    ("dec4 to 192", 64, (256, 256), {"size": (192, 192)}),
]
# the DSN label map of that step: the labels as a 1-channel fp32 map,
# nearest-resized by size to layer3's 48x48 (mrfp_tpu/train/step.py:93-101)
DSN_LABELS = (TRAIN_N, 1, CROP, CROP)
DSN_HW = (CROP // 16, CROP // 16)
# the sliding evaluator's tiles on an H x W image: three of 1024x1024
SLIDING_CROP = 1024
# (name, N, C, in_hw, out_hw): the bilinear resizes of its tile forward
SLIDING_RESIZES = [
    ("sliding aspp broadcast", 3, 256, (1, 1), (SLIDING_CROP // 16,) * 2),
    ("sliding decoder upsample", 3, 256, (SLIDING_CROP // 16,) * 2, (SLIDING_CROP // 4,) * 2),
    ("sliding logit upsample", 3, 19, (SLIDING_CROP // 4,) * 2, (SLIDING_CROP,) * 2),
]
# (name, N, C, in_hw, rule): nearest edge cases, forward and backward: empty
# ranges (downsamples), widths 1, 7 and 9, h = 1, and 21 planes of 37 rows,
# which leave the staged backward a partial last block. Here and at the OC
# shapes every backward sum has at most two terms per axis, which fp32
# adds exactly alike in any order, and both versions sum in fp32 and round
# once: kernel and plain must be exactly equal.
NEAREST_EDGES = [
    ("7 to 3 by size", 2, 3, (7, 7), {"size": (3, 3)}),
    ("33x29 x0.798", 2, 3, (33, 29), {"scale": (0.798, 0.798)}),
    ("width 1 x1.5", 2, 3, (5, 1), {"scale": (1.5, 1.5)}),
    ("width 7 x1.3", 2, 3, (6, 7), {"scale": (1.3, 1.3)}),
    ("width 9 to 11x13", 2, 3, (9, 9), {"size": (11, 13)}),
    ("h 1 to 2x30", 2, 3, (1, 20), {"size": (2, 30)}),
    ("partial last block", 3, 7, (37, 45), {"scale": (1.2, 1.2)}),
]
# (name, N, C, in_hw, rule): ranges longer than two, which the staged
# backward does not take: the direct kernel sums them. Sums of more than two
# terms depend on their order (the plain version's index_add_ adds in any
# order): each result within terms * 2^-24 of the summed magnitudes of a
# float64 reference, plus its own rounding
NEAREST_LONG = [
    ("x3 upsample", 2, 3, (5, 6), {"scale": (3.0, 3.0)}),
    ("4 to 30000 wide", 1, 2, (3, 4), {"size": (3, 30000)}),
]
# (name, N, C, in_hw, out_hw): the bilinear resizes of the train step, whose
# forward and backward run there, and the eval shapes
BILINEAR_TRAIN_SHAPES = [
    ("train aspp broadcast", TRAIN_N, 256, (1, 1), (48, 48)),
    ("train decoder upsample", TRAIN_N, 256, (48, 48), (192, 192)),
    ("train decoder injection", TRAIN_N, 256, (192, 192), (384, 384)),
    ("train logits from H/2", TRAIN_N, 19, (384, 384), (768, 768)),
    ("train logits from H/4", TRAIN_N, 19, (192, 192), (768, 768)),
] + RESIZE_SHAPES[:3] + [
    # a width that is no whole number of 16-byte vectors: the scalar route
    ("odd crop 769 logits", TRAIN_N, 19, (193, 193), (769, 769)),
]
# the four parameters whose gradients the kernel-vs-plain step compares
# the fused fp32 step's fixture: every residual branch's last BN scale x DAMP
# (tests/test_torch_train.py::ref_damped, ROADMAP C3)
DAMP = 0.1
GRAD_KEYS = ("layer0.0.weight", "layer1.0.conv1.weight", "aspp.img_conv.0.weight",
             "final2.0.weight")
RESIZE_KERNELS = ("resize_bilinear", "resize_bilinear_bwd", "resize_nearest",
                  "resize_nearest_bwd")
# the kernels an MRFP+ train step with its OC gates launches: the bilinear
# resizes and the fused OC stage, whose nearest resizes are inside it (no
# resize_nearest call is left on that path without the DSN head)
MRFP_TRAIN_KERNELS = ("resize_bilinear", "resize_bilinear_bwd", "oc_stage_stats", "oc_stage",
                      "oc_stage_bwd")
# (name, Cin, Cout, side, sites): the 15 distinct shapes of the 36 bottleneck
# 1x1 conv + BN pairs of the batch-8 768x768 step (side: the output's H = W)
DOT_STATS_SHAPES = [
    ("layer1 conv1 block0", 64, 64, 192, 1),
    ("layer1 conv3 + downsample", 64, 256, 192, 4),
    ("layer1 conv1 blocks1-2", 256, 64, 192, 2),
    ("layer2 conv1 block0", 256, 128, 192, 1),
    ("layer2 conv3", 128, 512, 96, 4),
    ("layer2 downsample (stride 2)", 256, 512, 96, 1),
    ("layer2 conv1 blocks1-3", 512, 128, 96, 3),
    ("layer3 conv1 block0", 512, 256, 96, 1),
    ("layer3 conv3", 256, 1024, 48, 6),
    ("layer3 downsample (stride 2)", 512, 1024, 48, 1),
    ("layer3 conv1 blocks1-5", 1024, 256, 48, 5),
    ("layer4 conv1 block0", 1024, 512, 48, 1),
    ("layer4 conv3", 512, 2048, 48, 3),
    ("layer4 downsample", 1024, 2048, 48, 1),
    ("layer4 conv1 blocks1-2", 2048, 512, 48, 2),
]
DOT_STATS_FP32 = ("layer1 conv1 block0", "layer3 conv3", "layer4 downsample")
# (name, N, Cin, Cout, (h, w)): shapes the step never gives, in bf16 and fp32:
# ragged tiles for the tensor-core kernel (HW not a multiple of 128, Cout not
# a multiple of 64, Cin = 8 x odd), and bf16 shapes it does not take (HW or
# Cin not a multiple of 8), which route to the CUDA-core kernel
DOT_STATS_RAGGED = [
    ("HW 2000", 2, 256, 256, (40, 50)),
    ("Cout 200", 2, 128, 200, (48, 48)),
    ("Cin 24", 2, 24, 128, (32, 32)),
    ("Cin 72, Cout 72, HW 1000", 3, 72, 72, (25, 40)),
    ("HW 63", 2, 64, 128, (7, 9)),
    ("Cin 30", 2, 30, 64, (16, 16)),
]
# the card's published peaks (H100 SXM, dense): HBM bytes/s and FLOP/s; fp32
# products run on the CUDA cores (TF32 off), bf16 ones may use the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


class Cost:
    """The least time the card could take for a sum of calls: per call, the
    larger of its bytes (each input read once, each output written once)
    over the memory rate and its operations over the peak rate of their
    type."""

    def __init__(self):
        self.bound_ms = self.bytes_ms = self.ops_ms = 0.0

    def add(self, nbytes: float, flops: float = 0.0, dtype=torch.bfloat16, times: int = 1):
        b = nbytes / HBM_BYTES_PER_S * 1e3
        o = flops / PEAK_FLOPS[dtype] * 1e3
        self.bound_ms += times * max(b, o)
        self.bytes_ms += times * b
        self.ops_ms += times * o
        return max(b, o)

    def fields(self) -> dict:
        return {"bound_ms": self.bound_ms,
                "bound_by": "bytes" if self.bytes_ms >= self.ops_ms else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# (kernel, dtype, input shape, output shape) of every resize-kernel call
# that a phase held against its plain version (``_held``); the calls of the
# extras step, the accumulated cli.train run and the sliding evaluator,
# recorded by ``_recording``, must all be among them
CHECKED = set()


def _key(kernel: str, inp, out, band=None) -> tuple:
    """A resize-kernel call's key: kernel, dtype and shapes, and for a band
    table (spatial parallelism) the table's spec (``_table_spec``)."""
    key = (kernel, inp.dtype, tuple(inp.shape), tuple(out.shape))
    return key if band is None else key + (band,)


def _held(kernel: str, inp, out, band=None) -> None:
    CHECKED.add(_key(kernel, inp, out, band))


def _table_spec(table) -> tuple:
    """An H or W table's spec: ("nearest", in, rule, arg[, band]) from the
    table itself, ("bilinear", in, out, band) from its cache key."""
    from mrfp_tpu_torch.ops import resize
    if isinstance(table, resize.NearestTable):
        return ("nearest",) + tuple(table.spec)
    for key, taps in resize._TAPS.items():
        if taps is table:
            return ("bilinear",) + tuple(key[:3])
    raise AssertionError("a bilinear table that is not in the cache")


def _band_of(table):
    """The spec of a band table, None for a whole axis."""
    spec = _table_spec(table)
    band = spec[3] if spec[0] == "bilinear" else (spec[4] if len(spec) > 4 else None)
    return spec if band is not None else None


@contextlib.contextmanager
def _recording():
    """Yields a list that collects the ``_key`` of every resize-kernel call
    made inside the block."""
    from mrfp_tpu_torch.ops import cuda_resize
    calls = []
    saved = {k: getattr(cuda_resize, k + "_cuda") for k in RESIZE_KERNELS}

    def spy(kernel, fn):
        def call(t, *args):
            out = fn(t, *args)
            calls.append(_key(kernel, t, out, _band_of(args[0])))
            return out
        return call

    for k, fn in saved.items():
        setattr(cuda_resize, k + "_cuda", spy(k, fn))
    try:
        yield calls
    finally:
        for k, fn in saved.items():
            setattr(cuda_resize, k + "_cuda", fn)


@contextlib.contextmanager
def _resizes_run():
    """Yields a set that collects every forward resize-kernel call made
    inside the block as ``(kind, dtype, n, c, H spec, W spec)``, the whole
    axes' specs (``_table_spec``)."""
    from mrfp_tpu_torch.ops import cuda_resize
    seen = set()
    saved = {k: getattr(cuda_resize, k + "_cuda") for k in ("resize_bilinear", "resize_nearest")}

    def spy(kind, fn):
        def call(t, ty, tx, *args):
            seen.add((kind, t.dtype, t.shape[0], t.shape[1], _table_spec(ty), _table_spec(tx)))
            return fn(t, ty, tx, *args)
        return call

    for k, fn in saved.items():
        setattr(cuda_resize, k + "_cuda", spy(k[len("resize_"):], fn))
    try:
        yield seen
    finally:
        for k, fn in saved.items():
            setattr(cuda_resize, k + "_cuda", fn)


def _all_held(calls, what: str) -> None:
    missing = sorted(set(calls) - CHECKED, key=str)
    if missing:
        raise AssertionError(f"{what}: resize kernels ran at shapes that no phase held "
                             f"against their plain versions: {missing}")


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


def device_ms(fn, calls: int = 20) -> float:
    """Device time of one call: ``calls`` calls captured in a CUDA graph,
    the replay timed with CUDA events, median of 5 replays. No host time
    (Python, the wrapper's allocations, launch latency) is in it, which a
    single-call timing of a call under ~0.1 ms mostly measures."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def profiled_device_ms(fn, calls: int = 5) -> float:
    """Device time of one call for a call a CUDA graph cannot capture (it
    reads a value back to the host): the kernels' and copies' own device
    time in a torch.profiler trace of ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    return us / calls / 1e3


def host_us(fn, runs: int = 50) -> float:
    """Host time of one call in microseconds: the median wall time of
    ``runs`` calls, each made with the card's queue drained, so none waits
    for the device."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


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
    log = _build.library_path().with_suffix(".log")
    if log.exists():  # ptxas: registers and spills per kernel, summed up
        text = log.read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        stores = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", text))
        loads = sum(int(b) for b in re.findall(r"(\d+) bytes spill loads", text))
        print(f"ptxas: {len(regs)} kernels, {min(regs, default=0)}-{max(regs, default=0)} "
              f"registers, {stores} bytes of spill stores, {loads} of spill loads "
              f"(per kernel: {log})")
        per_kernel = []  # "name[dtype,variant] registers", one per compiled entry
        for entry in text.split("Compiling entry function")[1:]:
            mangled = entry.split("'")[1]
            name = re.search(r"\d+((?:[a-z]+_)*[a-z]*kernel)", mangled)
            used = re.search(r"Used (\d+) registers", entry)
            if name and used:
                tags = [t for key, t in (("bfloat16", "bf16"), ("kernelIf", "f32"))
                        if key in mangled]
                per_kernel.append(f"{name.group(1)}{'[' + ','.join(tags) + ']' if tags else ''} "
                                  f"{used.group(1)}")
        print(f"ptxas registers per kernel: {', '.join(per_kernel)}")


def _bilinear_route(x, size) -> str:
    """The route the bilinear forward takes for ``x`` resized to ``size``:
    "vector" (16-byte stores) or "scalar" (the wrapper's outputs are
    16-byte aligned, so the width decides), and "tiled" where a row is cut
    into column tiles."""
    from mrfp_tpu_torch.ops import cuda_resize
    plan = cuda_resize.bilinear_fwd_plan(*x.shape[2:], *size, x.element_size(), True)
    route = "vector" if plan.vec > 1 else "scalar"
    return route + (" tiled" if plan.cols < size[1] else "")


def _bilinear_fwd_equal(got, ref, what: str) -> None:
    if not torch.equal(got, ref):
        raise AssertionError(f"resize_bilinear {what}: kernel != plain, max "
                             f"{(got.float() - ref.float()).abs().max().item():.3e}")


def phase_resize(gen) -> None:
    """The bilinear forward against its plain version at the eval shapes and
    the sliding evaluator's tile shapes and the edge cases: exactly equal,
    each line naming the route that ran."""
    from mrfp_tpu_torch.ops.resize import resize_bilinear_align_corners as resize
    for dtype in (torch.float32, torch.bfloat16):
        for name, n, c, (h, w), size in RESIZE_SHAPES + SLIDING_RESIZES:
            x = torch.randn((n, c, h, w), generator=gen).to(DEV, dtype)
            got = resize(x, size)
            ref = resize(x, size, impl="plain")
            torch.cuda.synchronize()
            what = f"{_dtype_name(dtype)} {name} ({n},{c},{h},{w})->{size}"
            _bilinear_fwd_equal(got, ref, what)
            _held("resize_bilinear", x, got)
            k_ms = median_ms(lambda: resize(x, size))
            p_ms = median_ms(lambda: resize(x, size, impl="plain"))
            gb = (got.numel() + x.numel()) * got.element_size() / 1e9
            print(f"resize_bilinear {what}: exactly equal, {_bilinear_route(x, size)} route; "
                  f"kernel {k_ms:.4f} ms ({gb / k_ms * 1e3:.0f} GB/s), plain {p_ms:.4f} ms")
        routes = []
        for (h, w), size in EDGE_RESIZES:
            # the second sample of three: a contiguous view whose data need
            # not start on a 16-byte boundary (5 h w values in)
            for x in (torch.randn((2, 5, h, w), generator=gen).to(DEV, dtype),
                      torch.randn((3, 5, h, w), generator=gen).to(DEV, dtype)[1:2]):
                _bilinear_fwd_equal(resize(x, size), resize(x, size, impl="plain"),
                                    f"{_dtype_name(dtype)} edge case {tuple(x.shape)}->{size} "
                                    f"at byte {x.data_ptr() % 16} of a granule")
            routes.append(_bilinear_route(x, size))
        print(f"resize_bilinear {_dtype_name(dtype)} edge cases {EDGE_RESIZES}, each also from "
              f"an offset view: exactly equal, routes {routes}")


def run_structured_map(gen, shape, num_classes: int):
    """A (label, pred) pair shaped like a segmentation map and its argmax,
    made from ``gen`` on the CPU: each row of the last axis cut into runs of
    64-512 pixels of one label each (the last run cut at the row's end);
    class 0 takes about 40% of the runs, the ignore label 255 about 10%, the
    rest uniform over 1..C-1. The pred is the label except on about 10% of
    the runs of a second, independent cut, and on ignore pixels, where it
    takes that run's own class, uniform over 0..C-1. uint8 label, int64
    pred."""
    *lead, w = shape
    rows = math.prod(lead)
    k = w // 64 + 1  # runs of >= 64 pixels: enough to cover a row
    cols = torch.arange(w).expand(rows, w).contiguous()

    def cut():
        ends = torch.randint(64, 513, (rows, k), generator=gen).cumsum(1)
        return torch.searchsorted(ends, cols, right=True)

    u = torch.rand((rows, k), generator=gen)
    cls = torch.randint(1, num_classes, (rows, k), generator=gen)
    cls[u < 0.4] = 0
    cls[(u >= 0.4) & (u < 0.5)] = 255
    label = cls.gather(1, cut())
    run = cut()
    wrong = (torch.rand((rows, k), generator=gen) < 0.1).gather(1, run)
    other = torch.randint(0, num_classes, (rows, k), generator=gen).gather(1, run)
    pred = torch.where(wrong | (label == 255), other, label)
    return label.to(torch.uint8).reshape(shape), pred.reshape(shape)


def _uniform_map(gen, shape, c: int):
    """Uniform noise over the C classes: 1% of preds C + 3 and 1% -1
    (dropped), 10% of labels 255 (ignore); int64 pred, uint8 label."""
    pred = torch.randint(0, c, shape, generator=gen)
    junk = torch.rand(shape, generator=gen)
    pred[junk < 0.01] = c + 3
    pred[junk > 0.99] = -1
    label = torch.randint(0, c, shape, generator=gen)
    label[torch.rand(shape, generator=gen) < 0.1] = 255
    return label.to(torch.uint8), pred


def _hist_equal(pred, label, c: int, what: str) -> int:
    """The kernel's counts against the plain version's."""
    from mrfp_tpu_torch.ops import cuda_hist
    got = cuda_hist.confusion_matrix_cuda(torch.zeros(c, c, dtype=torch.int32, device=DEV),
                                          pred, label, c)
    ref = cuda_hist.confusion_matrix_plain(pred, label, c)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"confusion matrix {what}: kernel != plain, "
                             f"{(got - ref).abs().sum().item()} counts apart")
    return int(got.sum().item())


def phase_hist(gen) -> dict:
    """The confusion matrix against its plain version, exactly: on uniform
    noise at the eval shape (C=19, 2x1024x2048) and at C=128, for every
    dtype pair the kernel reads natively (pred int64/int32, label
    uint8/int32/int64); on a run-structured map at
    the eval shape (``run_structured_map``, with int64 preds of 2^32 + 3,
    which int32 would wrap into range, -1 and C sprinkled in), with uint8
    and int32 labels and int64 and int32 preds. Times the eval path's pair
    (int64 pred, uint8 label) on both maps, and shows from a
    profiler trace that one call launches one kernel (no cast pass). The
    library call is one bincount of the kept pixels' flat indices."""
    from torch.profiler import ProfilerActivity, profile

    from mrfp_tpu_torch.ops.hist import confusion_matrix_update as update
    out = {}
    preds, labels = (torch.int64, torch.int32), (torch.uint8, torch.int32, torch.int64)
    for c, shape in ((19, (2, H, W)), (128, (1 << 20,))):
        label, pred = (t.to(DEV) for t in _uniform_map(gen, shape, c))
        counted = _hist_equal(pred, label, c, f"C={c} uniform")
        for pd in preds:
            for ld in labels:
                _hist_equal(pred.to(pd), label.to(ld), c, f"C={c} uniform pred {pd} label {ld}")
        hist = torch.zeros(c, c, dtype=torch.int32, device=DEV)
        k_ms = median_ms(lambda: update(hist, pred, label, c))
        p_ms = median_ms(lambda: update(hist, pred, label, c, impl="plain"))
        lab = label.long()
        keep = (lab < c) & (pred >= 0) & (pred < c)
        flat = (lab * c + pred)[keep]
        l_ms = median_ms(lambda: torch.bincount(flat, minlength=c * c))
        cost = Cost()
        cost.add(nbytes(pred, label, hist))
        print(f"confusion_matrix C={c} pred/label {tuple(shape)}: exactly equal "
              f"({counted} counted; every native dtype pair); kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bincount {l_ms:.4f} ms, bound "
              f"{cost.bound_ms:.4f} ms")
        if c == 19:  # the eval shape
            # bincount reads its input's max back to the host, so no graph
            # can capture it: its device time comes from a profiler trace
            dev = (device_ms(lambda: update(hist, pred, label, c)),
                   profiled_device_ms(lambda: torch.bincount(flat, minlength=c * c)))
            print(f"confusion_matrix C={c} uniform: device time kernel {dev[0]:.4f} ms (graph), "
                  f"bincount {dev[1]:.4f} ms (profiler)")
            for _ in range(3):  # a trace can come back empty, which shows nothing
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    update(hist, pred, label, c)
                    torch.cuda.synchronize()
                on_card = [(e.key, e.count) for e in prof.key_averages()
                           if e.self_device_time_total > 0]
                if on_card:
                    break
            print(f"confusion_matrix int64 pred, uint8 label: one call's device work {on_card}")
            if len(on_card) != 1 or "confusion_matrix_kernel" not in on_card[0][0] \
                    or on_card[0][1] != 1:
                raise AssertionError(f"confusion matrix: one call ran {on_card}, not the "
                                     f"kernel alone")
            out = {"max_abs_err": 0.0, "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                   "device_ms": dev[0], "library_device_ms": dev[1], **cost.fields()}
        del label, pred, lab, keep, flat

    # the run-structured map at the eval shape
    c = 19
    label, pred = run_structured_map(gen, (2, H, W), c)
    spots = torch.randint(0, pred.numel(), (3, 1000), generator=gen)
    for s, v in zip(spots, (2 ** 32 + 3, -1, c)):  # out of range in int64
        pred.view(-1)[s] = v
    label, pred = label.to(DEV), pred.to(DEV)
    counted = 0
    for pd in preds:
        for ld in labels[:2]:
            counted = _hist_equal(pred.to(pd), label.to(ld), c,
                                  f"C={c} run-structured pred {pd} label {ld}")
    lab = label.long()
    keep = (lab < c) & (pred >= 0) & (pred < c)
    flat = (lab * c + pred)[keep]
    share = [(lab == 0).float().mean().item(), (lab == 255).float().mean().item(),
             (pred == lab)[lab != 255].float().mean().item()]
    hist = torch.zeros(c, c, dtype=torch.int32, device=DEV)
    k_ms = median_ms(lambda: update(hist, pred, label, c))
    p_ms = median_ms(lambda: update(hist, pred, label, c, impl="plain"))
    l_ms = median_ms(lambda: torch.bincount(flat, minlength=c * c))
    dev = (device_ms(lambda: update(hist, pred, label, c)),
           profiled_device_ms(lambda: torch.bincount(flat, minlength=c * c)))
    print(f"confusion_matrix C={c} run-structured {tuple(label.shape)} (class 0 {share[0]:.3f}, "
          f"ignore {share[1]:.3f}, pred == label {share[2]:.3f} of the rest): exactly equal "
          f"({counted} counted; pred int64/int32, label uint8/int32); kernel {k_ms:.4f} ms, "
          f"plain {p_ms:.4f} ms, bincount {l_ms:.4f} ms; device time kernel {dev[0]:.4f} ms "
          f"(graph), bincount {dev[1]:.4f} ms (profiler); "
          f"uniform {out['device_ms']:.4f} ms")
    out.update(run_ms=k_ms, run_device_ms=dev[0], run_library_ms=l_ms,
               run_library_device_ms=dev[1])
    return out


def phase_model(gen, profile_dir) -> float:
    """Returns the kernel path's fp32 forward ms."""
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
    return k_ms


SERVING_FORWARDS = 20  # the fresh process's timed forwards of the artifact
SNAPSHOT_N = 2  # the --snapshot-every run's batch (r18-D32)


def serving_child(artifact: str, inputs: str, out: str) -> None:
    """The fresh process of ``phase_serving``: load the artifact through
    ``mrfp_tpu_torch.serving`` alone, run it, and write what it saw to
    ``out`` (JSON)."""
    t0 = time.perf_counter()
    from mrfp_tpu_torch.serving import load_exported
    fn, manifest = load_exported(artifact)
    load_s = time.perf_counter() - t0
    model_code = sorted(m for m in sys.modules if m.split(".")[:2] in (
        ["mrfp_tpu_torch", "models"], ["mrfp_tpu_torch", "nn"], ["mrfp_tpu_torch", "perturb"],
        ["mrfp_tpu_torch", "train"]))
    from mrfp_tpu_torch.ops import LAUNCHES
    saved = torch.load(inputs, map_location="cuda")
    x, live = saved["images"], saved["logits"]
    got = fn(x)  # warm-up: cuDNN's first calls
    torch.cuda.synchronize()
    forwards = 1 + SERVING_FORWARDS
    ms = median_ms(lambda: fn(x), runs=SERVING_FORWARDS, warmup=0)
    got = fn(x)
    torch.cuda.synchronize()
    forwards += 1
    with open(out, "w") as f:
        json.dump({"model_code": model_code, "load_s": load_s, "ms": ms, "forwards": forwards,
                   "launches": dict(LAUNCHES), "shape": list(got.shape),
                   "finite": bool(torch.isfinite(got).all()),
                   "max_abs_err": (got - live).abs().max().item(),
                   "close": bool(torch.allclose(got, live, atol=1e-4, rtol=1e-4)),
                   "manifest": manifest}, f)


def _tb_scalars(run_dir: str) -> dict:
    """{tag: {step: value}} of every event file under ``run_dir/tb``, read
    with the port's own reader."""
    from mrfp_tpu_torch.utils.tbevents import read_tfevents
    by_tag = {}
    tb = os.path.join(run_dir, "tb")
    for name in sorted(os.listdir(tb)):
        for tag, value, step, _ in read_tfevents(os.path.join(tb, name)):
            by_tag.setdefault(tag, {})[step] = value
    return by_tag


def phase_serving(live_fp32_ms: float) -> dict:
    """The serving path and the run tools: ``cli.export`` at 1x1024x2048
    with a uint8 wire in fp32 and bf16, each with its bit-exact ``--check``;
    the live and the loaded fp32 forward timed in turns in this process;
    the fp32 artifact in a fresh process that imports no model code (its
    forward time, its bilinear launches, its logits against the live
    model's); ``cli.visualize``; ``cli.train --snapshot-every`` (snapshot
    copy times, ``tb/`` read back, the checkpoint resumed); and
    ``cli.bench_input`` beside the rate the bf16 step consumes. Returns the
    launches of these paths, the fresh process's included."""
    from mrfp_tpu_torch.cli import bench_input as cli_bench_input
    from mrfp_tpu_torch.cli import export as cli_export
    from mrfp_tpu_torch.cli import train as cli_train
    from mrfp_tpu_torch.cli import visualize as cli_visualize
    from mrfp_tpu_torch.models import build_mrfp
    from mrfp_tpu_torch.ops import LAUNCHES, reset_launches
    from mrfp_tpu_torch.serving import load_exported
    reset_launches()  # the comparisons above launched too; count only these paths
    with tempfile.TemporaryDirectory() as tmp:
        arts = {}
        for dtype in ("float32", "bfloat16"):
            arts[dtype] = os.path.join(tmp, f"r50_d16_{dtype}.pt2x")
            res = cli_export.main(["--device", "cuda", "--height", str(H), "--width", str(W),
                                   "--batch", "1", "--wire", "uint8", "--dtype", dtype,
                                   "--check", "--out", arts[dtype]])
            print(f"serving export {dtype} 1x{H}x{W}x3 uint8: {res['export_s']:.3f} s to "
                  f"export, {res['mb']:.1f} MB, ops {res['manifest']['ops']}; "
                  f"check: {res['check']} (TF32 off: "
                  f"{not torch.backends.cudnn.allow_tf32})")
            if dtype == "bfloat16":
                os.unlink(arts[dtype])

        # the live model's logits for the fresh process to hold its own to,
        # and the live and the loaded forward timed in turns in this process
        model = build_mrfp("cuda", generator=torch.Generator().manual_seed(0))
        live_fwd = cli_export.ServingForward(model, autocast=False)
        x = cli_export.random_batch((1, H, W, 3), "uint8", "cuda")
        with torch.no_grad():
            live = live_fwd(x)
            loaded, _ = load_exported(arts["float32"])
            turns = [median_ms(lambda f=f: f(x), runs=SERVING_FORWARDS)
                     for f in (live_fwd, loaded, loaded, live_fwd)]
        print(f"serving fp32 forward in one process, live / artifact / artifact / live: "
              f"{' / '.join(f'{t:.3f}' for t in turns)} ms (medians of {SERVING_FORWARDS})")
        del model, live_fwd, loaded
        inputs, out = os.path.join(tmp, "inputs.pt"), os.path.join(tmp, "child.json")
        torch.save({"images": x.cpu(), "logits": live.cpu()}, inputs)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT)] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c",
                               f"import chip_smoke; chip_smoke.serving_child("
                               f"{arts['float32']!r}, {inputs!r}, {out!r})"],
                              cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"serving child: rc {proc.returncode}\n{proc.stderr[-4000:]}")
        with open(out) as f:
            child = json.load(f)
        per_forward = child["launches"]["resize_bilinear"] / child["forwards"]
        print(f"serving artifact fp32 in a fresh process ({time.perf_counter() - t0:.1f} s "
              f"with start-up; load {child['load_s']:.3f} s): forward median "
              f"{child['ms']:.3f} ms over {SERVING_FORWARDS} (live fp32 forward "
              f"{live_fp32_ms:.3f} ms, phase_model); resize_bilinear launches "
              f"{child['launches']['resize_bilinear']} in {child['forwards']} forwards "
              f"({per_forward:g} a forward); max_abs_err vs the live logits "
              f"{child['max_abs_err']:.3e} (bound 1e-4); model code imported: "
              f"{child['model_code']}")
        if child["model_code"] or per_forward != 3 or not child["close"] \
                or not child["finite"] or child["shape"] != [1, 19, H, W] \
                or any(v for k, v in child["launches"].items() if k != "resize_bilinear"):
            raise AssertionError(f"serving artifact in a fresh process: {child}")

        viz = os.path.join(tmp, "viz")
        n = cli_visualize.main(["--device", "cuda", "--synthetic", "--synthetic-hw", str(H),
                                str(W), "--n", "2", "--out", viz])
        pngs = sorted(os.listdir(viz))
        print(f"cli.visualize: {n} triplets, {pngs}")
        if n != 2 or len(pngs) != 6:
            raise AssertionError(f"cli.visualize wrote {pngs}")

        runs = os.path.join(tmp, "runs")
        # r18-D32 at batch SNAPSHOT_N: a checkpoint is written (and synced to
        # disk) at each of a run's last 20 steps, and a smaller state writes faster
        common = ["--device", DEV, "--synthetic", "--trunk", "resnet-18", "--variant", "D32",
                  "--batch-size", str(SNAPSHOT_N), "--crop-size", str(CROP), "--log-every", "1",
                  "--snapshot-every", "2", "--step-timeout", "900", "--runs-dir", runs,
                  "--json-out", os.path.join(runs, "result.json")]
        # a checkpoint is written at each of a run's last 20 steps, and a
        # snapshot is skipped where one was (as in JAX): 24 steps leave steps
        # 1-3 without one, so snapshots fall at steps 2 and 4
        t0 = time.perf_counter()
        rc = cli_train.main(common + ["--max-iter", "24"])
        seconds = time.perf_counter() - t0
        with open(os.path.join(runs, "result.json")) as f:
            result = json.load(f)
        m, tb = _metrics(result["run_dir"]), _tb_scalars(result["run_dir"])
        snaps = {s: (m["train/snapshot_seconds"][s], int(m["train/snapshot_bytes"][s]))
                 for s in sorted(m.get("train/snapshot_seconds", {}))}
        consumed = m["train/images_per_sec"][3]  # no snapshot in step 3's window
        print(f"cli.train --snapshot-every 2, r18-D32 bf16 batch {SNAPSHOT_N}, 24 steps: rc "
              f"{rc}, {seconds:.1f} s end to end; "
              f"snapshots (step: host-copy s, bytes) {snaps}; tb/ steps of train/loss "
              f"{sorted(tb.get('train/loss', {}))}, of train/lr {sorted(tb.get('train/lr', {}))}; "
              f"images/s at step 3 {consumed:.3f}")
        steps = list(range(1, 25))
        if rc != 0 or result["step"] != 24 or sorted(snaps) != [2, 4] \
                or sorted(tb.get("train/loss", {})) != steps \
                or sorted(tb.get("train/lr", {})) != steps \
                or any(abs(tb["train/loss"][s] - m["train/loss"][s]) > 1e-6 * abs(m["train/loss"][s])
                       for s in steps):
            raise AssertionError(f"cli.train --snapshot-every: rc {rc}, result {result}, "
                                 f"snapshots {snaps}, tb {tb}")
        rc = cli_train.main(common + ["--max-iter", "25"])
        with open(os.path.join(runs, "result.json")) as f:
            resumed = json.load(f)
        print(f"cli.train resumed from the snapshot run's checkpoint: rc {rc}, steps "
              f"{sorted(resumed['losses'])}")
        if rc != 0 or resumed["step"] != 25 or sorted(resumed["losses"]) != ["25"]:
            raise AssertionError(f"cli.train resume after --snapshot-every: rc {rc}, {resumed}")
        launched = dict(LAUNCHES)

    bench = cli_bench_input.main(["--images", "16", "--batch-size", "4", "--num-workers", "4"])
    print(f"cli.bench_input 1914x1052 -> 768x768: {bench['main']:.2f} images/s in the main "
          f"process, {bench['process']:.2f} with 4 worker processes (start-up included), "
          f"beside {consumed:.2f} images/s that the r18-D32 bf16 batch-{SNAPSHOT_N} step "
          f"consumed (cli.train step 3)")
    launched["resize_bilinear"] += child["launches"]["resize_bilinear"]
    return launched


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
        if min(launched[k] for k in ("resize_bilinear", "confusion_matrix")) <= 0:
            raise AssertionError(f"cli.eval {dtype}: a kernel was not launched: {launched}")
        if r["images"] != 4 or r["pixels"] != 4 * H * W:
            raise AssertionError(f"cli.eval {dtype}: scored {r['images']} images, "
                                 f"{r['pixels']} pixels; expected 4, {4 * H * W}")
        if not all(math.isfinite(r[k]) and 0.0 <= r[k] <= 1.0
                   for k in ("mean_iu", "acc", "fwavacc")):
            raise AssertionError(f"cli.eval {dtype}: metrics out of range: {r}")
    return dict(LAUNCHES)


def _dtype_name(dtype) -> str:
    return str(dtype)[6:]


def _nearest_bwd_kernel(x, rule) -> str:
    """Which nearest backward kernel the wrapper launches for ``x`` and
    ``rule``: "staged" (every range at most two long, and a row fits its
    shared memory) or "direct"."""
    from mrfp_tpu_torch.ops import cuda_resize
    from mrfp_tpu_torch.ops.resize import nearest_table
    (rule_name, arg), = rule.items()
    h, w = x.shape[2:]
    ty = nearest_table(h, rule_name, arg[0], DEV)
    tx = nearest_table(w, rule_name, arg[1], DEV)
    rows = cuda_resize.nearest_bwd_rows_per_block(w, tx.idx.numel(), ty.max_run, tx.max_run,
                                                  x.element_size())
    return "staged" if rows else "direct"


def _nearest_fwd_kernel(x, rule) -> str:
    """Which nearest forward kernel the wrapper launches for ``x`` and
    ``rule``: "staged" (the ix table and a band's input rows fit its shared
    memory) or "direct"."""
    from mrfp_tpu_torch.ops import cuda_resize
    from mrfp_tpu_torch.ops.resize import nearest_table
    (rule_name, arg), = rule.items()
    h, w = x.shape[2:]
    ty = nearest_table(h, rule_name, arg[0], DEV)
    ow = nearest_table(w, rule_name, arg[1], DEV).idx.numel()
    plan = cuda_resize.nearest_fwd_plan(ty.spec, w, ow, x.element_size())
    return "staged" if plan.band else "direct"


def _nearest_fwd_bytes(x, rule) -> int:
    """The bytes the staged nearest forward moves for ``x``: each band's run
    of input rows (a downsample's band reads the rows it skips too, and a
    row two bands share is read twice) and the output once."""
    from mrfp_tpu_torch.ops import cuda_resize
    from mrfp_tpu_torch.ops.resize import nearest_index, nearest_table
    (rule_name, arg), = rule.items()
    n, c, h, w = x.shape
    ty = nearest_table(h, rule_name, arg[0], DEV)
    ow = nearest_table(w, rule_name, arg[1], DEV).idx.numel()
    band = cuda_resize.nearest_fwd_plan(ty.spec, w, ow, x.element_size()).band
    iy = nearest_index(*ty.spec)
    rows = sum(int(iy[min(o + band, iy.size) - 1] - iy[o]) + 1 for o in range(0, iy.size, band))
    return n * c * (rows * w + iy.size * ow) * x.element_size()


def _nearest_pair(x, rule, cuda_gen):
    """The nearest resize of ``x`` through the kernels and through the plain
    versions, forward and backward; raises unless both directions are
    exactly equal, or if either does not take its staged kernel. Returns
    the kernel's output and the cotangent."""
    from mrfp_tpu_torch.ops.resize import resize_nearest
    if _nearest_bwd_kernel(x, rule) != "staged" or _nearest_fwd_kernel(x, rule) != "staged":
        raise AssertionError(f"resize_nearest {tuple(x.shape)} {rule} {x.dtype}: a direction "
                             f"would not take its staged kernel")
    xk, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    yk = resize_nearest(xk, **rule)
    yp = resize_nearest(xp, impl="plain", **rule)
    g = torch.randn(yk.shape, device=DEV, generator=cuda_gen).to(x.dtype)
    yk.backward(g)
    yp.backward(g)
    torch.cuda.synchronize()
    if not (torch.equal(yk, yp) and torch.equal(xk.grad, xp.grad)):
        raise AssertionError(
            f"resize_nearest {tuple(x.shape)} {rule} {x.dtype}: kernel != plain, forward max "
            f"{(yk.float() - yp.float()).abs().max().item()}, backward max "
            f"{(xk.grad.float() - xp.grad.float()).abs().max().item()}")
    _held("resize_nearest", x, yk)
    _held("resize_nearest_bwd", g, xk.grad)
    return yk.detach(), g


def _nearest_bwd_f64(g, ty, tx, h: int, w: int):
    """The nearest backward of ``g`` in float64 (the W sums, then the H sums)."""
    gd = g.double()
    n, c, oh, _ = gd.shape
    gw = gd.new_zeros((n, c, oh, w)).index_add_(3, tx.idx.long(), gd)
    return gd.new_zeros((n, c, h, w)).index_add_(2, ty.idx.long(), gw)


def phase_nearest(cuda_gen) -> dict:
    """Kernels A and B against their plain versions at the OC shapes and the
    edge cases (both directions exactly equal; both staged kernels), and at
    ranges longer than two and a 30,000-wide output (the backward's direct
    kernel, and the forward's for that width). The OC lines give each
    direction's route, single-call and device time and GB/s."""
    from mrfp_tpu_torch.ops import cuda_resize
    from mrfp_tpu_torch.ops.resize import nearest_table
    import torch.nn.functional as F
    kernels = ("resize_nearest", "resize_nearest_bwd")
    # bf16 sums: kernel, plain, library single-call; kernel, library on the device
    times = {k: [0.0] * 5 for k in kernels}
    costs = {k: Cost() for k in kernels}
    fwd_own_gb = 0.0  # the bytes the staged forward itself moves, bf16
    for dtype in (torch.bfloat16, torch.float32):
        for name, n, c, (h, w), rule in NEAREST_EDGES:
            x = torch.randn((n, c, h, w), device=DEV, generator=cuda_gen).to(dtype)
            _nearest_pair(x, rule, cuda_gen)
        print(f"resize_nearest {_dtype_name(dtype)} edge cases "
              f"{[e[0] for e in NEAREST_EDGES]}: forward and backward exactly equal "
              f"(staged forward, staged backward)")
        for name, n, c, (h, w), rule in NEAREST_LONG:
            rule_name, arg = next(iter(rule.items()))
            ty = nearest_table(h, rule_name, arg[0], DEV)
            tx = nearest_table(w, rule_name, arg[1], DEV)
            x = torch.randn((n, c, h, w), device=DEV, generator=cuda_gen).to(dtype)
            if _nearest_bwd_kernel(x, rule) != "direct":
                raise AssertionError(f"resize_nearest_bwd {name}: not the direct kernel")
            if not torch.equal(cuda_resize.resize_nearest_cuda(x, ty, tx),
                               cuda_resize.resize_nearest_plain(x, ty, tx)):
                raise AssertionError(f"resize_nearest {name} {dtype}: forward kernel != plain")
            g = torch.randn((n, c, ty.idx.numel(), tx.idx.numel()), device=DEV,
                            generator=cuda_gen).to(dtype)
            got = cuda_resize.resize_nearest_bwd_cuda(g, ty, tx, h, w).double()
            exact, mag = (_nearest_bwd_f64(t, ty, tx, h, w) for t in (g, g.abs()))
            rounding = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -24
            terms = ty.max_run * tx.max_run
            over = ((got - exact).abs() - terms * 2.0 ** -24 * mag
                    - rounding * exact.abs()).max().item()
            if over > 0:
                raise AssertionError(f"resize_nearest_bwd {name} {dtype}: exceeds the bound "
                                     f"by {over:.3e}")
            print(f"resize_nearest_bwd {_dtype_name(dtype)} {name} ({n},{c},{h},{w}), up to "
                  f"{terms} terms a sum, direct kernel: max_abs_err vs float64 "
                  f"{(got - exact).abs().max().item():.3e}, within the bound; forward "
                  f"exactly equal, {_nearest_fwd_kernel(x, rule)} kernel")
        for name, c, (h, w), rule in NEAREST_SHAPES:
            x = torch.randn((TRAIN_N, c, h, w), device=DEV, generator=cuda_gen).to(dtype)
            yk, g = _nearest_pair(x, rule, cuda_gen)
            rule_name, arg = next(iter(rule.items()))
            ty = nearest_table(h, rule_name, arg[0], x.device)
            tx = nearest_table(w, rule_name, arg[1], x.device)
            out_hw = list(yk.shape[2:])
            with torch.no_grad():
                ms = {"resize_nearest": (
                    median_ms(lambda: cuda_resize.resize_nearest_cuda(x, ty, tx), runs=10),
                    median_ms(lambda: cuda_resize.resize_nearest_plain(x, ty, tx), runs=10),
                    median_ms(lambda: F.interpolate(x, size=out_hw, mode="nearest"), runs=10)),
                      "resize_nearest_bwd": (
                    median_ms(lambda: cuda_resize.resize_nearest_bwd_cuda(g, ty, tx, h, w),
                              runs=10),
                    median_ms(lambda: cuda_resize.resize_nearest_bwd_plain(g, ty, tx, h, w),
                              runs=10),
                    median_ms(lambda: torch.ops.aten.upsample_nearest2d_backward(
                        g, out_hw, list(x.shape)), runs=10))}
                dev = {"resize_nearest": (
                    device_ms(lambda: cuda_resize.resize_nearest_cuda(x, ty, tx), calls=10),
                    device_ms(lambda: F.interpolate(x, size=out_hw, mode="nearest"), calls=10)),
                       "resize_nearest_bwd": (
                    device_ms(lambda: cuda_resize.resize_nearest_bwd_cuda(g, ty, tx, h, w),
                              calls=10),
                    device_ms(lambda: torch.ops.aten.upsample_nearest2d_backward(
                        g, out_hw, list(x.shape)), calls=10))}
            gb = 2 * yk.numel() * yk.element_size() / 1e9  # one read, one write of out
            own_gb = _nearest_fwd_bytes(x, rule) / 1e9
            gb_bwd = (yk.numel() + x.numel()) * yk.element_size() / 1e9  # g in, gx out
            print(f"resize_nearest {_dtype_name(dtype)} {name} ({TRAIN_N},{c},{h},{w})->"
                  f"{tuple(yk.shape[2:])}: forward exactly equal, "
                  f"{_nearest_fwd_kernel(x, rule)} kernel "
                  f"{ms['resize_nearest'][0]:.4f} ms ({gb / ms['resize_nearest'][0] * 1e3:.0f}"
                  f" GB/s), plain {ms['resize_nearest'][1]:.4f} ms, F.interpolate "
                  f"{ms['resize_nearest'][2]:.4f} ms; device time (graph) forward kernel "
                  f"{dev['resize_nearest'][0]:.4f} ms "
                  f"({gb / dev['resize_nearest'][0] * 1e3:.0f} GB/s; its own "
                  f"{own_gb:.4f} GB, bound's {nbytes(x, yk) / 1e9:.4f}), F.interpolate "
                  f"{dev['resize_nearest'][1]:.4f} ms; backward exactly equal, staged kernel "
                  f"{ms['resize_nearest_bwd'][0]:.4f} ms "
                  f"({gb_bwd / ms['resize_nearest_bwd'][0] * 1e3:.0f} GB/s), plain "
                  f"{ms['resize_nearest_bwd'][1]:.4f} ms, aten backward "
                  f"{ms['resize_nearest_bwd'][2]:.4f} ms; device time (graph) backward kernel "
                  f"{dev['resize_nearest_bwd'][0]:.4f} ms "
                  f"({gb_bwd / dev['resize_nearest_bwd'][0] * 1e3:.0f} GB/s), aten "
                  f"{dev['resize_nearest_bwd'][1]:.4f} ms")
            if dtype == torch.bfloat16:
                for k in times:
                    for i, t in enumerate(ms[k] + dev[k]):
                        times[k][i] += t
                    costs[k].add(nbytes(x, yk))  # forward: x in, y out; backward: g in, gx out
                fwd_own_gb += own_gb
            del x, yk, g
        torch.cuda.empty_cache()
    for k, lib in (("resize_nearest", "F.interpolate"),
                   ("resize_nearest_bwd", "aten backward")):
        t = times[k]
        print(f"{k} bf16, the seven OC resizes: kernel {t[0]:.3f} ms, plain {t[1]:.3f} ms, "
              f"{lib} {t[2]:.3f} ms, bound {costs[k].bound_ms:.3f} ms; device time (graph) "
              f"kernel {t[3]:.3f} ms, {lib} {t[4]:.3f} ms")
    bound_gb = costs["resize_nearest"].bytes_ms * HBM_BYTES_PER_S / 1e12
    print(f"resize_nearest bf16, the seven OC resizes: the staged forward moves "
          f"{fwd_own_gb:.4f} GB, the bound counts {bound_gb:.4f} GB")
    return {k: {"max_abs_err": 0.0, "ms": times[k][0], "plain_ms": times[k][1],
                "library_ms": times[k][2], "device_ms": times[k][3],
                "library_device_ms": times[k][4], **costs[k].fields()} for k in times}


def _bilinear_bwd_route(g, h: int, w: int) -> str:
    """The route the bilinear backward takes for the cotangent ``g`` of an
    (h, w) input: "sum" (1x1 input), "staged" (with its 16-byte or scalar
    cotangent loads, "tiled" where a row is cut into column tiles) or
    "direct"."""
    from mrfp_tpu_torch.ops import cuda_resize
    plan = cuda_resize.bilinear_bwd_plan(h, w, *g.shape[2:], g.element_size())
    if plan.route != "staged":
        return plan.route
    return ("staged vector" if plan.vec > 1 else "staged scalar") + \
        (" tiled" if plan.cols < w else "")


def _bilinear_bwd_close(got, g, ty, tx, h: int, w: int, what: str) -> float:
    """Holds the backward kernel's ``got`` for the cotangent ``g`` against
    the plain version; returns the largest difference. The two sum in
    different orders (the plain version's index_add_ uses atomics): fp32
    within 1e-5 + 1e-5 * |ref| plus 2^-21 of the summed magnitudes of the
    terms (an input of the 1x1 broadcast sums 2,304, at eval 8,192); bf16
    within ``TOL``, about one ulp."""
    from mrfp_tpu_torch.ops import cuda_resize
    ref = cuda_resize.resize_bilinear_bwd_plain(g, ty, tx, h, w)
    if g.dtype == torch.float32:
        mag = cuda_resize.resize_bilinear_bwd_plain(g.abs(), ty, tx, h, w)
        allowed = 1e-5 + 1e-5 * ref.abs() + 2.0 ** -21 * mag
        over = ((got - ref).abs() - allowed).max().item()
        if over > 0:
            raise AssertionError(f"resize_bilinear_bwd {what}: kernel vs plain exceeds the "
                                 f"bound by {over:.3e}")
    else:
        torch.testing.assert_close(got, ref, **TOL[g.dtype], msg=lambda m: f"{what}: {m}")
    return (got.float() - ref.float()).abs().max().item()


def _bilinear_pair(x, size, cuda_gen, what: str) -> tuple:
    """The bilinear resize of ``x`` to ``size`` through the kernels and
    through the plain versions, forward and backward: raises unless the
    forward is exactly equal and the backward within its bound
    (``_bilinear_bwd_close``). Returns the cotangent, the two tap tables,
    the backward's max_abs_err and the plain gradient's largest value."""
    from mrfp_tpu_torch.ops.resize import bilinear_taps, resize_bilinear_align_corners
    h, w = x.shape[2:]
    xk, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    yk = resize_bilinear_align_corners(xk, size)
    yp = resize_bilinear_align_corners(xp, size, impl="plain")
    torch.cuda.synchronize()
    _bilinear_fwd_equal(yk, yp, what)
    g = torch.randn(yk.shape, device=DEV, generator=cuda_gen).to(x.dtype)
    yk.backward(g)
    yp.backward(g)
    ty, tx = bilinear_taps(h, size[0], x.device), bilinear_taps(w, size[1], x.device)
    torch.cuda.synchronize()
    err = _bilinear_bwd_close(xk.grad, g, ty, tx, h, w, what)
    _held("resize_bilinear", x, yk)
    _held("resize_bilinear_bwd", g, xk.grad)
    return g, ty, tx, err, xp.grad.float().abs().max().item()


def phase_bilinear_train(cuda_gen) -> dict:
    """The bilinear forward and its backward (kernel C) against their plain
    versions at the train and eval shapes and at an odd width (the forward's
    scalar route), the backward also at every edge shape, from an offset
    view too: the forward exactly equal, each line naming both routes.
    Returns the two kernels' entries: worst error, and single-call and
    device (CUDA-graph) ms of kernel, plain version and library call summed
    over the five train shapes in bf16 (the step's own resizes)."""
    import torch.nn.functional as F
    from mrfp_tpu_torch.ops import cuda_resize
    from mrfp_tpu_torch.ops.resize import bilinear_taps
    keys = ("ms", "plain_ms", "library_ms", "device_ms", "library_device_ms")
    out = {k: {"max_abs_err": 0.0, **dict.fromkeys(keys, 0.0)}
           for k in ("resize_bilinear", "resize_bilinear_bwd")}
    costs = {k: Cost() for k in out}
    for dtype in (torch.bfloat16, torch.float32):
        for name, n, c, (h, w), size in BILINEAR_TRAIN_SHAPES:
            x = torch.randn((n, c, h, w), device=DEV, generator=cuda_gen).to(dtype)
            what = f"{_dtype_name(dtype)} {name} ({n},{c},{h},{w})->{size}"
            g, ty, tx, bwd_err, grad_max = _bilinear_pair(x, size, cuda_gen, what)
            calls = {"resize_bilinear": (
                lambda: cuda_resize.resize_bilinear_cuda(x, ty, tx),
                lambda: cuda_resize.resize_bilinear_plain(x, ty, tx),
                lambda: F.interpolate(x, size=size, mode="bilinear", align_corners=True)),
                     "resize_bilinear_bwd": (
                lambda: cuda_resize.resize_bilinear_bwd_cuda(g, ty, tx, h, w),
                lambda: cuda_resize.resize_bilinear_bwd_plain(g, ty, tx, h, w),
                lambda: torch.ops.aten.upsample_bilinear2d_backward(
                    g, list(size), list(x.shape), True))}
            with torch.no_grad():
                # single call: kernel, plain, library; device: kernel, library
                ms = {k: [median_ms(f, runs=10) for f in fns]
                      + [device_ms(fns[0], calls=10), device_ms(fns[2], calls=10)]
                      for k, fns in calls.items()}
            for k, err in (("resize_bilinear", 0.0), ("resize_bilinear_bwd", bwd_err)):
                out[k]["max_abs_err"] = max(out[k]["max_abs_err"], err)
                if dtype == torch.bfloat16 and name.startswith("train"):
                    for key, t in zip(keys, ms[k]):
                        out[k][key] += t
                    costs[k].add(nbytes(x, g))  # x in / y out, or g in / gx out
            gb = (g.numel() + x.numel()) * g.element_size() / 1e9
            fwd, bwd = ms["resize_bilinear"], ms["resize_bilinear_bwd"]
            print(f"resize_bilinear {what}: forward exactly equal, "
                  f"{_bilinear_route(x, size)} route, kernel {fwd[0]:.4f} ms, plain "
                  f"{fwd[1]:.4f} ms, F.interpolate {fwd[2]:.4f} ms; device time (graph) kernel "
                  f"{fwd[3]:.4f} ms ({gb / fwd[3] * 1e3:.0f} GB/s), F.interpolate {fwd[4]:.4f} "
                  f"ms; backward {_bilinear_bwd_route(g, h, w)} route, max_abs_err "
                  f"{bwd_err:.3e} (|grad| max {grad_max:.3e}), kernel {bwd[0]:.4f} ms "
                  f"({gb / bwd[0] * 1e3:.0f} GB/s), plain {bwd[1]:.4f} ms, aten backward "
                  f"{bwd[2]:.4f} ms; device time (graph) kernel {bwd[3]:.4f} ms, aten "
                  f"{bwd[4]:.4f} ms")
            del x, g
        torch.cuda.empty_cache()
        routes = []
        for (h, w), size in EDGE_RESIZES:
            ty, tx = bilinear_taps(h, size[0], DEV), bilinear_taps(w, size[1], DEV)
            # the second cotangent of three: a contiguous view whose data
            # need not start on a 16-byte boundary
            for g in (torch.randn((2, 5, *size), device=DEV, generator=cuda_gen).to(dtype),
                      torch.randn((3, 5, *size), device=DEV,
                                  generator=cuda_gen).to(dtype)[1:2]):
                what = (f"{_dtype_name(dtype)} edge case {tuple(g.shape)} to ({h}, {w}) at "
                        f"byte {g.data_ptr() % 16} of a granule")
                err = _bilinear_bwd_close(cuda_resize.resize_bilinear_bwd_cuda(g, ty, tx, h, w),
                                          g, ty, tx, h, w, what)
                out["resize_bilinear_bwd"]["max_abs_err"] = max(
                    out["resize_bilinear_bwd"]["max_abs_err"], err)
            routes.append(_bilinear_bwd_route(g, h, w))
        print(f"resize_bilinear_bwd {_dtype_name(dtype)} edge cases {EDGE_RESIZES}, each also "
              f"from an offset view: within the bound, routes {routes}")
    for k in out:
        out[k].update(costs[k].fields())
        print(f"{k} bf16, the five train resizes: kernel {out[k]['ms']:.3f} ms, plain "
              f"{out[k]['plain_ms']:.3f} ms, library {out[k]['library_ms']:.3f} ms, bound "
              f"{out[k]['bound_ms']:.3f} ms; device time (graph) kernel "
              f"{out[k]['device_ms']:.3f} ms, library {out[k]['library_device_ms']:.3f} ms")
    return out


def _dot_stats_check(name, x, w) -> tuple:
    """dot_with_stats on ``x``, ``w`` through the kernel its route names and
    through the plain version. Bounds, with u = 2^-24: y within
    2*K*u*(|w| @ |x|) of plain (two fp32 GEMMs of depth K), plus one bf16 ulp
    (2^-7 |y|) in bf16; each sum within 2^-15 of the summed magnitudes of
    the kernel's own stored y (the sum of y and of y^2 in float64). Raises
    if a bound fails or the launch did not take its route. Returns the
    kernel's name, its y error, the sums' distance from plain's (relative
    to the summed magnitudes), |y| max and the kernel's stored y."""
    from mrfp_tpu_torch.ops import LAUNCHES, cuda_dot_stats
    n, cin = x.shape[:2]
    tc = cuda_dot_stats.tensor_core_route(x.dtype, cin, x.shape[2] * x.shape[3])
    before = LAUNCHES["dot_with_stats_tc"]
    yk, s1k, s2k = cuda_dot_stats.dot_with_stats_cuda(x, w)
    took_tc = LAUNCHES["dot_with_stats_tc"] - before
    yp, s1p, s2p = cuda_dot_stats.dot_with_stats_plain(x, w)
    torch.cuda.synchronize()
    xc = x.contiguous().float().reshape(n, cin, -1)
    mag = torch.matmul(w.float().abs(), xc.abs()).reshape(yp.shape)
    allowed = 2 * cin * 2.0 ** -24 * mag + 1e-30
    if x.dtype == torch.bfloat16:
        allowed = allowed + 2.0 ** -7 * yp.float().abs()
    diff = (yk.float() - yp.float()).abs()
    over = (diff - allowed).max().item()
    yd = yk.double()
    sum_err = max(((s1k.double() - yd.sum((0, 2, 3))).abs()
                   - 2.0 ** -15 * yd.abs().sum((0, 2, 3))).max().item(),
                  ((s2k.double() - (yd * yd).sum((0, 2, 3))).abs()
                   - 2.0 ** -15 * (yd * yd).sum((0, 2, 3))).max().item())
    # kernel vs plain sums, relative to the summed magnitudes (diagnostic)
    s_rel = max(((s1k.double() - s1p.double()).abs()
                 / yd.abs().sum((0, 2, 3))).max().item(),
                ((s2k.double() - s2p.double()).abs() / (yd * yd).sum((0, 2, 3))).max().item())
    kernel = "tensor-core" if tc else "CUDA-core"
    if over > 0 or sum_err > 0 or not torch.isfinite(yk).all() or took_tc != int(tc):
        raise AssertionError(f"dot_with_stats {name} {x.dtype} ({kernel} route, "
                             f"{took_tc} tensor-core launches): kernel vs plain exceeds the "
                             f"bound by {over:.3e} (y) / {sum_err:.3e} (sums)")
    return kernel, diff.max().item(), s_rel, yp.float().abs().max().item(), yk


def phase_dot_stats(cuda_gen) -> dict:
    """dot_with_stats against its plain version (bounds: ``_dot_stats_check``)
    at the 15 shapes of the 36 fused sites in bf16 (the strided downsamples
    from a stride-2 slice), at three of them in fp32 (TF32 off), and at the
    ragged shapes in both dtypes. Each line names the kernel that ran."""
    import torch.nn.functional as F
    from mrfp_tpu_torch.ops import cuda_dot_stats
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = [(n, TRAIN_N, ci, co, (s, s), k, torch.bfloat16)
             for n, ci, co, s, k in DOT_STATS_SHAPES]
    cases += [(n, TRAIN_N, ci, co, (s, s), k, torch.float32)
              for n, ci, co, s, k in DOT_STATS_SHAPES if n in DOT_STATS_FP32]
    cases += [(f"ragged: {n}", b, ci, co, hw, 0, dt) for n, b, ci, co, hw in DOT_STATS_RAGGED
              for dt in (torch.bfloat16, torch.float32)]
    worst, totals, cost = 0.0, [0.0] * 5, Cost()  # bf16 sums; the last two on the device
    for name, batch, cin, cout, (h, wd), sites, dtype in cases:
        stride = 2 if "stride 2" in name else 1
        x = torch.randn((batch, cin, h * stride, wd * stride), device=DEV,
                        generator=cuda_gen).to(dtype)[:, :, ::stride, ::stride]
        w = (torch.randn((cout, cin), device=DEV, generator=cuda_gen) * cin ** -0.5).to(dtype)
        kernel, err, s_rel, ymax, yk = _dot_stats_check(name, x, w)
        worst = max(worst, err)
        w4 = w[:, :, None, None]
        k_ms = median_ms(lambda: cuda_dot_stats.dot_with_stats_cuda(x, w), runs=10)
        p_ms = median_ms(lambda: cuda_dot_stats.dot_with_stats_plain(x, w), runs=10)
        l_ms = median_ms(lambda: torch.var_mean(F.conv2d(x, w4), dim=(0, 2, 3)), runs=10)
        dev = (device_ms(lambda: cuda_dot_stats.dot_with_stats_cuda(x, w)),
               device_ms(lambda: torch.var_mean(F.conv2d(x, w4), dim=(0, 2, 3))))
        flops = 2.0 * batch * cin * cout * h * wd
        moved = nbytes(x, w, yk) + 8 * cout
        bound = Cost().add(moved, flops, dtype)
        where = f"{sites} site(s)" if sites else "not a site of the step"
        print(f"dot_with_stats {_dtype_name(dtype)} {name} ({batch},{cin},{h},{wd})"
              f"x({cout},{cin}), {where}: {kernel} kernel; y max_abs_err {err:.3e} "
              f"(|y| max {ymax:.3e}), sums vs plain {s_rel:.3e} of the summed magnitudes; "
              f"kernel {k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s, "
              f"{moved / k_ms / 1e6:.0f} GB/s), plain {p_ms:.4f} ms, "
              f"conv2d+var_mean {l_ms:.4f} ms, bound {bound:.4f} ms; device time (graph) "
              f"kernel {dev[0]:.4f} ms ({flops / dev[0] / 1e9:.1f} TFLOP/s, "
              f"{moved / dev[0] / 1e6:.0f} GB/s), conv2d+var_mean {dev[1]:.4f} ms")
        if dtype == torch.bfloat16:
            for i, t in enumerate((k_ms, p_ms, l_ms) + dev):
                totals[i] += sites * t
            cost.add(moved, flops, dtype, times=sites)
        del x, w, yk
    torch.cuda.empty_cache()
    _dot_stats_host_times(cuda_gen)
    print(f"dot_with_stats bf16, the 36 sites of a batch-{TRAIN_N} step: kernel "
          f"{totals[0]:.3f} ms, plain {totals[1]:.3f} ms, conv2d+var_mean {totals[2]:.3f} ms, "
          f"bound {cost.bound_ms:.3f} ms; device time (graph) kernel {totals[3]:.3f} ms, "
          f"conv2d+var_mean {totals[4]:.3f} ms")
    return {"max_abs_err": worst, "ms": totals[0], "plain_ms": totals[1],
            "library_ms": totals[2], "device_ms": totals[3], "library_device_ms": totals[4],
            **cost.fields()}


def _dot_stats_host_times(cuda_gen) -> None:
    """Host time of a tensor-core dot_with_stats call at a layer3 site:
    through the wrapper, and through the library's C entry alone (its three
    tensor-map encodings and two launches) with the outputs allocated
    beforehand. Prints one line beside the call's device time."""
    from mrfp_tpu_torch.ops import _build, cuda_dot_stats
    name, cin, cout, side, _sites = next(s for s in DOT_STATS_SHAPES
                                         if s[0] == "layer3 conv1 blocks1-5")
    hw = side * side
    x = torch.randn((TRAIN_N, cin, side, side), device=DEV, generator=cuda_gen).to(torch.bfloat16)
    w = (torch.randn((cout, cin), device=DEV, generator=cuda_gen) * cin ** -0.5).to(torch.bfloat16)
    lib = _build.load_library()
    parts = lib.mrfp_dot_with_stats_parts(TRAIN_N, cout, hw, 1)
    y = torch.empty((TRAIN_N, cout, side, side), dtype=torch.bfloat16, device=DEV)
    part = torch.empty((2, parts, cout), dtype=torch.float64, device=DEV)
    s1, s2 = (torch.empty(cout, device=DEV) for _ in range(2))
    stream = torch.cuda.current_stream().cuda_stream

    def c_entry():
        err = lib.mrfp_dot_with_stats(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                      part.data_ptr(), parts, s1.data_ptr(), s2.data_ptr(),
                                      TRAIN_N, cin, cout, hw, 1, 1, stream)
        _build.check(err, "dot_with_stats")

    calls = (lambda: cuda_dot_stats.dot_with_stats_cuda(x, w), c_entry)
    rounds = [[host_us(fn, runs=20) for fn in calls] for _ in range(5)]  # interleaved
    us = [statistics.median(r[i] for r in rounds) for i in range(len(calls))]
    dev = device_ms(lambda: cuda_dot_stats.dot_with_stats_cuda(x, w))
    print(f"dot_with_stats host time a call, bf16 {name} {tuple(x.shape)}x({cout},{cin}), "
          f"tensor-core kernel: wrapper {us[0]:.1f} us, of which the C entry (three tensor-map "
          f"encodings, two launches) {us[1]:.1f} us; device time (graph) {dev * 1e3:.1f} us")
    del x, w, y, part


def _nearest_idx(size: int, rule: str, arg) -> tuple:
    from mrfp_tpu_torch.ops.resize import _nearest_idx_from_scale, _nearest_idx_from_size
    idx = (_nearest_idx_from_scale(size, float(arg)) if rule == "scale"
           else _nearest_idx_from_size(size, int(arg)))
    return tuple(int(i) for i in idx)


# (name, N, C, in_hw, (rule, arg), dim): row-mix edge cases of take_rows,
# both directions exactly equal: widths 1, 7 and 9, h = 1, odd widths on
# both axes, downsamples (their transposes have empty rows), and rows too
# wide for a stage (the direct W kernel, the scalar H route)
ROW_MIX_EDGES = [
    ("width 1 x1.5 along W", 2, 3, (5, 1), ("scale", 1.5), 3),
    ("width 7 x1.3 along W", 2, 3, (6, 7), ("scale", 1.3), 3),
    ("width 9 to 13 along W", 2, 3, (9, 9), ("size", 13), 3),
    ("width 7, x1.3 along H", 2, 3, (6, 7), ("scale", 1.3), 2),
    ("width 9, x0.798 along H", 2, 3, (9, 9), ("scale", 0.798), 2),
    ("h 1 to 2 along H", 2, 3, (1, 20), ("size", 2), 2),
    ("h 1, 20 to 30 along W", 2, 3, (1, 20), ("size", 30), 3),
    ("7 to 3 along W", 2, 3, (7, 7), ("size", 3), 3),
    ("11000 to 11002 wide along W", 1, 2, (2, 11000), ("size", 11002), 3),
    ("width 11001, x1.5 along H", 1, 2, (3, 11001), ("scale", 1.5), 2),
]


def _row_mix_route(x, table, dim) -> str:
    """The route ``row_mix_table_cuda`` takes for ``x`` and ``table``."""
    from mrfp_tpu_torch.ops import cuda_row_mix
    n, c, h, w = x.shape
    return cuda_row_mix._table_plan(table, dim, w, x.element_size(), x.data_ptr() % 16 == 0,
                                    n * c * h).route


def _row_mix_route_comparison(cuda_gen) -> None:
    """The H mix's 16-byte route against the staged route on the same rows:
    in bf16 at the three OC shapes whose rows are whole 16-byte vectors
    (enc1, dec2, dec4; forward + backward with take_rows' tables, device
    time), and for a dense P at the enc1 shape, where a table compacted on
    the card leaves the scalar route as the other choice. The other route
    is forced by planning as if the pointers were not 16-byte aligned;
    both must equal plain as the kernel's own checks require."""
    from unittest import mock

    from mrfp_tpu_torch.ops import cuda_row_mix as rm
    from mrfp_tpu_torch.ops.resize import onehot_rows, onehot_table
    plan = rm._table_plan

    def unaligned(table, dim, width, itemsize, aligned, rows):
        return plan(table, dim, width, itemsize, False, rows)

    def timed(fn, check):
        """(route, device ms) of fn() as planned, then with the other route."""
        out = []
        for patch in (mock.patch.object(rm, "_table_plan", plan),
                      mock.patch.object(rm, "_table_plan", unaligned)):
            with patch:
                check(fn())
                out.append(device_ms(fn, calls=10))
        return out

    for i in (0, 4, 6):
        name, c, (h, w), rule = NEAREST_SHAPES[i]
        (rule_name, arg), = rule.items()
        idx = _nearest_idx(h, rule_name, arg[0])
        tab, tabt = onehot_table(idx, h, DEV), onehot_table(idx, h, DEV, transpose=True)
        x = torch.randn((TRAIN_N, c, h, w), device=DEV, generator=cuda_gen).to(torch.bfloat16)
        g = torch.randn((TRAIN_N, c, len(idx), w), device=DEV,
                        generator=cuda_gen).to(torch.bfloat16)
        yp = rm.row_mix_plain(x, onehot_rows(idx, h, DEV), 2)
        gp = rm.row_mix_plain(g, onehot_rows(idx, h, DEV, transpose=True), 2)

        def equal(ref):
            def check(got):
                if not torch.equal(got, ref):
                    raise AssertionError(f"row_mix route comparison {name}: kernel != plain")
            return check
        fwd = timed(lambda: rm.row_mix_table_cuda(x, tab, 2), equal(yp))
        bwd = timed(lambda: rm.row_mix_table_cuda(g, tabt, 2), equal(gp))
        routes = (_row_mix_route(x, tab, 2), unaligned(tab, 2, w, 2, True, 0).route)
        print(f"row_mix route comparison bf16 {name} ({TRAIN_N},{c},{h},{w}) along H, forward "
              f"+ backward, exactly equal both ways: device time (graph) {routes[0]} route "
              f"{fwd[0] + bwd[0]:.4f} ms (forward {fwd[0]:.4f}), {routes[1]} route "
              f"{fwd[1] + bwd[1]:.4f} ms (forward {fwd[1]:.4f})")
        del x, g, yp, gp

    name, c, (h, w), _ = NEAREST_SHAPES[0]
    x = torch.randn((TRAIN_N, c, h, w), device=DEV, generator=cuda_gen).to(torch.bfloat16)
    p = torch.randn((231, h), device=DEV, generator=cuda_gen)
    table = rm.row_mix_compact_cuda(p)
    ref = rm.row_mix_table_cuda(x, table, 2)

    def same(got):
        if not torch.equal(got, ref):  # one column order, one fmaf chain: bit-equal
            raise AssertionError("row_mix route comparison, dense P: the routes disagree")
    ms = timed(lambda: rm.row_mix_table_cuda(x, table, 2), same)
    print(f"row_mix route comparison bf16 dense P (231,{h}) on {name} ({TRAIN_N},{c},{h},{w}) "
          f"along H, bit-equal both ways: device time (graph) "
          f"{_row_mix_route(x, table, 2)} route {ms[0]:.4f} ms, "
          f"{unaligned(table, 2, w, 2, True, 0).route} route {ms[1]:.4f} ms")
    del x, ref
    torch.cuda.empty_cache()


def phase_row_mix(cuda_gen) -> dict:
    """take_rows' kernel (the mix with the one-hot P's cached table, and with
    P^T's for the gradient) against the plain versions at the seven OC
    shapes, along H for the even ones and W for the odd, and at the edge
    cases: a copy and sums of at most two terms, so both directions must be
    exactly equal, and the forward equal to index_select. Times in bf16,
    summed over the seven, forward plus backward; the library calls
    index_select / index_add_. Then a general dense random P at the enc1
    shape along both axes, fp32 and bf16 x, through ``row_mix_cuda``
    (compaction, then the mix): within in * 2^-23 of the summed magnitudes
    |P| @ |x| of plain's fp32 product (two fp32 sums of ``in`` terms in
    different orders), plus one bf16 ulp (2^-7 of the result) in bf16; the
    compaction's own time on a line of its own."""
    from mrfp_tpu_torch.ops import LAUNCHES, cuda_row_mix
    from mrfp_tpu_torch.ops.resize import onehot_rows, onehot_table
    totals, cost = [0.0] * 5, Cost()
    for dtype in (torch.bfloat16, torch.float32):
        for i, (name, c, (h, w), rule) in enumerate(NEAREST_SHAPES):
            dim = 2 if i % 2 == 0 else 3
            rule_name, arg = next(iter(rule.items()))
            size = (h, w)[dim - 2]
            idx = _nearest_idx(size, rule_name, arg[dim - 2])
            p, pt = onehot_rows(idx, size, DEV), onehot_rows(idx, size, DEV, transpose=True)
            tab, tabt = onehot_table(idx, size, DEV), onehot_table(idx, size, DEV, transpose=True)
            x = torch.randn((TRAIN_N, c, h, w), device=DEV, generator=cuda_gen).to(dtype)
            yk = cuda_row_mix.row_mix_table_cuda(x, tab, dim)
            yp = cuda_row_mix.row_mix_plain(x, p, dim)
            g = torch.randn(yk.shape, device=DEV, generator=cuda_gen).to(dtype)
            gk = cuda_row_mix.row_mix_table_cuda(g, tabt, dim)
            gp = cuda_row_mix.row_mix_plain(g, pt, dim)
            torch.cuda.synchronize()
            ti = torch.as_tensor(idx, device=DEV)
            if not (torch.equal(yk, yp) and torch.equal(yk, x.index_select(dim, ti))
                    and torch.equal(gk, gp)):
                raise AssertionError(f"row_mix {name} dim {dim} {dtype}: kernel != plain "
                                     f"(forward {torch.equal(yk, yp)}, "
                                     f"backward {torch.equal(gk, gp)})")
            pairs = ((lambda: cuda_row_mix.row_mix_table_cuda(x, tab, dim),
                      lambda: cuda_row_mix.row_mix_table_cuda(g, tabt, dim)),
                     (lambda: cuda_row_mix.row_mix_plain(x, p, dim),
                      lambda: cuda_row_mix.row_mix_plain(g, pt, dim)),
                     (lambda: x.index_select(dim, ti),
                      lambda: torch.zeros_like(x).index_add_(dim, ti, g)))
            ms = [median_ms(fwd, runs=10) + median_ms(bwd, runs=10) for fwd, bwd in pairs]
            fwd_dev = device_ms(pairs[0][0], calls=10)
            bwd_dev = device_ms(pairs[0][1], calls=10)
            ms += [fwd_dev + bwd_dev, device_ms(pairs[2][0], calls=10)
                   + device_ms(pairs[2][1], calls=10)]
            gb = nbytes(x, yk, g, gk) / 1e9
            print(f"row_mix {_dtype_name(dtype)} {name} ({TRAIN_N},{c},{h},{w}) along "
                  f"{'HW'[dim - 2]} -> {tuple(yk.shape[2:])}: forward and backward exactly "
                  f"equal, forward {_row_mix_route(x, tab, dim)} route, backward "
                  f"{_row_mix_route(g, tabt, dim)} route; forward + backward kernel "
                  f"{ms[0]:.4f} ms, plain {ms[1]:.4f} ms, index_select + index_add_ "
                  f"{ms[2]:.4f} ms; device time (graph) kernel {ms[3]:.4f} ms (forward "
                  f"{fwd_dev:.4f}, backward {bwd_dev:.4f}; {gb / ms[3] * 1e3:.0f} GB/s), "
                  f"index_select + index_add_ {ms[4]:.4f} ms")
            if dtype == torch.bfloat16:
                for j in range(5):
                    totals[j] += ms[j]
                # each direction reads one map and P, writes the other map
                cost.add(nbytes(x, yk, p))
                cost.add(nbytes(g, gk, pt))
            del x, yk, yp, g, gk, gp
        torch.cuda.empty_cache()
    print(f"row_mix bf16, the seven OC shapes forward + backward: kernel {totals[0]:.3f} ms, "
          f"plain {totals[1]:.3f} ms, index_select + index_add_ {totals[2]:.3f} ms, bound "
          f"{cost.bound_ms:.3f} ms; device time (graph) kernel {totals[3]:.3f} ms, "
          f"index_select + index_add_ {totals[4]:.3f} ms")
    _row_mix_route_comparison(cuda_gen)

    routes = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, n, c, (h, w), (rule_name, arg), dim in ROW_MIX_EDGES:
            size = (h, w)[dim - 2]
            idx = _nearest_idx(size, rule_name, arg)
            tab, tabt = onehot_table(idx, size, DEV), onehot_table(idx, size, DEV, transpose=True)
            # the second of three samples: a view that need not start 16-byte aligned
            for x in (torch.randn((n, c, h, w), device=DEV, generator=cuda_gen).to(dtype),
                      torch.randn((3, c, h, w), device=DEV, generator=cuda_gen).to(dtype)[1:2]):
                y = cuda_row_mix.row_mix_table_cuda(x, tab, dim)
                g = torch.randn(y.shape, device=DEV, generator=cuda_gen).to(dtype)
                gx = cuda_row_mix.row_mix_table_cuda(g, tabt, dim)
                ok = (torch.equal(y, cuda_row_mix.row_mix_plain(x, onehot_rows(idx, size, DEV),
                                                                dim))
                      and torch.equal(y, x.index_select(dim, torch.as_tensor(idx, device=DEV)))
                      and torch.equal(gx, cuda_row_mix.row_mix_plain(
                          g, onehot_rows(idx, size, DEV, transpose=True), dim)))
                if not ok:
                    raise AssertionError(f"row_mix edge case {name} {dtype} "
                                         f"{tuple(x.shape)}: kernel != plain")
            routes.append(f"{_row_mix_route(x, tab, dim)}/{_row_mix_route(g, tabt, dim)}")
    print(f"row_mix edge cases {[e[0] for e in ROW_MIX_EDGES]}, bf16 and fp32, each also "
          f"from an offset view: both directions exactly equal, routes (forward/backward) "
          f"{routes}")

    # an x3 upsample: its transposed rows have three terms, which the staged
    # routes sum in a loop; held to the general P's bound below
    idx = _nearest_idx(9, "scale", 3.0)
    pt = onehot_rows(idx, 9, DEV, transpose=True)
    tabt = onehot_table(idx, 9, DEV, transpose=True)
    for dtype in (torch.bfloat16, torch.float32):
        for dim in (2, 3):
            shape = [2, 3, 9, 9]
            shape[dim] = len(idx)
            g = torch.randn(shape, device=DEV, generator=cuda_gen).to(dtype)
            got = cuda_row_mix.row_mix_table_cuda(g, tabt, dim)
            ref = cuda_row_mix.row_mix_plain(g, pt, dim)
            bound = 3 * 2.0 ** -23 * cuda_row_mix.row_mix_plain(g.float().abs(), pt, dim)
            if dtype == torch.bfloat16:
                bound = bound + 2.0 ** -7 * ref.float().abs()
            over = ((got.float() - ref.float()).abs() - bound).max().item()
            print(f"row_mix {_dtype_name(dtype)} x3 upsample's transpose along "
                  f"{'HW'[dim - 2]} (three terms a row, {_row_mix_route(g, tabt, dim)} route): "
                  f"max_abs_err {(got.float() - ref.float()).abs().max().item():.3e}, within "
                  f"the bound (largest excess {over:.3e})")
            if over > 0:
                raise AssertionError(f"row_mix x3 transpose {dtype} dim {dim}: excess {over:.3e}")

    # a general dense P: the compaction, then the mix
    name, c, (h, w), _ = NEAREST_SHAPES[0]
    on = 231
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((TRAIN_N, c, h, w), device=DEV, generator=cuda_gen).to(dtype)
        for dim in (2, 3):
            size = (h, w)[dim - 2]
            p = torch.randn((on, size), device=DEV, generator=cuda_gen)
            before = LAUNCHES["row_mix_compact"]
            got = cuda_row_mix.row_mix_cuda(x, p, dim)
            compacted = LAUNCHES["row_mix_compact"] - before
            ref = cuda_row_mix.row_mix_plain(x, p, dim)
            mag = cuda_row_mix.row_mix_plain(x.float().abs(), p.abs(), dim)
            bound = size * 2.0 ** -23 * mag
            if dtype == torch.bfloat16:
                bound = bound + 2.0 ** -7 * ref.float().abs()
            err = (got.float() - ref.float()).abs()
            over = (err - bound).max().item()
            table = cuda_row_mix.row_mix_compact_cuda(p)
            k_ms = median_ms(lambda: cuda_row_mix.row_mix_cuda(x, p, dim), runs=3, warmup=1)
            c_ms = median_ms(lambda: cuda_row_mix.row_mix_compact_cuda(p), runs=10)
            p_ms = median_ms(lambda: cuda_row_mix.row_mix_plain(x, p, dim), runs=3, warmup=1)
            print(f"row_mix general P {_dtype_name(dtype)} {name} ({TRAIN_N},{c},{h},{w}) "
                  f"along {'HW'[dim - 2]}, P ({on},{size}) dense: max_abs_err {err.max().item():.3e}, "
                  f"within the bound (largest excess {over:.3e}), {compacted} compaction, "
                  f"{_row_mix_route(x, table, dim)} route; kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms")
            print(f"row_mix compaction of P ({on},{size}): {c_ms:.4f} ms a call")
            if over > 0 or compacted != 1 or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"row_mix general P {dtype} dim {dim}: excess {over:.3e}, "
                                     f"{compacted} compactions")
            del got, ref, mag, bound, err
        del x
    torch.cuda.empty_cache()
    return {"max_abs_err": 0.0, "ms": totals[0], "plain_ms": totals[1],
            "library_ms": totals[2], "device_ms": totals[3], "library_device_ms": totals[4],
            **cost.fields()}


def phase_channel_sums(cuda_gen) -> dict:
    """channel_sums at the layer1 conv3 output (8,256,192,192), bf16 (the
    train dtype) and fp32: each sum within 2^-15 of the summed magnitudes of
    the float64 sum. The library call is one var_mean."""
    from mrfp_tpu_torch.ops import cuda_channel_sums
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = (torch.randn((TRAIN_N, 256, CROP // 4, CROP // 4), device=DEV, generator=cuda_gen)
             + 0.5).to(dtype)
        s1k, s2k = cuda_channel_sums.channel_sums_cuda(x)
        s1p, s2p = cuda_channel_sums.channel_sums_plain(x)
        xd = x.double()
        exact1, exact2 = xd.sum((0, 2, 3)), (xd * xd).sum((0, 2, 3))
        mag1 = xd.abs().sum((0, 2, 3))
        del xd
        over = max(((s1k.double() - exact1).abs() - 2.0 ** -15 * mag1).max().item(),
                   ((s2k.double() - exact2).abs() - 2.0 ** -15 * exact2).max().item())
        err = max((s1k - s1p).abs().max().item(), (s2k - s2p).abs().max().item())
        if over > 0:
            raise AssertionError(f"channel_sums {dtype}: exceeds the bound by {over:.3e}")
        k_ms = median_ms(lambda: cuda_channel_sums.channel_sums_cuda(x), runs=10)
        p_ms = median_ms(lambda: cuda_channel_sums.channel_sums_plain(x), runs=10)
        l_ms = median_ms(lambda: torch.var_mean(x, dim=(0, 2, 3)), runs=10)
        dev = (device_ms(lambda: cuda_channel_sums.channel_sums_cuda(x)),
               device_ms(lambda: torch.var_mean(x, dim=(0, 2, 3))))
        cost = Cost()
        cost.add(nbytes(x, s1k, s2k), 3.0 * x.numel(), torch.float32)
        print(f"channel_sums {_dtype_name(dtype)} {tuple(x.shape)}: max abs diff vs "
              f"plain {err:.3e} (|s2| max {s2p.abs().max().item():.3e}); kernel {k_ms:.4f} ms "
              f"({nbytes(x) / k_ms / 1e6:.0f} GB/s), plain {p_ms:.4f} ms, var_mean "
              f"{l_ms:.4f} ms, bound {cost.bound_ms:.4f} ms; device time (graph) kernel "
              f"{dev[0]:.4f} ms ({nbytes(x) / dev[0] / 1e6:.0f} GB/s), var_mean {dev[1]:.4f} ms")
        if dtype == torch.bfloat16:
            out = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                   "device_ms": dev[0], "library_device_ms": dev[1], **cost.fields()}
        del x
    torch.cuda.empty_cache()
    return out


# (C, side): the two NP+ sites of the batch-8 step (H/4 = 192), then a
# ragged plane (191 x 191 values, no whole number of 16-byte vectors): the
# scalar route
NP_PLUS_SHAPES = [(64, CROP // 4), (256, CROP // 4), (64, CROP // 4 - 1)]


def phase_np_plus(cuda_gen) -> dict:
    """np_plus_apply at the two NP+ sites of the batch-8 step, (8,64,192,192)
    and (8,256,192,192), and at a ragged plane, in bf16 and fp32: kernel and
    plain round the same fp32 ops, so they must be exactly equal. The
    library call is one addcmul with the coefficients in x's dtype (the JAX
    package's form). Sums over the two sites in bf16, single-call and on
    the device (CUDA graph)."""
    from mrfp_tpu_torch.ops import cuda_np_plus
    totals, cost = [0.0] * 5, Cost()
    for c, side in NP_PLUS_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((TRAIN_N, c, side, side), device=DEV,
                            generator=cuda_gen).to(dtype)
            alpha = torch.randn((TRAIN_N, c, 1, 1), device=DEV, generator=cuda_gen)
            shift = torch.randn((TRAIN_N, c, 1, 1), device=DEV, generator=cuda_gen)
            got = cuda_np_plus.np_plus_apply_cuda(x, alpha, shift)
            ref = cuda_np_plus.np_plus_apply_plain(x, alpha, shift)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"np_plus_apply C={c} {dtype}: kernel != plain, max "
                                     f"{(got.float() - ref.float()).abs().max().item()}")
            vec = cuda_np_plus.np_plus_vector_width(x.element_size(), side * side,
                                                    x.data_ptr(), got.data_ptr())
            a, b = alpha.to(dtype), shift.to(dtype)
            fns = (lambda: cuda_np_plus.np_plus_apply_cuda(x, alpha, shift),
                   lambda: cuda_np_plus.np_plus_apply_plain(x, alpha, shift),
                   lambda: torch.addcmul(b, x, a))
            ms = [median_ms(f, runs=10) for f in fns] + [device_ms(fns[0]), device_ms(fns[2])]
            moved = 2 * nbytes(x)
            print(f"np_plus_apply {_dtype_name(dtype)} {tuple(x.shape)}: exactly equal, "
                  f"{'vector' if vec > 1 else 'scalar'} route; kernel {ms[0]:.4f} ms "
                  f"({moved / ms[0] / 1e6:.0f} GB/s), plain {ms[1]:.4f} ms, addcmul "
                  f"{ms[2]:.4f} ms; device time (graph) kernel {ms[3]:.4f} ms "
                  f"({moved / ms[3] / 1e6:.0f} GB/s), addcmul {ms[4]:.4f} ms")
            if dtype == torch.bfloat16 and side == CROP // 4:
                for j in range(5):
                    totals[j] += ms[j]
                cost.add(nbytes(x, got, alpha, shift))
            del x, got, ref
    torch.cuda.empty_cache()
    print(f"np_plus_apply bf16, the two NP+ sites: kernel {totals[0]:.4f} ms, plain "
          f"{totals[1]:.4f} ms, addcmul {totals[2]:.4f} ms, bound {cost.bound_ms:.4f} ms; "
          f"device time (graph) kernel {totals[3]:.4f} ms, addcmul {totals[4]:.4f} ms")
    return {"max_abs_err": 0.0, "ms": totals[0], "plain_ms": totals[1],
            "library_ms": totals[2], "device_ms": totals[3], "library_device_ms": totals[4],
            **cost.fields()}


# the fused OC stage at the batch-16 768x768 step (the benchmark's train
# cell): (name, conv (Cin, Cout, dilation), C, the conv's and the stage's
# input (h, w), rule, the memory formats the branch writes)
OC_N = 16
OC_STAGES = [
    ("enc1", (64, 64, 1), 64, (192, 192), {"scale": (1.205, 1.205)}, ("nhwc",)),
    ("enc2", (64, 64, 1), 64, (231, 231), {"scale": (1.2, 1.2)}, ("nhwc",)),
    ("enc3", (64, 128, 2), 128, (277, 277), {"scale": (1.2, 1.2)}, ("nhwc",)),
    ("enc4", (128, 256, 2), 256, (332, 332), {"size": (384, 384)}, ("nhwc", "nchw")),
    ("dec1", (256, 128, 1), 128, (384, 384), {"size": (384, 384)}, ("nhwc",)),
    ("dec2", (128, 64, 1), 64, (384, 384), {"scale": (0.838, 0.838)}, ("nhwc",)),
    ("dec3", (64, 64, 2), 64, (321, 321), {"scale": (0.798, 0.798)}, ("nhwc",)),
    ("dec4", (64, 64, 2), 64, (256, 256), {"size": (192, 192)}, ("nchw",)),
]
# kernel against the kernels' plain versions: the same arithmetic, in the
# same order, the sums in fp64 rounded once, so they agree bit for bit but
# where a sum lies within fp64's error of an fp32 rounding boundary: a bf16
# ulp, or fp32 to the closed form's cancellation
OC_TOL = {torch.bfloat16: dict(atol=1e-2, rtol=8e-3), torch.float32: dict(atol=1e-4, rtol=1e-4)}


def _formats(names):
    return tuple(torch.channels_last if n == "nhwc" else torch.contiguous_format for n in names)


def _oc_tables(y, rule, band=None):
    """(the stage's input rows, H table, W table, identity) of ``rule`` on
    ``y``; with ``band = (o0, o1)`` the rows that band of output rows reads
    and its band table."""
    from mrfp_tpu_torch.ops.resize import nearest_band_rows, nearest_input, nearest_table
    h, w = y.shape[2:]
    if band is not None:
        (kind, arg), = rule.items()
        lo, hi = nearest_band_rows(h, kind, arg[0], *band)
        return (y[:, :, lo:hi], nearest_table(h, kind, arg[0], DEV, band),
                nearest_table(w, kind, arg[1], DEV), False)
    read = nearest_input(y, **rule)
    if read is None:
        return y, nearest_table(h, "size", h, DEV), nearest_table(w, "size", w, DEV), True
    return (*read, False)


def _oc_stage_pair(y, w, b, rule, layouts, cuda_gen, what, band=None):
    """One stage through the kernels and through their plain versions (the
    same ``OCStage``, ``kernel=False``) from one map and one set of
    cotangents: raises unless the statistics, every output and the input
    gradient agree (``OC_TOL``). Returns the kernel's input rows, tables,
    statistics and cotangents for timing."""
    from mrfp_tpu_torch.ops import cuda_oc_stage
    from mrfp_tpu_torch.ops.oc_stage import EPS, OCStage
    x, ty, tx, identity = _oc_tables(y, rule, band)
    count = x.shape[0] * ty.idx.numel() * tx.idx.numel()
    xk = cuda_oc_stage.nhwc(x).detach().requires_grad_(True)
    xp = x.detach().contiguous().requires_grad_(True)
    outk = OCStage.apply(xk, w, b, ty, tx, layouts, True, identity)
    outp = OCStage.apply(xp, w, b, ty, tx, layouts, False, identity)
    grads = [torch.randn(o.shape, device=DEV, generator=cuda_gen).to(y.dtype)
             .contiguous(memory_format=fmt) for o, fmt in zip(outk, layouts)]
    torch.autograd.backward(outk, grads)
    torch.autograd.backward(outp, grads)
    torch.cuda.synchronize()
    tol = OC_TOL[y.dtype]
    stats_k, local_k = cuda_oc_stage.oc_stage_stats_cuda(xk.detach(), ty, tx, count, EPS)
    stats_p, local_p = cuda_oc_stage.oc_stage_stats_plain(xp.detach(), ty, tx, count, EPS)
    mean_err = ((stats_k[0] - stats_p[0]).abs() * stats_p[2]).max().item()
    inv_err = ((stats_k[2] / stats_p[2]) - 1).abs().max().item()
    errs = [(a.float() - c.float()).abs().max().item() for a, c in zip(outk, outp)]
    grad_err = (xk.grad.float() - xp.grad.float()).abs().max().item()
    # the fp64 moments the ranks combine: the mean in stds, M2 relative, each
    # within 1e-10, far inside an fp32 ulp (6e-8), so both round alike
    std = (local_p[1] / count).sqrt().clamp_min(1e-30)
    local_err = max(((local_k[0] - local_p[0]).abs() / std).max().item(),
                    ((local_k[1] / local_p[1].clamp_min(1e-300)) - 1).abs().max().item())
    if mean_err > 1e-5 or inv_err > 1e-5 or local_err > 1e-10:
        raise AssertionError(f"oc_stage {what}: statistics kernel != plain: mean "
                             f"{mean_err:.3e} of a std, invstd {inv_err:.3e}, fp64 moments "
                             f"{local_err:.3e}")
    for fmt, a, c in zip(layouts, outk, outp):
        if not a.is_contiguous(memory_format=fmt):
            raise AssertionError(f"oc_stage {what}: an output is not in {fmt}")
        torch.testing.assert_close(a, c, **tol, msg=lambda m: f"oc_stage {what} forward: {m}")
    if not xk.grad.permute(0, 2, 3, 1).is_contiguous():
        raise AssertionError(f"oc_stage {what}: the input gradient is not channels-last")
    # where the routes' statistics differ in a last bit (a sum within fp64's
    # error of a rounding boundary), a source whose BN argument z lies within
    # rounding of 0 may take the ReLU's other side in one of them (its whole
    # cotangent sum then differs): such sources, and no others, may lie
    # outside the bound, at most one in 10^5
    ch = (slice(None), None, None)
    z = ((xp.detach().float() - stats_p[0][ch]) * (stats_p[2] * w)[ch] + b[ch]).abs()
    bad = ~torch.isclose(xk.grad.float(), xp.grad.float(), **tol)
    flips, off = int(bad.sum()), int((bad & (z > 1e-4)).sum())
    del z, bad
    if off or flips > 1e-5 * xk.numel():
        raise AssertionError(f"oc_stage {what} backward: {flips} gradients outside "
                             f"{tol}, {off} of them where |z| > 1e-4 (max {grad_err:.3e})")
    print(f"oc_stage {what} {_dtype_name(y.dtype)} {tuple(x.shape)}->"
          f"{tuple(outk[0].shape[2:])} {[str(f).split('.')[-1] for f in layouts]}: kernel vs "
          f"plain, statistics {mean_err:.2e} (mean, in stds) {inv_err:.2e} (invstd) "
          f"{local_err:.2e} (fp64 moments), outputs "
          f"max {max(errs):.3e}, gradient max {grad_err:.3e} ({flips} outside the bound, "
          f"all where |z| <= 1e-4: the ReLU's edge)")
    return xk.detach(), ty, tx, identity, stats_k, grads


def phase_oc_stage(cuda_gen) -> dict:
    """The fused OC stage (``csrc/oc_stage.cu``) against its plain versions
    at the eight stages of the batch-16 step in bf16 (every layout the
    branch writes: enc4 both), at enc2 in fp32, on a band table of enc3 (a
    2-way spatial split's first band), with an odd channel count (single-
    value accesses) and with ranges longer than two (the general sums).
    Then each stage's device time, forward and backward, beside its bytes
    bound (the map, the outputs and cotangents, the gradient, each once)
    and beside the path it replaced (the nearest-resize kernels, fp32
    ``F.batch_norm``, ReLU and the casts, autograd through them), and the
    stage's conv, forward and input gradient, NCHW against channels-last."""
    import torch.nn.functional as F
    from mrfp_tpu_torch.nn.norms import norm_group
    from mrfp_tpu_torch.ops import LAUNCHES, cuda_oc_stage, reset_launches
    from mrfp_tpu_torch.ops.oc_stage import EPS
    from mrfp_tpu_torch.ops.resize import resize_nearest
    reset_launches()
    group = norm_group()
    totals = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0)
    cost = Cost()

    def draw(shape, dtype, c):
        y = torch.randn(shape, device=DEV, generator=cuda_gen).to(dtype)
        w = 0.5 * torch.randn(c, device=DEV, generator=cuda_gen)
        b = 0.1 * torch.randn(c, device=DEV, generator=cuda_gen)
        return y.contiguous(memory_format=torch.channels_last), w, b

    # the stem features into the branch: fp32 NCHW -> bf16 channels-last under
    # autocast, the gradient back; exact both ways (a cast and a copy), at the
    # step's shape and at an odd one (the single-value route)
    from mrfp_tpu_torch.ops.oc_stage import to_channels_last
    for shape in ((OC_N, 64, 192, 192), (2, 3, 5, 7)):
        xp = torch.randn(shape, device=DEV, generator=cuda_gen).requires_grad_(True)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            xc = to_channels_last(xp)
        g = torch.randn(shape, device=DEV, generator=cuda_gen).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        xc.backward(g)
        torch.cuda.synchronize()
        if not (xc.dtype == torch.bfloat16 and xc.is_contiguous(memory_format=torch.channels_last)
                and torch.equal(xc, xp.detach().to(torch.bfloat16)) and xp.grad.is_contiguous()
                and torch.equal(xp.grad, g.float())):
            raise AssertionError(f"oc_stage layout {shape}: the channels-last copy or its "
                                 f"gradient is not exact")
    xd = torch.randn((OC_N, 64, 192, 192), device=DEV, generator=cuda_gen)
    lay = {"kernel": device_ms(lambda: cuda_oc_stage.oc_stage_layout_cuda(
               xd, torch.channels_last, torch.bfloat16), calls=5),
           "library": device_ms(lambda: xd.to(torch.bfloat16, memory_format=torch.channels_last),
                                calls=5)}
    moved = nbytes(xd) + xd.numel() * 2
    print(f"oc_stage layout: the stem features {tuple(xd.shape)} fp32 NCHW -> bf16 channels-last "
          f"exact both ways; kernel {lay['kernel']:.3f} ms device ({moved / lay['kernel'] / 1e6:.0f}"
          f" GB/s, bound {moved / HBM_BYTES_PER_S * 1e3:.3f}), .to(bf16, channels_last) "
          f"{lay['library']:.3f} ms")
    del xd

    for name, (cin, cout, dil), c, hw, rule, fmts in OC_STAGES:
        layouts = _formats(fmts)
        y, w, b = draw((OC_N, c, *hw), torch.bfloat16, c)
        x, ty, tx, identity, stats, grads = _oc_stage_pair(y, w, b, rule, layouts, cuda_gen, name)
        count = x.shape[0] * ty.idx.numel() * tx.idx.numel()

        def fwd():
            st, _ = cuda_oc_stage.oc_stage_stats_cuda(x, ty, tx, count, EPS)
            return cuda_oc_stage.oc_stage_apply_cuda(x, st, w, b, ty, tx, layouts, identity)

        def bwd():
            return cuda_oc_stage.oc_stage_bwd_cuda(grads, layouts, x, stats, w, b, ty, tx, group,
                                                   identity)

        outs = fwd()
        dx = bwd()
        y_old = x.contiguous().requires_grad_(True)
        g_old = sum(g.float() for g in grads).to(x.dtype).contiguous()

        def old():  # the replaced chain: the resize kernels, fp32 BN, ReLU, casts
            r = resize_nearest(y_old, **rule)
            out = F.relu(F.batch_norm(r.float(), None, None, w, b, training=True, eps=EPS))
            return torch.autograd.grad(out.to(x.dtype), y_old, g_old)

        def plain():  # the kernels' plain versions, forward and backward
            st, _ = cuda_oc_stage.oc_stage_stats_plain(x, ty, tx, count, EPS)
            cuda_oc_stage.oc_stage_apply_plain(x, st, w, b, ty, tx, layouts)
            return cuda_oc_stage.oc_stage_bwd_plain(grads, x, st, w, b, ty, tx, group)

        new = {"fwd": median_ms(fwd, runs=10), "bwd": median_ms(bwd, runs=10),
               "fwd_dev": device_ms(fwd, calls=5), "bwd_dev": device_ms(bwd, calls=5),
               "old": median_ms(old, runs=5), "plain": median_ms(plain, runs=3)}
        fb = nbytes(x, *outs)
        bb = nbytes(x, dx, *grads)
        bound = cost.add(fb) + cost.add(bb)
        totals["ms"] += new["fwd"] + new["bwd"]
        totals["device_ms"] += new["fwd_dev"] + new["bwd_dev"]
        totals["library_ms"] += new["old"]
        totals["plain_ms"] += new["plain"]
        print(f"oc_stage {name} bf16 {tuple(x.shape)}: forward {new['fwd']:.3f} ms (device "
              f"{new['fwd_dev']:.3f}, {fb / new['fwd_dev'] / 1e6:.0f} GB/s, bound "
              f"{fb / HBM_BYTES_PER_S * 1e3:.3f}), backward {new['bwd']:.3f} ms (device "
              f"{new['bwd_dev']:.3f}, {bb / new['bwd_dev'] / 1e6:.0f} GB/s, bound "
              f"{bb / HBM_BYTES_PER_S * 1e3:.3f}); together bound {bound:.3f} ms; plain "
              f"versions {new['plain']:.3f} ms; the replaced chain forward + backward "
              f"{new['old']:.3f} ms")

        # the stage's conv, forward and input gradient, in either layout
        xin = torch.randn((OC_N, cin, *hw), device=DEV, generator=cuda_gen).to(torch.bfloat16)
        wt = (0.05 * torch.randn((cout, cin, 3, 3), device=DEV, generator=cuda_gen)
              ).to(torch.bfloat16)
        conv_ms = {}
        for fmt in ("nchw", "nhwc"):
            xi = xin.contiguous(memory_format=_formats([fmt])[0]).requires_grad_(True)
            go = torch.randn((OC_N, cout, *xin.shape[2:]), device=DEV, generator=cuda_gen
                             ).to(torch.bfloat16).contiguous(memory_format=_formats([fmt])[0])

            def conv():
                out = F.conv2d(xi, wt, None, 1, dil, dil)
                return torch.autograd.grad(out, xi, go)

            conv_ms[fmt] = median_ms(conv, runs=5)
        print(f"oc_stage {name} conv {cin}->{cout} d{dil} at {tuple(xin.shape[2:])} bf16 "
              f"forward + input gradient: NCHW {conv_ms['nchw']:.3f} ms, channels-last "
              f"{conv_ms['nhwc']:.3f} ms")
        del y, x, outs, dx, y_old, grads, xin, xi, go
        torch.cuda.empty_cache()

    # fp32 at enc2, a band of enc3, single-value accesses, long ranges
    y, w, b = draw((OC_N, 64, 231, 231), torch.float32, 64)
    _oc_stage_pair(y, w, b, {"scale": (1.2, 1.2)}, _formats(["nhwc", "nchw"]), cuda_gen,
                   "enc2 fp32")
    y, w, b = draw((OC_N, 128, 277, 277), torch.bfloat16, 128)
    _oc_stage_pair(y, w, b, {"scale": (1.2, 1.2)}, _formats(["nhwc"]), cuda_gen,
                   "enc3 band 0 of 2", band=(0, 166))
    for dtype in (torch.bfloat16, torch.float32):
        y, w, b = draw((2, 3, 37, 45), dtype, 3)
        _oc_stage_pair(y, w, b, {"scale": (1.2, 1.2)}, _formats(["nhwc", "nchw"]), cuda_gen,
                       "odd channels")
        y, w, b = draw((2, 4, 5, 6), dtype, 4)
        _oc_stage_pair(y, w, b, {"scale": (3.0, 3.0)}, _formats(["nchw"]), cuda_gen,
                       "x3 (ranges of 3)")
    del y
    torch.cuda.empty_cache()
    launched = {k: LAUNCHES[k] for k in ("oc_stage_stats", "oc_stage", "oc_stage_bwd",
                                         "oc_stage_layout")}
    print(f"oc_stage bf16, the eight stages of the batch-{OC_N} step: kernels forward + backward "
          f"{totals['ms']:.3f} ms (device {totals['device_ms']:.3f}), bound "
          f"{cost.bound_ms:.3f} ms, plain versions {totals['plain_ms']:.3f} ms, the replaced "
          f"chain {totals['library_ms']:.3f} ms; launches {launched}")
    return {"ms": totals["ms"], "device_ms": totals["device_ms"], "plain_ms": totals["plain_ms"],
            "library_ms": totals["library_ms"], **cost.fields()}


def phase_public_paths(cuda_gen) -> dict:
    """The public functions of the kernels no train or eval path runs (as in
    the JAX package), driven as a user calls them, with the counts set to 0
    just before and read just after: the OC branch's first nearest resize
    (x1.205, (8,64,192,192) bf16) as two take_rows and its gradient,
    checked against resize_nearest and its gradient (the nearest backward
    kernel's one caller; the forward exactly; the gradient, which
    the two take_rows round twice, within 2^-6 of its summed magnitudes); channel_stats of
    the layer1 conv3 output and its gradient, checked against the plain
    version; NP+ with the fused apply at both NP+ sites, checked against the
    train path's NP+ on the same draws (bf16 outputs: one ulp)."""
    from mrfp_tpu_torch.ops import LAUNCHES, reset_launches
    from mrfp_tpu_torch.ops.np_plus import normalization_perturbation_plus_fused
    from mrfp_tpu_torch.ops.resize import resize_nearest, take_rows
    from mrfp_tpu_torch.ops.stats import channel_stats
    from mrfp_tpu_torch.perturb.np_plus import draw_np_plus, np_plus
    side = CROP // 4
    idx = _nearest_idx(side, "scale", 1.205)
    x = torch.randn((TRAIN_N, 64, side, side), device=DEV, generator=cuda_gen).to(torch.bfloat16)
    g = torch.randn((TRAIN_N, 64, len(idx), len(idx)), device=DEV,
                    generator=cuda_gen).to(torch.bfloat16)
    big = torch.randn((TRAIN_N, 256, side, side), device=DEV,
                      generator=cuda_gen).to(torch.bfloat16)
    draws = torch.Generator().manual_seed(5)
    noise = [draw_np_plus(draws, TRAIN_N, c, DEV) for c in (64, 256)]
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    bg = big.clone().requires_grad_(True)
    torch.cuda.synchronize()
    reset_launches()
    y = take_rows(take_rows(xa, idx, 2), idx, 3)
    y.backward(g)
    mean, var = channel_stats(bg)
    (mean.sum() + var.sum()).backward()
    nps = [normalization_perturbation_plus_fused(nz, f) for nz, f in zip(noise, (x, big))]
    torch.cuda.synchronize()
    launched = {k: LAUNCHES[k] for k in ("row_mix", "channel_sums", "np_plus_apply")}
    compactions = LAUNCHES["row_mix_compact"]
    ref = resize_nearest(xb, scale=(1.205, 1.205))
    ref.backward(g)
    torch.cuda.synchronize()
    # the nearest backward kernel's one caller: no train path differentiates
    # a nearest resize since the OC branch's stages fuse theirs
    launched["resize_nearest_bwd"] = LAUNCHES["resize_nearest_bwd"]
    mean_p, var_p = channel_stats(big, impl="plain")
    for f, nz, got in zip((x, big), noise, nps):
        torch.testing.assert_close(got, np_plus(f, nz), atol=1e-2, rtol=8e-3)
    torch.cuda.synchronize()
    # the two take_rows round their partial sums in bf16 once each,
    # resize_nearest its sum once: each rounding is within 2^-8 of the summed
    # magnitudes (the gradient of |g|, in fp32)
    xm = torch.zeros(x.shape, device=DEV, requires_grad=True)
    resize_nearest(xm, scale=(1.205, 1.205), impl="plain").backward(g.float().abs())
    grad_over = ((xa.grad.float() - xb.grad.float()).abs() - 2.0 ** -6 * xm.grad).max().item()
    ok = (torch.equal(y, ref) and grad_over <= 0
          and torch.allclose(mean, mean_p, rtol=1e-5, atol=1e-6)
          and torch.allclose(var, var_p, rtol=1e-4, atol=1e-5)
          and bool(torch.isfinite(bg.grad).all()))
    print(f"public paths: launches {launched}; take_rows x2 == resize_nearest forward: "
          f"{torch.equal(y, ref)}, backward max_abs_err "
          f"{(xa.grad.float() - xb.grad.float()).abs().max().item():.3e}; channel_stats "
          f"mean/var max diff vs plain {(mean - mean_p).abs().max().item():.3e} / "
          f"{(var - var_p).abs().max().item():.3e}; fused NP+ within one bf16 ulp of the "
          f"train path's NP+")
    print(f"public paths: take_rows launched {compactions} row_mix compactions (its one-hot "
          f"tables are built on the host)")
    if not ok or min(launched.values()) <= 0 or compactions != 0:
        raise AssertionError(f"public paths: checks {ok}, launches {launched}, "
                             f"{compactions} compactions")
    return {**launched, "row_mix_compact": compactions}


def _train_cfg(batch: int, dtype: str):
    from mrfp_tpu_torch.core.config import mrfp_plus_config
    cfg = mrfp_plus_config()
    return cfg.replace(data=dataclasses.replace(cfg.data, batch_size=batch, crop_size=CROP),
                       train=dataclasses.replace(cfg.train, compute_dtype=dtype))


def _batch(gen, n: int):
    """A uint8 NHWC image batch and NHW labels (10% ignore) on the card."""
    img = torch.randint(0, 256, (n, CROP, CROP, 3), generator=gen, dtype=torch.uint8)
    lbl = torch.randint(0, 19, (n, CROP, CROP), generator=gen, dtype=torch.uint8)
    lbl[torch.rand((n, CROP, CROP), generator=gen) < 0.1] = 255
    return img.to(DEV), lbl.to(DEV)


def _rel(a, b) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def phase_train_step(gen, profile_dir) -> None:
    """One full-width MRFP+ step through the kernels and through the plain
    versions from the same state and draws; then the bf16 step's time."""
    from mrfp_tpu_torch.cli.train import build_state
    from mrfp_tpu_torch.models.mrfp import PerturbArgs
    from mrfp_tpu_torch.perturb.np_plus import draw_np_plus
    from mrfp_tpu_torch.perturb.oc_branch import oc_init, oc_maybe_resample
    from mrfp_tpu_torch.train.state import create_train_state
    from mrfp_tpu_torch.train.step import train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _train_cfg(2, "float32")
    states = {"kernel": build_state(cfg, torch.device(DEV))}
    for name in ("plain", "plain again"):
        states[name] = create_train_state(copy.deepcopy(states["kernel"].model), cfg.train)
    img, lbl = _batch(gen, 2)
    draws = torch.Generator().manual_seed(1)
    gates_on = PerturbArgs(True, True, True, draw_np_plus(draws, 2, 64, DEV),
                           draw_np_plus(draws, 2, 256, DEV))
    losses, grads = {}, {}
    for name, st in states.items():
        m = train_step(st, img, lbl, cfg, perturb=gates_on,
                       impl=None if name == "kernel" else "plain")
        losses[name] = m["loss"].item()
        params = dict(st.model.named_parameters())
        grads[name] = {k: params[k].grad for k in GRAD_KEYS}
    loss_err = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
    errs = {k: _rel(grads["kernel"][k], grads["plain"][k]) for k in GRAD_KEYS}
    floor = {k: _rel(grads["plain again"][k], grads["plain"][k]) for k in GRAD_KEYS}
    print(f"train step R50-D16 MRFP+ 2x{CROP}x{CROP} fp32 (TF32 off), all gates on: "
          f"loss kernel {losses['kernel']:.6f} plain {losses['plain']:.6f} (rel {loss_err:.3e}); "
          f"gradient rel err kernel vs plain {errs}; plain vs plain again {floor}")
    if not all(math.isfinite(v) for v in losses.values()) or loss_err > 1e-4:
        raise AssertionError(f"train step: loss kernel vs plain {losses}")
    bad = {k: v for k, v in errs.items() if not v <= 1e-3}
    if bad:
        raise AssertionError(f"train step: gradient rel err above 1e-3: {bad}")
    del states, grads
    torch.cuda.empty_cache()

    # the bf16 recipe at batch 8 (TF32 back to torch's defaults, as cli.train)
    torch.backends.cudnn.allow_tf32 = True
    cfg8 = _train_cfg(TRAIN_N, "bfloat16")
    state = build_state(cfg8, torch.device(DEV))
    img8, lbl8 = _batch(gen, TRAIN_N)
    np0, np1 = draw_np_plus(draws, TRAIN_N, 64, DEV), draw_np_plus(draws, TRAIN_N, 256, DEV)
    torch.cuda.reset_peak_memory_stats()
    cfg8f = cfg8.replace(train=dataclasses.replace(cfg8.train, fuse_bn_stats=True))
    for gates in ((True, True, True), (False, False, False)):
        p = PerturbArgs(*gates, np0, np1)
        for c, label in ((cfg8, "unfused"), (cfg8f, "fuse_bn_stats")):
            row = {}
            for impl in (None, "plain"):
                row[impl or "kernel"] = median_ms(
                    lambda: train_step(state, img8, lbl8, c, perturb=p, impl=impl),
                    runs=5, warmup=1)
            print(f"train step bf16 {TRAIN_N}x{CROP}x{CROP} {label}, gates "
                  f"{'on' if gates[0] else 'off'}: kernel path {row['kernel']:.3f} ms, "
                  f"plain path {row['plain']:.3f} ms (median of 5)")
    print(f"train step bf16 peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the OC re-init: 3.5 MB drawn on the host and copied from pinned memory
    draw_ms, call_ms, copy_ms = [], [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh = oc_init(draws)
        draw_ms.append((time.perf_counter() - t0) * 1e3)
        pinned = {k: v.pin_memory() for k, v in fresh.items()}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for k, v in pinned.items():
            state.model.get_buffer(k).copy_(v, non_blocking=True)
        end.record()
        end.synchronize()
        copy_ms.append(start.elapsed_time(end))
        t0 = time.perf_counter()
        oc_maybe_resample(state.model, True, draws)
        call_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    nbytes = sum(v.numel() * v.element_size() for v in fresh.values())
    print(f"OC re-init: {nbytes / 1e6:.2f} MB; oc_maybe_resample on the host "
          f"{statistics.median(call_ms):.3f} ms (of which the draw "
          f"{statistics.median(draw_ms):.3f} ms); the pinned copies on the device "
          f"{statistics.median(copy_ms):.3f} ms (medians of 5)")

    if profile_dir:
        from torch.profiler import ProfilerActivity, profile
        p = PerturbArgs(True, True, True, np0, np1)
        for c, name in ((cfg8, "profile_bf16_train_step.txt"),
                        (cfg8f, "profile_bf16_fused_train_step.txt")):
            train_step(state, img8, lbl8, c, perturb=p)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                train_step(state, img8, lbl8, c, perturb=p)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
            Path(profile_dir).mkdir(parents=True, exist_ok=True)
            out = Path(profile_dir) / name
            out.write_text(f"wall {wall:.3f} ms (host clock, profiler on)\n{table}")
            print(f"profile: {out}")
    del state
    torch.cuda.empty_cache()


def phase_fused_step(gen) -> dict:
    """The ``fuse_bn_stats`` train path. One fp32 step (TF32 off) at batch 2,
    768x768, all gates on, the same draws, from one state: the damped
    fixture of the CPU tests (every ``bn3.weight`` x``DAMP``), where fp32
    flips few ReLUs and the early layers' gradients are well conditioned
    (ROADMAP C3). Two controls, each the same plain step on an input
    perturbed by a small relative amount, say how far rounding alone moves
    the gradients:

    - fused through every kernel against fused through every plain version:
      loss 1e-4 relative; each of the four gradients within 1e-3 or within
      a third of the 1e-7-input control, whichever is larger. The two paths
      differ by last bits: the resize kernels', and cuBLAS's split-K order
      in the plain version of the layer3 and layer4 1x1s with Cin >= 1024
      (elsewhere the kernel's fp32 y and its fp64 sums equal the plain ones
      bit for bit);
    - fused plain against unfused plain (one-pass against two-pass
      variance): loss within 1e-5 relative, each gradient within the
      1e-6-input control (tests/test_train_step.py bounds the JAX package's
      fused-vs-unfused step by the same control).

    Then the main path: one bf16 batch-8 fused step through ``train_step``
    with the counts set to 0 just before and read just after; it must launch
    dot_with_stats 36 times (once per bottleneck 1x1), all 36 on the
    tensor-core kernel, and every resize kernel."""
    from mrfp_tpu_torch.cli.train import build_state
    from mrfp_tpu_torch.models.mrfp import PerturbArgs
    from mrfp_tpu_torch.ops import LAUNCHES, reset_launches
    from mrfp_tpu_torch.perturb.np_plus import draw_np_plus
    from mrfp_tpu_torch.train.state import create_train_state
    from mrfp_tpu_torch.train.step import train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _train_cfg(2, "float32")
    cfg_f = cfg.replace(train=dataclasses.replace(cfg.train, fuse_bn_stats=True))
    base = build_state(cfg, torch.device(DEV))
    with torch.no_grad():
        for k, prm in base.model.named_parameters():
            if k.endswith("bn3.weight"):
                prm.mul_(DAMP)
    img, lbl = _batch(gen, 2)
    x = img.float()
    noise = torch.randn(x.shape, generator=torch.Generator().manual_seed(3)).to(DEV)
    draws = torch.Generator().manual_seed(2)
    gates_on = PerturbArgs(True, True, True, draw_np_plus(draws, 2, 64, DEV),
                           draw_np_plus(draws, 2, 256, DEV))
    runs = {"fused kernel": (cfg_f, None, x),
            "fused plain": (cfg_f, "plain", x),
            "fused plain, input x(1+1e-7 noise)": (cfg_f, "plain", x * (1 + 1e-7 * noise)),
            "unfused plain": (cfg, "plain", x),
            "unfused plain, input x(1+1e-6 noise)": (cfg, "plain", x * (1 + 1e-6 * noise))}
    losses, grads = {}, {}
    for name, (c, impl, inp) in runs.items():
        st = create_train_state(copy.deepcopy(base.model), c.train)
        losses[name] = train_step(st, inp, lbl, c, perturb=gates_on, impl=impl)["loss"].item()
        params = dict(st.model.named_parameters())
        grads[name] = {k: params[k].grad.clone() for k in GRAD_KEYS}
        del st
    del base
    torch.cuda.empty_cache()

    def compare(a, b):
        return (abs(losses[a] - losses[b]) / abs(losses[b]),
                {k: _rel(grads[a][k], grads[b][k]) for k in GRAD_KEYS})

    kp_loss, kp = compare("fused kernel", "fused plain")
    c7_loss, c7 = compare("fused plain, input x(1+1e-7 noise)", "fused plain")
    fu_loss, fu = compare("fused plain", "unfused plain")
    c6_loss, c6 = compare("unfused plain, input x(1+1e-6 noise)", "unfused plain")
    print(f"fused step R50-D16 MRFP+ 2x{CROP}x{CROP} fp32 (TF32 off), all gates on, "
          f"bn3 scales x{DAMP}: losses {losses}")
    print(f"fused step: kernel path vs plain path: loss rel {kp_loss:.3e}, gradients {kp}; "
          f"control (plain, input perturbed 1e-7): loss rel {c7_loss:.3e}, gradients {c7}")
    print(f"fused step: fused plain vs unfused plain: loss rel {fu_loss:.3e}, gradients {fu}; "
          f"control (unfused, input perturbed 1e-6): loss rel {c6_loss:.3e}, gradients {c6}")
    if not all(math.isfinite(v) for v in losses.values()) or kp_loss > 1e-4:
        raise AssertionError(f"fused step: loss kernel vs plain {losses}")
    bad = {k: v for k, v in kp.items() if not v <= max(1e-3, c7[k] / 3)}
    if bad:
        raise AssertionError(f"fused step: kernel vs plain path beyond 1e-3 and a third of "
                             f"the 1e-7 control: {bad}")
    bad = {k: v for k, v in fu.items() if not v <= c6[k]}
    if not fu_loss <= 1e-5 or bad:
        raise AssertionError(f"fused step: fused vs unfused: loss {fu_loss:.3e} (bound 1e-5), "
                             f"gradients beyond the 1e-6 control: {bad}")

    # the main path: one bf16 batch-8 fused step, counted
    torch.backends.cudnn.allow_tf32 = True
    cfg8 = _train_cfg(TRAIN_N, "bfloat16")
    cfg8 = cfg8.replace(train=dataclasses.replace(cfg8.train, fuse_bn_stats=True))
    state = build_state(cfg8, torch.device(DEV))
    img8, lbl8 = _batch(gen, TRAIN_N)
    p = PerturbArgs(True, True, True, draw_np_plus(draws, TRAIN_N, 64, DEV),
                    draw_np_plus(draws, TRAIN_N, 256, DEV))
    torch.cuda.synchronize()
    reset_launches()
    loss = train_step(state, img8, lbl8, cfg8, perturb=p)["loss"].item()
    torch.cuda.synchronize()
    launched = dict(LAUNCHES)
    print(f"fused step bf16 {TRAIN_N}x{CROP}x{CROP}, gates on, through train_step: loss "
          f"{loss:.6f}; launches {launched}")
    if not math.isfinite(loss) or launched["dot_with_stats"] != 36 \
            or launched["dot_with_stats_tc"] != 36 \
            or min(launched[k] for k in MRFP_TRAIN_KERNELS) <= 0:
        raise AssertionError(f"fused step: loss {loss}, launches {launched} (want 36 "
                             f"dot_with_stats, all 36 on the tensor-core kernel, and every "
                             f"bilinear and OC-stage kernel)")
    del state
    torch.cuda.empty_cache()
    return launched


def _metrics(run_dir: str):
    by_tag = {}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            by_tag.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
    return by_tag


def phase_cli_train() -> dict:
    """The train entry point: 6 steps, then resumed to 8, then the eval
    entry point on that run's checkpoint."""
    from mrfp_tpu_torch.cli import eval as cli_eval
    from mrfp_tpu_torch.cli import train as cli_train
    from mrfp_tpu_torch.ops import LAUNCHES, reset_launches
    with tempfile.TemporaryDirectory() as runs:
        common = ["--device", DEV, "--synthetic", "--batch-size", str(TRAIN_N),
                  "--crop-size", str(CROP), "--log-every", "1", "--seed", "0",
                  "--runs-dir", runs, "--json-out", os.path.join(runs, "result.json")]
        reset_launches()  # the comparisons above launched too; count only this run
        t0 = time.perf_counter()
        rc = cli_train.main(common + ["--max-iter", "6"])
        seconds = time.perf_counter() - t0
        launched = dict(LAUNCHES)
        with open(os.path.join(runs, "result.json")) as f:
            result = json.load(f)
        m = _metrics(result["run_dir"])
        gates = {s: "".join(c if m[f"train/gate_{k}"][s] else "-"
                            for c, k in zip("ond", ("oc", "np", "dec")))
                 for s in sorted(m["train/loss"])}
        ips = [m["train/images_per_sec"][s] for s in sorted(m["train/images_per_sec"])][1:]
        print(f"cli.train 6 steps: rc {rc}, {seconds:.1f} s end to end; launches {launched}; "
              f"losses {result['losses']}; gates per step {gates}; images/s steps 2-6 "
              f"{[round(v, 3) for v in ips]} (median {statistics.median(ips):.3f})")
        losses = list(result["losses"].values())
        if rc != 0 or result["step"] != 6 or len(losses) != 6 \
                or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"cli.train: rc {rc}, result {result}")
        ckpt = os.path.join(result["run_dir"], "ckpt", "step_6.pt")
        if not os.path.exists(ckpt):
            raise AssertionError(f"cli.train: no checkpoint at step 6 ({ckpt})")
        if min(launched[k] for k in MRFP_TRAIN_KERNELS) <= 0:
            raise AssertionError(f"cli.train: a resize or OC-stage kernel was not launched: "
                                 f"{launched}")
        if not any(g[0] == "o" for g in gates.values()) or \
                not any(g[2] == "d" for g in gates.values()):
            raise AssertionError(f"cli.train: gate_oc or gate_dec never fired: {gates}")

        rc = cli_train.main(common + ["--max-iter", "8"])
        with open(os.path.join(runs, "result.json")) as f:
            resumed = json.load(f)
        print(f"cli.train resumed: rc {rc}, steps {sorted(resumed['losses'])}, "
              f"losses {resumed['losses']}")
        if rc != 0 or resumed["step"] != 8 or sorted(resumed["losses"]) != ["7", "8"]:
            raise AssertionError(f"cli.train resume: rc {rc}, result {resumed}")

        scored = cli_eval.main(["--device", DEV, "--ckpt", resumed["run_dir"], "--synthetic",
                                "--synthetic-hw", str(CROP), str(CROP), "--max-images", "2",
                                "--domains", "cityscapes"])["cityscapes"]
        print(f"cli.eval --ckpt {os.path.basename(resumed['run_dir'])} (its step 8): mean_iu "
              f"{scored['mean_iu']:.5f}, {scored['images']} images, {scored['pixels']} pixels")
        if scored["images"] != 2 or scored["pixels"] != 2 * CROP * CROP \
                or not math.isfinite(scored["mean_iu"]):
            raise AssertionError(f"cli.eval --ckpt: {scored}")

    return launched


def phase_dsn_nearest(gen) -> dict:
    """The nearest forward at the DSN label shape, (8,1,768,768) fp32 ->
    48x48, a 16x downsample of one channel: exactly equal to its plain
    version and to ``F.interpolate`` (768/48 is exact, so both index rules
    agree), its route, single-call and device time beside its bound (the
    input values the output reads, read once, and the output written once)
    and ``F.interpolate``'s. The microbatch shape of ``--accum-steps 2``,
    (4,1,768,768), is held exactly too."""
    import torch.nn.functional as F
    from mrfp_tpu_torch.ops import cuda_resize
    from mrfp_tpu_torch.ops.resize import nearest_table
    rule = {"size": DSN_HW}
    ty = nearest_table(CROP, "size", DSN_HW[0], DEV)
    tx = nearest_table(CROP, "size", DSN_HW[1], DEV)
    for n in (TRAIN_N // 2, TRAIN_N):
        lbl = torch.randint(0, 19, (n, *DSN_LABELS[1:]), generator=gen).float()
        lbl[torch.rand(lbl.shape, generator=gen) < 0.1] = 255.0
        x = lbl.to(DEV)
        got = cuda_resize.resize_nearest_cuda(x, ty, tx)
        plain = cuda_resize.resize_nearest_plain(x, ty, tx)
        lib = F.interpolate(x, size=DSN_HW, mode="nearest")
        torch.cuda.synchronize()
        if not (torch.equal(got, plain) and torch.equal(got, lib)):
            raise AssertionError(f"resize_nearest DSN labels {tuple(x.shape)}: kernel != plain "
                                 f"or F.interpolate (max {(got - plain).abs().max().item()}, "
                                 f"{(got - lib).abs().max().item()})")
        _held("resize_nearest", x, got)
    plan = cuda_resize.nearest_fwd_plan(ty.spec, CROP, DSN_HW[1], x.element_size())
    cost = Cost()
    # what the gather must move: the inputs the outputs read (one each; a
    # 16x downsample reads 1/256 of the map) and the output
    cost.add(2 * nbytes(got))
    times = {"ms": median_ms(lambda: cuda_resize.resize_nearest_cuda(x, ty, tx)),
             "plain_ms": median_ms(lambda: cuda_resize.resize_nearest_plain(x, ty, tx)),
             "library_ms": median_ms(lambda: F.interpolate(x, size=DSN_HW, mode="nearest")),
             "device_ms": device_ms(lambda: cuda_resize.resize_nearest_cuda(x, ty, tx)),
             "library_device_ms": device_ms(
                 lambda: F.interpolate(x, size=DSN_HW, mode="nearest"))}
    print(f"resize_nearest float32 DSN labels {DSN_LABELS}->{DSN_HW}: exactly equal to plain "
          f"and to F.interpolate, {_nearest_fwd_kernel(x, rule)} kernel (band {plan.band} "
          f"output rows, {plan.stage_rows} staged input rows, {plan.smem} bytes of shared "
          f"memory); kernel {times['ms']:.4f} ms, plain {times['plain_ms']:.4f} ms, "
          f"F.interpolate {times['library_ms']:.4f} ms; device time (graph) kernel "
          f"{times['device_ms']:.4f} ms, F.interpolate {times['library_device_ms']:.4f} ms; "
          f"bound {cost.bound_ms:.5f} ms ({2 * nbytes(got) / 1e6:.4f} MB; the whole input "
          f"and the output, {nbytes(x, got) / 1e6:.3f} MB, would take "
          f"{nbytes(x, got) / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    return {"max_abs_err": 0.0, **times, **cost.fields()}


def _hold_train_shapes(n: int, dtypes, cuda_gen) -> float:
    """The five train bilinear resizes (forward exactly equal, backward
    within its bound) and the seven OC nearest resizes (both directions
    exactly equal) at batch ``n`` in ``dtypes``, against their plain
    versions; returns the largest bilinear backward error."""
    errs = []
    for dtype in dtypes:
        for name, _, c, (h, w), size in BILINEAR_TRAIN_SHAPES:
            if name.startswith("train"):
                x = torch.randn((n, c, h, w), device=DEV, generator=cuda_gen).to(dtype)
                what = f"{_dtype_name(dtype)} batch {n} {name} ({n},{c},{h},{w})->{size}"
                errs.append(_bilinear_pair(x, size, cuda_gen, what)[3])
        for name, c, (h, w), rule in NEAREST_SHAPES:
            x = torch.randn((n, c, h, w), device=DEV, generator=cuda_gen).to(dtype)
            _nearest_pair(x, rule, cuda_gen)
        torch.cuda.empty_cache()
    return max(errs)


def phase_microbatch(cuda_gen) -> None:
    """The resize kernels at the microbatch shapes of ``--accum-steps 2``
    (batch ``TRAIN_N // 2``), bf16 and fp32, against their plain versions
    (``_hold_train_shapes``). Checks only; the times are those of the full
    batch."""
    n = TRAIN_N // 2
    err = _hold_train_shapes(n, (torch.bfloat16, torch.float32), cuda_gen)
    print(f"microbatch shapes, batch {n}, bf16 and fp32: the five train bilinear resizes' "
          f"forward exactly equal, backward within the bound (max_abs_err {err:.3e}); "
          f"the seven OC nearest resizes exactly equal both ways")


def _extras_cfg(batch: int, dtype: str, reduce_border_iter: int = 0):
    """The MRFP+ recipe with every training extra: the DSN head, the
    border-relaxed CE (border 1; halved past ``reduce_border_iter``, -1
    never), batch class weights and the HPF transform."""
    cfg = _train_cfg(batch, dtype)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, use_dsn_aux=True),
        data=dataclasses.replace(cfg.data, jointwtborder=True, border_window=1,
                                 reduce_border_iter=reduce_border_iter, batch_weighting=True,
                                 freq_transform="hpf"))


def _damp_(model) -> None:
    """The damped fixture (ROADMAP C3): each residual branch's last BN
    scale (a Bottleneck's ``bn3``, a BasicBlock's ``bn2``) times ``DAMP``."""
    from mrfp_tpu_torch.nn.resnet import BasicBlock, Bottleneck
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Bottleneck):
                m.bn3.weight.mul_(DAMP)
            elif isinstance(m, BasicBlock):
                m.bn2.weight.mul_(DAMP)


def _damped_state(cfg):
    """A fresh train state of ``cfg`` on the damped fixture."""
    from mrfp_tpu_torch.cli.train import build_state
    state = build_state(cfg, torch.device(DEV))
    _damp_(state.model)
    return state


@contextlib.contextmanager
def _fp64_transposes():
    """The plain resize backwards, while open, summed in fp64 and rounded
    once to the cotangent's dtype: the same transposes as the plain fp32
    ``index_add_`` ones, rounded another way, as the kernels' are. A step
    under it is the control of a kernel-vs-plain gradient check."""
    from mrfp_tpu_torch.ops import cuda_resize

    def bilinear(g, ty, tx, h, w):
        gd = g.double()
        n, c, oh, _ow = gd.shape
        fx, fy = tx.frac.double(), ty.frac.double()[:, None]
        gw = gd.new_zeros((n, c, oh, w))
        gw.index_add_(3, tx.idx0.long(), gd * (1 - fx))
        gw.index_add_(3, tx.idx1.long(), gd * fx)
        gx = gd.new_zeros((n, c, h, w))
        gx.index_add_(2, ty.idx0.long(), gw * (1 - fy))
        gx.index_add_(2, ty.idx1.long(), gw * fy)
        return gx.to(g.dtype)

    def nearest(g, ty, tx, h, w):
        gd = g.double()
        n, c, oh, _ow = gd.shape
        gw = gd.new_zeros((n, c, oh, w)).index_add_(3, tx.idx.long(), gd)
        return gd.new_zeros((n, c, h, w)).index_add_(2, ty.idx.long(), gw).to(g.dtype)

    saved = cuda_resize.resize_bilinear_bwd_plain, cuda_resize.resize_nearest_bwd_plain
    cuda_resize.resize_bilinear_bwd_plain, cuda_resize.resize_nearest_bwd_plain = (bilinear,
                                                                                   nearest)
    try:
        yield
    finally:
        cuda_resize.resize_bilinear_bwd_plain, cuda_resize.resize_nearest_bwd_plain = saved


def _noise(grads: dict, keys) -> dict:
    """The noise runs' relative gradient distances from the plain step:
    ``plain again`` (the plain transposes' ``index_add_`` atomics, cuDNN's
    backward) and, where it ran, ``control`` (the plain step under
    ``_fp64_transposes``)."""
    return {name: {k: _rel(grads[name][k], grads["plain"][k]) for k in keys}
            for name in ("plain again", "control") if name in grads}


def _floor(noise: dict) -> dict:
    """Each gradient's rounding floor: its largest distance over the noise
    runs. A second plain step alone is no floor: it can land on the first
    bit for bit, while the kernels' other fp32 summation order still moves
    a bf16 step's stem gradient by about 2%; the control moves it by
    rounding the same transposes another way."""
    runs = list(noise.values())
    return {k: max(r[k] for r in runs) for k in runs[0]}


def _per_key_limits(noise: dict) -> dict:
    """Each gradient's own limit, ``phase_zoo_trunks``' rule: 3x its rounding
    floor + 1e-3, and never above 3x the largest key's floor."""
    floor = _floor(noise)
    top = 3 * max(floor.values())
    return {k: min(3 * v + 1e-3, top) for k, v in floor.items()}


def _noise_text(noise: dict) -> str:
    """The noise runs' distances as the check lines print them."""
    return ", ".join(f"{name} vs plain {({k: round(v, 6) for k, v in d.items()})}"
                     for name, d in noise.items())


def _extras_compare(base, img, lbl, cfg, start: int, record: bool,
                    keys=GRAD_KEYS + ("dsn.4.weight",), control: bool = False) -> tuple:
    """One step of ``cfg`` from ``base`` at step ``start`` through the kernels,
    through the plain versions and through them again and, with
    ``control``, under ``_fp64_transposes``, each from a copy of
    the same state (so the same gates and dropout masks). Returns the
    losses, the relative gradient differences of ``keys`` (kernel vs plain),
    the noise runs' (``_noise``) and, with ``record``, the kernel step's
    resize calls."""
    from mrfp_tpu_torch.train.state import create_train_state
    from mrfp_tpu_torch.train.step import train_step
    losses, grads, calls = {}, {}, []
    for name in ("kernel", "plain", "plain again") + (("control",) if control else ()):
        st = create_train_state(copy.deepcopy(base.model), cfg.train)
        st.step = start
        with _recording() if record and name == "kernel" else contextlib.nullcontext([]) as seen, \
                _fp64_transposes() if name == "control" else contextlib.nullcontext():
            losses[name] = train_step(st, img, lbl, cfg, impl=None if name == "kernel"
                                      else "plain")["loss"].item()
        calls += seen
        params = dict(st.model.named_parameters())
        grads[name] = {k: params[k].grad.clone() for k in keys}
        del st, params
    errs = {k: _rel(grads["kernel"][k], grads["plain"][k]) for k in keys}
    return losses, errs, _noise(grads, keys), calls


def phase_extras_step(gen) -> dict:
    """The training extras (``_extras_cfg``), kernel path against plain path
    from one state on the damped fixture (ROADMAP C3), each from step 0 (the
    full border window) and from step 1 (past ``reduce_border_iter``:
    halved, boundaries x2), gates as drawn. First in fp32 at batch 2 (TF32
    off, cuDNN deterministic, as the backward check of ``phase_train_step``):
    loss within 1e-4 and the gradients of ``GRAD_KEYS`` and the DSN
    classifier within 1e-3 relative. Then in bf16 at batch 8, 768x768: the
    loss within 1e-4; the gradients, whose bf16 backward differs between
    two plain runs by about 1.5% where cuDNN's backward is not
    bit-reproducible, each within 3x its own rounding floor of that step +
    1e-3, and never above 3x the largest key's floor (``_per_key_limits``;
    ``_floor``: the plain-again and the fp64-transpose differences). The bf16
    kernel path's two steps are counted: they must launch every forward
    resize kernel, the nearest one at the DSN label shape once a step, and
    only at shapes held against the plain versions. Then the extras step's
    time with the full window (``reduce_border_iter`` -1, as
    ``--jointwtborder`` runs by default) and with the halved one, beside
    the default MRFP+ step's, all from the same steps, so all draw the same
    gates."""
    from mrfp_tpu_torch.ops import LAUNCHES, reset_launches
    from mrfp_tpu_torch.train.step import train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        cfg = _extras_cfg(2, "float32")
        base = _damped_state(cfg)
        img, lbl = _batch(gen, 2)
        for start in (0, 1):
            losses, errs, noise, _ = _extras_compare(base, img, lbl, cfg, start, record=False)
            err = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
            print(f"extras step fp32 2x{CROP}x{CROP} (TF32 off, cuDNN deterministic) from step "
                  f"{start} ({'halved' if start else 'full'} window), bn3 scales x{DAMP}: loss "
                  f"kernel {losses['kernel']:.6f} plain {losses['plain']:.6f} (rel {err:.3e}); "
                  f"gradient rel err kernel vs plain {errs}; plain again vs plain "
                  f"{noise['plain again']}")
            if not all(math.isfinite(v) for v in losses.values()) or err > 1e-4:
                raise AssertionError(f"extras step fp32: kernel vs plain path losses {losses}")
            bad = {k: v for k, v in errs.items() if not v <= 1e-3}
            if bad:
                raise AssertionError(f"extras step fp32: gradient rel err above 1e-3: {bad}")
        del base
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()

    torch.backends.cudnn.allow_tf32 = True
    cfg = _extras_cfg(TRAIN_N, "bfloat16")
    base = _damped_state(cfg)
    img, lbl = _batch(gen, TRAIN_N)
    torch.cuda.synchronize()
    reset_launches()  # the plain steps launch nothing: this counts the kernel path's
    calls = []
    for start in (0, 1):
        losses, errs, noise, seen = _extras_compare(base, img, lbl, cfg, start, record=True,
                                                    control=True)
        calls += seen
        err = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
        limit = _per_key_limits(noise)
        print(f"extras step bf16 {TRAIN_N}x{CROP}x{CROP} from step {start} (DSN, relaxed "
              f"CE border 1, {'halved' if start else 'full'} window; batch weights, HPF), "
              f"gates as drawn, bn3 scales x{DAMP}: loss kernel {losses['kernel']:.6f} "
              f"plain {losses['plain']:.6f} (rel {err:.3e}); gradient rel err kernel vs "
              f"plain {({k: round(v, 6) for k, v in errs.items()})}, {_noise_text(noise)}, "
              f"limits {({k: round(v, 6) for k, v in limit.items()})}")
        if not all(math.isfinite(v) for v in losses.values()) or err > 1e-4:
            raise AssertionError(f"extras step bf16: kernel vs plain path losses {losses}")
        bad = {k: v for k, v in errs.items() if not v <= limit[k]}
        if bad:
            raise AssertionError(f"extras step bf16: gradient rel err above its limit {limit}: "
                                 f"{bad}")
    torch.cuda.synchronize()
    launched = dict(LAUNCHES)
    dsn_key = ("resize_nearest", torch.float32, DSN_LABELS, (TRAIN_N, 1, *DSN_HW))
    dsn = calls.count(dsn_key)
    print(f"extras step: the kernel path's two steps launched {launched}, the nearest at the "
          f"DSN shape {dsn} times; {len(set(calls))} distinct resize calls, each held "
          f"against its plain version")
    if dsn != 2 or min(launched[k] for k in RESIZE_KERNELS if k != "resize_nearest_bwd") <= 0:
        raise AssertionError(f"extras step: launches {launched}, DSN-shape nearest {dsn} "
                             f"(want 2, one a step)")
    _all_held(calls, "extras step")
    torch.cuda.empty_cache()

    default = _damped_state(_train_cfg(TRAIN_N, "bfloat16"))
    runs = {"full window": (base, _extras_cfg(TRAIN_N, "bfloat16", reduce_border_iter=-1)),
            "halved window": (base, cfg),
            "default MRFP+ step": (default, _train_cfg(TRAIN_N, "bfloat16"))}
    times = {}
    for name, (st, c) in runs.items():
        st.step = 1  # steps 1-6 of one seed: the same gates for all three
        times[name] = median_ms(lambda: train_step(st, img, lbl, c), runs=5, warmup=1)
    print(f"extras step bf16 {TRAIN_N}x{CROP}x{CROP}, gates as drawn (steps 1-6 of one "
          f"seed), medians of 5: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in times.items()))
    del base, default
    torch.cuda.empty_cache()
    return launched


def phase_cli_train_accum() -> dict:
    """``cli.train --accum-steps 2`` at batch 8 with ``--use-dsn`` and the
    bf16 momentum (``cfg.train.momentum_dtype``, which has no flag, set
    through the config): 3 steps, counted, then resumed to 4; the peak
    device memory beside a 2-step run of the same flags without
    accumulation. The nearest kernel must run at the DSN shape of a
    microbatch, (4,1,768,768), twice a step, and every resize kernel of the
    counted run only at shapes held against the plain versions."""
    from mrfp_tpu_torch.cli import train as cli_train
    from mrfp_tpu_torch.ops import LAUNCHES, reset_launches
    build_config = cli_train.build_config
    calls = []

    def bf16_momentum(args):
        cfg = build_config(args)
        return cfg.replace(train=dataclasses.replace(cfg.train, momentum_dtype="bfloat16"))

    common = ["--device", DEV, "--synthetic", "--batch-size", str(TRAIN_N), "--crop-size",
              str(CROP), "--log-every", "1", "--seed", "0", "--use-dsn"]
    peaks, results = {}, {}
    cli_train.build_config = bf16_momentum
    try:
        with tempfile.TemporaryDirectory() as runs:
            for accum, max_iters in ((1, (2,)), (2, (3, 4))):
                for max_iter in max_iters:
                    out = os.path.join(runs, f"accum{accum}_{max_iter}.json")
                    argv = common + ["--accum-steps", str(accum), "--max-iter", str(max_iter),
                                     "--runs-dir", os.path.join(runs, str(accum)),
                                     "--json-out", out]
                    counted = (accum, max_iter) == (2, 3)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    if counted:
                        reset_launches()
                    with _recording() if counted else contextlib.nullcontext([]) as seen:
                        rc = cli_train.main(argv)
                    calls += seen
                    torch.cuda.synchronize()
                    if counted:
                        launched = dict(LAUNCHES)
                    peaks.setdefault(accum, torch.cuda.max_memory_allocated() / 2**30)
                    with open(out) as f:
                        results[(accum, max_iter)] = (rc, json.load(f))
            ckpt = os.path.join(results[(2, 4)][1]["run_dir"], "ckpt", "step_4.pt")
            blob = torch.load(ckpt, map_location="cpu", weights_only=True)
            buffers = {str(s["momentum_buffer"].dtype) for s in blob["optimizer"]["state"].values()}
            dsn_keys = sum(k.startswith("dsn.") for k in blob["model"])
    finally:
        cli_train.build_config = build_config
    micro = (TRAIN_N // 2, 1, CROP, CROP)
    dsn = calls.count(("resize_nearest", torch.float32, micro, (micro[0], 1, *DSN_HW)))
    first, resumed = results[(2, 3)][1], results[(2, 4)][1]
    print(f"cli.train --accum-steps 2 --use-dsn, bf16 momentum, batch {TRAIN_N}: 3 steps, "
          f"losses {first['losses']}; launches {launched}, nearest at the DSN microbatch "
          f"shape {micro} {dsn}, {len(set(calls))} distinct resize calls, each held against "
          f"its plain version; resumed to 4: steps "
          f"{sorted(resumed['losses'])}, losses {resumed['losses']}; checkpoint momentum "
          f"{sorted(buffers)}, {dsn_keys} DSN tensors; peak device memory accum 2 "
          f"{peaks[2]:.2f} GiB, accum 1 (same flags, 2 steps) {peaks[1]:.2f} GiB")
    rcs = [rc for rc, _ in results.values()]
    losses = [v for _, r in results.values() for v in r["losses"].values()]
    if any(rcs) or first["step"] != 3 or resumed["step"] != 4 \
            or sorted(resumed["losses"]) != ["4"] or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"cli.train --accum-steps 2: rcs {rcs}, results {results}")
    if buffers != {"torch.bfloat16"} or not dsn_keys:
        raise AssertionError(f"cli.train --accum-steps 2: momentum {buffers}, DSN keys {dsn_keys}")
    if dsn != 6 or min(launched[k] for k in ("resize_bilinear", "resize_bilinear_bwd")) <= 0:
        raise AssertionError(f"cli.train --accum-steps 2: launches {launched}, DSN-shape "
                             f"nearest {dsn} (want 6: 2 a step)")
    _all_held(calls, "cli.train --accum-steps 2")
    return launched


def phase_sliding() -> dict:
    """``SlidingEvaluator`` on one synthetic H x W (1024x2048) image at crop
    ``SLIDING_CROP`` (1024): three tiles in one batch of 3, fp32. The
    histogram must hold every pixel, the confusion-matrix kernel must run,
    every bilinear call must be at a shape held against its plain version
    (``SLIDING_RESIZES``), and the prediction must agree with the same
    evaluator's through the plain versions on 99.99% of the pixels, as the
    eval forward's does (``phase_model``). Seconds per image from the
    second of two runs (the first pays cuDNN's set-up)."""
    import functools
    from mrfp_tpu_torch.data import SyntheticDataset
    from mrfp_tpu_torch.models import build_mrfp
    from mrfp_tpu_torch.ops import LAUNCHES, reset_launches
    from mrfp_tpu_torch.train.evaluator import SlidingEvaluator
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_mrfp(DEV, generator=torch.Generator().manual_seed(0))
    ev = SlidingEvaluator(model, crop_size=SLIDING_CROP, tile_batch=3, device=DEV)
    spans = ev.spans(H, W)
    ds = SyntheticDataset(length=1, hw=(H, W))
    quiet = lambda *a, **k: None  # noqa: E731
    ev.run(ds, log=quiet)
    torch.cuda.synchronize()
    reset_launches()
    with _recording() as calls:
        res = ev.run(ds, log=quiet)
    launched = dict(LAUNCHES)
    img = ds[0]["image"]
    plain = SlidingEvaluator(functools.partial(model, impl="plain"), crop_size=SLIDING_CROP,
                             tile_batch=3, device=DEV)
    with torch.inference_mode():
        agree = (ev.predict(img) == plain.predict(img)).float().mean().item()
    print(f"SlidingEvaluator 1x{H}x{W}, crop {SLIDING_CROP}, tiles {spans} in one batch of "
          f"3, fp32: {res['seconds']:.3f} s an image; launches {launched}, bilinear at "
          f"{sorted(c[2:] for c in set(calls))}, each held against its plain version; "
          f"histogram sum {int(res['hist'].sum())}, mean_iu {res['mean_iu']:.5f}; prediction "
          f"agreement with the plain path {agree}")
    if len(spans) != 3 or int(res["hist"].sum()) != H * W or res["scored"] != 1 \
            or launched["confusion_matrix"] <= 0 or launched["resize_bilinear"] <= 0:
        raise AssertionError(f"SlidingEvaluator: spans {spans}, result {res}, "
                             f"launches {launched}")
    _all_held(calls, "SlidingEvaluator")
    if agree < 0.9999:
        raise AssertionError(f"SlidingEvaluator: prediction agreement with the plain path "
                             f"{agree} < 0.9999")
    del model
    torch.cuda.empty_cache()
    return launched


# the nine trunks' phase: the eval forward at H x W and a bf16 MRFP+ step
# at this batch of 768x768 crops
TRUNK_STEP_N = 2
# the zoo recipe of cli.train_zoo's defaults (r18-D32, wt_layer 0022200,
# ISW loss; bf16, batch 16, 768x768) and the resizes it runs on the card:
# (name, N, C, in_hw, out_hw), forward and backward in the step
ZOO_N, ZOO_WT = 16, ("0", "0", "2", "2", "2", "0", "0")
ZOO_STEPS = 6  # cli.train_zoo's counted steps, few for the script's time
ZOO_TRAIN_RESIZES = [
    ("zoo aspp broadcast", ZOO_N, 256, (1, 1), (CROP // 32,) * 2),
    ("zoo decoder upsample", ZOO_N, 256, (CROP // 32,) * 2, (CROP // 4,) * 2),
    ("zoo logit upsample", ZOO_N, 19, (CROP // 4,) * 2, (CROP,) * 2),
]
# ... and those of its eval forward at H x W (cli.eval, cli.export)
ZOO_EVAL_RESIZES = [
    ("zoo eval aspp broadcast", 1, 256, (1, 1), (H // 32, W // 32)),
    ("zoo eval decoder upsample", 1, 256, (H // 32, W // 32), (H // 4, W // 4)),
    ("zoo eval logit upsample", 1, 19, (H // 4, W // 4), (H, W)),
]
ZOO_DSN_LABELS, ZOO_DSN_HW = (ZOO_N, 1, CROP, CROP), (CROP // 16, CROP // 16)


def phase_trunks(gen, cuda_gen) -> dict:
    """Each of the nine ResNet trunks in MRFP at D16 (``wt_layer``
    (0,0,4,4,4,0,0), seeded random weights): the fp32 eval forward at
    1x3xHxW (TF32 off) through the kernels and through the plain versions,
    logits within 1e-4 and argmax 99.99%, its kernel path's median ms of 5;
    then one bf16 MRFP+ step at ``TRUNK_STEP_N`` x 768x768 on the damped
    fixture, kernel path against plain path from one state (the same drawn
    gates), with ``phase_extras_step``'s bound: loss within 1e-4, each
    gradient of ``GRAD_KEYS`` within its own limit (``_per_key_limits``).
    resnet-101 takes the baseline step: its deep stem gives 128 channels
    and the OC branch reads 64, so the JAX package cannot trace its
    perturbed step and the port refuses the OC buffers (ROADMAP C8), which
    is checked here too. Every resize call of these paths is at a shape
    held against the plain versions. Returns the eval ms by trunk."""
    from mrfp_tpu_torch.models import MRFP, build_mrfp
    from mrfp_tpu_torch.nn.resnet import RESNET_TRUNKS
    err = _hold_train_shapes(TRUNK_STEP_N, (torch.bfloat16, torch.float32), cuda_gen)
    print(f"trunk step shapes, batch {TRUNK_STEP_N}, bf16 and fp32: the five train bilinear "
          f"resizes' forward exactly equal, backward within the bound (max_abs_err "
          f"{err:.3e}); the seven OC nearest resizes exactly equal both ways")
    x = (torch.rand((1, 3, H, W), generator=gen) * 255).to(DEV)
    img, lbl = _batch(gen, TRUNK_STEP_N)
    eval_ms = {}
    for trunk in RESNET_TRUNKS:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        model = build_mrfp(DEV, generator=torch.Generator().manual_seed(0), trunk=trunk)
        with torch.inference_mode():
            with _recording() as calls:
                got = model(x)
            ref = model(x, impl="plain")
            torch.cuda.synchronize()
            if got.shape != (1, 19, H, W) or not torch.isfinite(got).all():
                raise AssertionError(f"{trunk} eval logits: shape {tuple(got.shape)}")
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
            agree = (got.argmax(1) == ref.argmax(1)).float().mean().item()
            if agree < 0.9999:
                raise AssertionError(f"{trunk} eval: argmax agreement {agree} < 0.9999")
            _all_held(calls, f"{trunk} eval forward")
            eval_ms[trunk] = median_ms(lambda: model(x), runs=5, warmup=1)
        n_params = sum(p.numel() for p in model.parameters())
        del model, got, ref
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32 = True
        cfg = _train_cfg(TRUNK_STEP_N, "bfloat16")
        if trunk == "resnet-101":
            try:
                MRFP(trunk=trunk, oc_branch=True)
            except ValueError as e:
                if "ROADMAP C8" not in str(e):
                    raise
            else:
                raise AssertionError("resnet-101 took the OC buffers (ROADMAP C8)")
            cfg = cfg.replace(perturb=dataclasses.replace(cfg.perturb, enabled=False),
                              model=dataclasses.replace(cfg.model, hrfp_plus=False))
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, trunk=trunk))
        base = _damped_state(cfg)
        losses, errs, noise, calls = _extras_compare(base, img, lbl, cfg, 0, record=True,
                                                     keys=GRAD_KEYS, control=True)
        loss_err = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
        limit = _per_key_limits(noise)
        print(f"trunk {trunk} ({n_params / 1e6:.1f} M parameters): eval fp32 1x3x{H}x{W} "
              f"kernel vs plain argmax agreement {agree}, kernel path {eval_ms[trunk]:.3f} "
              f"ms (median of 5); bf16 {'MRFP+' if cfg.perturb.enabled else 'baseline'} "
              f"step {TRUNK_STEP_N}x{CROP}x{CROP}, gates as drawn at step 0, bn scales "
              f"x{DAMP}: loss kernel {losses['kernel']:.6f} plain {losses['plain']:.6f} "
              f"(rel {loss_err:.3e}); gradient rel err kernel vs plain "
              f"{({k: round(v, 6) for k, v in errs.items()})}, {_noise_text(noise)}, "
              f"limits {({k: round(v, 6) for k, v in limit.items()})}")
        if not all(math.isfinite(v) for v in losses.values()) or loss_err > 1e-4:
            raise AssertionError(f"{trunk} step: kernel vs plain path losses {losses}")
        bad = {k: v for k, v in errs.items() if not v <= limit[k]}
        if bad:
            raise AssertionError(f"{trunk} step: gradient rel err above its limit {limit}: "
                                 f"{bad}")
        _all_held(calls, f"{trunk} step")
        del base
        torch.cuda.empty_cache()
    return eval_ms


def _zoo_step_time(wt=ZOO_WT) -> dict:
    """The zoo step of ``cli.train_zoo``'s recipe (r18-D32, bf16, batch
    ``ZOO_N``, ``wt`` the plan) in process: with an ISW slot, masks from a
    statistics pass over 4 view pairs and the whitening loss; then the step
    timed with CUDA events (median of 5 after 2 warm-up steps), images/s
    from it, and the peak device memory of those steps."""
    from mrfp_tpu_torch.cli import train_zoo
    from mrfp_tpu_torch.models.deepv3_zoo import build_cov_layers
    from mrfp_tpu_torch.train.zoo_step import covstat_pass, zoo_train_step
    isw = "2" in wt
    args = train_zoo.parse_args(["--trunk", "resnet-18", "--variant", "D32", "--wt-layer", *wt,
                                 "--batch-size", str(ZOO_N), "--crop-size", str(CROP)]
                                + (["--use-wtloss"] if isw else []))
    cfg = train_zoo.build_config(args)
    state = train_zoo.build_state(cfg, torch.device(DEV))
    gen = torch.Generator().manual_seed(5)
    masks = nrc = None
    if isw:
        pairs = [tuple((torch.rand((ZOO_N, CROP, CROP, 3), generator=gen) * 255).numpy()
                       for _ in range(2)) for _ in range(4)]
        layers = build_cov_layers("resnet-18", tuple(map(int, wt)))
        masks, nrc = covstat_pass(state.model, layers, pairs, cfg, torch.device(DEV))
    img, lbl = _batch(gen, ZOO_N)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = median_ms(lambda: zoo_train_step(state, img, lbl, cfg, masks, nrc), runs=5, warmup=2)
    gib = torch.cuda.max_memory_allocated() / 2 ** 30
    del state
    torch.cuda.empty_cache()
    return {"step_ms": ms, "images_per_s": ZOO_N / ms * 1e3, "peak_gib": gib}


def phase_cli_train_zoo(cuda_gen) -> dict:
    """The zoo recipe at full width, the JAX CLI's defaults: ``cli.train_zoo
    --synthetic --trunk resnet-18 --variant D32 --wt-layer 0 0 2 2 2 0 0
    --use-wtloss --batch-size 16 --crop-size 768 --max-iter 6`` (bf16, the
    ISW statistics phase over 4 view pairs of 32 images, the DSN head),
    counted; then ``cli.eval`` of its checkpoint at 1xHxW (the bilinear and
    confusion-matrix kernels launched) and ``cli.export --check`` of it at
    1xHxW (bit for bit). First the resizes these paths run are held against
    the plain versions (the bilinear pairs at the step's shapes in bf16 and
    fp32, the eval shapes forward, the DSN label map's nearest exactly), and
    every recorded call must be at a held shape. The step's time, images/s
    and peak memory come from ``_zoo_step_time``."""
    from mrfp_tpu_torch.cli import eval as cli_eval
    from mrfp_tpu_torch.cli import export as cli_export
    from mrfp_tpu_torch.cli import train_zoo
    from mrfp_tpu_torch.ops import LAUNCHES, cuda_resize, reset_launches
    from mrfp_tpu_torch.ops.resize import nearest_table, resize_bilinear_align_corners
    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        for name, n, c, (h, w), size in ZOO_TRAIN_RESIZES:
            x = torch.randn((n, c, h, w), device=DEV, generator=cuda_gen).to(dtype)
            what = f"{_dtype_name(dtype)} {name} ({n},{c},{h},{w})->{size}"
            errs.append(_bilinear_pair(x, size, cuda_gen, what)[3])
        for name, n, c, (h, w), size in ZOO_EVAL_RESIZES:
            x = torch.randn((n, c, h, w), device=DEV, generator=cuda_gen).to(dtype)
            got = resize_bilinear_align_corners(x, size)
            _bilinear_fwd_equal(got, resize_bilinear_align_corners(x, size, impl="plain"),
                                f"{_dtype_name(dtype)} {name}")
            _held("resize_bilinear", x, got)
        torch.cuda.empty_cache()
    ty = nearest_table(CROP, "size", ZOO_DSN_HW[0], DEV)
    tx = nearest_table(CROP, "size", ZOO_DSN_HW[1], DEV)
    lbl = torch.randint(0, 19, ZOO_DSN_LABELS, device=DEV, generator=cuda_gen).float()
    got = cuda_resize.resize_nearest_cuda(lbl, ty, tx)
    if not torch.equal(got, cuda_resize.resize_nearest_plain(lbl, ty, tx)):
        raise AssertionError(f"resize_nearest zoo DSN labels {ZOO_DSN_LABELS}: kernel != plain")
    _held("resize_nearest", lbl, got)
    del lbl, got
    print(f"zoo shapes: the step's three bilinear resizes at batch {ZOO_N}, bf16 and fp32, "
          f"forward exactly equal, backward within the bound (max_abs_err {max(errs):.3e}); "
          f"the eval forward's three at 1x{H}x{W} exactly equal; the DSN label map "
          f"{ZOO_DSN_LABELS} -> {ZOO_DSN_HW} exactly equal")
    torch.cuda.empty_cache()

    counted = {}
    with tempfile.TemporaryDirectory() as runs:
        out = os.path.join(runs, "result.json")
        argv = ["--device", DEV, "--synthetic", "--trunk", "resnet-18", "--variant", "D32",
                "--wt-layer", *ZOO_WT, "--use-wtloss", "--batch-size", str(ZOO_N),
                "--crop-size", str(CROP), "--max-iter", str(ZOO_STEPS), "--log-every", "1",
                "--runs-dir", runs, "--json-out", out]
        reset_launches()  # count this run alone
        t0 = time.perf_counter()
        with _recording() as calls:
            rc = train_zoo.main(argv)
        seconds = time.perf_counter() - t0
        launched = dict(LAUNCHES)
        with open(out) as f:
            result = json.load(f)
        m = _metrics(result["run_dir"])
        ips = [m["train/images_per_sec"][s] for s in sorted(m["train/images_per_sec"])][2:]
        cov = result["covstat"]
        print(f"cli.train_zoo r18-D32 wt 0022200 ISW, bf16 {ZOO_N}x{CROP}x{CROP}, {ZOO_STEPS} "
              f"steps: "
              f"rc {rc}, {seconds:.1f} s end to end; covstat phase {cov['seconds']:.3f} s over "
              f"{cov['pairs']} view pairs of {2 * ZOO_N} images, masks (dim, nrc) "
              f"{[(k['dim'], k['nrc']) for k in cov['masks']]}; launches {launched}; losses "
              f"{ {k: round(v, 4) for k, v in result['losses'].items()} }; loss_wt "
              f"{ {k: round(v, 5) for k, v in m.get('train/loss_wt', {}).items()} }; images/s "
              f"steps 3-{ZOO_STEPS} end to end (a checkpoint each) median "
              f"{statistics.median(ips):.3f}")
        losses = list(result["losses"].values())
        if rc != 0 or result["step"] != ZOO_STEPS or len(losses) != ZOO_STEPS \
                or not all(math.isfinite(v) for v in losses) \
                or [k["dim"] for k in cov["masks"]] != [64, 64, 128] \
                or not all(k["nrc"] > 0 for k in cov["masks"]):
            raise AssertionError(f"cli.train_zoo: rc {rc}, result {result}")
        if min(launched[k] for k in ("resize_bilinear", "resize_bilinear_bwd",
                                     "resize_nearest")) <= 0:
            raise AssertionError(f"cli.train_zoo: a resize kernel was not launched: {launched}")
        _all_held(calls, "cli.train_zoo")
        counted["train"] = launched

        flags = ["--trunk", "resnet-18", "--variant", "D32", "--wt-layer", *ZOO_WT,
                 "--ckpt", result["run_dir"]]
        reset_launches()
        with _recording() as calls:
            scored = cli_eval.main(["--device", DEV, "--synthetic", "--synthetic-hw", str(H),
                                    str(W), "--max-images", "2", "--domains", "cityscapes",
                                    *flags])["cityscapes"]
        launched = dict(LAUNCHES)
        print(f"cli.eval --wt-layer {' '.join(ZOO_WT)} --ckpt <the zoo run> at {H}x{W}: "
              f"launches {launched}; mean_iu {scored['mean_iu']:.5f}, {scored['images']} "
              f"images, {scored['images_per_s']:.3f} images/s")
        if min(launched[k] for k in ("resize_bilinear", "confusion_matrix")) <= 0 \
                or scored["images"] != 2 or not math.isfinite(scored["mean_iu"]):
            raise AssertionError(f"cli.eval of the zoo run: launches {launched}, {scored}")
        _all_held(calls, "cli.eval of the zoo run")
        counted["eval"] = launched

        reset_launches()
        with _recording() as calls:
            exported = cli_export.main(["--device", DEV, "--height", str(H), "--width",
                                        str(W), "--check", "--out",
                                        os.path.join(runs, "zoo.pt2x"), *flags])
        launched = dict(LAUNCHES)
        print(f"cli.export --wt-layer {' '.join(ZOO_WT)} --ckpt <the zoo run> at 1x{H}x{W} "
              f"bf16: {exported['mb']:.1f} MB in {exported['export_s']:.3f} s; "
              f"{exported['check']}; launches {launched}")
        if "bit for bit" not in exported["check"] or launched["resize_bilinear"] <= 0:
            raise AssertionError(f"cli.export of the zoo run: {exported}, launches {launched}")
        _all_held(calls, "cli.export of the zoo run")
        counted["export"] = launched
    torch.cuda.empty_cache()
    timed = _zoo_step_time()
    print(f"zoo step bf16 {ZOO_N}x{CROP}x{CROP} r18-D32 wt 0022200 with the ISW loss: "
          f"{timed['step_ms']:.3f} ms (median of 5 after 2 warm-up), "
          f"{timed['images_per_s']:.2f} images/s, peak {timed['peak_gib']:.2f} GiB")
    return {k: sum(c[k] for c in counted.values()) for k in counted["train"]}


# the zoo's other trunks at their factories' variant (D16 for all six)
# and the strides of the features the heads read there, (layer1's,
# layer4's): ShuffleNetV2's, MobileNetV2's and MNASNet's low-level features
# come at 1/8; SE-ResNeXt takes no variant, so its layer4 stays at 1/32
# (ROADMAP C12)
ZOO_TRUNK_STRIDES = {"mobilenetv2": (8, 16), "shufflenetv2": (8, 16), "mnasnet_05": (8, 16),
                     "mnasnet_10": (8, 16), "se_resnext-50": (4, 32), "se_resnext-101": (4, 32)}
# the step's plan: ISW in the three slots of the trunks that have them
ZOO_TRUNK_WT = {"mobilenetv2": (0, 0, 2, 2, 2, 0, 0), "shufflenetv2": (0, 0, 2, 2, 2, 0, 0)}
ZOO_TRUNK_N = 2  # the bf16 step's batch of 768x768 crops
SW_WT = ("0", "0", "5", "5", "5", "0", "0")  # SwitchWhiten in the stem and layers 1-2


def _head_resizes(n: int, c: int, hw, low: int, top: int) -> list:
    """(name, N, C, in_hw, out_hw): the three bilinear resizes of a
    DeepV3Plus forward at ``hw`` whose layer1 is at stride ``low`` and
    layer4 at ``top``."""
    h, w = hw
    return [("aspp broadcast", n, 256, (1, 1), (h // top, w // top)),
            ("decoder upsample", n, 256, (h // top, w // top), (h // low, w // low)),
            ("logit upsample", n, c, (h // low, w // low), (h, w))]


def _hold_zoo_trunk_shapes(cuda_gen) -> float:
    """The resizes of the six trunks' paths against the plain versions:
    the eval forward's three at 1xHxW (forward exactly equal), the step's
    three at ``ZOO_TRUNK_N`` x CROP (bilinear pairs, bf16 and fp32) and its
    DSN label map (nearest, exactly equal). Returns the largest bilinear
    backward error."""
    from mrfp_tpu_torch.ops import cuda_resize
    from mrfp_tpu_torch.ops.resize import nearest_table, resize_bilinear_align_corners
    errs = []
    for low, top in sorted(set(ZOO_TRUNK_STRIDES.values())):
        for dtype in (torch.bfloat16, torch.float32):
            for name, n, c, (h, w), size in _head_resizes(1, 19, (H, W), low, top):
                x = torch.randn((n, c, h, w), device=DEV, generator=cuda_gen).to(dtype)
                got = resize_bilinear_align_corners(x, size)
                _bilinear_fwd_equal(got, resize_bilinear_align_corners(x, size, impl="plain"),
                                    f"{_dtype_name(dtype)} zoo trunk eval {name}")
                _held("resize_bilinear", x, got)
            for name, n, c, (h, w), size in _head_resizes(ZOO_TRUNK_N, 19, (CROP, CROP), low,
                                                          top):
                x = torch.randn((n, c, h, w), device=DEV, generator=cuda_gen).to(dtype)
                what = f"{_dtype_name(dtype)} zoo trunk step {name} ({n},{c},{h},{w})->{size}"
                errs.append(_bilinear_pair(x, size, cuda_gen, what)[3])
    shape = (ZOO_TRUNK_N, 1, CROP, CROP)
    ty = nearest_table(CROP, "size", CROP // 16, DEV)
    lbl = torch.randint(0, 19, shape, device=DEV, generator=cuda_gen).float()
    got = cuda_resize.resize_nearest_cuda(lbl, ty, ty)
    if not torch.equal(got, cuda_resize.resize_nearest_plain(lbl, ty, ty)):
        raise AssertionError(f"resize_nearest zoo trunk DSN labels {shape}: kernel != plain")
    _held("resize_nearest", lbl, got)
    torch.cuda.empty_cache()
    return max(errs)


def _zoo_trunk_step(trunk: str, img, lbl):
    """One bf16 zoo step of ``trunk`` (DSN head; the ISW loss over fixed
    strictly-upper masks where the trunk has slots) from one seeded state
    through the kernels, through the plain versions, through them again and
    under ``_fp64_transposes``. Returns the losses, the relative
    gradient differences of the stem's first conv, the ASPP pool conv, the
    classifier and the DSN classifier (kernel vs plain), the noise runs'
    (``_noise``), the kernel step's
    resize calls, and the kernel path's step ms (median of 5 after one
    warm-up step, from the compared state on)."""
    from mrfp_tpu_torch.core.config import Config
    from mrfp_tpu_torch.models.deepv3_zoo import DeepV3Plus, SLOT_CHANNELS
    from mrfp_tpu_torch.nn.layers import init_random_
    from mrfp_tpu_torch.train.state import create_train_state
    from mrfp_tpu_torch.train.zoo_step import zoo_train_step
    wt = ZOO_TRUNK_WT.get(trunk, (0,) * 7)
    cfg = Config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, trunk=trunk, variant="D16",
                                                wt_layer=wt, use_wtloss=2 in wt),
                      train=dataclasses.replace(cfg.train, compute_dtype="bfloat16"))
    masks = [torch.triu(torch.ones(d, d, device=DEV), 1)
             for d, c in zip(SLOT_CHANNELS[trunk], wt) if c == 2]
    nrc = [float(m.sum()) for m in masks]
    base = DeepV3Plus(trunk=trunk, variant="D16", wt_layer=wt, use_dsn=True)
    init_random_(base, torch.Generator().manual_seed(0))
    base = base.to(DEV)
    stem = next(k for k, p in base.named_parameters() if k.startswith("layer0") and p.dim() == 4)
    keys = (stem, "aspp.img_conv.0.weight", "final2.0.weight", "dsn.4.weight")
    losses, grads, calls = {}, {}, []
    for name in ("kernel", "plain", "plain again", "control"):
        st = create_train_state(copy.deepcopy(base), cfg.train)
        with _recording() if name == "kernel" else contextlib.nullcontext([]) as seen, \
                _fp64_transposes() if name == "control" else contextlib.nullcontext():
            losses[name] = zoo_train_step(st, img, lbl, cfg, masks, nrc,
                                          impl=None if name == "kernel" else "plain")[
                                              "loss"].item()
        calls += seen
        params = dict(st.model.named_parameters())
        grads[name] = {k: params[k].grad.clone() for k in keys}
        if name == "kernel":
            with _recording() as seen:
                ms = median_ms(lambda: zoo_train_step(st, img, lbl, cfg, masks, nrc), runs=5,
                               warmup=1)
            calls += seen
        del st, params
    errs = {k: _rel(grads["kernel"][k], grads["plain"][k]) for k in keys}
    del base
    return losses, errs, _noise(grads, keys), calls, ms


def _switchwhiten_layer(cuda_gen, profile_dir) -> float:
    """One train-mode SwitchWhiten layer (``make_iw_layer(5)``) at the zoo
    recipe's stem map, ``ZOO_N`` x 64 x CROP/2 x CROP/2 bf16: the median ms
    of its forward and backward, and with ``profile_dir`` the
    torch.profiler kernel table of one such call."""
    from mrfp_tpu_torch.nn.norms import make_iw_layer
    layer = make_iw_layer(5, 64).to(DEV).train()
    x = torch.randn((ZOO_N, 64, CROP // 2, CROP // 2), generator=cuda_gen, device=DEV,
                    dtype=torch.bfloat16).requires_grad_()
    g = torch.randn(x.shape, generator=cuda_gen, device=DEV, dtype=torch.bfloat16)

    def run():
        layer(x).backward(g)

    ms = median_ms(run, runs=5, warmup=2)
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        out = Path(profile_dir) / "profile_switchwhiten.txt"
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30))
        print(f"profile: {out}")
    return ms


def phase_zoo_trunks(gen, cuda_gen, profile_dir=None) -> dict:
    """The zoo's other trunks and SwitchWhiten at full width and depth,
    seeded random weights. First the resizes of their paths are held
    against the plain versions (``_hold_zoo_trunk_shapes``). Then, for each
    of MobileNetV2, ShuffleNetV2, MNASNet 0.5 and 1.0 and SE-ResNeXt-50 and
    -101 in ``DeepV3Plus`` at D16: the fp32 eval forward at 1x3xHxW (TF32
    off) through the kernels and through the plain versions, logits within
    1e-4 and argmax 99.99%, the kernel path's median ms of 5; one bf16 zoo
    step at ``ZOO_TRUNK_N`` x 768x768, kernel against plain from one state
    (``_zoo_trunk_step``): loss within 1e-4, each gradient within 3x its
    own rounding floor (``_floor``) plus 1e-3, and the kernel path's step
    ms. Then
    the zoo recipe with SwitchWhiten (``SW_WT``; r18-D32, bf16, batch
    ``ZOO_N``, 768x768): its step time, images/s and peak memory
    (``_zoo_step_time``), one of its SwitchWhiten layers alone
    (``_switchwhiten_layer``), and ``cli.export --check`` of that model at
    1xHxW, bit for bit. Every resize call is at a held shape; the kernel
    paths' launches are counted and returned."""
    from mrfp_tpu_torch.cli import export as cli_export
    from mrfp_tpu_torch.models.deepv3_zoo import DeepV3Plus
    from mrfp_tpu_torch.nn.layers import init_random_
    from mrfp_tpu_torch.ops import LAUNCHES, reset_launches
    err = _hold_zoo_trunk_shapes(cuda_gen)
    print(f"zoo trunk shapes: the eval forward's bilinear resizes at 1x{H}x{W} for layer1 at "
          f"1/8 and 1/4 exactly equal; the step's at batch {ZOO_TRUNK_N}, bf16 and fp32, "
          f"forward exactly equal, backward within the bound (max_abs_err {err:.3e}); the DSN "
          f"label map ({ZOO_TRUNK_N},1,{CROP},{CROP}) -> {CROP // 16} exactly equal")
    counted = {k: 0 for k in LAUNCHES}

    def count():
        for k, v in LAUNCHES.items():
            counted[k] += v

    x = (torch.rand((1, 3, H, W), generator=gen) * 255).to(DEV)
    img, lbl = _batch(gen, ZOO_TRUNK_N)
    for trunk in ZOO_TRUNK_STRIDES:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        model = DeepV3Plus(trunk=trunk, variant="D16", wt_layer=ZOO_TRUNK_WT.get(trunk, (0,) * 7))
        init_random_(model, torch.Generator().manual_seed(0))
        model = model.to(DEV).eval()
        n_params = sum(p.numel() for p in model.parameters())
        with torch.inference_mode():
            reset_launches()
            with _recording() as calls:
                got = model(x)
            torch.cuda.synchronize()
            count()
            ref = model(x, impl="plain")
            torch.cuda.synchronize()
            if got.shape != (1, 19, H, W) or not torch.isfinite(got).all():
                raise AssertionError(f"{trunk} eval logits: shape {tuple(got.shape)}")
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
            agree = (got.argmax(1) == ref.argmax(1)).float().mean().item()
            if agree < 0.9999:
                raise AssertionError(f"{trunk} eval: argmax agreement {agree} < 0.9999")
            _all_held(calls, f"{trunk} eval forward")
            eval_ms = median_ms(lambda: model(x), runs=5, warmup=1)
        del model, got, ref
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32 = True
        reset_launches()
        losses, errs, noise, calls, step_ms = _zoo_trunk_step(trunk, img, lbl)
        torch.cuda.synchronize()
        count()
        loss_err = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
        # each gradient against 3x its own rounding floor: the stem conv's bf16
        # noise must not widen the bound on the heads behind the resize kernels
        floor = _floor(noise)
        limit = {k: 3 * floor[k] + 1e-3 for k in errs}
        print(f"zoo trunk {trunk} D16 ({n_params / 1e6:.1f} M parameters): eval fp32 1x3x{H}x{W} "
              f"kernel vs plain argmax agreement {agree}, kernel path {eval_ms:.3f} ms (median "
              f"of 5); bf16 zoo step {ZOO_TRUNK_N}x{CROP}x{CROP} (DSN"
              f"{', ISW ' + str(ZOO_TRUNK_WT[trunk]) if trunk in ZOO_TRUNK_WT else ''}): loss "
              f"kernel {losses['kernel']:.6f} plain {losses['plain']:.6f} (rel {loss_err:.3e}); "
              f"gradient rel err kernel vs plain {({k: round(v, 6) for k, v in errs.items()})}, "
              f"{_noise_text(noise)}, limits "
              f"{({k: round(v, 6) for k, v in limit.items()})}; kernel path step "
              f"{step_ms:.3f} ms (median of 5 after 1 warm-up)")
        if not all(math.isfinite(v) for v in losses.values()) or loss_err > 1e-4:
            raise AssertionError(f"{trunk} zoo step: kernel vs plain path losses {losses}")
        bad = {k: v for k, v in errs.items() if not v <= limit[k]}
        if bad:
            raise AssertionError(f"{trunk} zoo step: gradient rel err above its limit "
                                 f"{limit}: {bad}")
        _all_held(calls, f"{trunk} zoo step")
        torch.cuda.empty_cache()

    reset_launches()
    with _recording() as calls:
        timed = _zoo_step_time(SW_WT)
    count()
    _all_held(calls, "SwitchWhiten zoo step")
    print(f"zoo step bf16 {ZOO_N}x{CROP}x{CROP} r18-D32 wt {''.join(SW_WT)} (SwitchWhiten): "
          f"{timed['step_ms']:.3f} ms (median of 5 after 2 warm-up), "
          f"{timed['images_per_s']:.2f} images/s, peak {timed['peak_gib']:.2f} GiB")
    sw_ms = _switchwhiten_layer(cuda_gen, profile_dir)
    print(f"SwitchWhiten layer alone ({ZOO_N}x64x{CROP // 2}x{CROP // 2} bf16, train mode, the "
          f"stem's): forward + backward {sw_ms:.3f} ms (median of 5 after 2 warm-up)")
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches()
        with _recording() as calls:
            exported = cli_export.main(["--device", DEV, "--height", str(H), "--width", str(W),
                                        "--trunk", "resnet-18", "--variant", "D32",
                                        "--wt-layer", *SW_WT, "--check", "--out",
                                        os.path.join(tmp, "sw.pt2x")])
        launched = dict(LAUNCHES)
        count()
    print(f"cli.export --trunk resnet-18 --variant D32 --wt-layer {' '.join(SW_WT)} at "
          f"1x{H}x{W} bf16: {exported['mb']:.1f} MB in {exported['export_s']:.3f} s; "
          f"{exported['check']}; launches {launched}")
    if "bit for bit" not in exported["check"] or launched["resize_bilinear"] <= 0:
        raise AssertionError(f"cli.export of the SwitchWhiten model: {exported}")
    _all_held(calls, "cli.export of the SwitchWhiten model")
    print(f"zoo trunks: launches {counted}")
    if min(counted[k] for k in ("resize_bilinear", "resize_bilinear_bwd",
                                "resize_nearest")) <= 0:
        raise AssertionError(f"zoo trunks: a resize kernel was not launched: {counted}")
    torch.cuda.empty_cache()
    return counted


DP_WORLD = 2  # ranks of the data-parallel phase, all on the one card
DP_FP32_N = 4  # the fp32 comparison's global batch (2 a rank)
# a rank's all_reduce calls and bytes in the MRFP+ bf16 step (R50-D16, global
# batch 8 on 2 ranks) as phase_data_parallel counts them on an H100
DP_BILL = (145, 162401496)


def _dp_setup(batch: int, dtype: str, damped: bool):
    """A state, draws and batch of ``phase_data_parallel``, the same in
    every process: the MRFP+ recipe from seeded weights (``damped``: the
    damped fixture, ROADMAP C3), the OC re-draw and the NP+ streams of step
    0 with every gate on, and a seeded synthetic batch."""
    from mrfp_tpu_torch.cli.train import build_state
    from mrfp_tpu_torch.core.rng import step_generators
    from mrfp_tpu_torch.models.mrfp import PerturbArgs
    from mrfp_tpu_torch.perturb.oc_branch import oc_maybe_resample
    cfg = _train_cfg(batch, dtype)
    state = _damped_state(cfg) if damped else build_state(cfg, torch.device(DEV))
    gens = step_generators(cfg.train.seed, 0)
    oc_maybe_resample(state.model, True, gens["oc_resample"])
    perturb = PerturbArgs(True, True, True, gens["np_l0"], gens["np_l1"])
    img, lbl = _batch(torch.Generator().manual_seed(5), batch)
    return cfg, state, perturb, img, lbl


@contextlib.contextmanager
def _strict_fp32():
    """fp32 without TF32, cuDNN deterministic; torch's defaults after."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags


def _dp_step(batch: int, dtype: str, rows: slice, noise: float = 0.0, damped=None):
    """One step of ``_dp_setup(batch, dtype, damped)`` (by default damped
    in fp32) on ``rows`` of its batch, the images x (1 + ``noise`` x
    N(0, 1)) (exact at 0), with every resize call recorded: ``(state
    before, loss, state after, gradients, calls)``, the tensors on the
    host."""
    from mrfp_tpu_torch.train.step import train_step
    damped = dtype == "float32" if damped is None else damped
    cfg, state, perturb, img, lbl = _dp_setup(batch, dtype, damped)
    eps = torch.randn(img.shape, generator=torch.Generator().manual_seed(2)).to(img.device)
    img = (img.float() * (1 + noise * eps))[rows].contiguous()
    host = lambda d: {k: v.detach().to("cpu", copy=True) for k, v in d.items()}  # noqa: E731
    before = host(state.model.state_dict())
    with _recording() as calls:
        loss = train_step(state, img, lbl[rows].contiguous(), cfg, perturb=perturb)["loss"]
    grads = host({k: p.grad for k, p in state.model.named_parameters()})
    return before, loss.item(), host(state.model.state_dict()), grads, calls


def dp_rank(rank: int, world: int, rendezvous: str, out: str) -> None:
    """One rank of ``phase_data_parallel`` (its own process): joins the gloo
    group, takes the fp32 step and the counted, recorded bf16 step on its
    rows of their batches, then three timed bf16 steps, and writes what it
    saw to ``out/rank<rank>.pt``."""
    from mrfp_tpu_torch.ops import LAUNCHES, reset_launches
    from mrfp_tpu_torch.parallel import dist
    from mrfp_tpu_torch.train.step import train_step
    dist.initialize_distributed(rendezvous, world, rank, DEV, backend="gloo", timeout_s=600)
    try:
        with _strict_fp32():
            n = DP_FP32_N // world
            _, fp32_loss, _, fp32_grads, fp32_calls = _dp_step(
                DP_FP32_N, "float32", slice(rank * n, (rank + 1) * n))
        torch.cuda.empty_cache()
        n = TRAIN_N // world
        rows = slice(rank * n, (rank + 1) * n)
        torch.cuda.synchronize()
        reset_launches()
        sizes, all_reduce = [], torch.distributed.all_reduce

        def counted(t, *args, **kw):  # the bytes of every collective of the step
            sizes.append(t.numel() * t.element_size())
            return all_reduce(t, *args, **kw)

        torch.distributed.all_reduce = counted
        try:
            _, loss, after, _, calls = _dp_step(TRAIN_N, "bfloat16", rows)
        finally:
            torch.distributed.all_reduce = all_reduce
        launched = dict(LAUNCHES)
        cfg, state, perturb, img, lbl = _dp_setup(TRAIN_N, "bfloat16", False)
        img, lbl = img[rows].contiguous(), lbl[rows].contiguous()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(state, img, lbl, cfg, perturb=perturb)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.save({"fp32_loss": fp32_loss, "fp32_grads": fp32_grads, "loss": loss,
                    "collectives": sizes,
                    "launched": launched, "state": after, "ms": times[1:],
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "calls": [(k, _dtype_name(d), i, o) for k, d, i, o in calls + fp32_calls]},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _run_ranks(target: str, timeout: float = 900, extra: tuple = ()) -> tuple:
    """``DP_WORLD`` processes of ``chip_smoke.<target>(rank, world,
    rendezvous, out, *extra)`` on a file rendezvous; their results and
    seconds."""
    args = "".join(f", {a!r}" for a in extra)
    with tempfile.TemporaryDirectory() as tmp:
        rendezvous = f"file://{tmp}/rendezvous"
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.{target}({r}, {DP_WORLD}, "
                                   f"{rendezvous!r}, {tmp!r}{args})"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(DP_WORLD)]
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=timeout)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        seconds = time.perf_counter() - t0
        bad = [(r, p.returncode, out[-3000:]) for r, (p, out) in enumerate(zip(procs, outs))
               if p.returncode != 0]
        if bad:
            raise AssertionError(f"{target}: a rank failed: {bad}")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(DP_WORLD)], seconds


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_data_parallel(cuda_gen) -> dict:
    """Data parallelism, one process per card, on the one card there is.

    ``DP_WORLD`` ranks share the card through gloo (NCCL refuses two ranks
    on one device), each in a process of its own, and take two MRFP+ steps
    (all gates on, the draws of one seed) on their rows of a global batch;
    this process takes the same steps on the whole batch, and again on the
    input moved slightly: the control, how far rounding alone moves them.

    - fp32 (TF32 off, cuDNN deterministic) at 768x768, global batch
      ``DP_FP32_N``, on the damped fixture (ROADMAP C3): the loss within
      1e-5 relative; every gradient within 3x the 1e-7-input control's
      distance plus 1e-4 of its norm, the rule of tests/test_torch_dist.py.
    - The bf16 recipe at 768x768, global batch ``TRAIN_N``: the ranks end
      with the same parameters and buffers bit for bit and the one-process
      step counters; the loss within half a bf16 ulp (2^-9 relative) of the
      one-process loss, or 3x the control's distance where that is larger
      (every BN output rounds to bf16, and the ranks round some of them
      the other way: a perturbation at every layer, which one at the input
      can understate); each BN statistic's move in the step within 3x the
      half-ulp-input control's relative distance plus 1e-2, each
      parameter's within 3x plus 2e-2. (On these random weights one bf16
      step's parameter moves are rounding noise: the control moves them
      ~100%, so the fp32 step is the gradient's check.)

    Every resize call of each rank must be at a shape held against its
    plain version (the microbatch shapes, and the fp32 ranks' batch, held
    here first). Then
    ``cli.train --num-processes 1 --coordinator-address`` on NCCL for two
    steps: the launch path with its process group, whose one rank reduces
    nothing. Returns the ranks' summed kernel launches in the bf16 step and
    a rank's all_reduce bill of that step, (calls, bytes)."""
    n = DP_FP32_N // DP_WORLD
    err = _hold_train_shapes(n, (torch.float32,), cuda_gen)
    print(f"the fp32 ranks' shapes, batch {n}: the five train bilinear resizes' forward "
          f"exactly equal, backward within the bound (max_abs_err {err:.3e}); the seven OC "
          f"nearest resizes exactly equal both ways")
    with tempfile.TemporaryDirectory() as nccl_runs:
        # cli.train on NCCL runs beside the ranks: both are correctness runs
        nccl_out = os.path.join(nccl_runs, "result.json")
        cmd = [sys.executable, "-m", "mrfp_tpu_torch.cli.train", "--device", DEV,
               "--synthetic", "--batch-size", str(TRAIN_N), "--crop-size", str(CROP),
               "--max-iter", "2", "--log-every", "1", "--runs-dir", nccl_runs, "--json-out",
               nccl_out, "--num-processes", "1", "--process-id", "0",
               "--coordinator-address", f"127.0.0.1:{_free_port()}", "--data-parallel", "-1"]
        with _beside({"nccl": cmd}, timeout=600) as side:
            ranks, seconds = _run_ranks("dp_rank")
        rc, _out, nccl_err, nccl_s = side["nccl"]
        result = json.load(open(nccl_out)) if rc == 0 else {}
        ckpt = os.path.exists(os.path.join(result.get("run_dir", nccl_runs), "ckpt",
                                           "step_2.pt"))

    every = slice(None)
    with _strict_fp32():
        _, one32_loss, _, one32, calls = _dp_step(DP_FP32_N, "float32", every)
        _all_held(calls, "data parallel: the one-process fp32 step")
        _, ctrl32_loss, _, ctrl32, _ = _dp_step(DP_FP32_N, "float32", every, 1e-7)
    torch.cuda.empty_cache()
    fp32_loss_err = abs(ranks[0]["fp32_loss"] - one32_loss) / abs(one32_loss)
    fp32_ratio, grounded, ref64 = {}, [], None
    for k, g in one32.items():
        got = ranks[0]["fp32_grads"][k]
        err = float((got - g).norm())
        fp32_ratio[k] = err / (3 * float((ctrl32[k] - g).norm()) + 1e-4 * float(g.norm())
                               + 1e-12)
        if fp32_ratio[k] > 1:  # the fp64-grounded rule, its step taken where needed
            if ref64 is None:
                with _strict_fp32():
                    ref64 = _sp_fp64_grads(DP_FP32_N)
            ref = ref64[k].double()
            fp32_ratio[k] = float((got.double() - ref).norm()) / (
                3 * float((g.double() - ref).norm()) + 1e-4 * float(ref.norm()) + 1e-12)
            grounded.append((k, round(fp32_ratio[k], 3)))
    fp32_worst = sorted(fp32_ratio.items(), key=lambda kv: -kv[1])[:3]
    fp32_keys = {k: (_rel(ranks[0]["fp32_grads"][k], one32[k]), _rel(ctrl32[k], one32[k]))
                 for k in GRAD_KEYS}

    before, one_loss, one, _, calls = _dp_step(TRAIN_N, "bfloat16", every)
    _all_held(calls, "data parallel: the one-process step")
    before_ctrl, ctrl_loss, ctrl, _, _ = _dp_step(TRAIN_N, "bfloat16", every, 2.0 ** -9)
    with _strict_fp32():  # which bf16 loss lies nearer the fp32 one (no check)
        ref32_loss = _dp_step(TRAIN_N, "float32", every, damped=False)[1]
    torch.cuda.empty_cache()
    if any(not torch.equal(v, before_ctrl[k]) for k, v in before.items()):
        raise AssertionError("data parallel: the control started from another state")
    same = [k for k, v in ranks[0]["state"].items() if not torch.equal(v, ranks[1]["state"][k])]
    loss = ranks[0]["loss"]
    loss_err = abs(loss - one_loss) / abs(one_loss)
    loss_ctrl = abs(ctrl_loss - one_loss) / abs(one_loss)

    def moved(a: dict, k: str) -> torch.Tensor:
        return a[k].double() - before[k].double()

    err, control = {}, {}
    for k, v in one.items():
        if v.is_floating_point() and moved(one, k).norm() > 0:
            err[k] = _rel(moved(ranks[0]["state"], k), moved(one, k))
            control[k] = _rel(moved(ctrl, k), moved(one, k))
    stats = [k for k in err if "running" in k]
    over = {k: (v, control[k]) for k, v in err.items()
            if v > 3 * control[k] + (1e-2 if k in stats else 2e-2)}
    counters = [k for k, v in one.items() if not v.is_floating_point()
                and not torch.equal(ranks[0]["state"][k], v)]
    launched = {k: sum(r["launched"][k] for r in ranks) for k in ranks[0]["launched"]}
    ms = [statistics.median(r["ms"]) for r in ranks]
    sizes = ranks[0]["collectives"]

    def summary(keys) -> str:
        e, c = [err[k] for k in keys], [control[k] for k in keys]
        return (f"median {statistics.median(e):.3e} (control {statistics.median(c):.3e}), "
                f"max {max(e):.3e} (control {max(c):.3e})")

    print(f"data parallel fp32 (TF32 off, deterministic), damped fixture: {DP_WORLD} ranks x "
          f"{DP_FP32_N // DP_WORLD} against one process x {DP_FP32_N}, {CROP}x{CROP}, all "
          f"gates on: loss {ranks[0]['fp32_loss']:.7f} vs {one32_loss:.7f} (rel "
          f"{fp32_loss_err:.3e}; 1e-7-input control "
          f"{abs(ctrl32_loss - one32_loss) / abs(one32_loss):.3e}); gradients of {len(one32)} "
          f"tensors, worst error / bound {[(k, round(v, 3)) for k, v in fp32_worst]}, median "
          f"{statistics.median(fp32_ratio.values()):.3f}; the four named (rel, control) "
          f"{ {k: (float(f'{a:.3e}'), float(f'{b:.3e}')) for k, (a, b) in fp32_keys.items()} }")
    print(f"data parallel bf16: {DP_WORLD} ranks x {TRAIN_N // DP_WORLD} images on one card "
          f"over gloo, {CROP}x{CROP}, all gates on, the same draws, against one process x "
          f"{TRAIN_N}: loss {loss:.6f} vs {one_loss:.6f}, rel {loss_err:.3e} (bound "
          f"{max(2.0 ** -9, 3 * loss_ctrl):.3e}: 2^-9 or 3x the control; "
          f"control, the input moved half a bf16 ulp: {loss_ctrl:.3e}; from the fp32 "
          f"step's {ref32_loss:.6f}: ranks {abs(loss - ref32_loss) / ref32_loss:.3e}, one "
          f"process {abs(one_loss - ref32_loss) / ref32_loss:.3e}); moves off the "
          f"one-process moves, {len(stats)} BN statistics: {summary(stats)}; "
          f"{len(err) - len(stats)} parameters: {summary([k for k in err if k not in stats])};"
          f" ranks identical: {not same}; launches (both ranks) {launched}; all_reduce calls "
          f"a rank: {len(sizes)}, the largest {max(sizes) / 1e6:.1f} MB, the others "
          f"{(sum(sizes) - max(sizes)) / 1e6:.3f} MB; step on the ranks "
          f"(gloo through the host: a correctness run, not a speed) median "
          f"{[round(m, 3) for m in ms]} ms, peak {max(r['peak_gib'] for r in ranks):.2f} GiB "
          f"a rank; {seconds:.1f} s for the ranks end to end")
    if not math.isfinite(fp32_loss_err) or fp32_loss_err > 1e-5 or fp32_worst[0][1] > 1:
        raise AssertionError(f"data parallel fp32: loss rel {fp32_loss_err}, gradients over "
                             f"their bounds {[kv for kv in fp32_worst if kv[1] > 1]}")
    if same or counters:
        raise AssertionError(f"data parallel: ranks differ at {same}; counters differ from "
                             f"one process at {counters}")
    if not math.isfinite(loss) or loss_err > max(2.0 ** -9, 3 * loss_ctrl):
        raise AssertionError(f"data parallel: loss {loss} against one process's {one_loss}")
    if over:
        raise AssertionError(f"data parallel: moves off the one-process step's beyond 3x "
                             f"the control's + 1e-2 (statistics) / 2e-2: {over}")
    if min(launched[k] for k in MRFP_TRAIN_KERNELS) <= 0:
        raise AssertionError(f"data parallel: a resize or OC-stage kernel was not launched: "
                             f"{launched}")
    for r in ranks:
        _all_held([(k, getattr(torch, d), i, o) for k, d, i, o in r["calls"]],
                  "data parallel: a rank's steps")

    nccl = "(nccl, tcp://127.0.0.1:" in nccl_err
    print(f"cli.train --num-processes 1 --process-id 0 --coordinator-address "
          f"127.0.0.1 (nccl: {nccl}): rc {rc}, {nccl_s:.1f} s end to end beside the ranks, "
          f"losses {result.get('losses')}, checkpoint {ckpt}")
    if rc != 0 or not nccl or result.get("step") != 2 or not ckpt \
            or not all(math.isfinite(v) for v in result["losses"].values()):
        raise AssertionError(f"cli.train on NCCL: rc {rc}, result {result}, "
                             f"stderr {nccl_err[-3000:]}")
    return launched, (len(sizes), sum(sizes))


SP_WORLD = 2     # ranks of the spatial phase: one spatial group, all on the one card
SP_FP32_N = 2    # the fp32 step's batch (every rank holds every sample)
SP_EVAL_IMAGES = 2  # SegEvaluator's synthetic images at H x W


def _hold_band_resizes(resizes, backward: bool, cuda_gen, sp: int = SP_WORLD) -> int:
    """Holds every band table that ``sp`` ranks make of each whole-map
    resize in ``resizes`` (``_resizes_run``'s records) against the plain
    versions, on the card: the forward exactly equal, and with
    ``backward`` the bilinear backward within ``_bilinear_bwd_close``'s
    bound and the nearest one exactly equal. Returns the band calls
    held."""
    from mrfp_tpu_torch.ops import cuda_resize
    from mrfp_tpu_torch.ops.resize import (bilinear_band_rows, bilinear_taps,
                                           nearest_band_rows, nearest_index, nearest_table)
    from mrfp_tpu_torch.parallel.dist import band
    held = 0
    for kind, dtype, n, c, sy, sx in sorted(resizes, key=str):
        h, w = sy[1], sx[1]
        if kind == "bilinear":
            oh = sy[2]
            tx = bilinear_taps(w, sx[2], DEV)
            fwd, bwd = cuda_resize.resize_bilinear_cuda, cuda_resize.resize_bilinear_bwd_cuda
            fwd_p, bwd_p = cuda_resize.resize_bilinear_plain, cuda_resize.resize_bilinear_bwd_plain
            ow = tx.idx0.numel()
        else:
            oh = len(nearest_index(*sy[1:4]))
            tx = nearest_table(w, sx[2], sx[3], DEV)
            fwd, bwd = cuda_resize.resize_nearest_cuda, cuda_resize.resize_nearest_bwd_cuda
            fwd_p, bwd_p = cuda_resize.resize_nearest_plain, cuda_resize.resize_nearest_bwd_plain
            ow = tx.idx.numel()
        for r in range(sp):
            o0, o1 = band(oh, sp, r)
            if kind == "bilinear":
                lo, hi = bilinear_band_rows(h, oh, o0, o1)
                ty = bilinear_taps(h, oh, DEV, (o0, o1))
                extra = ((h, oh, (o0, o1)),)
            else:
                lo, hi = nearest_band_rows(h, sy[2], sy[3], o0, o1)
                ty = nearest_table(h, sy[2], sy[3], DEV, (o0, o1))
                extra = ()
            x = torch.randn((n, c, hi - lo, w), device=DEV, generator=cuda_gen).to(dtype)
            y = fwd(x, ty, tx, *extra)
            what = f"band {r} of {sp}: {kind} {_dtype_name(dtype)} ({n},{c},{h},{w})->({oh},{ow})"
            if y.shape != (n, c, o1 - o0, ow) or not torch.equal(y, fwd_p(x, ty, tx)):
                raise AssertionError(f"{what}: the band forward is not the plain version's")
            band_spec = _table_spec(ty)
            _held(f"resize_{kind}", x, y, band_spec)
            held += 1
            if backward:
                g = torch.randn(y.shape, device=DEV, generator=cuda_gen).to(dtype)
                gx = bwd(g, ty, tx, hi - lo, w)
                if kind == "bilinear":
                    _bilinear_bwd_close(gx, g, ty, tx, hi - lo, w, what)
                elif not torch.equal(gx, bwd_p(g, ty, tx, hi - lo, w)):
                    raise AssertionError(f"{what}: the band backward is not the plain version's")
                _held(f"resize_{kind}_bwd", g, gx, band_spec)
                held += 1
    torch.cuda.synchronize()
    return held


def _sp_step(batch: int, dtype: str, mesh=None, noise: float = 0.0, damped=None, cfg=None):
    """One step of ``_dp_setup(batch, dtype, damped)`` (by default damped in
    fp32), with ``cfg`` in place of its config where given: on the whole
    batch, or with a spatial ``mesh`` on this rank's band of every image's
    rows (``band_batch``: an FFT transform on the whole images first); the
    images x (1 + ``noise`` x N(0, 1)). Every resize call recorded:
    ``(state before, loss, state after, gradients, calls)``, the tensors on
    the host."""
    from mrfp_tpu_torch.train.step import band_batch, train_step
    damped = dtype == "float32" if damped is None else damped
    setup_cfg, state, perturb, img, lbl = _dp_setup(batch, dtype, damped)
    cfg = cfg or setup_cfg
    eps = torch.randn(img.shape, generator=torch.Generator().manual_seed(2)).to(img.device)
    img = img.float() * (1 + noise * eps)
    hw = None
    if mesh is not None:
        img, lbl, hw = band_batch(mesh, img, lbl, cfg)
    host = lambda d: {k: v.detach().to("cpu", copy=True) for k, v in d.items()}  # noqa: E731
    before = host(state.model.state_dict())
    with _recording() as calls:
        loss = train_step(state, img.contiguous(), lbl.contiguous(), cfg, perturb=perturb,
                          hw=hw, transformed=hw is not None)["loss"]
    grads = host({k: p.grad for k, p in state.model.named_parameters()})
    return before, loss.item(), host(state.model.state_dict()), grads, calls


def _sp_fp64_grads(batch: int) -> dict:
    """The gradients of ``_sp_step(batch, "float32")``'s one-process step
    taken in fp64 (the model, the images and every op but the bilinear
    resizes' plain versions, which interpolate in fp32), on the host in
    fp32: the reference from which the fp32 steps' distances are read
    where a 1e-7-input control understates their rounding (the ASPP image
    pool's BatchNorm over the batch's 1x1 maps amplifies a pooled mean's
    last-bit differences; the control moves that mean far less than a
    rounding at every layer does)."""
    import torch.nn.functional as F
    cfg, state, perturb, img, lbl = _dp_setup(batch, "float32", True)
    model = state.model.double().train()
    logits = model(img.permute(0, 3, 1, 2).double(), impl="plain", perturb=perturb)
    labels = lbl.long()
    loss = F.cross_entropy(logits, labels, ignore_index=255, reduction="sum") \
        / (labels != 255).sum().clamp_min(1)
    loss.backward()
    return {k: p.grad.float().to("cpu") for k, p in model.named_parameters()}


def _sp_logits_fp64() -> torch.Tensor:
    """``_sp_eval``'s one-process logits in fp64 (the model and the image;
    the bilinear resizes' plain versions interpolate in fp32): the
    reference from which the fp32 logits' distances are read."""
    from mrfp_tpu_torch.models import build_mrfp
    model = build_mrfp(DEV, generator=torch.Generator().manual_seed(0)).double()
    x = (torch.rand((1, 3, H, W), generator=torch.Generator().manual_seed(21)) * 255).to(DEV)
    with torch.inference_mode():
        return model(x.double(), impl="plain").to("cpu")


def _sp_eval(mesh=None):
    """The fp32 eval forward of the seeded R50-D16 model at 1x3xHxW (TF32 off,
    cuDNN deterministic), on the whole image or this rank's band, and
    ``SegEvaluator``'s histogram over ``SP_EVAL_IMAGES`` synthetic images;
    every resize call recorded, and the kernels' launches of the
    evaluator's run: ``(logits on the host, hist, calls, launches)``."""
    from mrfp_tpu_torch.data import SyntheticDataset
    from mrfp_tpu_torch.models import build_mrfp
    from mrfp_tpu_torch.ops import LAUNCHES, reset_launches
    from mrfp_tpu_torch.parallel.dist import band
    from mrfp_tpu_torch.train.evaluator import SegEvaluator
    model = build_mrfp(DEV, generator=torch.Generator().manual_seed(0))
    x = (torch.rand((1, 3, H, W), generator=torch.Generator().manual_seed(21)) * 255).to(DEV)
    with _strict_fp32(), torch.inference_mode(), _recording() as calls:
        if mesh is None:
            logits = model(x)
        else:
            lo, hi = band(H, mesh.sp, mesh.spatial_index)
            logits = model(x[:, :, lo:hi].contiguous(), hw=(H, W))
        logits = logits.to("cpu")
        torch.cuda.synchronize()
        reset_launches()
        res = SegEvaluator(model, device=DEV, mesh=mesh).run(
            SyntheticDataset(length=SP_EVAL_IMAGES, hw=(H, W)), log=lambda *a, **k: None)
        launched = dict(LAUNCHES)
    return logits, torch.as_tensor(res["hist"]), calls, launched


def sp_rank(rank: int, world: int, rendezvous: str, out: str) -> None:
    """One rank of ``phase_spatial_parallel`` (its own process): joins the
    gloo group, lays out one spatial group, takes the fp32 step on its band
    of the batch's rows, then the counted, recorded bf16 step and three
    timed ones, then the fp32 eval forward and the evaluator on its bands,
    and writes what it saw to ``out/rank<rank>.pt``."""
    from mrfp_tpu_torch.core.config import MeshConfig
    from mrfp_tpu_torch.core.mesh import create_mesh, spatial_sharding
    from mrfp_tpu_torch.ops import LAUNCHES, reset_launches
    from mrfp_tpu_torch.parallel import dist
    from mrfp_tpu_torch.parallel.audit import count_collectives, summarize_by_group
    from mrfp_tpu_torch.train.step import train_step
    dist.initialize_distributed(rendezvous, world, rank, DEV, backend="gloo", timeout_s=600)
    try:
        mesh = create_mesh(MeshConfig(data_parallel=1, spatial_parallel=world))
        with _strict_fp32():
            _, fp32_loss, _, fp32_grads, fp32_calls = _sp_step(SP_FP32_N, "float32", mesh)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with count_collectives() as log:
            _, loss, after, _, calls = _sp_step(TRAIN_N, "bfloat16", mesh)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        launched = dict(LAUNCHES)
        cfg, state, perturb, img, lbl = _dp_setup(TRAIN_N, "bfloat16", False)
        img, lbl = spatial_sharding(mesh, img), spatial_sharding(mesh, lbl)
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(state, img, lbl, cfg, perturb=perturb, hw=(CROP, CROP))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        del state, img, lbl
        torch.cuda.empty_cache()
        logits, hist, eval_calls, eval_launched = _sp_eval(mesh)
        for k, v in eval_launched.items():
            launched[k] += v
        torch.save({"fp32_loss": fp32_loss, "fp32_grads": fp32_grads, "loss": loss,
                    "state": after, "collectives": summarize_by_group(log),
                    "launched": launched, "ms": times[1:], "peak_gib": peak,
                    "logits": logits, "hist": hist,
                    "calls": [(c[0], _dtype_name(c[1])) + c[2:]
                              for c in calls + fp32_calls + eval_calls]},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


@contextlib.contextmanager
def _beside(cmds: dict, timeout: float = 900, env=None):
    """Each command of ``cmds`` (name -> argv) in a process of its own (with
    ``env`` added to this one's environment) while the block runs, its
    output in a file (no pipe to fill); yields a dict that holds, once the
    block has ended, each one's ``(returncode, stdout, stderr, seconds)``,
    the seconds from the block's start to its end."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = {}
        for name, cmd in cmds.items():
            out, err = (open(os.path.join(tmp, f"{name}.{k}"), "w+") for k in ("out", "err"))
            procs[name] = (subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=err, text=True,
                                            env=env and {**os.environ, **env}), out, err)
        done = {}
        try:
            yield done
            for name, (proc, out, err) in procs.items():
                proc.wait(timeout=timeout)
                out.seek(0)
                err.seek(0)
                done[name] = (proc.returncode, out.read(), err.read(), time.perf_counter() - t0)
        finally:
            for proc, out, err in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                out.close()
                err.close()


@contextlib.contextmanager
def _cli_evals(*extras):
    """``cli.eval --synthetic`` at H x W on one image, fp32, once with each
    of ``extras`` (its extra flags), in processes of their own while the
    block runs; yields a list that holds their results, in order, once
    the block has ended."""
    with tempfile.TemporaryDirectory() as tmp:
        cmds = {str(i): [sys.executable, "-m", "mrfp_tpu_torch.cli.eval", "--device", DEV,
                         "--synthetic", "--synthetic-hw", str(H), str(W), "--domains",
                         "cityscapes", "--max-images", "1", "--json-out",
                         os.path.join(tmp, f"{i}.json"), *extra]
                for i, extra in enumerate(extras)}
        results = []
        with _beside(cmds, timeout=600) as done:
            yield results
        for i, cmd in cmds.items():
            rc, _out, err, _s = done[i]
            if rc != 0:
                raise AssertionError(f"{' '.join(cmd[2:])}: rc {rc}: {err[-3000:]}")
            results.append(json.load(open(os.path.join(tmp, f"{i}.json")))["cityscapes"])


def phase_spatial_parallel(cuda_gen) -> dict:
    """Spatial parallelism on the one card there is: ``SP_WORLD`` ranks, each
    a process of its own, share the card through gloo (as
    ``phase_data_parallel``'s) and split every image's rows, each taking
    its band of every map and fetching the halo rows from the other.

    One process first takes the same runs on whole images, recording every
    resize it launches; each band table the ranks will make of those
    resizes is then held against the plain version (``_hold_band_resizes``),
    and every resize call of the ranks must be at a held band.

    - fp32 (TF32 off, cuDNN deterministic), the damped fixture, batch
      ``SP_FP32_N`` at 768x768, all gates on: the loss within 1e-5
      relative of one process's; every gradient within 3x a 1e-7-input
      control + 1e-4 of its norm, or, where the control understates the
      rounding of every layer, no further from the same step in fp64
      (``_sp_fp64_grads``) than 3x the one-process step's distance + 1e-4
      of its norm: as accurate as one process.
    - bf16, the recipe at batch ``TRAIN_N``: the ranks end bit-identical;
      the loss within 2^-9 or 3x the half-ulp-input control; each BN
      statistic's move within 3x the control + 1e-2, each parameter's
      within 3x + 2e-2 (``phase_data_parallel``'s rules). Each rank's peak
      memory above what it held before the step's set-up, beside one
      process's; each rank's collectives a step by group, halo rows apart
      from statistics; the ranks' step ms (gloo through the host: a
      correctness time).
    - Eval: the fp32 forward at 1x3xHxW, the ranks' bands against one
      process's logits within atol 2e-4, rtol 1e-4 (JAX's
      test_spatial_eval_logits_match_unsharded bound; a rounding at every
      layer moves logits of up to ~32 by ~2e-4), and no further from the
      same forward in fp64 than 3x one process's distance (norm);
      ``SegEvaluator`` over
      ``SP_EVAL_IMAGES`` synthetic images, the histograms equal or apart in
      at most 0.01% of the pixels (cuDNN's band algorithms may flip an
      argmax tie); then ``cli.eval --spatial-parallel 2`` against
      ``cli.eval`` on one image: the pixels equal and the accuracy within
      1e-4 (at most 0.01% of the pixels moved).

    Returns the ranks' summed kernel launches in the bf16 step and the
    evaluator's run."""
    t0 = time.perf_counter()
    every = None
    with _strict_fp32(), _resizes_run() as fp32_resizes:
        _, one32_loss, _, one32, _ = _sp_step(SP_FP32_N, "float32", every)
        _, ctrl32_loss, _, ctrl32, _ = _sp_step(SP_FP32_N, "float32", every, 1e-7)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with _resizes_run() as bf16_resizes:
        before, one_loss, one, _, _ = _sp_step(TRAIN_N, "bfloat16", every)
    torch.cuda.synchronize()
    one_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    before_ctrl, ctrl_loss, ctrl, _, _ = _sp_step(TRAIN_N, "bfloat16", every, 2.0 ** -9)
    torch.cuda.empty_cache()
    with _resizes_run() as eval_resizes:
        one_logits, one_hist, _, _ = _sp_eval()
    logits64 = _sp_logits_fp64()
    torch.cuda.empty_cache()
    held = (_hold_band_resizes(fp32_resizes | bf16_resizes, True, cuda_gen)
            + _hold_band_resizes(eval_resizes, False, cuda_gen))
    torch.cuda.empty_cache()
    print(f"spatial parallel: {held} band resize calls of {SP_WORLD} ranks held against the "
          f"plain versions ({len(fp32_resizes | bf16_resizes)} train resizes fp32 and bf16, "
          f"forward exactly equal, backward within the bound; {len(eval_resizes)} eval "
          f"resizes, forward exactly equal); one process's runs {time.perf_counter() - t0:.1f} s")

    with _cli_evals([], ["--spatial-parallel", "2"]) as evals:  # beside the ranks
        ranks, seconds = _run_ranks("sp_rank")
    for r in ranks:
        _all_held([(c[0], getattr(torch, c[1])) + tuple(c[2:]) for c in r["calls"]],
                  "spatial parallel: a rank's runs")
    fp32_loss_err = abs(ranks[0]["fp32_loss"] - one32_loss) / abs(one32_loss)
    fp32_ratio, grounded, ref64 = {}, [], None
    for k, g in one32.items():
        got = ranks[0]["fp32_grads"][k]
        err = float((got - g).norm())
        fp32_ratio[k] = err / (3 * float((ctrl32[k] - g).norm()) + 1e-4 * float(g.norm())
                               + 1e-12)
        if fp32_ratio[k] > 1:  # the fp64-grounded rule, its step taken where needed
            if ref64 is None:
                with _strict_fp32():
                    ref64 = _sp_fp64_grads(SP_FP32_N)
            ref = ref64[k].double()
            fp32_ratio[k] = float((got.double() - ref).norm()) / (
                3 * float((g.double() - ref).norm()) + 1e-4 * float(ref.norm()) + 1e-12)
            grounded.append((k, round(fp32_ratio[k], 3)))
    fp32_worst = sorted(fp32_ratio.items(), key=lambda kv: -kv[1])[:3]
    if any(not torch.equal(v, before_ctrl[k]) for k, v in before.items()):
        raise AssertionError("spatial parallel: the control started from another state")
    same = [k for k, v in ranks[0]["state"].items() if not torch.equal(v, ranks[1]["state"][k])]
    loss = ranks[0]["loss"]
    loss_err = abs(loss - one_loss) / abs(one_loss)
    loss_ctrl = abs(ctrl_loss - one_loss) / abs(one_loss)

    def moved(a: dict, k: str) -> torch.Tensor:
        return a[k].double() - before[k].double()

    err, control = {}, {}
    for k, v in one.items():
        if v.is_floating_point() and moved(one, k).norm() > 0:
            err[k] = _rel(moved(ranks[0]["state"], k), moved(one, k))
            control[k] = _rel(moved(ctrl, k), moved(one, k))
    stats = [k for k in err if "running" in k]
    over = {k: (v, control[k]) for k, v in err.items()
            if v > 3 * control[k] + (1e-2 if k in stats else 2e-2)}
    counters = [k for k, v in one.items() if not v.is_floating_point()
                and not torch.equal(ranks[0]["state"][k], v)]
    launched = {k: sum(r["launched"][k] for r in ranks) for k in ranks[0]["launched"]}
    ms = [statistics.median(r["ms"]) for r in ranks]
    logits = torch.cat([r["logits"] for r in ranks], dim=2)
    logit_err = (logits - one_logits).abs().max().item()
    d64 = {k: float((v.double() - logits64).norm() / logits64.norm())
           for k, v in (("ranks", logits), ("one", one_logits))}
    hist_moved = [int((r["hist"].long() - one_hist.long()).abs().sum()) // 2 for r in ranks]
    pixels = int(one_hist.sum())
    one_eval, two_eval = evals
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"spatial parallel fp32 (TF32 off, deterministic), damped fixture: {SP_WORLD} ranks "
          f"x a band of {SP_FP32_N} images against one process, {CROP}x{CROP}, all gates on: "
          f"loss {ranks[0]['fp32_loss']:.7f} vs {one32_loss:.7f} (rel {fp32_loss_err:.3e}; "
          f"1e-7-input control {abs(ctrl32_loss - one32_loss) / abs(one32_loss):.3e}); "
          f"gradients of {len(one32)} tensors, worst error / bound "
          f"{[(k, round(v, 3)) for k, v in fp32_worst]}, median "
          f"{statistics.median(fp32_ratio.values()):.3f}; held to the fp64 step instead "
          f"(over 3x the control): {len(grounded)} {grounded[:8]}")
    print(f"spatial parallel bf16: {SP_WORLD} ranks x a band of {TRAIN_N} images over gloo, "
          f"{CROP}x{CROP}, all gates on, against one process: loss {loss:.6f} vs "
          f"{one_loss:.6f}, rel {loss_err:.3e} (bound {max(2.0 ** -9, 3 * loss_ctrl):.3e}); "
          f"BN statistics' moves off one process's, median "
          f"{statistics.median(err[k] for k in stats):.3e} (control "
          f"{statistics.median(control[k] for k in stats):.3e}); ranks identical: {not same}")
    for r, res in enumerate(ranks):
        print(f"spatial parallel rank {r}: peak {res['peak_gib']:.3f} GiB above its set-up "
              f"(one process {one_peak:.3f} GiB); collectives a bf16 step "
              f"{json.dumps(res['collectives'], sort_keys=True)}; step median {ms[r]:.1f} ms "
              f"(gloo through the host: a correctness time); card {card.strip()}")
    print(f"spatial parallel eval fp32 1x3x{H}x{W}: the ranks' bands against one process's "
          f"logits max_abs_err {logit_err:.3e} (|logits| max {one_logits.abs().max().item():.3e});"
          f" relative distance from the fp64 forward: ranks {d64['ranks']:.3e}, one process "
          f"{d64['one']:.3e}; SegEvaluator over {SP_EVAL_IMAGES} images: "
          f"pixels moved {hist_moved} of {pixels}; cli.eval --spatial-parallel 2 {two_eval} "
          f"vs cli.eval {one_eval}; launches (both ranks: bf16 step and evaluator) {launched}; "
          f"{seconds:.1f} s for the ranks end to end")
    if not math.isfinite(fp32_loss_err) or fp32_loss_err > 1e-5 or fp32_worst[0][1] > 1:
        raise AssertionError(f"spatial parallel fp32: loss rel {fp32_loss_err}, gradients over "
                             f"their bounds {[kv for kv in fp32_worst if kv[1] > 1]}")
    if same or counters:
        raise AssertionError(f"spatial parallel: ranks differ at {same}; counters differ from "
                             f"one process at {counters}")
    if not math.isfinite(loss) or loss_err > max(2.0 ** -9, 3 * loss_ctrl):
        raise AssertionError(f"spatial parallel: loss {loss} against one process's {one_loss}")
    if over:
        raise AssertionError(f"spatial parallel: moves off the one-process step's beyond 3x "
                             f"the control's + 1e-2 (statistics) / 2e-2: {over}")
    if not all(r["collectives"].get("spatial", {}).get("halo", {}).get("count", 0) > 0
               for r in ranks):
        raise AssertionError(f"spatial parallel: a rank fetched no halo rows: "
                             f"{[r['collectives'] for r in ranks]}")
    if logits.shape != one_logits.shape:
        raise AssertionError(f"spatial parallel eval: logits {tuple(logits.shape)}")
    torch.testing.assert_close(logits, one_logits, atol=2e-4, rtol=1e-4,
                               msg=lambda m: f"spatial parallel eval logits: {m}")
    if not d64["ranks"] <= 3 * d64["one"]:
        raise AssertionError(f"spatial parallel eval: the bands' logits lie {d64['ranks']} from "
                             f"the fp64 forward, one process's {d64['one']}")
    if max(hist_moved) > 1e-4 * pixels:
        raise AssertionError(f"spatial parallel eval: {hist_moved} of {pixels} pixels moved")
    if two_eval["pixels"] != one_eval["pixels"] or \
            not abs(two_eval["acc"] - one_eval["acc"]) <= 1e-4:
        raise AssertionError(f"cli.eval --spatial-parallel 2: {two_eval} against {one_eval}")
    if min(launched[k] for k in MRFP_TRAIN_KERNELS + ("confusion_matrix",)) <= 0:
        raise AssertionError(f"spatial parallel: a kernel was not launched: {launched}")
    return launched


# the zoo's data-parallel phase: DeepR50V3PlusD (resnet-50 D16, full width
# and depth), ISW in slots 2-3 and SwitchWhiten in slot 4, the whitening
# loss and the DSN head, 768x768 crops on DP_WORLD ranks: the bf16 recipe at
# global batch ZOO_DP_N, fp32 on the damped fixture at ZOO_DP_FP32_N
ZOO_DP_WT, ZOO_DP_N, ZOO_DP_FP32_N = ("0", "0", "2", "2", "5", "0", "0"), 8, 4


def _zoo_dp_setup(batch: int, dtype: str):
    """The zoo phase's config, state (fp32: on the damped fixture), view
    pairs (2 pairs at the bf16 ranks' batch) and global batch of ``batch``
    images, the same in every process."""
    from mrfp_tpu_torch.cli import train_zoo
    args = train_zoo.parse_args(["--arch", "DeepR50V3PlusD", "--wt-layer", *ZOO_DP_WT,
                                 "--use-wtloss", "--batch-size", str(batch),
                                 "--crop-size", str(CROP)]
                                + (["--no-bf16"] if dtype == "float32" else []))
    train_zoo.check_args(args)
    cfg = train_zoo.build_config(args)
    state = train_zoo.build_state(cfg, torch.device(DEV))
    if dtype == "float32":
        _damp_(state.model)
    gen = torch.Generator().manual_seed(5)
    local = ZOO_DP_N // DP_WORLD
    pairs = [tuple((torch.rand((local, CROP, CROP, 3), generator=gen) * 255).numpy()
                   for _ in range(2)) for _ in range(2)]
    img, lbl = _batch(gen, batch)
    return cfg, state, pairs, img, lbl


def _zoo_dp_step(rows: slice, noise: float = 0.0, steps=None, batch: int = ZOO_DP_N,
                 dtype: str = "bfloat16", mesh=None) -> dict:
    """The statistics pass, then one zoo step of ``_zoo_dp_setup(batch,
    dtype)`` on ``rows`` of its batch (with a spatial ``mesh``, this rank's
    band of every view's and image's rows), the images x (1 + ``noise`` x
    N(0, 1)), with every resize call recorded and the step's collectives
    and launches counted; then ``steps`` more steps timed. The tensors (the
    state before and after, the gradients) come back on the host, with the
    names of SwitchWhiten's parameters."""
    from mrfp_tpu_torch.core.mesh import spatial_sharding
    from mrfp_tpu_torch.models.deepv3_zoo import build_cov_layers
    from mrfp_tpu_torch.nn.norms import SwitchWhiten2d
    from mrfp_tpu_torch.ops import LAUNCHES, reset_launches
    from mrfp_tpu_torch.parallel.audit import count_collectives
    from mrfp_tpu_torch.train.zoo_step import covstat_pass, zoo_train_step
    cfg, state, pairs, img, lbl = _zoo_dp_setup(batch, dtype)
    layers = build_cov_layers("resnet-50", tuple(map(int, ZOO_DP_WT)))
    masks, nrc = covstat_pass(state.model, layers, pairs, cfg, torch.device(DEV))
    eps = torch.randn(img.shape, generator=torch.Generator().manual_seed(2)).to(img.device)
    img = (img.float() * (1 + noise * eps))[rows].contiguous()
    lbl = lbl[rows].contiguous()
    hw = None
    if mesh is not None:
        img, lbl, hw = spatial_sharding(mesh, img), spatial_sharding(mesh, lbl), (CROP, CROP)
    host = lambda d: {k: v.detach().to("cpu", copy=True) for k, v in d.items()}  # noqa: E731
    before = host(state.model.state_dict())
    torch.cuda.synchronize()
    reset_launches()
    with _recording() as calls, count_collectives() as log:
        m = zoo_train_step(state, img, lbl, cfg, masks, nrc, hw=hw)
        losses = {k: float(v) for k, v in m.items() if k.startswith("loss")}
    launched = dict(LAUNCHES)
    after = host(state.model.state_dict())
    grads = host({k: p.grad for k, p in state.model.named_parameters() if p.grad is not None})
    sw = [f"{name}.{k}" for name, mod in state.model.named_modules()
          if isinstance(mod, SwitchWhiten2d) for k, _ in mod.named_parameters()]
    times = []
    for _ in range(steps or 0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zoo_train_step(state, img, lbl, cfg, masks, nrc, hw=hw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"before": before, "losses": losses, "after": after, "grads": grads, "sw": sw,
            "launched": launched, "masks": [t.cpu() for t in masks], "nrc": nrc, "ms": times,
            "collectives": [vars(c) for c in log],
            "calls": [(c[0], _dtype_name(c[1])) + tuple(c[2:]) for c in calls]}


def zoo_dp_rank(rank: int, world: int, rendezvous: str, out: str) -> None:
    """One rank of ``phase_zoo_data_parallel`` (its own process): joins the
    gloo group, takes the fp32 ``_zoo_dp_step`` on its rows, then the bf16
    one and three timed bf16 steps, and writes what it saw to
    ``out/rank<rank>.pt``."""
    from mrfp_tpu_torch.parallel import dist
    dist.initialize_distributed(rendezvous, world, rank, DEV, backend="gloo", timeout_s=600)
    try:
        n = ZOO_DP_FP32_N // world
        with _strict_fp32():
            fp32 = _zoo_dp_step(slice(rank * n, (rank + 1) * n), batch=ZOO_DP_FP32_N,
                                dtype="float32")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        n = ZOO_DP_N // world
        res = _zoo_dp_step(slice(rank * n, (rank + 1) * n), steps=3)
        res["fp32"] = {k: fp32[k] for k in ("losses", "grads", "masks", "nrc")}
        res["calls"] += fp32["calls"]
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def phase_zoo_data_parallel(cuda_gen, dp_bill=None) -> dict:
    """The zoo on several processes, on the one card there is.

    First the resizes of the ranks' batches and of the one process's are
    held against their plain versions: the head's three bilinear resizes
    in bf16 and fp32 (forward exactly, backward within the bound) and the
    DSN label map (exactly). ``DP_WORLD`` ranks then share the card
    through gloo (``zoo_dp_rank``), each running the statistics pass over
    the same view pairs (rank 0's masks broadcast) and a zoo step of
    ``_zoo_dp_setup`` on its half of the global batch, fp32 then bf16; this
    process takes the same passes and steps on the whole batches, and
    again on the input moved by a rounding step (the controls: 1e-7 in
    fp32, half a bf16 ulp in bf16). Checks:

    - fp32 (TF32 off, cuDNN deterministic, the damped fixture): the masks
      equal across ranks and to one process's; each loss and every
      gradient, SwitchWhiten's parameters' included, within 3x the
      control's distance plus 1e-4 of its size (tests/test_torch_dist.py's
      rule);
    - bf16: the ranks' masks equal each other's and the one-process pass's
      bit for bit; the ranks end with bit-identical parameters and
      buffers; the loss within 2^-9 relative of the one-process loss; each
      BatchNorm and SwitchWhiten running statistic's move within 3x the
      control's relative distance + 2e-2 (``phase_data_parallel``'s bf16
      bound);
    - every resize call at a held shape.

    Prints the ranks' bf16 step ms (gloo through the host: a correctness
    time) and the step's collectives by op and dtype. Then ``cli.plan``
    plans the MRFP+ R50-D16 launch of global batch 8 on 2 ranks (bf16): its
    all-reduce count and bytes must be ``dp_bill``, those
    ``phase_data_parallel`` counted in this run (``DP_BILL`` when that
    phase did not run); and ``cli.train_zoo --num-processes 1
    --coordinator-address`` trains two steps of the recipe on NCCL. Both
    run in processes of their own beside the ranks. Returns the ranks'
    summed launches."""
    from mrfp_tpu_torch.models.deepv3_zoo import iw_slots
    from mrfp_tpu_torch.ops import cuda_resize
    from mrfp_tpu_torch.ops.resize import nearest_table
    from mrfp_tpu_torch.parallel.audit import Collective, summarize, summarize_by_dtype
    slots = [i for i, c in enumerate(ZOO_DP_WT) if c != "0"]
    if not set(slots) <= set(iw_slots("resnet-50")):
        raise AssertionError(f"resnet-50 reads slots {iw_slots('resnet-50')}, not {slots}")
    local, local32 = ZOO_DP_N // DP_WORLD, ZOO_DP_FP32_N // DP_WORLD
    errs = []
    for dtype, batches in ((torch.bfloat16, (local, ZOO_DP_N)),
                           (torch.float32, (local32, ZOO_DP_FP32_N))):
        for name, n, c, (h, w), size in [r for b in batches
                                         for r in _head_resizes(b, 19, (CROP, CROP), 4, 16)]:
            x = torch.randn((n, c, h, w), device=DEV, generator=cuda_gen).to(dtype)
            what = f"{_dtype_name(dtype)} zoo {name} ({n},{c},{h},{w})->{size}"
            errs.append(_bilinear_pair(x, size, cuda_gen, what)[3])
    ty = nearest_table(CROP, "size", CROP // 16, DEV)
    for n in sorted({local, ZOO_DP_N, local32, ZOO_DP_FP32_N}):
        lbl = torch.randint(0, 19, (n, 1, CROP, CROP), device=DEV, generator=cuda_gen).float()
        got = cuda_resize.resize_nearest_cuda(lbl, ty, ty)
        if not torch.equal(got, cuda_resize.resize_nearest_plain(lbl, ty, ty)):
            raise AssertionError(f"resize_nearest zoo DSN labels {tuple(lbl.shape)}: "
                                 f"kernel != plain")
        _held("resize_nearest", lbl, got)
    del lbl, got
    torch.cuda.empty_cache()
    print(f"zoo shapes, batch {local} (a rank's) and {ZOO_DP_N} in bf16, {local32} and "
          f"{ZOO_DP_FP32_N} in fp32: the head's three bilinear resizes forward exactly "
          f"equal, backward within the bound (max_abs_err "
          f"{max(errs):.3e}); the DSN label map (n,1,{CROP},{CROP}) -> "
          f"{CROP // 16}x{CROP // 16} exactly equal")

    with tempfile.TemporaryDirectory() as tmp:
        # cli.plan and cli.train_zoo on NCCL run beside the ranks: all are
        # correctness runs, and none waits for another
        plan_out, zoo_out = os.path.join(tmp, "plan.json"), os.path.join(tmp, "zoo.json")
        side = {"plan": [sys.executable, "-m", "mrfp_tpu_torch.cli.plan", "--trunk", "resnet-50",
                         "--variant", "D16", "--mode", "mrfp+", "--batch-size", str(TRAIN_N),
                         "--crop-size", str(CROP), "--data-parallel", str(DP_WORLD),
                         "--device", DEV, "--json-out", plan_out],
                "nccl": [sys.executable, "-m", "mrfp_tpu_torch.cli.train_zoo", "--device", DEV,
                         "--synthetic", "--arch", "DeepR50V3PlusD", "--wt-layer", *ZOO_DP_WT,
                         "--use-wtloss", "--covstat-batches", "1", "--batch-size", str(local),
                         "--crop-size", str(CROP), "--max-iter", "2", "--log-every", "1",
                         "--runs-dir", os.path.join(tmp, "runs"), "--json-out", zoo_out,
                         "--num-processes", "1", "--process-id", "0", "--coordinator-address",
                         f"127.0.0.1:{_free_port()}", "--data-parallel", "-1"]}
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)
                 for k, cmd in side.items()}
        try:
            ranks, seconds = _run_ranks("zoo_dp_rank")
            with _strict_fp32():
                one32 = _zoo_dp_step(slice(None), batch=ZOO_DP_FP32_N, dtype="float32")
                ctrl32 = _zoo_dp_step(slice(None), 1e-7, batch=ZOO_DP_FP32_N, dtype="float32")
            one = _zoo_dp_step(slice(None))
            ctrl = _zoo_dp_step(slice(None), 2.0 ** -9)
            outs = {k: p.communicate(timeout=900) for k, p in procs.items()}
            side_s = time.perf_counter() - t0
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        report = result = None
        if procs["plan"].returncode == 0:
            with open(plan_out) as f:
                report = json.load(f)
        if procs["nccl"].returncode == 0:
            with open(zoo_out) as f:
                result = json.load(f)
            ckpt = os.path.exists(os.path.join(result["run_dir"], "ckpt", "step_2.pt"))
    torch.cuda.empty_cache()

    def masks_equal(a: dict, b: dict, c: dict) -> bool:
        return a["nrc"] == b["nrc"] == c["nrc"] and all(
            torch.equal(x, y) and torch.equal(x, z)
            for x, y, z in zip(a["masks"], b["masks"], c["masks"]))

    r32 = ranks[0]["fp32"]
    masks32 = masks_equal(r32, ranks[1]["fp32"], one32)
    loss32 = {k: (abs(r32["losses"][k] - v) / max(abs(v), 1e-30),
                  (3 * abs(ctrl32["losses"][k] - v) + 1e-4 * abs(v)) / max(abs(v), 1e-30))
              for k, v in one32["losses"].items()}
    ratio32 = {}
    for k, g in one32["grads"].items():
        ratio32[k] = float((r32["grads"][k] - g).norm()) / (
            3 * float((ctrl32["grads"][k] - g).norm()) + 1e-4 * float(g.norm()) + 1e-12)
    worst32 = sorted(ratio32.items(), key=lambda kv: -kv[1])[:3]
    sw32 = {k: round(ratio32[k], 3) for k in one32["sw"]}
    print(f"zoo data parallel fp32 (TF32 off, deterministic), damped fixture: DeepR50V3PlusD wt "
          f"{''.join(ZOO_DP_WT)}, DSN, {DP_WORLD} ranks x {local32} against one process x "
          f"{ZOO_DP_FP32_N}, {CROP}x{CROP}: masks bit-equal across ranks and to one process's: "
          f"{masks32}; losses (rel, bound) "
          f"{ {k: (float(f'{e:.3e}'), float(f'{b:.3e}')) for k, (e, b) in loss32.items()} }; "
          f"gradients of {len(ratio32)} tensors (ranks {len(r32['grads'])}), worst error / "
          f"bound (3x the 1e-7-input control + 1e-4) "
          f"{[(k, round(v, 3)) for k, v in worst32]}, median "
          f"{statistics.median(ratio32.values()):.3f}; SwitchWhiten's {len(sw32)} "
          f"parameters {sw32}")
    if not masks32 or set(r32["grads"]) != set(one32["grads"]) or not sw32 \
            or any(not math.isfinite(e) or e > b for e, b in loss32.values()) \
            or worst32[0][1] > 1:
        raise AssertionError(f"zoo data parallel fp32: masks equal {masks32}; losses {loss32}; "
                             f"gradients over their bounds "
                             f"{[kv for kv in worst32 if kv[1] > 1]}; SwitchWhiten {sw32}")

    masks_bf16 = masks_equal(ranks[0], ranks[1], one)
    same = [k for k, v in ranks[0]["after"].items() if not torch.equal(v, ranks[1]["after"][k])]
    if any(not torch.equal(v, ctrl["before"][k]) for k, v in one["before"].items()):
        raise AssertionError("zoo data parallel: the control started from another state")
    loss, one_loss = ranks[0]["losses"]["loss"], one["losses"]["loss"]
    loss_err = abs(loss - one_loss) / abs(one_loss)
    loss_ctrl = abs(ctrl["losses"]["loss"] - one_loss) / abs(one_loss)

    def moved(res: dict, k: str) -> torch.Tensor:
        return res["after"][k].double() - one["before"][k].double()

    err, control = {}, {}
    for k in one["after"]:
        if "running" in k and moved(one, k).norm() > 0:
            err[k] = _rel(moved(ranks[0], k), moved(one, k))
            control[k] = _rel(moved(ctrl, k), moved(one, k))
    over = {k: (v, control[k]) for k, v in err.items() if v > 3 * control[k] + 2e-2}
    # SwitchWhiten's running mean is (g, c, 1), BatchNorm's (C,)
    sw = [k for k in err if "running_cov" in k or one["after"][k].dim() == 3]
    log = [Collective(**{**c, "shape": tuple(c["shape"])}) for c in ranks[0]["collectives"]]
    rollup, by_dtype = summarize(log), summarize_by_dtype(log)
    largest = max(c.bytes for c in log)
    launched = {k: sum(r["launched"][k] for r in ranks) for k in ranks[0]["launched"]}
    ms = [statistics.median(r["ms"]) for r in ranks]
    print(f"zoo data parallel bf16: DeepR50V3PlusD wt {''.join(ZOO_DP_WT)} (ISW slots 2-3, "
          f"SwitchWhiten slot 4), DSN, {DP_WORLD} ranks x {local} images on one card over "
          f"gloo, {CROP}x{CROP}, against one process x {ZOO_DP_N}: masks (dim, nrc) "
          f"{[(m.shape[0], n) for m, n in zip(one['masks'], one['nrc'])]} bit-equal across "
          f"ranks and to one process's pass at batch {local}: {masks_bf16}; losses "
          f"{ {k: round(v, 6) for k, v in ranks[0]['losses'].items()} } vs "
          f"{ {k: round(v, 6) for k, v in one['losses'].items()} }, loss rel {loss_err:.3e} "
          f"(bound 2^-9 = {2.0 ** -9:.3e}; control, the input moved half a bf16 ulp: "
          f"{loss_ctrl:.3e}); running-statistic moves off the one-process moves, {len(err)} "
          f"tensors ({len(sw)} SwitchWhiten): median "
          f"{statistics.median(err.values()):.3e} (control "
          f"{statistics.median(control.values()):.3e}), max {max(err.values()):.3e} "
          f"(control {max(control.values()):.3e}), SwitchWhiten "
          f"{ {k: (float(f'{err[k]:.3e}'), float(f'{control[k]:.3e}')) for k in sw} }; "
          f"ranks identical: {not same}; launches (both ranks) {launched}; step on the ranks "
          f"(gloo through the host, beside cli.plan and cli.train_zoo: a correctness run, "
          f"not a speed) median {[round(m, 3) for m in ms]} ms, peak "
          f"{max(r['peak_gib'] for r in ranks):.2f} GiB a rank; {seconds:.1f} s for the ranks "
          f"end to end")
    dtypes = {op: {dt: (v["count"], v["bytes"]) for dt, v in d.items()}
              for op, d in by_dtype.items()}
    print(f"zoo data parallel collectives a rank a step (parallel/audit.py): "
          f"{ {op: (v['count'], round(v['bytes'] / 1e6, 3)) for op, v in rollup.items()} } "
          f"(count, MB); by dtype (count, bytes) {dtypes}; the largest {largest / 1e6:.1f} MB, "
          f"the others {(sum(c.bytes for c in log) - largest) / 1e6:.3f} MB")
    if not masks_bf16:
        raise AssertionError("zoo data parallel: the masks differ across ranks or from one "
                             "process's pass at the ranks' batch")
    if same:
        raise AssertionError(f"zoo data parallel: ranks differ at {same}")
    if not math.isfinite(loss) or loss_err > 2.0 ** -9:
        raise AssertionError(f"zoo data parallel: loss {loss} against one process's {one_loss}")
    if over or not sw:
        raise AssertionError(f"zoo data parallel: running-statistic moves off the one-process "
                             f"step's beyond 3x the control's + 2e-2: {over} (SwitchWhiten "
                             f"keys {sw})")
    # the zoo has no OC branch: no nearest backward (the DSN labels take none)
    if min(launched[k] for k in ("resize_bilinear", "resize_bilinear_bwd",
                                 "resize_nearest")) <= 0:
        raise AssertionError(f"zoo data parallel: a resize kernel was not launched: {launched}")
    for res in ranks + [one, one32]:
        _all_held([(c[0], getattr(torch, c[1])) + tuple(c[2:]) for c in res["calls"]],
                  "zoo data parallel: a step")

    if report is None:
        raise AssertionError(f"cli.plan: rc {procs['plan'].returncode}: "
                             f"{outs['plan'][0][-3000:]} {outs['plan'][1][-3000:]}")
    print("\n".join(line for line in outs["plan"][0].splitlines() if not line.startswith("{")))
    print(f"cli.plan MRFP+ R50-D16, global batch {TRAIN_N} on {DP_WORLD} ranks, bf16: "
          f"{json.dumps(report)}")
    ar = report["collectives_per_step"].get("all-reduce", {})
    got = (ar.get("count"), sum(v["bytes"] for v in
                                report["collectives_by_dtype"].get("all-reduce", {}).values()))
    want = tuple(dp_bill or DP_BILL)
    print(f"cli.plan all-reduce bill (calls, bytes): {got}; phase_data_parallel's count "
          f"{'in this run' if dp_bill else 'recorded (the phase did not run)'}: {want}")
    if sorted(report["collectives_per_step"]) != ["all-reduce"] or got != want:
        raise AssertionError(f"cli.plan: all-reduce bill {got} against the hand count {want}")

    nccl = "(nccl, tcp://127.0.0.1:" in outs["nccl"][1]
    print(f"cli.train_zoo DeepR50V3PlusD wt {''.join(ZOO_DP_WT)} --num-processes 1 "
          f"--process-id 0 --coordinator-address 127.0.0.1 (nccl: {nccl}): rc "
          f"{procs['nccl'].returncode}, losses {result and result['losses']}, covstat masks "
          f"{result and result['covstat']['masks']}, checkpoint {result and ckpt}; "
          f"{side_s:.1f} s for cli.plan and cli.train_zoo end to end, beside the ranks")
    if result is None or not nccl or result["step"] != 2 or not ckpt \
            or not all(math.isfinite(v) for v in result["losses"].values()):
        raise AssertionError(f"cli.train_zoo on NCCL: rc {procs['nccl'].returncode}, result "
                             f"{result}, stderr {outs['nccl'][1][-3000:]}")
    return launched


# the spatial phase of the zoo and the extras: SP_WORLD ranks on the one card.
# The zoo leg is phase_zoo_data_parallel's recipe (_zoo_dp_setup) on bands:
# fp32 on the damped fixture at SPZ_FP32_N, bf16 at TRAIN_N; the extras leg
# the MRFP+ R50-D16 bf16 step at TRAIN_N with --jointwtborder, phot and
# fuse_bn_stats (_spx_cfg); the eval leg SPZ_EVAL_ARCH at H x W
SPZ_FP32_N = 4
SPZ_EVAL_ARCH = "DeepSEResNext50V3PlusD"
DOT_CHECKED = set()


def _dot_key(dtype, x_shape, w_shape) -> tuple:
    return ("dot_with_stats", _dtype_name(dtype), tuple(x_shape), tuple(w_shape))


@contextlib.contextmanager
def _dot_recording():
    """Yields a list that collects the ``_dot_key`` of every
    ``dot_with_stats`` kernel call made inside the block."""
    from mrfp_tpu_torch.ops import cuda_dot_stats
    calls, fn = [], cuda_dot_stats.dot_with_stats_cuda

    def spy(x, w):
        calls.append(_dot_key(x.dtype, x.shape, w.shape))
        return fn(x, w)

    cuda_dot_stats.dot_with_stats_cuda = spy
    try:
        yield calls
    finally:
        cuda_dot_stats.dot_with_stats_cuda = fn


def _hold_band_dots(calls, cuda_gen, sp: int = SP_WORLD) -> int:
    """Holds ``dot_with_stats`` at every band shape that ``sp`` ranks give
    the whole-map calls ``calls`` (``_dot_recording``'s keys: a band of the
    product's rows, the fetched rows of a strided 1x1 sliced to them), in
    bf16 and fp32, against the plain version within ``_dot_stats_check``'s
    bounds. Returns the band shapes held."""
    from mrfp_tpu_torch.parallel.dist import band
    shapes = set()
    for _kind, _dt, (n, cin, oh, ow), (cout, _cin) in set(calls):
        for r in range(sp):
            o0, o1 = band(oh, sp, r)
            shapes.add((n, cin, o1 - o0, ow, cout))
    worst = 0.0
    with _strict_fp32():
        for n, cin, rows, ow, cout in sorted(shapes):
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn((n, cin, rows, ow), device=DEV, generator=cuda_gen).to(dtype)
                w = (torch.randn((cout, cin), device=DEV, generator=cuda_gen)
                     * cin ** -0.5).to(dtype)
                worst = max(worst, _dot_stats_check(f"band ({rows} rows)", x, w)[1])
                DOT_CHECKED.add(_dot_key(dtype, x.shape, w.shape))
    del x, w
    torch.cuda.empty_cache()
    print(f"dot_with_stats at the {len(shapes)} band shapes of {sp} ranks (the fused step's "
          f"{len(set(calls))} shapes, strided 1x1s on their fetched rows), bf16 and fp32: "
          f"within the bounds, y max_abs_err {worst:.3e}")
    return len(shapes)


def _hold_band_hist(cuda_gen, sp: int = SP_WORLD) -> None:
    """The confusion matrix at the eval leg's bands of H x W (one image,
    19 classes, 10% ignore labels): the kernel exactly equal to the plain
    version."""
    from mrfp_tpu_torch.ops import cuda_hist
    from mrfp_tpu_torch.parallel.dist import band
    for r in range(sp):
        lo, hi = band(H, sp, r)
        pred = torch.randint(0, 19, (1, hi - lo, W), device=DEV, generator=cuda_gen)
        label = torch.randint(0, 19, (1, hi - lo, W), device=DEV, generator=cuda_gen)
        label[torch.rand(label.shape, device=DEV, generator=cuda_gen) < 0.1] = 255
        got = cuda_hist.confusion_matrix_cuda(torch.zeros(19, 19, dtype=torch.int32, device=DEV),
                                              pred, label, 19)
        if not torch.equal(got, cuda_hist.confusion_matrix_plain(pred, label, 19)):
            raise AssertionError(f"confusion_matrix band {r} of {sp} (1,{hi - lo},{W}): "
                                 f"kernel != plain")
    print(f"confusion_matrix at the {sp} bands of 1x{H}x{W}: exactly equal to plain")


def _spz_fp64_grads(masks, nrc) -> dict:
    """The gradients of the one-process fp32 step ``_zoo_dp_step(...,
    SPZ_FP32_N, "float32")`` taken in fp64 (the model, the images, the
    losses, with the fp32 pass's masks; the resizes' plain versions
    interpolate in fp32), on the host in fp32: the reference of the fp32
    rule's fallback, as ``_sp_fp64_grads`` is the MRFP leg's."""
    from mrfp_tpu_torch.train.zoo_step import zoo_train_step
    cfg, state, _pairs, img, lbl = _zoo_dp_setup(SPZ_FP32_N, "float32")
    state.model.double()
    zoo_train_step(state, img.double(), lbl, cfg, [m.to(DEV) for m in masks], nrc,
                   impl="plain")
    return {k: p.grad.float().to("cpu") for k, p in state.model.named_parameters()}


def _spx_cfg():
    """The extras leg: the bf16 MRFP+ recipe at TRAIN_N with the border-relaxed
    CE (window 1), the PHOT transform and the fused BN statistics."""
    cfg = _train_cfg(TRAIN_N, "bfloat16")
    return cfg.replace(
        data=dataclasses.replace(cfg.data, jointwtborder=True, freq_transform="phot"),
        train=dataclasses.replace(cfg.train, fuse_bn_stats=True))


def _spz_eval(mesh=None):
    """``SPZ_EVAL_ARCH`` with ``cli.eval``'s seeded weights, fp32 (TF32 off,
    cuDNN deterministic): ``SegEvaluator`` over one synthetic H x W image, on
    the whole image or this rank's bands; every resize call recorded and the
    run's launches counted: ``(hist, calls, launches)``."""
    from mrfp_tpu_torch.cli import eval as cli_eval
    from mrfp_tpu_torch.data import SyntheticDataset
    from mrfp_tpu_torch.ops import LAUNCHES, reset_launches
    from mrfp_tpu_torch.train.evaluator import SegEvaluator
    model = cli_eval.build_model(cli_eval.parse_args(["--arch", SPZ_EVAL_ARCH]),
                                 torch.Generator().manual_seed(0)).to(DEV).eval()
    with _strict_fp32(), _recording() as calls:
        torch.cuda.synchronize()
        reset_launches()
        res = SegEvaluator(model, device=DEV, mesh=mesh).run(
            SyntheticDataset(length=1, hw=(H, W)), log=lambda *a, **k: None)
        launched = dict(LAUNCHES)
    return (torch.as_tensor(res["hist"]),
            [(c[0], _dtype_name(c[1])) + tuple(c[2:]) for c in calls], launched)


def _spx_counted(fn):
    """``fn()``'s result with the launches, the ``dot_with_stats`` calls and
    the peak GiB above what was held before it (its set-up included) of
    the run."""
    from mrfp_tpu_torch.ops import LAUNCHES, reset_launches
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with _dot_recording() as dots:
        out = fn()
    torch.cuda.synchronize()
    return out, {"launched": dict(LAUNCHES), "dots": dots,
                 "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30}


def spx_rank(rank: int, world: int, rendezvous: str, out: str) -> None:
    """One rank of ``phase_spatial_zoo_extras`` (its own process): joins the
    gloo group, lays out one spatial group, takes the fp32 and the bf16 zoo
    steps (and one timed bf16 step), the bf16 extras step and the eval
    leg's evaluator on its bands, and writes what it saw to
    ``out/rank<rank>.pt``."""
    from mrfp_tpu_torch.core.config import MeshConfig
    from mrfp_tpu_torch.core.mesh import create_mesh
    from mrfp_tpu_torch.parallel import dist
    from mrfp_tpu_torch.parallel.audit import Collective, count_collectives, summarize_by_group
    dist.initialize_distributed(rendezvous, world, rank, DEV, backend="gloo", timeout_s=600)
    try:
        mesh = create_mesh(MeshConfig(data_parallel=1, spatial_parallel=world))
        with _strict_fp32():
            z32 = _zoo_dp_step(slice(None), batch=SPZ_FP32_N, dtype="float32", mesh=mesh)
        zoo, zoo_run = _spx_counted(lambda: _zoo_dp_step(slice(None), steps=1, mesh=mesh))
        zoo_run["collectives"] = summarize_by_group(
            [Collective(**{**c, "shape": tuple(c["shape"])}) for c in zoo["collectives"]])
        with count_collectives() as log:
            (_, loss, after, _, calls), extras_run = _spx_counted(
                lambda: _sp_step(TRAIN_N, "bfloat16", mesh, cfg=_spx_cfg()))
        extras_run["collectives"] = summarize_by_group(log)
        hist, eval_calls, eval_launched = _spz_eval(mesh)
        launched = {k: zoo["launched"][k] + extras_run["launched"][k] + eval_launched[k]
                    for k in zoo["launched"]}
        torch.save({"z32": {k: z32[k] for k in ("losses", "grads", "masks", "nrc")},
                    "zoo": {**{k: zoo[k] for k in ("losses", "after", "masks", "nrc", "ms")},
                            **zoo_run},
                    "extras": {"loss": loss, "after": after, **extras_run},
                    "hist": hist, "launched": launched,
                    "calls": z32["calls"] + zoo["calls"] + eval_calls
                    + [(c[0], _dtype_name(c[1])) + tuple(c[2:]) for c in calls]},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def phase_spatial_zoo_extras(cuda_gen) -> dict:
    """Spatial parallelism for the zoo and the training extras on the one
    card: ``SP_WORLD`` ranks, each a process of its own (``spx_rank``),
    share the card through gloo and split every image's rows.

    One process first takes the same runs on whole images, recording every
    resize and ``dot_with_stats`` call; every band table and band shape the
    ranks will make of them is held against the plain versions
    (``_hold_band_resizes``, ``_hold_band_dots``, ``_hold_band_hist``), and
    every resize call of the ranks must be at a held band, every
    ``dot_with_stats`` call at a held shape.

    - Zoo leg (``_zoo_dp_setup``: DeepR50V3PlusD, ISW slots 2-3,
      SwitchWhiten slot 4, the whitening loss, the DSN head, 768x768): the
      statistics pass's masks on the ranks' bands equal one process's; fp32
      on the damped fixture at batch ``SPZ_FP32_N``: each loss within 1e-5
      relative of one process's, every gradient within 3x a 1e-7-input
      control + 1e-4 of its norm, or no further from the step in fp64
      (``_spz_fp64_grads``) than 3x one process's distance + 1e-4; bf16 at
      batch ``TRAIN_N``: the loss within 2^-9 or 3x the half-ulp-input
      control, the ranks bit-identical, each running statistic's move
      within 3x the control + 2e-2. Each rank's peak GiB above its set-up
      beside one process's, its collectives a step by group (halo rows
      apart from statistics) and its step ms (gloo through the host: a
      correctness time).
    - Extras leg (``_spx_cfg``): the bf16 MRFP+ step with the relaxed CE,
      PHOT and the fused BN statistics: the loss within 2^-9 or 3x the
      control, the ranks bit-identical, the statistics' moves within 3x
      the control + 1e-2 and the parameters' within 3x + 2e-2
      (``phase_spatial_parallel``'s rules).
    - Eval leg: ``SegEvaluator`` over one H x W image of ``SPZ_EVAL_ARCH``
      (its ceil-mode stem pool and SE pools on bands) against one process:
      the histograms equal or apart in at most 0.01% of the pixels (argmax
      ties); then ``cli.eval --arch SPZ_EVAL_ARCH --spatial-parallel 2``
      against ``cli.eval``: the pixels equal and the accuracy within 1e-4.

    Returns the ranks' summed launches of the zoo and extras steps and the
    evaluator."""
    t0 = time.perf_counter()
    with _strict_fp32(), _resizes_run() as fp32_resizes:
        one32 = _zoo_dp_step(slice(None), batch=SPZ_FP32_N, dtype="float32")
        ctrl32 = _zoo_dp_step(slice(None), 1e-7, batch=SPZ_FP32_N, dtype="float32")
    with _resizes_run() as bf16_resizes:
        zoo, zoo_run = _spx_counted(lambda: _zoo_dp_step(slice(None), steps=1))
    zoo_ctrl = _zoo_dp_step(slice(None), 2.0 ** -9)
    with _resizes_run() as extras_resizes:
        (x_before, x_loss, x_after, _, _), extras_run = _spx_counted(
            lambda: _sp_step(TRAIN_N, "bfloat16", cfg=_spx_cfg()))
    _, x_ctrl_loss, x_ctrl_after, _, _ = _sp_step(TRAIN_N, "bfloat16", noise=2.0 ** -9,
                                                  cfg=_spx_cfg())
    torch.cuda.empty_cache()
    with _resizes_run() as eval_resizes:
        one_hist, _, _ = _spz_eval()
    torch.cuda.empty_cache()
    held = (_hold_band_resizes(fp32_resizes | bf16_resizes | extras_resizes, True, cuda_gen)
            + _hold_band_resizes(eval_resizes, False, cuda_gen))
    dot_shapes = _hold_band_dots(extras_run["dots"], cuda_gen)
    _hold_band_hist(cuda_gen)
    torch.cuda.empty_cache()
    print(f"spatial zoo and extras: {held} band resize calls of {SP_WORLD} ranks held against "
          f"the plain versions ({len(fp32_resizes | bf16_resizes)} zoo resizes fp32 and bf16, "
          f"{len(extras_resizes)} extras resizes, forward exactly equal, backward within the "
          f"bound; {len(eval_resizes)} eval resizes, forward exactly equal), {dot_shapes} "
          f"dot_with_stats band shapes; one process's runs {time.perf_counter() - t0:.1f} s")

    arch = ["--arch", SPZ_EVAL_ARCH]
    with _cli_evals(arch, arch + ["--spatial-parallel", "2"]) as evals:  # beside the ranks
        ranks, seconds = _run_ranks("spx_rank")
    for r in ranks:
        _all_held([(c[0], getattr(torch, c[1])) + tuple(c[2:]) for c in r["calls"]],
                  "spatial zoo and extras: a rank's runs")
        missing = sorted(set(map(tuple, r["extras"]["dots"])) - DOT_CHECKED, key=str)
        if missing:
            raise AssertionError(f"spatial extras: dot_with_stats ran at shapes no phase held: "
                                 f"{missing}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()

    # the zoo leg, fp32
    r32 = ranks[0]["z32"]
    masks_ok = all(r["z32"]["nrc"] == one32["nrc"] and r["zoo"]["nrc"] == zoo["nrc"]
                   and all(torch.equal(a, b) for a, b in zip(r["z32"]["masks"], one32["masks"]))
                   and all(torch.equal(a, b) for a, b in zip(r["zoo"]["masks"], zoo["masks"]))
                   for r in ranks)
    loss32 = {k: abs(r32["losses"][k] - v) / max(abs(v), 1e-30)
              for k, v in one32["losses"].items()}
    ratio32, grounded, ref64 = {}, [], None
    for k, g in one32["grads"].items():
        got = r32["grads"][k]
        ratio32[k] = float((got - g).norm()) / (3 * float((ctrl32["grads"][k] - g).norm())
                                                + 1e-4 * float(g.norm()) + 1e-12)
        if ratio32[k] > 1:  # the fp64-grounded rule, its step taken where needed
            if ref64 is None:
                with _strict_fp32():
                    ref64 = _spz_fp64_grads(one32["masks"], one32["nrc"])
            ref = ref64[k].double()
            ratio32[k] = float((got.double() - ref).norm()) / (
                3 * float((g.double() - ref).norm()) + 1e-4 * float(ref.norm()) + 1e-12)
            grounded.append((k, round(ratio32[k], 3)))
    worst32 = sorted(ratio32.items(), key=lambda kv: -kv[1])[:3]
    print(f"spatial zoo fp32 (TF32 off, deterministic), damped fixture: DeepR50V3PlusD wt "
          f"{''.join(ZOO_DP_WT)}, DSN, {SP_WORLD} ranks x a band of {SPZ_FP32_N} images "
          f"against one process, {CROP}x{CROP}: masks (fp32 and bf16 passes) equal to one "
          f"process's: {masks_ok}; losses rel {({k: float(f'{v:.3e}') for k, v in loss32.items()})}"
          f"; gradients of {len(ratio32)} tensors, worst error / bound "
          f"{[(k, round(v, 3)) for k, v in worst32]}, median "
          f"{statistics.median(ratio32.values()):.3f}; held to the fp64 step instead (over 3x "
          f"the control): {len(grounded)} {grounded[:8]}")

    def moved(res: dict, base: dict, k: str) -> torch.Tensor:
        return res[k].double() - base[k].double()

    def bf16_moves(two: dict, one: dict, ctrl: dict, base: dict, stats_bound: float,
                   param_bound: float):
        err, control = {}, {}
        for k, v in one.items():
            if v.is_floating_point() and moved(one, base, k).norm() > 0:
                err[k] = _rel(moved(two, base, k), moved(one, base, k))
                control[k] = _rel(moved(ctrl, base, k), moved(one, base, k))
        over = {k: (v, control[k]) for k, v in err.items()
                if v > 3 * control[k] + (stats_bound if "running" in k else param_bound)}
        return err, control, over

    # the zoo leg, bf16
    zr = [r["zoo"] for r in ranks]
    same_zoo = [k for k, v in zr[0]["after"].items() if not torch.equal(v, zr[1]["after"][k])]
    zloss, zone = zr[0]["losses"]["loss"], zoo["losses"]["loss"]
    zloss_err = abs(zloss - zone) / abs(zone)
    zloss_ctrl = abs(zoo_ctrl["losses"]["loss"] - zone) / abs(zone)
    zerr, zcontrol, zover = bf16_moves(zr[0]["after"], zoo["after"], zoo_ctrl["after"],
                                       zoo["before"], 2e-2, float("inf"))
    zstats = [k for k in zerr if "running" in k]
    print(f"spatial zoo bf16: {SP_WORLD} ranks x a band of {TRAIN_N} images over gloo, "
          f"{CROP}x{CROP}, against one process: losses "
          f"{ {k: round(v, 6) for k, v in zr[0]['losses'].items()} } vs "
          f"{ {k: round(v, 6) for k, v in zoo['losses'].items()} }, loss rel {zloss_err:.3e} "
          f"(bound {max(2.0 ** -9, 3 * zloss_ctrl):.3e}); running-statistic moves off one "
          f"process's, {len(zstats)} tensors: median "
          f"{statistics.median(zerr[k] for k in zstats):.3e} (control "
          f"{statistics.median(zcontrol[k] for k in zstats):.3e}); ranks identical: "
          f"{not same_zoo}")
    for r, res in enumerate(zr):
        print(f"spatial zoo rank {r}: peak {res['peak_gib']:.3f} GiB above what it held "
              f"before the step's set-up (one process {zoo_run['peak_gib']:.3f} GiB); "
              f"collectives a bf16 step {json.dumps(res['collectives'], sort_keys=True)}; "
              f"a timed step {res['ms'][0]:.1f} ms (one process {zoo['ms'][0]:.1f} ms; gloo "
              f"through the host: a correctness time); card {card}")

    # the extras leg
    xr = [r["extras"] for r in ranks]
    same_x = [k for k, v in xr[0]["after"].items() if not torch.equal(v, xr[1]["after"][k])]
    xloss_err = abs(xr[0]["loss"] - x_loss) / abs(x_loss)
    xloss_ctrl = abs(x_ctrl_loss - x_loss) / abs(x_loss)
    xerr, xcontrol, xover = bf16_moves(xr[0]["after"], x_after, x_ctrl_after, x_before, 1e-2,
                                       2e-2)
    xstats = [k for k in xerr if "running" in k]
    print(f"spatial extras bf16 (relaxed CE, PHOT, fused BN statistics; all gates on): "
          f"{SP_WORLD} ranks x a band of {TRAIN_N} images against one process: loss "
          f"{xr[0]['loss']:.6f} vs {x_loss:.6f}, rel {xloss_err:.3e} (bound "
          f"{max(2.0 ** -9, 3 * xloss_ctrl):.3e}); BN statistics' moves median "
          f"{statistics.median(xerr[k] for k in xstats):.3e} (control "
          f"{statistics.median(xcontrol[k] for k in xstats):.3e}); ranks identical: "
          f"{not same_x}")
    for r, res in enumerate(xr):
        print(f"spatial extras rank {r}: peak {res['peak_gib']:.3f} GiB above what it held "
              f"before the step's set-up (one process {extras_run['peak_gib']:.3f} GiB); "
              f"collectives a step {json.dumps(res['collectives'], sort_keys=True)}; "
              f"dot_with_stats calls {len(res['dots'])}; card {card}")

    # the eval leg
    hist_moved = [int((r["hist"].long() - one_hist.long()).abs().sum()) // 2 for r in ranks]
    pixels = int(one_hist.sum())
    one_eval, two_eval = evals
    launched = {k: sum(r["launched"][k] for r in ranks) for k in ranks[0]["launched"]}
    print(f"spatial zoo eval fp32 {SPZ_EVAL_ARCH} 1x3x{H}x{W}: SegEvaluator pixels moved "
          f"{hist_moved} of {pixels}; cli.eval --spatial-parallel 2 {two_eval} vs cli.eval "
          f"{one_eval}; launches (both ranks: the zoo and extras steps and the evaluator) "
          f"{launched}; {seconds:.1f} s for the ranks end to end")

    if not masks_ok:
        raise AssertionError("spatial zoo: the statistics pass's masks differ from one "
                             "process's")
    if any(not math.isfinite(v) or v > 1e-5 for v in loss32.values()) or worst32[0][1] > 1:
        raise AssertionError(f"spatial zoo fp32: losses rel {loss32}, gradients over their "
                             f"bounds {[kv for kv in worst32 if kv[1] > 1]}")
    if same_zoo or same_x:
        raise AssertionError(f"spatial zoo and extras: ranks differ at {same_zoo + same_x}")
    if not math.isfinite(zloss) or zloss_err > max(2.0 ** -9, 3 * zloss_ctrl):
        raise AssertionError(f"spatial zoo bf16: loss {zloss} against one process's {zone}")
    if not math.isfinite(xr[0]["loss"]) or xloss_err > max(2.0 ** -9, 3 * xloss_ctrl):
        raise AssertionError(f"spatial extras bf16: loss {xr[0]['loss']} against one "
                             f"process's {x_loss}")
    if zover or xover:
        raise AssertionError(f"spatial zoo and extras: moves off one process's beyond the "
                             f"bounds: zoo {zover}, extras {xover}")
    if not all(res["collectives"].get("spatial", {}).get("halo", {}).get("count", 0) > 0
               and res["collectives"]["spatial"].get("stats", {}).get("count", 0) > 0
               for res in zr + xr):
        raise AssertionError("spatial zoo and extras: a rank fetched no halo rows or combined "
                             "no band statistics")
    if max(hist_moved) > 1e-4 * pixels:
        raise AssertionError(f"spatial zoo eval: {hist_moved} of {pixels} pixels moved")
    if two_eval["pixels"] != one_eval["pixels"] or \
            not abs(two_eval["acc"] - one_eval["acc"]) <= 1e-4:
        raise AssertionError(f"cli.eval --arch {SPZ_EVAL_ARCH} --spatial-parallel 2: "
                             f"{two_eval} against {one_eval}")
    if min(launched[k] for k in MRFP_TRAIN_KERNELS + ("resize_nearest", "confusion_matrix",
                                                      "dot_with_stats")) <= 0:
        raise AssertionError(f"spatial zoo and extras: a kernel was not launched: {launched}")
    return launched


# the tensor-parallel phase: MP_WORLD ranks on one model group, all on the
# one card; the fp32 comparison's batch, the bf16 recipe's and the fused
# leg's (every rank holds every sample; the fused leg only has to put
# dot_with_stats on a rank's shapes, so it takes the smaller batch: each
# sample costs the ranks about 1.5 GB of gathers through the host)
MP_WORLD = 2
MP_FP32_N, MP_N, MP_FUSED_N = 2, 4, 2


def _hold_channel_resizes(resizes, backward: bool, cuda_gen, mp: int = MP_WORLD) -> int:
    """Holds each whole-map resize of ``resizes`` (``_resizes_run``'s
    records of one process's runs) at the channel counts a model rank
    gives it, ``c / mp`` (the sliced maps: the ASPP image pool's
    broadcast, the decoder's upsample and injection), and ``c`` (the
    replicated ones: the OC branch, the logits), against the plain
    versions on the card: the forward exactly equal, and with ``backward``
    the bilinear backward within ``_bilinear_bwd_close``'s bound and the
    nearest one exactly equal. Returns the calls held."""
    from mrfp_tpu_torch.ops import cuda_resize
    from mrfp_tpu_torch.ops.resize import bilinear_taps, nearest_table
    held = 0
    for kind, dtype, n, c, sy, sx in sorted(resizes, key=str):
        h, w = sy[1], sx[1]
        if kind == "bilinear":
            ty, tx = bilinear_taps(h, sy[2], DEV), bilinear_taps(w, sx[2], DEV)
            fwd, bwd = cuda_resize.resize_bilinear_cuda, cuda_resize.resize_bilinear_bwd_cuda
            fwd_p, bwd_p = cuda_resize.resize_bilinear_plain, cuda_resize.resize_bilinear_bwd_plain
        else:
            ty, tx = nearest_table(h, sy[2], sy[3], DEV), nearest_table(w, sx[2], sx[3], DEV)
            fwd, bwd = cuda_resize.resize_nearest_cuda, cuda_resize.resize_nearest_bwd_cuda
            fwd_p, bwd_p = cuda_resize.resize_nearest_plain, cuda_resize.resize_nearest_bwd_plain
        for ch in sorted({c, c // mp} if c % mp == 0 else {c}):
            x = torch.randn((n, ch, h, w), device=DEV, generator=cuda_gen).to(dtype)
            y = fwd(x, ty, tx)
            what = f"model rank: {kind} {_dtype_name(dtype)} ({n},{ch},{h},{w})->{tuple(y.shape)}"
            if not torch.equal(y, fwd_p(x, ty, tx)):
                raise AssertionError(f"{what}: the forward is not the plain version's")
            _held(f"resize_{kind}", x, y)
            held += 1
            if backward:
                g = torch.randn(y.shape, device=DEV, generator=cuda_gen).to(dtype)
                gx = bwd(g, ty, tx, h, w)
                if kind == "bilinear":
                    _bilinear_bwd_close(gx, g, ty, tx, h, w, what)
                elif not torch.equal(gx, bwd_p(g, ty, tx, h, w)):
                    raise AssertionError(f"{what}: the backward is not the plain version's")
                _held(f"resize_{kind}_bwd", g, gx)
                held += 1
    torch.cuda.synchronize()
    return held


def _hold_rank_dots(calls, cuda_gen, mp: int = MP_WORLD) -> int:
    """Holds ``dot_with_stats`` at every shape a model rank gives the whole
    kernel's calls ``calls`` (``_dot_recording``'s keys): the same input,
    the kernel's rows ``Cout / mp``, in bf16 and fp32, against the plain
    version within ``_dot_stats_check``'s bounds. Returns the shapes
    held."""
    shapes = {(x_shape, (cout // mp, cin)) for _k, _dt, x_shape, (cout, cin) in set(calls)}
    worst = 0.0
    with _strict_fp32():
        for x_shape, w_shape in sorted(shapes):
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(x_shape, device=DEV, generator=cuda_gen).to(dtype)
                w = (torch.randn(w_shape, device=DEV, generator=cuda_gen)
                     * w_shape[1] ** -0.5).to(dtype)
                worst = max(worst, _dot_stats_check(f"model rank (Cout/{mp})", x, w)[1])
                DOT_CHECKED.add(_dot_key(dtype, x.shape, w.shape))
    del x, w
    torch.cuda.empty_cache()
    print(f"dot_with_stats at the {len(shapes)} model-rank shapes of {mp} ranks (the fused "
          f"step's {len(set(calls))} shapes, Cout / {mp} rows of each kernel), bf16 and fp32: "
          f"within the bounds, y max_abs_err {worst:.3e}")
    return len(shapes)


def _mp_step(batch: int, dtype: str, noise: float = 0.0, cfg=None) -> dict:
    """One step of ``_dp_setup(batch, dtype)`` (damped in fp32), with ``cfg``
    in place of its config where given, on the whole batch x (1 + ``noise``
    x N(0, 1)); under a model axis this process's shards of the state.
    Returns ``before``, ``loss``, ``after`` and ``grads`` (the state and
    gradients whole, the model group's shards gathered, on the host), the
    step's resize and ``dot_with_stats`` calls (``calls``, ``dots``), its
    collectives by group (``collectives``), its ms and the ``state``."""
    from mrfp_tpu_torch.core.mesh import current_mesh
    from mrfp_tpu_torch.parallel.audit import count_collectives, summarize_by_group
    from mrfp_tpu_torch.parallel.dist import gather_rows
    from mrfp_tpu_torch.train.step import train_step
    from mrfp_tpu_torch.weights import whole_state_dict
    setup_cfg, state, perturb, img, lbl = _dp_setup(batch, dtype, dtype == "float32")
    cfg = cfg or setup_cfg
    eps = torch.randn(img.shape, generator=torch.Generator().manual_seed(2)).to(img.device)
    img = (img.float() * (1 + noise * eps)).contiguous()
    mesh, model = current_mesh(), state.model
    keys = getattr(model, "tp_keys", frozenset())
    host = lambda d: {k: v.detach().to("cpu", copy=True) for k, v in d.items()}  # noqa: E731
    before = host(whole_state_dict(model, mesh))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _recording() as calls, _dot_recording() as dots, count_collectives() as log:
        loss = train_step(state, img, lbl.contiguous(), cfg, perturb=perturb)["loss"].item()
    ms = (time.perf_counter() - t0) * 1e3
    grads = host({k: gather_rows(p.grad, mesh.model) if k in keys else p.grad
                  for k, p in model.named_parameters()})
    return {"before": before, "loss": loss, "after": host(whole_state_dict(model, mesh)),
            "grads": grads, "calls": calls, "dots": dots,
            "collectives": summarize_by_group(log), "ms": ms, "state": state}


def _mp_fused_cfg():
    """The bf16 MRFP+ recipe at ``MP_FUSED_N`` with the fused BN statistics."""
    cfg = _train_cfg(MP_FUSED_N, "bfloat16")
    return cfg.replace(train=dataclasses.replace(cfg.train, fuse_bn_stats=True))


def _mp_eval_logits(model) -> tuple:
    """``model``'s fp32 eval forward (TF32 off, cuDNN deterministic) of the
    seeded 1x3xHxW image, on the host, and its resize calls."""
    x = (torch.rand((1, 3, H, W), generator=torch.Generator().manual_seed(21)) * 255).to(DEV)
    with _strict_fp32(), torch.inference_mode(), _recording() as calls:
        logits = model.eval()(x).to("cpu")
    return logits, calls


def _state_bytes(state) -> int:
    """The bytes this process holds of the parameters, their momentum and
    the BN statistics."""
    model = state.model
    return (nbytes(*model.parameters())
            + nbytes(*(s["momentum_buffer"] for s in state.optimizer.state.values()))
            + nbytes(*(b for k, b in model.named_buffers() if "running" in k)))


def mp_rank(rank: int, world: int, rendezvous: str, out: str) -> None:
    """One rank of ``phase_model_parallel`` (its own process): joins the gloo
    group, lays out one model group, and on its shards of the state takes
    the fp32 step, the counted and recorded bf16 step, whose whole state it
    checkpoints (``CheckpointManager``: every rank gathers, rank 0 writes)
    and evaluates, and the fused bf16 step; writes what it saw, and rank 0
    the checkpoint it wrote, to ``out/rank<rank>.pt``."""
    from mrfp_tpu_torch.core.config import MeshConfig
    from mrfp_tpu_torch.core.mesh import create_mesh
    from mrfp_tpu_torch.ops import LAUNCHES, reset_launches
    from mrfp_tpu_torch.parallel import dist
    from mrfp_tpu_torch.parallel.audit import count_collectives, summarize_by_group
    from mrfp_tpu_torch.train.checkpoint import CheckpointManager
    dist.initialize_distributed(rendezvous, world, rank, DEV, backend="gloo", timeout_s=900)
    try:
        create_mesh(MeshConfig(data_parallel=1, model_parallel=world))
        with _strict_fp32():
            fp32 = _mp_step(MP_FP32_N, "float32")
        del fp32["state"]
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        bf16 = _mp_step(MP_N, "bfloat16")
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        state = bf16.pop("state")
        state_bytes = _state_bytes(state)
        ckpt = CheckpointManager(os.path.join(out, "ckpt"), keep=1)
        ckpt.save(state)
        ckpt.close()
        blob = (torch.load(os.path.join(out, "ckpt", f"step_{state.step}.pt"),
                           weights_only=True) if rank == 0 else None)
        logits, eval_calls = _mp_eval_logits(state.model)
        del state
        torch.cuda.empty_cache()
        fused = _mp_step(MP_FUSED_N, "bfloat16", cfg=_mp_fused_cfg())
        del fused["state"]
        torch.cuda.synchronize()
        launched = dict(LAUNCHES)
        torch.save({"fp32_loss": fp32["loss"], "fp32_grads": fp32["grads"],
                    "loss": bf16["loss"], "state": bf16["after"],
                    "collectives": bf16["collectives"], "step_ms": bf16["ms"],
                    "peak_gib": peak, "state_bytes": state_bytes, "ckpt": blob,
                    "logits": logits, "fused_loss": fused["loss"], "dots": fused["dots"],
                    "launched": launched,
                    "calls": [(c[0], _dtype_name(c[1])) + c[2:] for c in fp32["calls"]
                              + bf16["calls"] + eval_calls + fused["calls"]]},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


@contextlib.contextmanager
def _plan_bill(batch: int):
    """``cli.plan --model-parallel 2``'s report of the MRFP+ R50-D16 bf16
    launch of global batch ``batch`` at 768x768 on one model group of
    ``MP_WORLD`` ranks (sharing the card through gloo), run in processes of
    its own while the block runs; yields a dict that holds the report once
    the block has ended."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "plan.json")
        cmd = [sys.executable, "-m", "mrfp_tpu_torch.cli.plan", "--device", DEV, "--trunk",
               "resnet-50", "--variant", "D16", "--batch-size", str(batch), "--crop-size",
               str(CROP), "--data-parallel", "1", "--model-parallel", str(MP_WORLD),
               "--json-out", out]
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        report = {}
        try:
            yield report
            log = proc.communicate(timeout=900)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode != 0:
            raise AssertionError(f"cli.plan --model-parallel {MP_WORLD}: rc {proc.returncode}: "
                                 f"{log[-3000:]}")
        report.update(json.load(open(out)))


def phase_model_parallel(cuda_gen) -> dict:
    """Tensor parallelism on the one card there is: ``MP_WORLD`` ranks, each
    a process of its own, share the card through gloo (as
    ``phase_spatial_parallel``'s) and split every conv's output channels,
    each holding its shards of the state (``weights.shard_model``) and
    gathering every conv's input map over the model group.

    One process first takes the same runs, recording every resize and
    ``dot_with_stats`` call; each is then held against its plain version
    at the shapes a model rank gives it (``_hold_channel_resizes``,
    ``_hold_rank_dots``), and every call of the ranks must be at a held
    shape.

    - fp32 (TF32 off, cuDNN deterministic), the damped fixture, batch
      ``MP_FP32_N`` at 768x768, all gates on: the loss within 1e-5
      relative of one process's; each gradient within 3x its own
      1e-7-input control distance + 1e-4 of its norm, or, where the control
      understates the rounding of every layer, no further from the same
      step in fp64 (``_sp_fp64_grads``) than 3x the one-process step's
      distance + 1e-4 of its norm.
    - bf16, the recipe at batch ``MP_N`` (its bill from ``cli.plan
      --model-parallel 2``): the ranks end bit-identical (the whole state
      gathered: every replicated tensor equal); the loss within 2^-9 or 3x
      the half-ulp-input control; each rank's state bytes and peak memory
      beside one process's; each rank's collectives by group and kind equal
      to ``cli.plan --model-parallel 2``'s bill, byte for byte.
    - The checkpoint of that step, written at M = 2, loads ``strict=True``
      into one process, its momentum whole, and its fp32 eval logits at
      1x3xHxW equal the ranks' sharded forward's within atol 2e-4, rtol
      1e-4 (the ranks' bit-equal).
    - The fused leg (``fuse_bn_stats``, bf16, batch ``MP_FUSED_N``):
      ``dot_with_stats`` on each rank's Cout / 2 rows, the loss within 2^-9
      or 3x the control of one process's fused step.

    Returns the ranks' summed kernel launches."""
    from mrfp_tpu_torch.models import MRFP, build_mrfp
    t0 = time.perf_counter()
    with _plan_bill(MP_N) as bill:  # cli.plan's processes run beside these runs and the ranks
        with _strict_fp32(), _resizes_run() as fp32_resizes:
            one32 = _mp_step(MP_FP32_N, "float32")
            ctrl32 = _mp_step(MP_FP32_N, "float32", 1e-7)
        one32_loss, ctrl32_loss = one32["loss"], ctrl32["loss"]
        one32, ctrl32 = one32["grads"], ctrl32["grads"]
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with _resizes_run() as bf16_resizes:
            run = _mp_step(MP_N, "bfloat16")
        torch.cuda.synchronize()
        one_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        one_bytes = _state_bytes(run["state"])
        before, one_loss, one = run["before"], run["loss"], run["after"]
        run = _mp_step(MP_N, "bfloat16", 2.0 ** -9)
        before_ctrl, ctrl_loss = run["before"], run["loss"]
        with _resizes_run() as fused_resizes:
            run = _mp_step(MP_FUSED_N, "bfloat16", cfg=_mp_fused_cfg())
        fused_loss, one_dots = run["loss"], run["dots"]
        fused_ctrl = _mp_step(MP_FUSED_N, "bfloat16", 2.0 ** -9, cfg=_mp_fused_cfg())["loss"]
        del run
        torch.cuda.empty_cache()
        with _resizes_run() as eval_resizes:
            _mp_eval_logits(build_mrfp(DEV, generator=torch.Generator().manual_seed(0),
                                       oc_branch=True))
        torch.cuda.empty_cache()
        train_resizes = fp32_resizes | bf16_resizes | fused_resizes
        held = (_hold_channel_resizes(train_resizes, True, cuda_gen)
                + _hold_channel_resizes(eval_resizes, False, cuda_gen))
        dot_shapes = _hold_rank_dots(one_dots, cuda_gen)
        print(f"model parallel: {held} resize calls at a model rank's channel counts held "
              f"against the plain versions ({len(train_resizes)} train resizes fp32 and bf16, "
              f"forward exactly equal, backward within the bound; {len(eval_resizes)} eval "
              f"resizes, forward exactly equal), {dot_shapes} dot_with_stats shapes; one "
              f"process's runs {time.perf_counter() - t0:.1f} s")
        ranks, seconds = _run_ranks("mp_rank")
    print(f"model parallel: cli.plan --model-parallel {MP_WORLD} beside the one-process runs "
          f"and the ranks, {time.perf_counter() - t0:.1f} s in all")
    for r in ranks:
        _all_held([(c[0], getattr(torch, c[1])) + tuple(c[2:]) for c in r["calls"]],
                  "model parallel: a rank's runs")
        missing = sorted(set(r["dots"]) - DOT_CHECKED)
        if missing:
            raise AssertionError(f"model parallel: dot_with_stats ran at shapes no phase held: "
                                 f"{missing}")
    fp32_loss_err = abs(ranks[0]["fp32_loss"] - one32_loss) / abs(one32_loss)
    fp32_ratio, grounded, ref64 = {}, [], None
    for k, g in one32.items():
        got = ranks[0]["fp32_grads"][k]
        fp32_ratio[k] = float((got - g).norm()) / (3 * float((ctrl32[k] - g).norm())
                                                   + 1e-4 * float(g.norm()) + 1e-12)
        if fp32_ratio[k] > 1:  # the fp64-grounded rule, its step taken where needed
            if ref64 is None:
                with _strict_fp32():
                    ref64 = _sp_fp64_grads(MP_FP32_N)
            ref = ref64[k].double()
            fp32_ratio[k] = float((got.double() - ref).norm()) / (
                3 * float((g.double() - ref).norm()) + 1e-4 * float(ref.norm()) + 1e-12)
            grounded.append((k, round(fp32_ratio[k], 3)))
    fp32_worst = sorted(fp32_ratio.items(), key=lambda kv: -kv[1])[:3]
    if any(not torch.equal(v, before_ctrl[k]) for k, v in before.items()):
        raise AssertionError("model parallel: the control started from another state")
    same = [k for k, v in ranks[0]["state"].items() if not torch.equal(v, ranks[1]["state"][k])]
    loss = ranks[0]["loss"]
    loss_err = abs(loss - one_loss) / abs(one_loss)
    loss_ctrl = abs(ctrl_loss - one_loss) / abs(one_loss)
    fused_err = abs(ranks[0]["fused_loss"] - fused_loss) / abs(fused_loss)
    fused_bound = max(2.0 ** -9, 3 * abs(fused_ctrl - fused_loss) / abs(fused_loss))
    counters = [k for k, v in one.items() if not v.is_floating_point()
                and not torch.equal(ranks[0]["state"][k], v)]
    launched = {k: sum(r["launched"][k] for r in ranks) for k in ranks[0]["launched"]}
    blob = ranks[0]["ckpt"]
    loaded = MRFP(oc_branch=True)
    loaded.load_state_dict(blob["model"], strict=True)
    params = [p for p in loaded.parameters() if p.requires_grad]
    momentum = blob["optimizer"]["state"]
    whole_momentum = len(momentum) == len(params) and all(
        momentum[i]["momentum_buffer"].shape == p.shape for i, p in enumerate(params))
    ckpt_logits, _ = _mp_eval_logits(loaded.to(DEV))
    del loaded
    torch.cuda.empty_cache()
    logit_err = (ranks[0]["logits"] - ckpt_logits).abs().max().item()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"model parallel fp32 (TF32 off, deterministic), damped fixture: {MP_WORLD} ranks "
          f"x half the channels of {MP_FP32_N} images against one process, {CROP}x{CROP}, "
          f"all gates on: loss {ranks[0]['fp32_loss']:.7f} vs {one32_loss:.7f} (rel "
          f"{fp32_loss_err:.3e}; 1e-7-input control "
          f"{abs(ctrl32_loss - one32_loss) / abs(one32_loss):.3e}); gradients of {len(one32)} "
          f"tensors, each to its own control, worst error / bound "
          f"{[(k, round(v, 3)) for k, v in fp32_worst]}, median "
          f"{statistics.median(fp32_ratio.values()):.3f}; held to the fp64 step instead "
          f"(over 3x the control): {len(grounded)} {grounded[:8]}")
    print(f"model parallel bf16: {MP_WORLD} ranks x half the channels of {MP_N} images over "
          f"gloo, {CROP}x{CROP}, all gates on, against one process: loss {loss:.6f} vs "
          f"{one_loss:.6f}, rel {loss_err:.3e} (bound {max(2.0 ** -9, 3 * loss_ctrl):.3e}); "
          f"ranks identical: {not same}; fused leg (dot_with_stats on Cout/{MP_WORLD} rows) "
          f"loss {ranks[0]['fused_loss']:.6f} vs {fused_loss:.6f}, rel {fused_err:.3e} "
          f"(bound {fused_bound:.3e})")
    for r, res in enumerate(ranks):
        print(f"model parallel rank {r}: state {res['state_bytes'] / 1e6:.3f} MB (one process "
              f"{one_bytes / 1e6:.3f} MB); peak {res['peak_gib']:.3f} GiB above its set-up (one "
              f"process {one_peak:.3f} GiB); collectives a bf16 step "
              f"{json.dumps(res['collectives'], sort_keys=True)}; counted step "
              f"{res['step_ms']:.1f} ms (gloo through the host: a correctness time); card "
              f"{card.strip()}")
    print(f"model parallel: cli.plan --model-parallel {MP_WORLD} bill "
          f"{json.dumps(bill['collectives_by_group'], sort_keys=True)}, state bytes a rank "
          f"{bill['per_chip_bytes']}; checkpoint at M = {MP_WORLD} loaded strict into one "
          f"process (momentum whole: {whole_momentum}), its fp32 eval logits 1x3x{H}x{W} vs "
          f"the ranks' max_abs_err {logit_err:.3e}; launches (both ranks) {launched}; "
          f"{seconds:.1f} s for the ranks end to end")
    if not math.isfinite(fp32_loss_err) or fp32_loss_err > 1e-5 or fp32_worst[0][1] > 1:
        raise AssertionError(f"model parallel fp32: loss rel {fp32_loss_err}, gradients over "
                             f"their bounds {[kv for kv in fp32_worst if kv[1] > 1]}")
    if same or counters:
        raise AssertionError(f"model parallel: ranks differ at {same}; counters differ from "
                             f"one process at {counters}")
    if not math.isfinite(loss) or loss_err > max(2.0 ** -9, 3 * loss_ctrl):
        raise AssertionError(f"model parallel: loss {loss} against one process's {one_loss}")
    if not math.isfinite(ranks[0]["fused_loss"]) or fused_err > fused_bound:
        raise AssertionError(f"model parallel fused: loss {ranks[0]['fused_loss']} against "
                             f"one process's {fused_loss}")
    if any(r["collectives"] != bill["collectives_by_group"] for r in ranks):
        raise AssertionError(f"model parallel: the ranks' collectives "
                             f"{[r['collectives'] for r in ranks]} are not cli.plan's bill "
                             f"{bill['collectives_by_group']}")
    if not whole_momentum or not torch.equal(ranks[0]["logits"], ranks[1]["logits"]):
        raise AssertionError("model parallel: the checkpoint's momentum is not whole, or the "
                             "ranks' logits differ")
    torch.testing.assert_close(ranks[0]["logits"], ckpt_logits, atol=2e-4, rtol=1e-4,
                               msg=lambda m: f"model parallel checkpoint eval logits: {m}")
    if min(launched[k] for k in MRFP_TRAIN_KERNELS + ("dot_with_stats",)) <= 0:
        raise AssertionError(f"model parallel: a kernel was not launched: {launched}")
    return launched


# the zoo's tensor-parallel leg: MP_WORLD ranks on the one card split every
# conv's channels of DeepR50V3PlusD (ZOO_DP_WT: ISW in slots 2-3 with the
# whitening loss, SwitchWhiten in slot 4, the DSN head) at 768x768: fp32 at
# MPZ_FP32_N (damped), bf16 at MPZ_N where the phase's own memory reading says
# two ranks fit (else MPZ_CUT_N); the entry point cli.train_zoo on the ZOO_WT
# recipe (r18-D32) at MPZ_CLI_N crops of MPZ_CLI_CROP with one validation
MPZ_FP32_N, MPZ_N, MPZ_CUT_N, MPZ_CLI_N, MPZ_CLI_CROP = 2, 4, 2, 2, 384


def _zoo_mp_step(batch: int, dtype: str, noise: float = 0.0) -> dict:
    """The statistics pass (on the whole model, gathered where this process
    holds shards: ``cli.train_zoo.whole_model``), then one zoo step of
    ``_zoo_dp_setup(batch, dtype)`` on the whole batch x (1 + ``noise`` x
    N(0, 1)), every resize call recorded, the collectives and launches
    counted; under a model axis this process's shards of the state.
    Returns the state after the step and the gradients (whole: the model
    group's shards gathered; on the host), the losses, masks and counts,
    the collectives by group, the step's ms and the ``state``."""
    from mrfp_tpu_torch.cli import train_zoo
    from mrfp_tpu_torch.core.mesh import current_mesh
    from mrfp_tpu_torch.models.deepv3_zoo import build_cov_layers
    from mrfp_tpu_torch.ops import LAUNCHES, reset_launches
    from mrfp_tpu_torch.parallel.audit import count_collectives, summarize_by_group
    from mrfp_tpu_torch.parallel.dist import gather_rows
    from mrfp_tpu_torch.train.zoo_step import covstat_pass, zoo_train_step
    from mrfp_tpu_torch.weights import whole_state_dict
    cfg, state, pairs, img, lbl = _zoo_dp_setup(batch, dtype)
    mesh, model = current_mesh(), state.model
    layers = build_cov_layers("resnet-50", tuple(map(int, ZOO_DP_WT)))
    whole = train_zoo.whole_model(cfg, model, torch.device(DEV))
    masks, nrc = covstat_pass(whole, layers, pairs, cfg, torch.device(DEV))
    del whole
    eps = torch.randn(img.shape, generator=torch.Generator().manual_seed(2)).to(img.device)
    img = (img.float() * (1 + noise * eps)).contiguous()
    keys = getattr(model, "tp_keys", frozenset())
    host = lambda d: {k: v.detach().to("cpu", copy=True) for k, v in d.items()}  # noqa: E731
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with _recording() as calls, count_collectives() as log:
        m = zoo_train_step(state, img, lbl.contiguous(), cfg, masks, nrc)
        losses = {k: float(v) for k, v in m.items() if k.startswith("loss")}
    ms = (time.perf_counter() - t0) * 1e3
    launched = dict(LAUNCHES)
    grads = host({k: gather_rows(p.grad, mesh.model) if k in keys else p.grad
                  for k, p in model.named_parameters()})
    return {"losses": losses, "after": host(whole_state_dict(model, mesh)),
            "grads": grads, "masks": [t.cpu() for t in masks], "nrc": nrc, "ms": ms,
            "collectives": summarize_by_group(log), "launched": launched, "state": state,
            "calls": calls}


def _zoo_mp_model():
    """DeepR50V3PlusD with ``ZOO_DP_WT`` and the DSN head, on the card."""
    from mrfp_tpu_torch.models.deepv3_zoo import DeepV3Plus
    return DeepV3Plus(trunk="resnet-50", variant="D16", wt_layer=tuple(map(int, ZOO_DP_WT)),
                      use_dsn=True).to(DEV)


def _zoo_mp_hist(model, mesh, logits) -> tuple:
    """The validation of the (sharded) ``model``: ``SegEvaluator`` with the
    mesh over one synthetic H x W image, its launches counted; and the
    confusion-matrix kernel held against its plain version on this rank's
    prediction from ``logits`` (10% ignore labels): ``(hist, held, launches,
    calls)``."""
    from mrfp_tpu_torch.data import SyntheticDataset
    from mrfp_tpu_torch.ops import LAUNCHES, cuda_hist, reset_launches
    from mrfp_tpu_torch.train.evaluator import SegEvaluator
    with _strict_fp32(), _recording() as calls:
        torch.cuda.synchronize()
        reset_launches()
        res = SegEvaluator(model, device=DEV, mesh=mesh).run(
            SyntheticDataset(length=1, hw=(H, W)), log=lambda *a, **k: None)
        launched = dict(LAUNCHES)
    pred = logits.to(DEV).argmax(1)
    gen = torch.Generator(device=DEV).manual_seed(3)
    label = torch.randint(0, 19, pred.shape, device=DEV, generator=gen)
    label[torch.rand(label.shape, device=DEV, generator=gen) < 0.1] = 255
    got = cuda_hist.confusion_matrix_cuda(torch.zeros(19, 19, dtype=torch.int32, device=DEV),
                                          pred, label, 19)
    held = torch.equal(got, cuda_hist.confusion_matrix_plain(pred, label, 19))
    return (torch.as_tensor(res["hist"]), held, launched,
            [(c[0], _dtype_name(c[1])) + tuple(c[2:]) for c in calls])


def mpz_rank(rank: int, world: int, rendezvous: str, out: str, batch: int) -> None:
    """One rank of ``phase_zoo_model_parallel`` (its own process): joins the
    gloo group, lays out one model group, and on its shards of the state
    takes the fp32 zoo step and the counted bf16 one at ``batch``, whose
    whole state it checkpoints (every rank gathers, rank 0 writes) and
    evaluates (the fp32 logits at 1x3xHxW and the validation's histogram);
    writes what it saw, and rank 0 the checkpoint, to ``out/rank<rank>.pt``."""
    from mrfp_tpu_torch.core.config import MeshConfig
    from mrfp_tpu_torch.core.mesh import create_mesh
    from mrfp_tpu_torch.parallel import dist
    from mrfp_tpu_torch.train.checkpoint import CheckpointManager
    dist.initialize_distributed(rendezvous, world, rank, DEV, backend="gloo", timeout_s=900)
    try:
        mesh = create_mesh(MeshConfig(data_parallel=1, model_parallel=world))
        with _strict_fp32():
            fp32 = _zoo_mp_step(MPZ_FP32_N, "float32")
        del fp32["state"]
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        bf16 = _zoo_mp_step(batch, "bfloat16")
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        state = bf16.pop("state")
        state_bytes = _state_bytes(state)
        sw_grads = {k: v for k, v in bf16["grads"].items() if "sw_" in k}
        ckpt = CheckpointManager(os.path.join(out, "ckpt"), keep=1)
        ckpt.save(state)
        ckpt.close()
        blob = (torch.load(os.path.join(out, "ckpt", f"step_{state.step}.pt"),
                           weights_only=True) if rank == 0 else None)
        logits, eval_calls = _mp_eval_logits(state.model)
        hist, hist_held, hist_launched, hist_calls = _zoo_mp_hist(state.model, mesh, logits)
        launched = {k: fp32["launched"][k] + bf16["launched"][k] + hist_launched[k]
                    for k in hist_launched}
        torch.save({"fp32": {k: fp32[k] for k in ("losses", "grads", "masks", "nrc")},
                    "losses": bf16["losses"], "after": bf16["after"], "grads": bf16["grads"],
                    "masks": bf16["masks"], "nrc": bf16["nrc"], "sw_grads": sw_grads,
                    "collectives": bf16["collectives"], "step_ms": bf16["ms"],
                    "peak_gib": peak, "state_bytes": state_bytes, "ckpt": blob,
                    "logits": logits, "hist": hist, "hist_held": hist_held,
                    "launched": launched,
                    "calls": [(c[0], _dtype_name(c[1])) + tuple(c[2:]) for c in
                              fp32["calls"] + bf16["calls"] + eval_calls] + hist_calls},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


@contextlib.contextmanager
def _zoo_mp_entry_point():
    """``python -m mrfp_tpu_torch.cli.train_zoo --model-parallel 2
    --num-processes 2`` (``LOCAL_WORLD_SIZE=2``: the ranks share the card,
    so they join through gloo): 2 steps of the ``ZOO_WT`` recipe (r18-D32,
    ISW, the whitening loss and its statistics phase, bf16) at batch
    ``MPZ_CLI_N`` of ``MPZ_CLI_CROP`` crops, with one validation at the last
    step, run beside the block (``_beside``); yields a dict that holds the
    ranks' results, their run's metrics and seconds once the block has
    ended."""
    with tempfile.TemporaryDirectory() as tmp:
        argv = [sys.executable, "-m", "mrfp_tpu_torch.cli.train_zoo", "--device", DEV,
                "--synthetic", "--trunk", "resnet-18", "--variant", "D32", "--wt-layer", *ZOO_WT,
                "--use-wtloss", "--covstat-batches", "1", "--batch-size", str(MPZ_CLI_N),
                "--crop-size", str(MPZ_CLI_CROP), "--max-iter", "2", "--log-every", "1",
                "--eval-every", "2", "--eval-max-images", "1", "--runs-dir",
                os.path.join(tmp, "runs"), "--num-processes", str(MP_WORLD),
                "--coordinator-address", f"file://{tmp}/rendezvous", "--model-parallel",
                str(MP_WORLD)]
        report = {}
        with _beside({str(r): argv + ["--process-id", str(r)] for r in range(MP_WORLD)},
                     env={"LOCAL_WORLD_SIZE": str(MP_WORLD)}) as done:
            yield report
        bad = [(r, rc, err[-3000:]) for r, (rc, _out, err, _s) in done.items() if rc != 0]
        if bad:
            raise AssertionError(f"cli.train_zoo --model-parallel {MP_WORLD}: {bad}")
        results = [json.loads(done[str(r)][1].strip().splitlines()[-1])
                   for r in range(MP_WORLD)]
        report.update(results=results, metrics=_metrics(results[0]["run_dir"]),
                      seconds=max(d[3] for d in done.values()),
                      gloo=all("(gloo, file://" in d[2] for d in done.values()))


def phase_zoo_model_parallel(cuda_gen) -> dict:
    """Tensor parallelism for the zoo on the one card: ``MP_WORLD`` ranks
    (``mpz_rank``), each a process of its own, share the card through gloo
    and split every conv's output channels of DeepR50V3PlusD (``ZOO_DP_WT``:
    ISW in slots 2-3 with the whitening loss and its statistics pass,
    SwitchWhiten in slot 4, whitening each rank's own groups of 16, the DSN
    head), each holding its shards of the state.

    One process first takes the same passes and steps, every resize call
    recorded; each is then held against its plain version at the channel
    counts a model rank gives it (``_hold_channel_resizes``: the head's
    bilinear resizes on 128 of 256 channels and on the 19 logits, the DSN
    labels' nearest at one process's shapes), and every call of the ranks
    must be at a held shape.

    - fp32 (TF32 off, cuDNN deterministic), the damped fixture, batch
      ``MPZ_FP32_N`` at 768x768, the statistics pass over the same view
      pairs: the masks and counts equal one process's; the loss within
      1e-5 relative; each gradient within its own limit (``_per_key_limits``
      of the 1e-7-input control's distance).
    - bf16 at ``MPZ_N`` (``MPZ_CUT_N`` where the one-process step's peak,
      times the ranks, does not fit the card's free memory): the masks
      equal; the loss within 2^-9 or 3x the half-ulp-input control; the
      ranks' whole gradients and state bit-identical (the replicated
      tensors, SwitchWhiten's mixing weights among them, and the gathered
      shards); each rank's state bytes, peak memory and collectives by
      group and kind beside one process's.
    - The checkpoint of that step, written at M = 2, loads ``strict=True``
      into one process, its momentum whole, and its fp32 eval logits at
      1x3xHxW equal the ranks' sharded forward's within atol 2e-4, rtol
      1e-4; the ranks' validation (``SegEvaluator`` on the sharded model)
      launches the confusion-matrix kernel, held exactly against the plain
      version on a rank's prediction.
    - ``cli.train_zoo --model-parallel 2 --num-processes 2`` (``_zoo_mp_entry_point``)
      runs beside the ranks: 2 steps and a validation, the ranks' logged
      losses within 2^-20 of each other and their replicated tensors
      (``weights.replicated_digest``) bit-identical after step 2.

    Returns the ranks' summed kernel launches."""
    t0 = time.perf_counter()
    with _strict_fp32(), _resizes_run() as fp32_resizes:
        one32 = _zoo_mp_step(MPZ_FP32_N, "float32")
        ctrl32 = _zoo_mp_step(MPZ_FP32_N, "float32", 1e-7)
    del one32["state"], ctrl32["state"]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with _resizes_run() as bf16_resizes:
        run = _zoo_mp_step(MPZ_N, "bfloat16")
    torch.cuda.synchronize()
    one_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    free_gib = torch.cuda.mem_get_info()[0] / 2 ** 30
    batch = MPZ_N if MP_WORLD * one_peak < 0.8 * free_gib else MPZ_CUT_N
    if batch != MPZ_N:
        del run
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        with _resizes_run() as bf16_resizes:
            run = _zoo_mp_step(batch, "bfloat16")
        torch.cuda.synchronize()
        one_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    one_bytes = _state_bytes(run.pop("state"))
    one = run
    ctrl = _zoo_mp_step(batch, "bfloat16", 2.0 ** -9)
    del ctrl["state"]
    torch.cuda.empty_cache()
    with _resizes_run() as eval_resizes:
        _mp_eval_logits(_zoo_mp_model())
    torch.cuda.empty_cache()
    train_resizes = fp32_resizes | bf16_resizes
    held = (_hold_channel_resizes(train_resizes, True, cuda_gen)
            + _hold_channel_resizes(eval_resizes, False, cuda_gen))
    print(f"zoo model parallel: {held} resize calls at a model rank's channel counts held "
          f"against the plain versions ({len(train_resizes)} train resizes fp32 and bf16 at "
          f"batch {MPZ_FP32_N} and {batch}, the DSN labels' nearest among them; "
          f"{len(eval_resizes)} eval resizes); the bf16 batch {batch}: one process's step "
          f"peaked at {one_peak:.3f} GiB, {free_gib:.3f} GiB free, {MP_WORLD} ranks "
          f"{'fit' if batch == MPZ_N else 'do not fit: cut to ' + str(MPZ_CUT_N)}; one "
          f"process's runs {time.perf_counter() - t0:.1f} s")

    with _zoo_mp_entry_point() as entry:  # cli.train_zoo's ranks beside these
        ranks, seconds = _run_ranks("mpz_rank", extra=(batch,))
    for r in ranks:
        _all_held([(c[0], getattr(torch, c[1])) + tuple(c[2:]) for c in r["calls"]],
                  "zoo model parallel: a rank's runs")
    r32 = ranks[0]["fp32"]
    masks32 = all(r["fp32"]["nrc"] == one32["nrc"] and all(
        torch.equal(a, b) for a, b in zip(r["fp32"]["masks"], one32["masks"])) for r in ranks)
    loss32 = abs(r32["losses"]["loss"] - one32["losses"]["loss"]) / abs(one32["losses"]["loss"])
    limits = _per_key_limits({"control": {k: _rel(ctrl32["grads"][k], g)
                                          for k, g in one32["grads"].items()}})
    ratio32 = {k: _rel(r32["grads"][k], g) / limits[k] for k, g in one32["grads"].items()}
    worst32 = sorted(ratio32.items(), key=lambda kv: -kv[1])[:3]
    masks = all(r["nrc"] == one["nrc"] and all(torch.equal(a, b) for a, b in
                                                zip(r["masks"], one["masks"])) for r in ranks)
    same = [k for part in ("after", "grads") for k, v in ranks[0][part].items()
            if not torch.equal(v, ranks[1][part][k])]
    sw = sorted(ranks[0]["sw_grads"])
    loss, one_loss = ranks[0]["losses"]["loss"], one["losses"]["loss"]
    loss_err = abs(loss - one_loss) / abs(one_loss)
    loss_bound = max(2.0 ** -9, 3 * abs(ctrl["losses"]["loss"] - one_loss) / abs(one_loss))
    launched = {k: sum(r["launched"][k] for r in ranks) for k in ranks[0]["launched"]}
    blob = ranks[0]["ckpt"]
    loaded = _zoo_mp_model()
    loaded.load_state_dict(blob["model"], strict=True)
    params = [p for p in loaded.parameters() if p.requires_grad]
    momentum = blob["optimizer"]["state"]
    whole_momentum = len(momentum) == len(params) and all(
        momentum[i]["momentum_buffer"].shape == p.shape for i, p in enumerate(params))
    ckpt_logits, _ = _mp_eval_logits(loaded)
    del loaded
    torch.cuda.empty_cache()
    logit_err = (ranks[0]["logits"] - ckpt_logits).abs().max().item()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"zoo model parallel fp32 (TF32 off, deterministic), damped fixture: DeepR50V3PlusD "
          f"wt {''.join(ZOO_DP_WT)}, DSN, {MP_WORLD} ranks x half the channels of "
          f"{MPZ_FP32_N} images against one process, {CROP}x{CROP}: masks (dim, nrc) "
          f"{[(m.shape[0], n) for m, n in zip(one32['masks'], one32['nrc'])]} equal to one "
          f"process's: {masks32}; loss {r32['losses']['loss']:.7f} vs "
          f"{one32['losses']['loss']:.7f} (rel {loss32:.3e}, bound 1e-5); gradients of "
          f"{len(ratio32)} tensors, each to its own limit (3x the 1e-7-input control + 1e-3, "
          f"at most 3x the largest control), worst error / limit "
          f"{[(k, round(v, 3)) for k, v in worst32]}, median "
          f"{statistics.median(ratio32.values()):.3f}")
    print(f"zoo model parallel bf16: {MP_WORLD} ranks x half the channels of {batch} images "
          f"over gloo, {CROP}x{CROP}, against one process: masks equal {masks}; losses "
          f"{ {k: round(v, 6) for k, v in ranks[0]['losses'].items()} } vs "
          f"{ {k: round(v, 6) for k, v in one['losses'].items()} }, loss rel {loss_err:.3e} "
          f"(bound {loss_bound:.3e}); ranks' whole gradients and state identical: "
          f"{not same} (SwitchWhiten's mixing weights {sw} among them)")
    for r, res in enumerate(ranks):
        print(f"zoo model parallel rank {r}: state {res['state_bytes'] / 1e6:.3f} MB (one "
              f"process {one_bytes / 1e6:.3f} MB); peak {res['peak_gib']:.3f} GiB above its "
              f"set-up (one process {one_peak:.3f} GiB); collectives a bf16 step "
              f"{json.dumps(res['collectives'], sort_keys=True)} (one process "
              f"{json.dumps(one['collectives'], sort_keys=True)}); counted step "
              f"{res['step_ms']:.1f} ms (gloo through the host: a correctness time; one "
              f"process {one['ms']:.1f} ms); card {card.strip()}")
    print(f"zoo model parallel: checkpoint at M = {MP_WORLD} loaded strict into one process "
          f"(momentum whole: {whole_momentum}), its fp32 eval logits 1x3x{H}x{W} vs the "
          f"ranks' max_abs_err {logit_err:.3e}; the ranks' validation histograms equal: "
          f"{torch.equal(ranks[0]['hist'], ranks[1]['hist'])}, confusion matrix on a rank's "
          f"prediction exactly plain's: {all(r['hist_held'] for r in ranks)}; launches (both "
          f"ranks) {launched}; {seconds:.1f} s for the ranks end to end")
    results, metrics = entry["results"], entry["metrics"]
    val = metrics.get("val/mean_iu", {})
    spread = max(abs(r["losses"][k] - v) / abs(v) for r in results
                 for k, v in results[0]["losses"].items())
    digests = {r["replicated_sha256"] for r in results}
    print(f"cli.train_zoo --model-parallel {MP_WORLD} --num-processes {MP_WORLD} "
          f"(LOCAL_WORLD_SIZE={MP_WORLD} on one card, gloo: {entry['gloo']}; r18-D32 wt "
          f"{''.join(ZOO_WT)}, ISW, bf16, batch {MPZ_CLI_N}, {MPZ_CLI_CROP}x{MPZ_CLI_CROP}): steps {[r['step'] for r in results]}, losses "
          f"{[r['losses'] for r in results]}, covstat masks {results[0]['covstat']['masks']}, "
          f"validation mean_iu {val}; the ranks' losses apart by {spread:.3e} relative at "
          f"most (bound 2^-20, a few ulps); their replicated tensors after step 2 "
          f"identical: {len(digests) == 1} (sha256 {sorted(digests)}); "
          f"{entry['seconds']:.1f} s end to end beside the ranks")
    if not masks32 or not math.isfinite(loss32) or loss32 > 1e-5 or worst32[0][1] > 1:
        raise AssertionError(f"zoo model parallel fp32: masks equal {masks32}, loss rel "
                             f"{loss32}, gradients over their limits "
                             f"{[kv for kv in worst32 if kv[1] > 1]}")
    if not masks or same or not sw:
        raise AssertionError(f"zoo model parallel: masks equal {masks}; ranks differ at {same}; "
                             f"SwitchWhiten's mixing weights {sw}")
    if not math.isfinite(loss) or loss_err > loss_bound:
        raise AssertionError(f"zoo model parallel: loss {loss} against one process's {one_loss}")
    if not whole_momentum or not torch.equal(ranks[0]["logits"], ranks[1]["logits"]):
        raise AssertionError("zoo model parallel: the checkpoint's momentum is not whole, or "
                             "the ranks' logits differ")
    torch.testing.assert_close(ranks[0]["logits"], ckpt_logits, atol=2e-4, rtol=1e-4,
                               msg=lambda m: f"zoo model parallel checkpoint eval logits: {m}")
    if not all(r["hist_held"] for r in ranks) or not torch.equal(ranks[0]["hist"],
                                                                 ranks[1]["hist"]):
        raise AssertionError("zoo model parallel: the validation's confusion matrix")
    # the zoo has no OC branch: no nearest backward (the DSN labels take none)
    if min(launched[k] for k in ("resize_bilinear", "resize_bilinear_bwd", "resize_nearest",
                                 "confusion_matrix")) <= 0:
        raise AssertionError(f"zoo model parallel: a kernel was not launched: {launched}")
    if any(abs(r["losses"][k] - v) > 2.0 ** -20 * abs(v) for r in results
           for k, v in results[0]["losses"].items()) \
            or any(r["step"] != 2 for r in results) or sorted(val) != [2] or len(digests) != 1 \
            or not entry["gloo"] \
            or not all(math.isfinite(v) for v in results[0]["losses"].values()):
        raise AssertionError(f"cli.train_zoo --model-parallel {MP_WORLD}: {results}, "
                             f"validation {val}")
    return launched


def _phase(fn, *args):
    """``fn(*args)``, its seconds printed on a line of their own."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"{fn.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


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
    _phase(phase_build)
    gen = torch.Generator().manual_seed(0)
    _phase(phase_resize, gen)
    hist = _phase(phase_hist, gen)
    live_fp32_ms = _phase(phase_model, gen, args.profile)
    torch.cuda.empty_cache()
    serving_launches = _phase(phase_serving, live_fp32_ms)
    torch.cuda.empty_cache()
    eval_launches = _phase(phase_entry_point)
    cuda_gen = torch.Generator(device=DEV).manual_seed(0)
    nearest = _phase(phase_nearest, cuda_gen)
    _phase(phase_dsn_nearest, gen)
    bilinear = _phase(phase_bilinear_train, cuda_gen)
    _phase(phase_microbatch, cuda_gen)
    dot_stats = _phase(phase_dot_stats, cuda_gen)
    row_mix = _phase(phase_row_mix, cuda_gen)
    channel_sums = _phase(phase_channel_sums, cuda_gen)
    np_plus = _phase(phase_np_plus, cuda_gen)
    oc_stage = _phase(phase_oc_stage, cuda_gen)
    public_launches = _phase(phase_public_paths, cuda_gen)
    _phase(phase_train_step, gen, args.profile)
    fused_launches = _phase(phase_fused_step, gen)
    train_launches = _phase(phase_cli_train)
    extras_launches = _phase(phase_extras_step, gen)
    accum_launches = _phase(phase_cli_train_accum)
    sliding_launches = _phase(phase_sliding)
    _phase(phase_trunks, gen, cuda_gen)
    torch.cuda.empty_cache()
    zoo_launches = _phase(phase_cli_train_zoo, cuda_gen)
    torch.cuda.empty_cache()
    zoo_trunk_launches = _phase(phase_zoo_trunks, gen, cuda_gen, args.profile)
    torch.cuda.empty_cache()
    dp_launches, dp_bill = _phase(phase_data_parallel, cuda_gen)
    torch.cuda.empty_cache()
    zoo_dp_launches = _phase(phase_zoo_data_parallel, cuda_gen, dp_bill)
    torch.cuda.empty_cache()
    sp_launches = _phase(phase_spatial_parallel, cuda_gen)
    torch.cuda.empty_cache()
    spx_launches = _phase(phase_spatial_zoo_extras, cuda_gen)
    torch.cuda.empty_cache()
    mp_launches = _phase(phase_model_parallel, cuda_gen)
    torch.cuda.empty_cache()
    mpz_launches = _phase(phase_zoo_model_parallel, cuda_gen)

    def launches(name, *counted):
        """The kernel's count over the counted drives of its paths."""
        return sum(c[name] for c in counted)

    later_paths = (serving_launches, extras_launches, accum_launches, sliding_launches,
                   zoo_launches, zoo_trunk_launches, dp_launches, zoo_dp_launches, sp_launches,
                   spx_launches, mp_launches, mpz_launches)
    src = "mrfp_tpu_torch/csrc/"
    kernels = [
        dict(name="resize_bilinear", route="cuda", source=src + "resize_bilinear.cu",
             replaces="mrfp_tpu/ops/pallas_resize.py:264",
             launches=launches("resize_bilinear", eval_launches, train_launches, *later_paths),
             **bilinear["resize_bilinear"]),
        dict(name="resize_bilinear_bwd", route="cuda", source=src + "resize_bilinear.cu",
             replaces="mrfp_tpu/ops/pallas_resize.py:280",
             launches=launches("resize_bilinear_bwd", train_launches, *later_paths),
             **bilinear["resize_bilinear_bwd"]),
        dict(name="resize_nearest", route="cuda", source=src + "resize_nearest.cu",
             replaces="mrfp_tpu/ops/pallas_resize.py:235",
             launches=launches("resize_nearest", train_launches, *later_paths),
             **nearest["resize_nearest"]),
        dict(name="resize_nearest_bwd", route="cuda", source=src + "resize_nearest.cu",
             replaces="mrfp_tpu/ops/pallas_resize.py:250",
             launches=launches("resize_nearest_bwd", train_launches, public_launches,
                               *later_paths),
             **nearest["resize_nearest_bwd"]),
        dict(name="oc_stage", route="cuda", source=src + "oc_stage.cu",
             replaces="mrfp_tpu/ops/pallas_resize.py:235, :250 with "
                      "mrfp_tpu/perturb/oc_branch.py:121-127",
             launches=launches("oc_stage", train_launches, *later_paths),
             backward_launches=launches("oc_stage_bwd", train_launches, *later_paths),
             **oc_stage),
        dict(name="confusion_matrix", route="cuda", source=src + "confusion_matrix.cu",
             replaces="mrfp_tpu/ops/pallas_hist.py:50",
             launches=launches("confusion_matrix", eval_launches, sliding_launches,
                               zoo_launches, sp_launches, spx_launches, mpz_launches),
             **hist),
        dict(name="dot_with_stats", route="cuda", source=src + "dot_stats.cu",
             replaces="mrfp_tpu/ops/pallas_dot_stats.py:112",
             launches=launches("dot_with_stats", fused_launches, spx_launches, mp_launches),
             tensor_core_launches=launches("dot_with_stats_tc", fused_launches, spx_launches,
                                           mp_launches),
             **dot_stats),
        dict(name="row_mix", route="cuda", source=src + "row_mix.cu",
             replaces="mrfp_tpu/ops/pallas_resize.py:74",
             launches=public_launches["row_mix"],
             compact_launches=public_launches["row_mix_compact"], **row_mix),
        dict(name="channel_sums", route="cuda", source=src + "channel_sums.cu",
             replaces="mrfp_tpu/ops/pallas_stats.py:88",
             launches=public_launches["channel_sums"], **channel_sums),
        dict(name="np_plus_apply", route="cuda", source=src + "np_plus_apply.cu",
             replaces="mrfp_tpu/ops/pallas_np_plus.py:31",
             launches=public_launches["np_plus_apply"], **np_plus),
    ]
    if min(k["launches"] for k in kernels) <= 0:
        raise AssertionError(f"a kernel was not launched on its path: "
                             f"{[(k['name'], k['launches']) for k in kernels]}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
