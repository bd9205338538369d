"""The fused OC stage (``ops/oc_stage.py``) on the CPU, through the plain
versions of its kernels (``ops/cuda_oc_stage.py``).

- The statistics the kernels take from the pre-resize map, each pixel
  weighted by how often the nearest resize repeats it, are the resized
  map's moments: at the eight stage tables of a 768x768 step (the
  downsampling stages' tables skip rows and columns: weight 0), over the
  whole map and as two bands of output rows combined by Chan's rule (the
  spatial split's tables and combination).
- ``OCStage``'s plain route (the kernels' arithmetic: weighted moments,
  apply through the gather, the backward's replica sums and closed form)
  against the composition the CPU runs (resize -> fp32 BatchNorm -> ReLU ->
  cast), forward and input gradient, in fp32 and fp64, at every stage's
  rule, and with two outputs (enc4's two layouts) taking cotangents.

fp64 agrees to rounding (1e-10); fp32 within 2e-5 of the map's scale: the
two take their sums in other orders.
"""

import math

import numpy as np
import pytest
import torch

from mrfp_tpu_torch.nn.norms import chan_combine, norm_group
from mrfp_tpu_torch.ops import cuda_oc_stage
from mrfp_tpu_torch.ops.cuda_oc_stage import NCHW, NHWC
from mrfp_tpu_torch.ops.cuda_resize import resize_nearest_bwd_plain, resize_nearest_plain
from mrfp_tpu_torch.ops.oc_stage import EPS, OCStage, oc_stage, oc_stage_plain
from mrfp_tpu_torch.ops.resize import nearest_band_rows, nearest_index, nearest_table

torch.set_num_threads(2)
CPU = torch.device("cpu")

# (stage, input side, rule, arg): the eight stages of a 768x768 step, the
# stem features 192x192 (dec1's resize is the identity)
STAGES = [
    ("enc1", 192, "scale", 1.205),
    ("enc2", 231, "scale", 1.2),
    ("enc3", 277, "scale", 1.2),
    ("enc4", 332, "size", 384),
    ("dec1", 384, "size", 384),
    ("dec2", 384, "scale", 0.838),
    ("dec3", 321, "scale", 0.798),
    ("dec4", 256, "size", 192),
]
DOWNSAMPLING = ("dec2", "dec3", "dec4")


def _moments(yf: torch.Tensor):
    """The plain per-channel count, mean and M2 of an NCHW map."""
    mean = yf.mean((0, 2, 3))
    return yf.numel() // yf.shape[1], mean, (yf - mean[:, None, None]).square().sum((0, 2, 3))


def _weighted(y: torch.Tensor, ty, tx):
    count = y.shape[0] * ty.idx.numel() * tx.idx.numel()
    _stats, local = cuda_oc_stage.oc_stage_stats_plain(y, ty, tx, count, EPS)
    return count, local[0], local[1]


@pytest.mark.parametrize("stage,side,rule,arg", STAGES, ids=[s[0] for s in STAGES])
def test_count_weighted_moments_are_the_resized_maps(stage, side, rule, arg):
    gen = torch.Generator().manual_seed(sum(map(ord, stage)))
    # an offset mean and uneven rows, so a weighting error shows
    y = (3.0 + torch.randn((2, 3, side, side), generator=gen, dtype=torch.float64)
         * torch.linspace(0.5, 2.0, side, dtype=torch.float64)[:, None])
    ty, tx = nearest_table(side, rule, arg, CPU), nearest_table(side, rule, arg, CPU)
    # a downsample skips many rows; an upsample by a scale may skip its last
    skipped = int((ty.hi == ty.lo).sum())
    assert (skipped > side // 10) == (stage in DOWNSAMPLING)
    n, mean, m2 = _moments(resize_nearest_plain(y, ty, tx))
    got = _weighted(y, ty, tx)
    assert got[0] == n
    torch.testing.assert_close(got[1], mean, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(got[2], m2, rtol=1e-10, atol=1e-9)

    # two bands of output rows, each from the input rows it reads, with the
    # band table of the global resize; combined as the ranks combine them
    oh = len(nearest_index(side, rule, arg))
    parts = []
    for o0, o1 in ((0, oh // 2), (oh // 2, oh)):
        lo, hi = nearest_band_rows(side, rule, arg, o0, o1)
        band = nearest_table(side, rule, arg, CPU, (o0, o1))
        assert band.idx.numel() == o1 - o0 and band.lo.numel() == hi - lo
        parts.append(_weighted(y[:, :, lo:hi], band, tx))
    n_k = torch.tensor([[float(p[0])] for p in parts], dtype=torch.float64)
    total, mean2, m22 = chan_combine(n_k, torch.stack([p[1] for p in parts]),
                                     torch.stack([p[2] for p in parts]))
    assert float(total[0]) == n
    torch.testing.assert_close(mean2, mean, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(m22, m2, rtol=1e-10, atol=1e-9)


# (stage, input (h, w), size or scale): each stage's rule on small maps, as
# the branch would run them on a 48x40 image
SMALL = [
    ("enc1", (12, 10), {"scale": (1.205, 1.205)}),
    ("enc2", (14, 12), {"scale": (1.2, 1.2)}),
    ("enc3", (16, 14), {"scale": (1.2, 1.2)}),
    ("enc4", (19, 16), {"size": (24, 20)}),
    ("dec1", (24, 20), {"size": (24, 20)}),
    ("dec2", (24, 20), {"scale": (0.838, 0.838)}),
    ("dec3", (20, 16), {"scale": (0.798, 0.798)}),
    ("dec4", (15, 12), {"size": (12, 10)}),
]
TOL = {torch.float64: dict(rtol=1e-10, atol=1e-10), torch.float32: dict(rtol=2e-5, atol=2e-5)}


def _tables(hw, rule):
    (kind, arg), = rule.items()
    if kind == "size" and tuple(arg) == tuple(hw):
        return (nearest_table(hw[0], "size", hw[0], CPU), nearest_table(hw[1], "size", hw[1], CPU),
                True)
    return (nearest_table(hw[0], kind, arg[0], CPU), nearest_table(hw[1], kind, arg[1], CPU),
            False)


def _inputs(stage, hw, dtype, c=5):
    gen = torch.Generator().manual_seed(len(stage) * 7 + hw[0])
    y = (0.5 + 2.0 * torch.randn((3, c, *hw), generator=gen, dtype=torch.float64)).to(dtype)
    w = (0.5 * torch.randn(c, generator=gen, dtype=torch.float64)).to(dtype)
    b = (0.1 * torch.randn(c, generator=gen, dtype=torch.float64)).to(dtype)
    return y, w, b, gen


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["fp32", "fp64"])
@pytest.mark.parametrize("stage,hw,rule", SMALL, ids=[s[0] for s in SMALL])
def test_plain_route_matches_the_composition(stage, hw, rule, dtype):
    y, w, b, gen = _inputs(stage, hw, dtype)
    ty, tx, identity = _tables(hw, rule)
    y_ref = y.clone().requires_grad_(True)
    ref = oc_stage_plain(y_ref, w, b, impl="plain", **rule)
    y_got = y.clone().requires_grad_(True)
    got, = OCStage.apply(y_got, w, b, ty, tx, (NCHW,), False, identity)
    assert got.dtype == dtype and got.shape == ref.shape
    torch.testing.assert_close(got, ref, **TOL[dtype])
    g = torch.randn(ref.shape, generator=gen, dtype=torch.float64).to(dtype)
    ref.backward(g)
    got.backward(g)
    torch.testing.assert_close(y_got.grad, y_ref.grad, **TOL[dtype])
    assert float(y_ref.grad.abs().sum()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["fp32", "fp64"])
def test_plain_route_two_layouts_take_both_cotangents(dtype):
    """enc4 for the decoder (channels-last) and the injection (NCHW): both
    outputs equal the composition's, and the input gradient is the
    composition's for the summed cotangent; with one output unused, that of
    the other alone."""
    stage, hw, rule = SMALL[3]
    y, w, b, gen = _inputs(stage, hw, dtype)
    ty, tx, identity = _tables(hw, rule)
    y_ref = y.clone().requires_grad_(True)
    ref = oc_stage_plain(y_ref, w, b, impl="plain", **rule)
    y_got = y.clone().requires_grad_(True)
    a, c = OCStage.apply(y_got, w, b, ty, tx, (NHWC, NCHW), False, identity)
    assert a.is_contiguous(memory_format=torch.channels_last) and c.is_contiguous()
    torch.testing.assert_close(a, ref, **TOL[dtype])
    torch.testing.assert_close(c, ref, **TOL[dtype])
    g1, g2 = (torch.randn(ref.shape, generator=gen, dtype=torch.float64).to(dtype)
              for _ in range(2))
    ref.backward(g1 + g2)
    (a * g1).sum().add((c * g2).sum()).backward()
    torch.testing.assert_close(y_got.grad, y_ref.grad, **TOL[dtype])
    y_one = y.clone().requires_grad_(True)
    a, _c = OCStage.apply(y_one, w, b, ty, tx, (NHWC, NCHW), False, identity)
    a.backward(g1)
    y_ref.grad = None
    oc_stage_plain(y_ref, w, b, impl="plain", **rule).backward(g1)
    torch.testing.assert_close(y_one.grad, y_ref.grad, **TOL[dtype])


def test_cpu_stage_is_the_composition_in_every_layout():
    """On the CPU ``oc_stage`` is the composition, the same tensor for each
    layout asked for; the group it reduces over is this process alone."""
    y, w, b, _ = _inputs("enc1", (12, 10), torch.float32)
    ref = oc_stage_plain(y, w, b, scale=(1.205, 1.205))
    outs = oc_stage(y, w, b, scale=(1.205, 1.205), layouts=(NHWC, NCHW))
    assert len(outs) == 2 and outs[0] is outs[1]
    assert torch.equal(outs[0], ref)
    assert norm_group().size == 1
    assert np.isfinite(ref.numpy()).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("stage,hw,rule", SMALL, ids=[s[0] for s in SMALL])
def test_plain_sums_are_the_exact_ones_rounded_once(stage, hw, rule, dtype):
    """The plain versions' statistics and backward sums are the exact ones
    (taken here in fp64 over the resized map, in another order) rounded once
    to fp32, bit for bit: so the kernels, whose fp64 sums round to the same
    numbers, agree with them whatever the order of either's sums."""
    y, w, b, gen = _inputs(stage, hw, dtype, c=16)
    w, b = w.float(), b.float()
    y = y + 40.0  # a mean far from 0 beside the spread: fp32 sums would lose it
    ty, tx, _identity = _tables(hw, rule)
    count = y.shape[0] * ty.idx.numel() * tx.idx.numel()
    stats, _local = cuda_oc_stage.oc_stage_stats_plain(y, ty, tx, count, EPS)
    yd = resize_nearest_plain(y.double(), ty, tx)
    var, mean = torch.var_mean(yd, (0, 2, 3), correction=0)
    assert stats.dtype == torch.float32
    assert torch.equal(stats[0], mean.float())
    assert torch.equal(stats[1], (var * count).float())
    assert torch.equal(stats[2], (1 / torch.sqrt(var + EPS)).float())
    g = torch.randn((y.shape[0], y.shape[1], ty.idx.numel(), tx.idx.numel()),
                    generator=gen).to(dtype)
    sums = []
    real = cuda_oc_stage.all_reduce_sum
    cuda_oc_stage.all_reduce_sum = lambda t, group: sums.append(t) or t
    try:
        cuda_oc_stage.oc_stage_bwd_plain([g], y, stats, w, b, ty, tx, norm_group())
    finally:
        cuda_oc_stage.all_reduce_sum = real
    # the same sums, exactly (math.fsum; each product of two fp32 values is
    # exact in fp64), over the sources: each one's replica sum G, masked;
    # rounded once to fp32 they are the plain version's
    big_g = resize_nearest_bwd_plain(g.float(), ty, tx, y.shape[2], y.shape[3])
    xh, z = cuda_oc_stage._bn_relu(y.float(), stats, w, b)
    gm = torch.where(z > 0, big_g, torch.zeros(())).double()
    for k, terms in enumerate((gm, gm * xh.double())):
        exact = [math.fsum(terms[:, c].flatten().tolist()) for c in range(terms.shape[1])]
        exact = torch.tensor(exact, dtype=torch.float64)
        assert sums[0].dtype == torch.float64  # the ranks add them before they round
        assert torch.equal(sums[0][k].float(), exact.float())


def test_ranks_round_one_process_statistics(monkeypatch):
    """Two ranks holding two bands of the output rows (a spatial split) pass
    their fp64 moments through the all_reduce and Chan's rule before they
    round: the statistics are one process's, bit for bit."""
    from types import SimpleNamespace

    from mrfp_tpu_torch.nn import norms
    side, arg = 60, 1.2
    gen = torch.Generator().manual_seed(5)
    y = (40.0 + torch.randn((2, 16, side, side), generator=gen)).to(torch.bfloat16)
    ty, tx = nearest_table(side, "scale", arg, CPU), nearest_table(side, "scale", arg, CPU)
    whole, _ = cuda_oc_stage.oc_stage_stats_plain(y, ty, tx, 2 * ty.idx.numel() * tx.idx.numel(),
                                                  EPS)
    oh = ty.idx.numel()
    bands = []
    for o0, o1 in ((0, oh // 2), (oh // 2, oh)):
        lo, hi = nearest_band_rows(side, "scale", arg, o0, o1)
        band = nearest_table(side, "scale", arg, CPU, (o0, o1))
        count = 2 * (o1 - o0) * tx.idx.numel()
        bands.append((count, cuda_oc_stage.oc_stage_stats_plain(y[:, :, lo:hi], band, tx, count,
                                                                EPS)[1]))
    other = torch.zeros((2, 3, 16), dtype=torch.float64)
    other[1, 0], other[1, 1], other[1, 2] = bands[1][0], bands[1][1][0], bands[1][1][1]
    monkeypatch.setattr(norms, "all_reduce_sum", lambda buf, group: buf + other)
    got = cuda_oc_stage.global_stats(bands[0][0], bands[0][1], SimpleNamespace(size=2, rank=0),
                                     EPS, torch.float32)
    assert torch.equal(got, whole)


def test_stage_output_ignores_the_conv_bias():
    """Where the kernels run, the stage's conv takes no bias: train-mode BN
    subtracts the batch mean, which cancels a per-channel constant. The
    composition with the bias and without it agree to rounding, forward and
    input gradient (fp64)."""
    from mrfp_tpu_torch.perturb.oc_branch import _stage
    gen = torch.Generator().manual_seed(11)
    w = 0.2 * torch.randn((6, 4, 3, 3), generator=gen, dtype=torch.float64)
    bias = 3.0 * torch.randn(6, generator=gen, dtype=torch.float64)
    bn_w = 0.5 * torch.randn(6, generator=gen, dtype=torch.float64)
    bn_b = 0.1 * torch.randn(6, generator=gen, dtype=torch.float64)
    x = torch.randn((2, 4, 9, 7), generator=gen, dtype=torch.float64)
    g = torch.randn((2, 6, 10, 8), generator=gen, dtype=torch.float64)
    outs, grads = [], []
    for b in (bias, torch.zeros_like(bias)):
        xi = x.clone().requires_grad_(True)
        out, = _stage((w, b, bn_w, bn_b), xi, 1, scale=(1.2, 1.2), impl="plain")
        out.backward(g)
        outs.append(out.detach())
        grads.append(xi.grad)
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-10, atol=1e-10)
