"""The yardstick's counters against hand counts at a tiny size."""

import copy

import torch

from benchmark import harness
from benchmark.reference import common, isw_r50_d16, mrfp_plus_r50_d16


def _tiny(name, n, side):
    cfg = copy.deepcopy(harness.load_json("configs", name))
    cfg["train"].update(batch_size=n, crop_size=side)
    return cfg


def _conv_flops(model, x):
    """2 * N * Cout * Ho * Wo * Cin * k * k of every conv, by hooks."""
    total = []

    def hook(mod, inp, out):
        k = mod.kernel_size[0] * mod.kernel_size[1]
        total.append(2 * out.numel() * mod.in_channels * k // mod.groups)
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        model(x)
    for h in hooks:
        h.remove()
    return sum(total)


def test_eval_flops_are_the_convolutions():
    cfg = _tiny("mrfp_plus_r50_d16", 1, 64)
    flops, calls = mrfp_plus_r50_d16.eval_work(cfg, (64, 128))
    model = mrfp_plus_r50_d16.build(cfg, False)
    assert flops == _conv_flops(model, torch.zeros(1, 3, 64, 128))
    # the ASPP broadcast, the decoder upsample and the logits' upsample
    assert [(c["in_hw"], c["out_hw"]) for c in calls] == [((1, 1), (4, 8)), ((4, 8), (16, 32)),
                                                         ((16, 32), (64, 128))]


def test_train_flops_are_three_times_the_forward_without_frozen_weights():
    cfg = _tiny("isw_r50_d16", 2, 64)
    flops, calls = isw_r50_d16.train_work(cfg)
    model = isw_r50_d16.build(cfg, False)
    fwd = _conv_flops(model, torch.zeros(2, 3, 64, 64))
    dsn = 2 * 2 * 4 * 4 * (512 * 1024 * 9 + 19 * 512)
    first = 2 * 2 * 32 * 32 * 64 * 3 * 49  # the stem conv takes no input gradient
    # the whitening loss: f f^T of the stem map (before its pool), layer1's and layer2's
    bmm = sum(2 * 2 * c * c * hw for c, hw in ((64, 32 * 32), (256, 16 * 16), (512, 8 * 8)))
    assert flops == 3 * (fwd + dsn) - first + 3 * bmm
    assert sum(c["labels"] for c in calls) == 1  # the DSN labels' nearest resize


def test_gated_steps_count_the_oc_branch():
    cfg = _tiny("mrfp_plus_r50_d16", 2, 64)
    off, calls_off = mrfp_plus_r50_d16.train_work(cfg, (False, False, False))
    on, calls_on = mrfp_plus_r50_d16.train_work(cfg, (True, True, True))
    assert on > off and len(calls_on) == len(calls_off) + 8  # 7 OC nearest + the injection
    assert all(c["kind"] == "nearest" for c in calls_on[:7])


def test_resize_bytes():
    reader = harness.reader("resize_roofline.train")
    calls = [dict(kind="bilinear", n=2, c=3, in_hw=(4, 4), out_hw=(8, 8), grad=True,
                  labels=False),
             dict(kind="nearest", n=2, c=1, in_hw=(8, 8), out_hw=(2, 2), grad=False,
                  labels=True)]
    assert reader.step_bytes(calls, "bfloat16") == 2 * 3 * (16 + 64) * 2 * 2 + 2 * (64 + 4) * 4


def test_rounding_controls():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -10, 3.0])
    assert torch.equal(common._round_tf32(x), torch.tensor([1.0, 1.0 + 2 ** -10, 3.0]))
    assert torch.equal(common._round_fp8(torch.tensor([448.0, 1.0, 0.0])),
                       torch.tensor([448.0, 1.0, 0.0]))
