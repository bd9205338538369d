"""Spatial parallelism of the zoo on the CPU: the DeepV3Plus zoo with image
H split in bands of rows across gloo ranks (``core/mesh.py``), against one
process on the whole map and against the JAX package (whose meshed zoo
loss tests/test_spatial.py holds to its one-device loss).

Two process groups (``torch_dist_group.Group``: file rendezvous, gloo, one
torch thread a rank) run the cases of ``torch_spatial_zoo_cases.py`` while
this process computes the whole-map results and JAX's step:

- a world of 4: SE-ResNeXt's ceil-mode max pool at every height 15..70 on
  spatial groups of 2, 3 and 4; ``SwitchWhiten2d`` types 2, 3 and 5 in
  eval mode on groups of 2, 3 and 4 and in train mode on the 4; the
  whitening loss and ``covariance_variance`` on groups of 2, 3 and 4; the
  2 x 2 (data x spatial) zoo step and statistics pass;
- a world of 2: ``SwitchWhiten2d`` and SE-ResNeXt's bottleneck (strided
  grouped 3x3 and downsample, the SE module) in train mode; the sp = 2 zoo steps
  (the ISW plan, a SwitchWhiten plan, MobileNetV2) and statistics pass;
  the eval forward of MobileNetV2, ShuffleNetV2, MNASNet-0.5 and
  SE-ResNeXt-50.

Bounds:

- The ceil-mode pool: the forward bit-equal to ``F.max_pool2d(ceil_mode=
  True)``'s rows in fp64 and fp32, the backward within 1e-12 (fp64) and
  1e-6 (fp32: a row read by two ranks' windows sums its two cotangents
  in another order).
- ``SwitchWhiten2d`` against the whole map: within 1e-12 of its largest
  value in fp64 (the bands' statistics are summed in another order), 1e-6
  in fp32 (1e-5 for the gradients); the softmax mixing weights' fp32
  gradients, differences of sums over the whole map, within 3x the
  one-process layer's distance from fp64 + 1e-6. The whitening loss
  (fp32 on any input) and ``covariance_variance`` (an fp32 result) within
  1e-6, the loss's gradient within 1e-5.
- The zoo step (r18-D32 at 64 px, batch 4, the DSN head with the injected
  keep mask, the whitening loss, the damped fixture, fp32): the losses
  within 1e-4 relative of one process's, every gradient and updated
  tensor within 3x a 1e-7-input control + 1e-4 of its norm
  (``torch_step_checks.as_close_as_the_control``), the ranks equal bit for
  bit; the ISW plan against JAX's one-device ``zoo_train_step`` as the
  one-process step lies (tests/test_torch_zoo_dist.py's bounds).
- The statistics pass: every rank's masks and counts bit-equal to one
  process's on the same pairs (at the JAX trainer's batch over the
  process count).
- The trunks' eval logits within atol 2e-4, rtol 1e-4 of the whole map's.
- Entry points: ``cli.train_zoo --num-processes 2 --spatial-parallel 2``
  takes two steps, its first loss within 1e-4 of one process's;
  ``cli.eval --arch DeepSEResNext50V3PlusD --spatial-parallel 2`` prints
  one process's results.
"""

import dataclasses
import functools
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mrfp_tpu.core.config import Config as JaxConfig
from mrfp_tpu.models import deepv3_zoo as jax_zoo
from mrfp_tpu.train import create_train_state as jax_create_train_state
from mrfp_tpu.train.zoo_step import zoo_train_step as jax_zoo_train_step
from mrfp_tpu_torch.nn.norms import SW_PERGROUP
from mrfp_tpu_torch.parallel.dist import band
from mrfp_tpu_torch.weights import state_dict_from_jax

import torch_spatial_zoo_cases as cases
from torch_dist_cases import digest
from torch_dist_group import REPO, Group, env
from torch_step_checks import (as_close_as_the_control, as_close_as_the_control_or_fp64,
                               perturbed)
from torch_zoo_fixture import (damp_last_bns, jax_vars, nchw, random_variables,
                               spd_running_cov, zoo_trunk_reference)

torch.set_num_threads(2)

HW, N = cases.HW, 4
SW_TYPES = (2, 3, 5)
POOL_HEIGHTS = range(15, 71)
TRUNKS = ("mobilenetv2", "shufflenetv2", "mnasnet_05", "se_resnext-50")


def _tensor(seed: int, shape, dtype=torch.float64) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)).to(dtype)


def _rel_close(got, want, tol: float, what) -> None:
    err = float((got.double() - want.double()).abs().max())
    scale = max(1e-30, float(want.double().abs().max()))
    assert err <= tol * scale, (what, err, tol * scale)


def _sw_state(seed: int, features: int, sw_type: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    g = features // SW_PERGROUP
    m = 0.3 * torch.randn(g, SW_PERGROUP, SW_PERGROUP, generator=gen)
    return {"sw_mean_weight": torch.randn(sw_type, generator=gen),
            "sw_var_weight": torch.randn(sw_type, generator=gen),
            "weight": 1 + 0.1 * torch.randn(features, generator=gen),
            "bias": 0.1 * torch.randn(features, generator=gen),
            "running_mean": 0.1 * torch.randn(g, SW_PERGROUP, 1, generator=gen),
            "running_cov": torch.eye(SW_PERGROUP) + m @ m.transpose(1, 2) / SW_PERGROUP}


def _sw_inputs(t: int, h: int, dtype) -> dict:
    x = (0.5 + _tensor(40 + h + t, (2, 32, h, 6))).to(dtype)
    return dict(x=x, dy=_tensor(50 + h + t, x.shape).to(dtype), sw_type=t,
                sd={k: v.to(dtype) for k, v in _sw_state(t, 32, t).items()})


# SwitchWhiten: (mode, sp, height) per case, each at types 2, 3, 5 in fp32 and fp64
SW_CASES = [("eval", 2, 13), ("eval", 3, 11), ("eval", 4, 17), ("train", 4, 14),
            ("train", 2, 9)]


def _pool_inputs(sp: int, dtype) -> dict:
    xs = [_tensor(100 + h, (1, 2, h, 9)).to(dtype) for h in POOL_HEIGHTS]
    dys = [_tensor(200 + x.shape[2], F.max_pool2d(x, 3, 2, ceil_mode=True).shape).to(dtype)
           for x in xs]
    return dict(xs=xs, dys=dys, sp=sp)


def _wtloss_inputs(dtype) -> dict:
    maps = [(1.0 + _tensor(300, (3, 16, 19, 7))).to(dtype),
            _tensor(301, (3, 32, 9, 5)).to(dtype)]
    rng = np.random.default_rng(302)
    masks = [torch.from_numpy(np.triu(rng.random((c, c)) < 0.4, 1).astype(np.float32))
             for c in (16, 32)]
    return dict(maps=maps, masks=masks, nrc=[float(m.sum()) for m in masks])


def _se_inputs(h: int, dtype) -> dict:
    from mrfp_tpu_torch.nn.seresnext import SEBottleneckBlock
    torch.manual_seed(h)
    block = SEBottleneckBlock(32, 16, "seresnext", groups=8, stride=2, has_downsample=True)
    with torch.no_grad():  # BatchNorm scales and shifts off their init
        for name, p in block.named_parameters():
            if "bn" in name:
                p.copy_(1 + 0.2 * torch.randn_like(p) if name.endswith("weight")
                        else 0.1 * torch.randn_like(p))
    x = _tensor(60 + h, (2, 32, h, 9)).to(dtype)
    out = torch.zeros(2, 64, (h - 1) // 2 + 1, 5)
    return dict(x=x, dy=_tensor(70 + h, out.shape).to(dtype),
                sd={k: v.clone() for k, v in block.state_dict().items()})


@pytest.fixture(scope="module")
def setup():
    """The damped fixture of the zoo steps (r18-D32, the ISW and the
    SwitchWhiten plans; MobileNetV2 with no whitening), the trunks' eval
    states, the batch, the masks, JAX's DSN keep mask of the ISW plan's
    step-0 key and the statistics pass's pairs."""
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 255, (N, HW, HW, 3)).astype(np.float32)
    lbl = rng.integers(0, 19, (N, HW, HW)).astype(np.int32)
    lbl[0, :5] = 255
    out = dict(img=torch.from_numpy(img), lbl=torch.from_numpy(lbl), plans={})
    for name, wt in cases.PLANS.items():
        jmodel = jax_zoo.DeepV3Plus(trunk="resnet-18", variant="D32", wt_layer=wt, use_dsn=True)
        params, stats = random_variables(jmodel, np.zeros((1, HW, HW, 3), np.float32), seed=3,
                                         damp=True, train=False)
        stats = spd_running_cov(stats)
        out["plans"][name] = dict(jmodel=jmodel, params=params, stats=stats,
                                  sd=state_dict_from_jax(params, stats))
    isw = out["plans"]["isw"]
    key = jax.random.fold_in(jax.random.PRNGKey(17), 0)  # zoo_train_step's draw
    _o, mut = isw["jmodel"].apply(jax_vars(isw["params"], isw["stats"]), jnp.asarray(img),
                                  train=True, mutable=["batch_stats", "intermediates"],
                                  capture_intermediates=True, rngs={"dropout": key})
    out["jax_keep"] = nchw(np.asarray(mut["intermediates"]["dsn"]["Dropout_0"]["__call__"][0])
                           != 0)
    out["keep"] = cases.keep_mask(out["jax_keep"].shape, 5)
    rng = np.random.default_rng(9)
    # the plans' ISW slots: layer1 and layer2 (64, 128), stem and layer1 (64, 64)
    out["masks"] = {plan: [torch.from_numpy(np.triu(rng.random((c, c)) < 0.3, 1)
                                            .astype(np.float32)) for c in dims]
                    for plan, dims in (("isw", (64, 128)), ("sw", (64, 64)))}
    out["pairs"] = [tuple(torch.from_numpy(rng.uniform(0, 255, (2, HW, HW, 3))
                                           .astype(np.float32)) for _ in range(2))
                    for _ in range(2)]
    out["trunks"] = {}
    with pytest.MonkeyPatch.context() as mp:
        for trunk in TRUNKS:
            variant, wt, _wtloss, _jm, params, stats = zoo_trunk_reference(mp, trunk, HW)
            out["trunks"][trunk] = dict(variant=variant, wt=wt,
                                        sd=state_dict_from_jax(params, stats))
    mob = out["trunks"]["mobilenetv2"]
    jm = jax_zoo.DeepV3Plus(trunk="mobilenetv2", variant=mob["variant"], wt_layer=(0,) * 7,
                            use_dsn=True)
    params, stats = random_variables(jm, np.zeros((1, HW, HW, 3), np.float32), seed=12,
                                     train=False)
    out["mobilenet_sd"] = state_dict_from_jax(damp_last_bns(params), stats)
    # unit-scale inputs, as tests/test_torch_spatial.py's eval: at image scale
    # SE-ResNeXt-50's logits reach ~470, and fp32 alone then moves them 4e-4
    # from fp64, past the atol
    out["x_eval"] = _tensor(4, (2, 3, HW, HW), torch.float32)
    return out


def _step_kwargs(s, plan: str) -> dict:
    p = s["plans"][plan]
    masks = s["masks"][plan]
    return dict(sd=p["sd"], img=s["img"], lbl=s["lbl"], masks=masks,
                nrc=[float(m.sum()) for m in masks],
                keep=s["jax_keep"] if plan == "isw" else s["keep"], wt=cases.PLANS[plan])


def _mobilenet_kwargs(s) -> dict:
    var = s["trunks"]["mobilenetv2"]["variant"]
    return dict(sd=s["mobilenet_sd"], img=s["img"], lbl=s["lbl"], masks=None, nrc=None,
                keep=None, trunk="mobilenetv2", variant=var, wt=(0,) * 7, use_wtloss=False)


def _jobs(s):
    four, two = {}, {}
    for sp in (2, 3, 4):
        for dtype in ("float64", "float32"):
            four[f"pool{sp}_{dtype}"] = ("pool_case", _pool_inputs(sp, getattr(torch, dtype)))
        four[f"wtloss{sp}"] = ("wtloss_case", dict(_wtloss_inputs(torch.float32), sp=sp))
    for mode, sp, h in SW_CASES:
        for t in SW_TYPES:
            for dtype in ("float64", "float32"):
                job = two if (mode, sp) == ("train", 2) else four
                job[f"sw_{mode}{sp}_{t}_{dtype}"] = (
                    "sw_case", dict(_sw_inputs(t, h, getattr(torch, dtype)),
                                    train=mode == "train", sp=sp))
    for h in (13, 16):
        for dtype in ("float64", "float32"):
            two[f"se{h}_{dtype}"] = ("se_block_case", dict(_se_inputs(h, getattr(torch, dtype)),
                                                           sp=2))
    four["covstat_2x2"] = ("covstat_case", dict(sd=s["plans"]["isw"]["sd"], pairs=s["pairs"],
                                                dp=2, sp=2))
    four["step_isw_2x2"] = ("zoo_step_case", dict(_step_kwargs(s, "isw"), dp=2, sp=2))
    two["covstat_1x2"] = ("covstat_case", dict(sd=s["plans"]["isw"]["sd"], pairs=s["pairs"],
                                               dp=1, sp=2))
    for trunk in TRUNKS:
        t = s["trunks"][trunk]
        two[f"eval_{trunk}"] = ("trunk_eval_case", dict(sd=t["sd"], trunk=trunk,
                                                        variant=t["variant"], wt=t["wt"],
                                                        x=s["x_eval"], sp=2))
    two["step_isw_1x2"] = ("zoo_step_case", dict(_step_kwargs(s, "isw"), dp=1, sp=2))
    two["step_sw_1x2"] = ("zoo_step_case", dict(_step_kwargs(s, "sw"), dp=1, sp=2))
    two["step_mobilenet_1x2"] = ("zoo_step_case", dict(_mobilenet_kwargs(s), dp=1, sp=2))
    return four, two


@pytest.fixture(scope="module")
def groups(setup, tmp_path_factory):
    four, two = _jobs(setup)
    g4 = Group(four, tmp_path_factory.mktemp("spatial_zoo4"), cases="torch_spatial_zoo_cases",
               world=4)
    g2 = Group(two, tmp_path_factory.mktemp("spatial_zoo2"), cases="torch_spatial_zoo_cases",
               world=2)
    yield {4: g4, 2: g2}
    g4.close()
    g2.close()


def _ranks(group, name: str, sp: int) -> list:
    """The results of ranks ``0..sp-1`` of case ``name``."""
    got = group.take(name)
    assert all(g == {"skip": True} for g in got[sp:]), name
    return got[:sp]


def _one(group, name: str, **change):
    """Case ``name`` in this process on the whole map (a step or the
    statistics pass: without a process group)."""
    case, kwargs = group.job[name]
    kwargs = dict(kwargs, **change)
    if case in ("pool_case", "sw_case", "wtloss_case", "trunk_eval_case", "se_block_case"):
        kwargs["sp"] = 1
    return getattr(cases, case)(**kwargs)


# -- the primitives -----------------------------------------------------------

@pytest.mark.parametrize("sp", [2, 3, 4])
def test_ceil_mode_max_pool_on_bands_is_the_whole_pool(groups, sp):
    """SE-ResNeXt's stem pool (3x3, stride 2, ceil mode) at every height
    15..70, fp64 and fp32: the last band's windows read past the bottom
    (-inf there); each rank's output band is ``F.max_pool2d(ceil_mode=
    True)``'s rows bit for bit, its input band's gradient the whole pool's
    rows."""
    for dtype in ("float64", "float32"):
        name = f"pool{sp}_{dtype}"
        got = _ranks(groups[4], name, sp)
        inp = groups[4].job[name][1]
        for i, (x, dy) in enumerate(zip(inp["xs"], inp["dys"])):
            xw = x.clone().requires_grad_(True)
            out = F.max_pool2d(xw, 3, 2, ceil_mode=True)
            (out * dy).sum().backward()
            for r, res in enumerate(got):
                o0, o1 = band(out.shape[2], sp, r)
                b0, b1 = band(x.shape[2], sp, r)
                assert torch.equal(res["out"][i], out.detach()[:, :, o0:o1]), (dtype, sp, i, r)
                _rel_close(res["dx"][i], xw.grad[:, :, b0:b1],
                           1e-12 if dtype == "float64" else 1e-6, (dtype, sp, i, r))


def _merged(got: list, k: str) -> torch.Tensor:
    """The ranks' ``k``: their bands of a map joined, else rank 0's (equal
    on every rank)."""
    if k in ("out", "dx"):
        return torch.cat([g[k] for g in got], dim=2)
    for g in got[1:]:
        assert torch.equal(g[k], got[0][k]), k
    return got[0][k]


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


MIXING = ("d_sw_mean_weight", "d_sw_var_weight")


@pytest.mark.parametrize("mode,sp,h", SW_CASES)
def test_switchwhiten_on_bands_is_the_layer_on_the_whole_map(groups, mode, sp, h):
    """``SwitchWhiten2d`` types 2, 3 and 5 on bands of an odd or even map
    (train mode: the BW statistics over the world, the IW and LN ones over
    the group; eval mode: BW from the running buffers) against the layer
    on the whole map: the output, the gradients of the input, the weight
    and bias and the mixing weights (summed over the ranks) and the
    running statistics; the ranks hold the same summed gradients and
    statistics."""
    group = groups[2 if (mode, sp) == ("train", 2) else 4]
    for t in SW_TYPES:
        name = f"sw_{mode}{sp}_{t}_float64"
        truth = _one(group, name)
        got = _ranks(group, name, sp)
        for k, v in truth.items():
            _rel_close(_merged(got, k), v, 1e-12, (name, k))
        name = f"sw_{mode}{sp}_{t}_float32"
        one = _one(group, name)
        got = _ranks(group, name, sp)
        for k, v in one.items():
            two = _merged(got, k)
            if k in MIXING:
                assert _rel(two, truth[k]) <= 3 * _rel(v, truth[k]) + 1e-6, \
                    (name, k, _rel(two, truth[k]), _rel(v, truth[k]))
            else:
                _rel_close(two, v, 1e-5 if k.startswith("d") else 1e-6, (name, k))


@pytest.mark.parametrize("sp", [2, 3, 4])
def test_whitening_loss_and_covariance_variance_on_bands(groups, sp):
    """``instance_whitening_loss`` over the bands of two maps (19 and 9
    rows, 16 and 32 channels): the ranks' shares sum to the whole maps'
    loss within 1e-6, each band's gradient is the whole gradient's rows
    within 1e-5 (the loss is fp32 on any input, as JAX's); each rank's
    ``covariance_variance`` (fp64 sums, an fp32 result) is the whole map's
    within 1e-6."""
    name = f"wtloss{sp}"
    one = _one(groups[4], name)
    got = _ranks(groups[4], name, sp)
    _rel_close(sum(g["loss"] for g in got), one["loss"], 1e-6, (name, "loss"))
    for i in range(2):
        dx = torch.cat([g["dx"][i] for g in got], dim=2)
        _rel_close(dx, one["dx"][i], 1e-5, (name, "dx", i))
        for g in got:
            _rel_close(g["var"][i], one["var"][i], 1e-6, (name, "var", i))


@pytest.mark.parametrize("h", [13, 16])
def test_se_bottleneck_on_bands_is_the_whole_block(groups, h):
    """SE-ResNeXt's bottleneck in train mode on two bands of a 13- or 16-row
    map: its grouped 3x3 and 1x1 downsample of stride 2 on the fetched
    rows, the SE module's mean over the group and its two 1x1s on the
    replicated pooled map. Against the block on the whole map: the output,
    the input's gradient and every parameter's (summed over the ranks),
    within 1e-12 of the largest value in fp64, 1e-5 in fp32 (1e-6 the
    output)."""
    for dtype, tol in (("float64", 1e-12), ("float32", 1e-5)):
        name = f"se{h}_{dtype}"
        one = _one(groups[2], name)
        got = _ranks(groups[2], name, 2)
        _rel_close(torch.cat([g["out"] for g in got], dim=2), one["out"],
                   1e-12 if dtype == "float64" else 1e-6, (name, "out"))
        _rel_close(torch.cat([g["dx"] for g in got], dim=2), one["dx"], tol, (name, "dx"))
        for k, v in one["dparams"].items():
            for g in got:
                _rel_close(g["dparams"][k], v, tol, (name, k))


# -- the zoo steps ------------------------------------------------------------

_STEPS = {}


def _one_step(groups, name: str, group: int = 2):
    """The one-process step of case ``name`` and its 1e-7-input control."""
    key = name.rsplit("_", 1)[0]
    if key not in _STEPS:
        kwargs = dict(groups[group].job[name][1], dp=1, sp=1)
        _STEPS[key] = (cases.zoo_step_case(**kwargs),
                       cases.zoo_step_case(**dict(kwargs, img=perturbed(kwargs["img"]))))
    return _STEPS[key]


def _held(got: list, one: dict, control: dict, what: str, ref64: dict = None) -> dict:
    """The ranks' step against one process's: the ranks equal bit for bit,
    the losses within 1e-4, every gradient and updated tensor by the
    control rule, or, with ``ref64`` (fp64 gradients), no further from
    fp64 than the one-process step (``as_close_as_the_control_or_fp64``)."""
    two, others = got[0], got[1:]
    for other in others:
        assert other["losses"] == two["losses"], what
        for part in ("grads", "state"):
            assert other[part] == {k: digest(v) for k, v in two[part].items()}, (what, part)
    for k, v in one["losses"].items():
        assert abs(two["losses"][k] - v) <= 1e-4 * abs(v), (what, k, two["losses"][k], v)
    for part in ("grads", "state"):
        if ref64 is None:
            as_close_as_the_control(two[part], one[part], control[part], f"{what} {part}")
        else:
            as_close_as_the_control_or_fp64(two[part], one[part], control[part], ref64,
                                            None if part == "grads" else one["grads"],
                                            f"{what} {part}")
    return two


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_zoo_isw_step_on_bands_takes_the_one_process_step_and_jax_s(setup, groups, mesh):
    """The ISW plan (r18-D32, ISW in layer1 and layer2, the whitening
    loss, the DSN head with JAX's keep mask) on a (dp, sp) mesh of bands
    against one process on the whole batch and against JAX's
    ``zoo_train_step`` on one device: the losses within 5e-4, every
    gradient (read back from JAX's update at lr 1) within 1e-2 of its
    norm (norm scales 5e-2), the BN statistics 2e-3, or, where the
    one-process step already lies further from JAX, within that distance
    plus 3x the control's. The halo rows and the bands' statistics cross
    the spatial group."""
    dp, sp = (int(v) for v in mesh.split("x"))
    got = _ranks(groups[dp * sp], f"step_isw_{mesh}", dp * sp)
    one, control = _one_step(groups, "step_isw_1x2")
    two = _held(got, one, control, f"isw {mesh}")
    spatial = two["collectives"]["spatial"]
    assert spatial["halo"]["count"] > 0 and spatial["stats"]["count"] > 0
    assert "halo" not in two["collectives"].get("world", {})
    plan = setup["plans"]["isw"]
    jcfg = JaxConfig()
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, use_wtloss=True),
                        train=dataclasses.replace(jcfg.train, lr=1.0))
    jstate = jax_create_train_state(plan["jmodel"], jcfg.train, (1, HW, HW, 3))
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, plan["params"]),
                            batch_stats=jax.tree_util.tree_map(jnp.asarray, plan["stats"]))
    masks = setup["masks"]["isw"]
    step = jax.jit(functools.partial(jax_zoo_train_step, model=plan["jmodel"], cfg=jcfg,
                                     wt_masks=[jnp.asarray(m.numpy()) for m in masks],
                                     wt_nrc=[float(m.sum()) for m in masks]))
    jstate, m = step(jstate, jnp.asarray(setup["img"].numpy()),
                     jnp.asarray(setup["lbl"].numpy()))
    for k, v in two["losses"].items():
        assert abs(v - float(m[k])) < 5e-4, (k, v, float(m[k]))
    after = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                                jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    start = plan["sd"]
    wd = cases.zoo_cfg("resnet-18", "D32", cases.PLANS["isw"], True).train.weight_decay
    for k, v in after.items():
        if k.endswith("num_batches_tracked"):  # JAX keeps no count
            continue
        if "running" in k:
            err = float((two["state"][k] - v).norm()) - 2e-3 * float(v.norm())
            allow = float((one["state"][k] - v).norm()) - 2e-3 * float(v.norm())
            slack = 3 * float((control["state"][k] - one["state"][k]).norm())
        else:
            p0 = start[k].double()
            g_jax = (p0 - v.double()) - wd * p0
            bound = (5e-2 if k.endswith("weight") and v.dim() == 1 else 1e-2) * \
                float(g_jax.norm()) + 1e-6
            err = float((two["grads"][k].double() - g_jax).norm()) - bound
            allow = float((one["grads"][k].double() - g_jax).norm()) - bound
            slack = 3 * float((control["grads"][k] - one["grads"][k]).norm())
        assert err <= max(0.0, allow) + slack, (k, err, allow, slack)


@pytest.mark.parametrize("plan", ["sw", "mobilenet"])
def test_zoo_step_on_bands_takes_the_one_process_step(groups, plan):
    """sp = 2 against one process on the whole batch: the SwitchWhiten
    plan (ISW in the stem and layer1, SwitchWhiten in layer2, whose IW
    covariance spans the bands and whose BW statistics span the world;
    a seeded keep mask), and MobileNetV2 with no whitening (the depthwise
    convs' backward on bands; the keep mask drawn from the step's stream,
    the band of the global draw). In MobileNetV2's step the ASPP image
    pool's BatchNorm over 4 samples' 1x1 maps amplifies the pooled means'
    last bits past what a 1e-7 change of the input moves: a tensor past
    the control rule is held to the step in fp64 instead (``_held``)."""
    name = f"step_{plan}_1x2"
    got = _ranks(groups[2], name, 2)
    one, control = _one_step(groups, name)
    ref64 = cases.zoo_fp64_grads(**groups[2].job[name][1]) if plan == "mobilenet" else None
    _held(got, one, control, plan, ref64)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_statistics_pass_on_bands_gives_one_process_s_masks(groups, mesh):
    """The statistics pass with each rank on its band of every view (the
    spatial group's sums of f f^T): every rank's masks and counts equal,
    bit for bit, those of one process over the same pairs, the pairs at
    the JAX trainer's batch for that process count."""
    dp, sp = (int(v) for v in mesh.split("x"))
    got = _ranks(groups[dp * sp], f"covstat_{mesh}", dp * sp)
    one = _one(groups[dp * sp], f"covstat_{mesh}", dp=1, sp=1)
    assert sum(float(m.sum()) for m in one["masks"]) > 0
    for r in got:
        assert r["nrc"] == one["nrc"]
        for a, b in zip(r["masks"], one["masks"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("trunk", TRUNKS)
def test_zoo_trunk_eval_on_bands_is_the_whole_forward(groups, trunk):
    """The eval forward of the zoo model over MobileNetV2 (ISW, SwitchWhiten
    and IN slots), ShuffleNetV2 (D, every code), MNASNet-0.5 and
    SE-ResNeXt-50 (its ceil-mode stem pool and SE pools; layer4 at 2 rows,
    one a rank) with H split in two, against the whole map's: atol 2e-4,
    rtol 1e-4."""
    got = _ranks(groups[2], f"eval_{trunk}", 2)
    one = _one(groups[2], f"eval_{trunk}")
    logits = torch.cat([g["logits"] for g in got], dim=2)
    torch.testing.assert_close(logits, one["logits"], atol=2e-4, rtol=1e-4)


# -- the entry points ---------------------------------------------------------

def _losses(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])["losses"]


def test_cli_train_zoo_on_a_spatial_mesh_matches_one_process(tmp_path):
    """``cli.train_zoo --device cpu --num-processes 2 --spatial-parallel 2``
    (r18-D32 at crop 64, fp32, global batch 2, ISW and SwitchWhiten slots,
    the DSN head): both ranks take two steps with rc 0 and log the same
    losses, and the first is one process's within 1e-4."""
    argv = ["-m", "mrfp_tpu_torch.cli.train_zoo", "--device", "cpu", "--synthetic",
            "--trunk", "resnet-18", "--variant", "D32", "--wt-layer", "0", "0", "2", "2", "5",
            "0", "0", "--crop-size", "64", "--batch-size", "2", "--no-bf16", "--log-every", "1"]
    procs = [subprocess.Popen([sys.executable, *argv, "--max-iter", "2", "--runs-dir",
                               str(tmp_path / "sp"), "--num-processes", "2", "--process-id",
                               str(r), "--coordinator-address", f"file://{tmp_path}/rdv",
                               "--spatial-parallel", "2"],
                              cwd=REPO, env=env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    one = subprocess.run([sys.executable, *argv, "--max-iter", "1", "--runs-dir",
                          str(tmp_path / "one")], cwd=REPO, env=env(), capture_output=True,
                         text=True, timeout=600)
    assert one.returncode == 0, one.stderr[-2000:]
    got = [_losses(o[0]) for o in outs]
    want = _losses(one.stdout)
    assert got[0] == got[1] and sorted(got[0]) == ["1", "2"]
    assert abs(got[0]["1"] - want["1"]) <= 1e-4 * abs(want["1"]), (got, want)


def test_cli_eval_of_a_zoo_model_on_a_spatial_mesh_prints_one_process_s_results(tmp_path):
    """``cli.eval --arch DeepSEResNext50V3PlusD --spatial-parallel 2`` (the
    ceil-mode stem pool and the SE pools on bands) starts its two ranks
    itself and prints what one process prints, the speed apart."""
    argv = ["-m", "mrfp_tpu_torch.cli.eval", "--device", "cpu", "--synthetic",
            "--synthetic-hw", "64", "64", "--max-images", "1", "--arch",
            "DeepSEResNext50V3PlusD", "--domains", "cityscapes"]
    runs = {}
    for name, extra in (("one", []), ("two", ["--spatial-parallel", "2"])):
        out = tmp_path / f"{name}.json"
        proc = subprocess.run([sys.executable, *argv, *extra, "--json-out", str(out)],
                              cwd=REPO, env=env(), capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert proc.stdout.count('"mean_iu"') == 1  # rank 0 alone prints
        runs[name] = json.load(open(out))
        for r in runs[name].values():
            r.pop("images_per_s")
    assert runs["two"] == runs["one"]


def test_statistics_pairs_stay_at_the_jax_trainers_batch_under_spatial_parallelism():
    """The statistics phase's pairs are the global batch over the process
    count, as JAX launched on as many processes takes them, whatever the
    spatial axis: at batch 4 on 4 processes (2 x 2) and on 2 (1 x 2), the
    pairs' batch is 1 and 2, the data axis apart."""
    from mrfp_tpu_torch.cli import train_zoo
    from mrfp_tpu_torch.data import SyntheticDataset
    ds = SyntheticDataset(length=8, hw=(32, 32))
    for nproc, sp in ((4, 2), (2, 2), (2, 1)):
        args = train_zoo.parse_args(["--batch-size", "4", "--covstat-batches", "2",
                                     "--num-processes", str(nproc), "--spatial-parallel",
                                     str(sp), "--crop-size", "32", "--trunk", "resnet-18"])
        train_zoo.check_args(args)
        pairs = train_zoo.statistics_pairs(args, ds, nproc)
        assert [p[0].shape[0] for p in pairs] == [4 // nproc] * 2
