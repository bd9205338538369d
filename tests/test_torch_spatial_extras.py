"""Spatial parallelism of the training extras on the CPU: the border-relaxed
CE, the class weights, the FFT transforms and the fused BN statistics with
image H split in bands of rows across gloo ranks (``core/mesh.py``),
against one process on the whole map.

Two process groups (``torch_dist_group.Group``: file rendezvous, gloo, one
torch thread a rank) run the cases of ``torch_spatial_extras_cases.py``
while this process computes the whole-map results:

- a world of 4: the relaxed target at drawn heights, borders and
  ``reduce_now`` on spatial groups of 2, 3 and 4 (windows that reach past
  a neighbour's band among them); the relaxed CE and the class weights on
  the 4; ``conv1x1_with_stats`` (the plain ``dot_with_stats``) at stride 1
  and 2 on odd heights on groups of 2, 3 and 4;
- a world of 2: one fp32 MRFP+ step (resnet-50 at depth (1, 1, 1, 1), D16,
  64 px, batch 4, the damped fixture, every gate off: the gated step on
  bands is tests/test_torch_spatial.py's) per extra at sp = 2:
  ``--jointwtborder`` with its window whole and halved (``reduce_now``,
  strict classes), each of ``hpf`` (with the class weights), ``lpf`` and
  ``phot``, and ``fuse_bn_stats``.

Bounds:

- The relaxed target (``allowed``, ``weight``): each rank's band is the
  whole map's target's rows, bit for bit.
- The relaxed CE: the ranks' losses sum to the whole map's within 1e-6,
  each band's logits gradient the whole gradient's rows within 1e-6; the
  class weights every rank's equal to the whole batch's, bit for bit.
- ``conv1x1_with_stats``: ``y`` bit-equal to the whole map's rows in fp64,
  the group's ``s1``, ``s2``, the weight's gradient and the input band's
  gradient within 1e-12 (fp64, 1e-5 in fp32) of their largest value, ``n``
  equal.
- Each step: the loss within 1e-4 relative of one process's, every
  gradient and updated tensor within 3x a 1e-7-input control + 1e-4 of
  its norm, or, where the ASPP image pool's BatchNorm over the batch's
  1x1 maps amplifies the ranks' last bits past what the control moves, no
  further from the step in fp64 than 3x the one-process step + 1e-4
  (``torch_step_checks.as_close_as_the_control_or_fp64``); the ranks
  equal bit for bit; the halo rows cross the spatial group only.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, Phase, given, settings
from hypothesis import strategies as st

from mrfp_tpu_torch.parallel.dist import band

import torch_spatial_extras_cases as cases
from torch_dist_cases import digest
from torch_dist_group import Group
from torch_step_checks import as_close_as_the_control_or_fp64, perturbed

torch.set_num_threads(2)

HW, N = cases.HW, 4
W = 11  # the primitives' width


def _drawn(strategy, n: int) -> list:
    """``n`` examples of ``strategy``, the same on every run."""
    out = []

    @settings(max_examples=n, derandomize=True, database=None, deadline=None,
              phases=[Phase.generate], suppress_health_check=list(HealthCheck))
    @given(strategy)
    def collect(example):
        out.append(example)

    collect()
    return out


@st.composite
def _relaxed_example(draw):
    sp = draw(st.sampled_from([2, 3, 4]))
    return dict(sp=sp, h=draw(st.integers(sp, 30)), border=draw(st.integers(0, 4)),
                reduce_now=draw(st.booleans()),
                strict=draw(st.sampled_from([None, (0,), (1, 3)])))


@st.composite
def _conv1x1_example(draw):
    sp = draw(st.sampled_from([2, 3, 4]))
    stride = draw(st.sampled_from([1, 2]))
    h = 2 * draw(st.integers(sp * stride // 2 + 1, 16)) + 1  # odd
    return dict(sp=sp, h=h, stride=stride, dtype=draw(st.sampled_from(["float64", "float32"])))


RELAXED = _drawn(_relaxed_example(), 24)
CONV1X1 = _drawn(_conv1x1_example(), 16) + [dict(sp=2, h=15, stride=2, dtype="float64"),
                                            dict(sp=3, h=15, stride=2, dtype="float32")]


def _tensor(seed: int, shape, dtype=torch.float64) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)).to(dtype)


def _labels(seed: int, h: int, n: int = 2) -> torch.Tensor:
    """Blocky labels (runs of a class, so the windows and boundaries see
    structure) with ignore pixels."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 6, (n, (h + 2) // 3, (W + 2) // 3))
    lbl = np.repeat(np.repeat(coarse, 3, axis=1), 3, axis=2)[:, :h, :W]
    lbl[rng.random(lbl.shape) < 0.05] = 255
    return torch.from_numpy(lbl.astype(np.int64))


def _relaxed_inputs(i: int, ex: dict) -> dict:
    return dict(labels=_labels(100 + i, ex["h"]), border=ex["border"],
                reduce_now=ex["reduce_now"], strict=ex["strict"], sp=ex["sp"])


def _conv1x1_inputs(i: int, ex: dict) -> dict:
    dtype = getattr(torch, ex["dtype"])
    x = _tensor(200 + i, (2, 6, ex["h"], 7), dtype)
    oh = (ex["h"] - 1) // ex["stride"] + 1
    ow = (7 - 1) // ex["stride"] + 1
    return dict(x=x, weight=_tensor(300 + i, (5, 6), dtype) * 0.4, stride=ex["stride"],
                dy=_tensor(400 + i, (2, 5, oh, ow), dtype), a=_tensor(500 + i, (5,), dtype),
                b=_tensor(600 + i, (5,), dtype) * 0.1, sp=ex["sp"])


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    img = rng.standard_normal((N, HW, HW, 3)).astype(np.float32)
    lbl = rng.integers(0, 19, (N, HW, HW)).astype(np.int64)
    lbl[:, 20:30, 10:40] = 5  # a region, so the border windows see a boundary
    lbl[0, :5] = 255
    h = 21
    return dict(sd=cases.fixture_state(), img=torch.from_numpy(img),
                lbl=torch.from_numpy(lbl),
                logits=_tensor(700, (2, 19, h, W), torch.float32) * 2,
                loss_labels=_labels(701, h))


def _jobs(s):
    four, two = {}, {}
    for i, ex in enumerate(RELAXED):
        four[f"relaxed{i}"] = ("relaxed_case", _relaxed_inputs(i, ex))
    for reduce_now in (False, True):
        four[f"relaxed_loss_{reduce_now}"] = ("relaxed_loss_case", dict(
            logits=s["logits"], labels=s["loss_labels"], border=2, reduce_now=reduce_now,
            sp=4))
    for i, ex in enumerate(CONV1X1):
        four[f"conv1x1_{i}"] = ("conv1x1_case", _conv1x1_inputs(i, ex))
    for extra in cases.EXTRAS:
        two[f"step_{extra}"] = ("extras_step_case", dict(sd=s["sd"], img=s["img"],
                                                         lbl=s["lbl"], extra=extra, dp=1,
                                                         sp=2))
    return four, two


@pytest.fixture(scope="module")
def groups(setup, tmp_path_factory):
    four, two = _jobs(setup)
    g4 = Group(four, tmp_path_factory.mktemp("spatial_extras4"),
               cases="torch_spatial_extras_cases", world=4)
    g2 = Group(two, tmp_path_factory.mktemp("spatial_extras2"),
               cases="torch_spatial_extras_cases", world=2)
    yield {4: g4, 2: g2}
    g4.close()
    g2.close()


def _ranks(group, name: str, sp: int) -> list:
    got = group.take(name)
    assert all(g == {"skip": True} for g in got[sp:]), name
    return got[:sp]


def _one(group, name: str):
    case, kwargs = group.job[name]
    if case == "extras_step_case":
        kwargs = dict(kwargs, dp=1, sp=1)
    else:
        kwargs = dict(kwargs, sp=1)
    return getattr(cases, case)(**kwargs)


def _rel_close(got, want, tol: float, what) -> None:
    err = float((got.double() - want.double()).abs().max())
    scale = max(1e-30, float(want.double().abs().max()))
    assert err <= tol * scale, (what, err, tol * scale)


# -- the primitives -----------------------------------------------------------

def test_relaxed_target_on_bands_is_the_whole_target(groups):
    """The multi-hot target and the weights of the border-relaxed CE at
    drawn heights (down to one row a rank), borders 0-4 (windows reaching
    past the neighbour's band), ``reduce_now`` both ways (the halved window
    and the boundary weight, which compares across a band's edge but not
    past the image's) and strict classes, on groups of 2, 3 and 4: each
    rank's band is the whole map's target's rows, bit for bit."""
    for i, ex in enumerate(RELAXED):
        name = f"relaxed{i}"
        one = _one(groups[4], name)
        for r, res in enumerate(_ranks(groups[4], name, ex["sp"])):
            lo, hi = band(ex["h"], ex["sp"], r)
            assert torch.equal(res["allowed"], one["allowed"][:, :, lo:hi]), (i, r, ex)
            assert torch.equal(res["weight"], one["weight"][:, lo:hi]), (i, r, ex)
        if ex["reduce_now"]:
            assert one["weight"].max() == 2.0, ex


@pytest.mark.parametrize("reduce_now", [False, True])
def test_relaxed_cross_entropy_and_class_weights_on_bands(groups, reduce_now):
    """On a group of 4 (21 rows, 5 or 6 a rank): the ranks' relaxed CE (the
    band's numerator over the world's weight sum) sums to the whole map's,
    each band's logits gradient is the whole gradient's rows, and the
    class weights from the world's histogram are the whole batch's."""
    name = f"relaxed_loss_{reduce_now}"
    one = _one(groups[4], name)
    got = _ranks(groups[4], name, 4)
    _rel_close(sum(g["loss"] for g in got), one["loss"], 1e-6, name)
    _rel_close(torch.cat([g["dlogits"] for g in got], dim=2), one["dlogits"], 1e-6, name)
    for g in got:
        assert torch.equal(g["class_weights"], one["class_weights"]), name


def test_conv1x1_with_stats_on_bands_is_the_whole_product(groups):
    """``conv1x1_with_stats`` at stride 1 and 2 on odd heights (a strided
    output band reads global rows ``2 o``, which need not lie in the
    rank's own band nor share its parity) on groups of 2, 3 and 4:
    ``y`` is the whole product's rows, the group's ``s1``, ``s2`` and
    ``n`` the whole map's, and the gradients the whole map's."""
    for i, ex in enumerate(CONV1X1):
        name = f"conv1x1_{i}"
        one = _one(groups[4], name)
        fp64 = ex["dtype"] == "float64"
        tol = 1e-12 if fp64 else 1e-5
        got = _ranks(groups[4], name, ex["sp"])
        ys = torch.cat([g["y"] for g in got], dim=2)
        if fp64:
            assert torch.equal(ys, one["y"]), (i, ex)
        else:
            _rel_close(ys, one["y"], 1e-6, (i, "y"))
        _rel_close(torch.cat([g["dx"] for g in got], dim=2), one["dx"], tol, (i, "dx"))
        for g in got:
            for k in ("s1", "s2", "dw"):
                _rel_close(g[k], one[k], tol, (i, k, ex))
            assert torch.equal(g["n"], one["n"]), (i, ex)


# -- the steps ----------------------------------------------------------------

@pytest.mark.parametrize("extra", list(cases.EXTRAS))
def test_extras_step_on_bands_takes_the_one_process_step(setup, groups, extra):
    """One fp32 MRFP+ step with the extra on two bands against one process
    on the whole batch: the border-relaxed CE with its window whole (2) and
    halved (3 // 2, the boundary weight, strict classes), HPF (with the
    class weights), LPF and PHOT on the whole images before the band is
    cut, and the fused BN statistics (``dot_with_stats`` on the fetched
    rows of the strided 1x1s). The halo rows cross the spatial group only;
    the fused step's BatchNorms take the world's sums."""
    got = _ranks(groups[2], f"step_{extra}", 2)
    name = f"step_{extra}"
    one = _one(groups[2], name)
    control = cases.extras_step_case(**dict(groups[2].job[name][1], dp=1, sp=1,
                                            img=perturbed(setup["img"])))
    two = got[0]
    assert got[1]["loss"] == two["loss"]
    for part in ("grads", "state"):
        assert got[1][part] == {k: digest(v) for k, v in two[part].items()}, part
    halo = two["collectives"]["spatial"]["halo"]
    assert halo["count"] > 0 and "halo" not in two["collectives"].get("world", {})
    assert abs(two["loss"] - one["loss"]) <= 1e-4 * abs(one["loss"]), (two["loss"], one["loss"])
    ref64 = cases.extras_fp64_grads(**groups[2].job[name][1])
    for part in ("grads", "state"):
        as_close_as_the_control_or_fp64(two[part], one[part], control[part], ref64,
                                        None if part == "grads" else one["grads"],
                                        f"{extra} {part}")
