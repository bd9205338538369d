"""Spatial parallelism of the port on the CPU: image H split in bands of
rows across gloo ranks (``core/mesh.py``), against one process on the whole
map and against the JAX package (whose meshed results tests/test_spatial.py
holds to its one-device ones).

Two process groups (``torch_dist_group.Group``: file rendezvous, gloo, one
torch thread a rank) run the cases of ``torch_spatial_cases.py`` while this
process computes the whole-map results and the JAX ones:

- a world of 4: the band primitives at hypothesis-drawn heights on spatial
  groups of 2, 3 and 4 ranks (``rows_from_group``, the conv at stride 1/2
  and dilation 1/2/6/18, the max pool, the instance norm), the sp = 4 eval
  forward and ``SegEvaluator``, and the 2 x 2 (data x spatial) step;
- a world of 2: the sp = 2 step.

Bounds:

- ``rows_from_group``: the forward equals slicing the padded map, bit for
  bit; the backward, the autograd of that slicing, within 1e-12 (fp64:
  the order of a sum of at most ``sp`` cotangents).
- The band conv and max pool against the rows of the whole op: the forward
  bit-equal in fp64 (the pool in fp32 too), 1e-6 relative in fp32; the
  input's and the parameters' gradients within 1e-12 (fp64) and 1e-5
  (fp32) of their largest value. The instance norm within 1e-6 (fp32) and
  1e-12 (fp64) of ``nn.InstanceNorm2d`` on the whole map.
- The band tables: equal to the global table's rows, and a band resize
  (both kernels' plain versions) exactly the global resize's rows forward,
  and its backward's bands summing to the global backward within 1e-6.
- The MRFP+ step (resnet-50 at depth (1, 1, 1, 1), D16, 64 px, batch 4,
  every gate on, JAX's OC re-draw and NP+ draws injected, the damped
  fixture, fp32): the loss within 1e-4 relative of one process's (JAX's
  test_spatial_train_step_loss_invariant bound), every gradient, parameter
  and BN statistic as ``torch_step_checks.as_close_as_the_control`` holds
  them (3x a 1e-7-input control + 1e-4 of the norm), the ranks equal bit
  for bit; against JAX's one-device step as the one-process step lies
  (``torch_step_checks.against_jax``).
- Eval at sp = 4: the logits within atol 2e-4, rtol 1e-4 of the unsharded
  forward (test_spatial_eval_logits_match_unsharded) and within the family
  bound of JAX's (atol 5e-4, rtol 1e-3); the evaluator's histograms at
  eval_batch 1 and 2 equal to one process's, bit for bit.
- Entry points: ``cli.train --num-processes 2 --spatial-parallel 2`` (fp32)
  takes two steps, its first loss within 1e-4 of one process's, and a step
  with ``--jointwtborder`` or ``--freq-transform phot``; ``cli.eval
  --spatial-parallel 2`` prints one process's results; a model axis whose
  product with the spatial one does not divide the processes raises.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import HealthCheck, Phase, assume, given, settings
from hypothesis import strategies as st

from mrfp_tpu.core.config import mrfp_plus_config as jax_mrfp_plus_config
from mrfp_tpu.core.rng import step_keys
from mrfp_tpu.models import MRFP as JaxMRFP
from mrfp_tpu.perturb import oc_init as jax_oc_init
from mrfp_tpu.perturb.oc_branch import oc_maybe_resample as jax_oc_maybe_resample
from mrfp_tpu.train import create_train_state as jax_create_train_state
from mrfp_tpu.train import make_jitted_steps
from mrfp_tpu.train.state import lr_schedule
from mrfp_tpu_torch.cli import eval as cli_eval
from mrfp_tpu_torch.cli import train as cli_train
from mrfp_tpu_torch.core.config import mrfp_plus_config
from mrfp_tpu_torch.ops import cuda_resize
from mrfp_tpu_torch.ops.resize import (bilinear_ac_weights, bilinear_band_rows,
                                       bilinear_band_weights, bilinear_taps, nearest_band_rows,
                                       nearest_index, nearest_table)
from mrfp_tpu_torch.parallel.dist import band
from mrfp_tpu_torch.train.step import band_batch
from mrfp_tpu_torch.weights import oc_state_from_jax, state_dict_from_jax

import torch_spatial_cases as cases
from torch_dist_cases import digest
from torch_dist_group import REPO, Group, env
from torch_port_fixture import np_draws
from torch_step_checks import against_jax, all_gates_key, as_close_as_the_control, jax_cfg
from torch_step_checks import perturbed
from torch_zoo_fixture import jax_vars, nchw, random_variables, reduced_trunk

torch.set_num_threads(2)

HW, N = cases.HW, 4


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
def _rows_example(draw):
    sp = draw(st.sampled_from([2, 3, 4]))
    h = draw(st.integers(sp, 40))
    windows = []
    for _ in range(sp):
        lo = draw(st.integers(-8, h + 2))
        windows.append((lo, lo + draw(st.integers(1, h + 8))))
    return dict(sp=sp, h=h, windows=windows, fill=draw(st.sampled_from([0.0, -2.5])))


@st.composite
def _conv_example(draw):
    sp = draw(st.sampled_from([2, 3, 4]))
    k = draw(st.sampled_from([1, 3]))
    stride = draw(st.sampled_from([1, 2]))
    dilation = draw(st.sampled_from([1, 2, 6, 18])) if k == 3 else 1
    pad = draw(st.sampled_from([0, dilation])) if k == 3 else 0
    h = draw(st.integers(4, 48))
    assume((h + 2 * pad - dilation * (k - 1) - 1) // stride + 1 >= sp)
    return dict(sp=sp, h=h, k=k, stride=stride, dilation=dilation, pad=pad,
                dtype=draw(st.sampled_from(["float64", "float32"])))


@st.composite
def _pool_example(draw):
    sp = draw(st.sampled_from([2, 3, 4]))
    h = draw(st.integers(2 * sp - 1, 40))
    return dict(sp=sp, h=h, dtype=draw(st.sampled_from(["float64", "float32"])))


@st.composite
def _in_example(draw):
    sp = draw(st.sampled_from([2, 3, 4]))
    return dict(sp=sp, h=draw(st.integers(sp, 40)), affine=draw(st.booleans()),
                dtype=draw(st.sampled_from(["float64", "float32"])))


ROWS = _drawn(_rows_example(), 30)
CONVS = _drawn(_conv_example(), 40)
POOLS = _drawn(_pool_example(), 12)
INS = _drawn(_in_example(), 12)
W = 7  # the primitives' width


def _tensor(seed: int, shape, dtype=torch.float64) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)).to(dtype)


def _conv_inputs(i: int, ex: dict) -> dict:
    dtype = getattr(torch, ex["dtype"])
    x = _tensor(100 + i, (2, 3, ex["h"], W + ex["dilation"] * (ex["k"] - 1)), dtype)
    conv = dict(in_channels=3, out_channels=4, kernel_size=ex["k"], stride=ex["stride"],
                padding=ex["pad"], dilation=ex["dilation"], bias=True)
    sd = {"weight": _tensor(200 + i, (4, 3, ex["k"], ex["k"]), dtype) * 0.3,
          "bias": _tensor(300 + i, (4,), dtype)}
    out = F.conv2d(x, sd["weight"], sd["bias"], ex["stride"], ex["pad"], ex["dilation"])
    return dict(x=x, kw=conv, sd=sd, dy=_tensor(400 + i, out.shape, dtype))


def _pool_inputs(i: int, ex: dict) -> dict:
    dtype = getattr(torch, ex["dtype"])
    x = _tensor(500 + i, (2, 3, ex["h"], W), dtype)
    out = F.max_pool2d(x, 3, 2, 1)
    return dict(x=x, kw={}, dy=_tensor(600 + i, out.shape, dtype))


def _in_inputs(i: int, ex: dict) -> dict:
    dtype = getattr(torch, ex["dtype"])
    x = 3.0 + _tensor(700 + i, (2, 5, ex["h"], W), dtype)
    sd = ({"weight": 1 + 0.2 * _tensor(800 + i, (5,), dtype),
           "bias": _tensor(900 + i, (5,), dtype)} if ex["affine"] else None)
    return dict(x=x, kw=dict(num_features=5, eps=1e-5, affine=ex["affine"]), sd=sd,
                dy=_tensor(1000 + i, x.shape, dtype))


def _rows_inputs(i: int, ex: dict) -> dict:
    x = _tensor(1100 + i, (2, 3, ex["h"], W))
    lo, hi = zip(*ex["windows"])
    dys = [_tensor(1200 + 10 * i + r, (2, 3, b - a, W)) for r, (a, b) in enumerate(ex["windows"])]
    return dict(x=x, dys=dys, sp=ex["sp"], lo=list(lo), hi=list(hi), fill=ex["fill"])


@pytest.fixture(scope="module")
def refs():
    """The damped fixture's weights (resnet-50 at reduced depth) as JAX trees
    and the port's state_dicts, JAX's OC re-draw and NP+ draws of a step
    whose gates all fire, the step's batch and the eval input."""
    with pytest.MonkeyPatch.context() as mp:
        trunk = reduced_trunk(mp, "bottleneck")
        jmodel = JaxMRFP(trunk=trunk, variant="D16", hrfp_plus=True)
        params, stats = random_variables(jmodel, np.zeros((1, HW, HW, 3), np.float32),
                                         seed=11, damp=True, train=False)
    oc = jax.tree_util.tree_map(np.asarray, jax_oc_init(jax.random.PRNGKey(1)))
    base_key = all_gates_key()
    keys = step_keys(base_key, 0)
    new_oc = jax.tree_util.tree_map(np.asarray, jax_oc_maybe_resample(
        jax.tree_util.tree_map(jnp.asarray, oc), jnp.asarray(True), keys["oc_resample"],
        jax_mrfp_plus_config().perturb.oc_bn_std))
    rng = np.random.default_rng(7)
    img = rng.standard_normal((N, HW, HW, 3)).astype(np.float32)
    lbl = rng.integers(0, 19, (N, HW, HW)).astype(np.int32)
    lbl[0, :5] = 255
    sd = state_dict_from_jax(params, stats)
    eval_sd = {k: v.clone() for k, v in sd.items()}
    sd.update(oc_state_from_jax(new_oc))
    return dict(trunk=trunk, params=params, stats=stats, oc=oc, base_key=np.asarray(base_key),
                sd=sd, eval_sd=eval_sd, img=torch.from_numpy(img), lbl=torch.from_numpy(lbl),
                draws={"np0": np_draws(keys["np_l0"], 64, N),
                       "np1": np_draws(keys["np_l1"], 256, N)},
                x_eval=_tensor(3, (2, 3, HW, HW), torch.float32))


def _jobs(r):
    four = {}
    for i, ex in enumerate(ROWS):
        four[f"rows{i}"] = ("rows_case", _rows_inputs(i, ex))
    for name, examples, build, op in (("conv", CONVS, _conv_inputs, "conv"),
                                      ("pool", POOLS, _pool_inputs, "pool"),
                                      ("in", INS, _in_inputs, "in")):
        for i, ex in enumerate(examples):
            four[f"{name}{i}"] = ("op_case", dict(op=op, sp=ex["sp"], **build(i, ex)))
    four["eval"] = ("eval_case", dict(sd=r["eval_sd"], x=r["x_eval"], sp=4))
    step = dict(sd=r["sd"], img=r["img"], lbl=r["lbl"], draws=r["draws"])
    four["step_2x2"] = ("step_case", dict(step, dp=2, sp=2))
    two = {"step_1x2": ("step_case", dict(step, dp=1, sp=2))}
    return four, two


@pytest.fixture(scope="module")
def groups(refs, tmp_path_factory):
    four, two = _jobs(refs)
    g4 = Group(four, tmp_path_factory.mktemp("spatial4"), cases="torch_spatial_cases", world=4)
    g2 = Group(two, tmp_path_factory.mktemp("spatial2"), cases="torch_spatial_cases", world=2)
    yield {4: g4, 2: g2}
    g4.close()
    g2.close()


def _ranks(group, name: str, sp: int) -> list:
    """The results of ranks ``0..sp-1`` of case ``name``."""
    got = group.take(name)
    assert all(g == {"skip": True} for g in got[sp:]), name
    return got[:sp]


def _tol_close(got, want, tol: float, what: str) -> None:
    err = float((got.double() - want.double()).abs().max())
    scale = max(1.0, float(want.double().abs().max()))
    assert err <= tol * scale, (what, err, tol * scale)


# -- the primitives -----------------------------------------------------------

def test_rows_from_group_is_slicing_both_ways(groups):
    """Drawn windows per rank (inside the map, across neighbours, past the
    edges, entirely in another rank's band) on groups of 2, 3 and 4: each
    rank's rows are the padded map's, bit for bit, and each rank's band of
    the gradient is the autograd of slicing the whole map."""
    for i, ex in enumerate(ROWS):
        inp = _rows_inputs(i, ex)
        got = _ranks(groups[4], f"rows{i}", ex["sp"])
        x = inp["x"].clone().requires_grad_(True)
        h = ex["h"]
        total = 0
        for r, (a, b) in enumerate(ex["windows"]):
            top, bottom = max(0, -a), max(0, b - h)
            body = x[:, :, max(a, 0):min(b, h)]
            fill = lambda rows: torch.full((2, 3, rows, W), ex["fill"],  # noqa: E731
                                           dtype=torch.float64)
            want = torch.cat([fill(top), body, fill(bottom)], dim=2) if b > 0 and a < h \
                else fill(b - a)
            assert torch.equal(got[r]["out"], want.detach()), (i, r)
            total = total + (want * inp["dys"][r]).sum()
        total.backward()
        for r in range(ex["sp"]):
            b0, b1 = band(h, ex["sp"], r)
            _tol_close(got[r]["dx"], x.grad[:, :, b0:b1], 1e-12, (i, r))


def _whole_op(op: str, inp: dict):
    x = inp["x"].clone().requires_grad_(True)
    if op == "conv":
        module = torch.nn.Conv2d(**inp["kw"]).to(x.dtype)
    elif op == "pool":
        module = torch.nn.MaxPool2d(3, 2, 1)
    else:
        module = torch.nn.InstanceNorm2d(**inp["kw"]).to(x.dtype)
    if inp.get("sd") is not None:
        module.load_state_dict(inp["sd"])
    out = module(x)
    (out * inp["dy"]).sum().backward()
    return out.detach(), x.grad, {k: p.grad for k, p in module.named_parameters()}


@pytest.mark.parametrize("op", ["conv", "pool", "in"])
def test_band_ops_are_the_rows_of_the_whole_op(groups, op):
    """The band conv (stride 1/2, dilation 1/2/6/18, halos reaching past a
    neighbour, uneven heights), the stem's max pool and the spatial
    instance norm on groups of 2, 3 and 4, against the whole map's op
    (``nn.Conv2d``, ``nn.MaxPool2d``, ``nn.InstanceNorm2d``)."""
    examples, build = {"conv": (CONVS, _conv_inputs), "pool": (POOLS, _pool_inputs),
                       "in": (INS, _in_inputs)}[op]
    for i, ex in enumerate(examples):
        inp = build(i, ex)
        out, dx, dparams = _whole_op(op, inp)
        got = _ranks(groups[4], f"{op}{i}", ex["sp"])
        fp64 = ex["dtype"] == "float64"
        for r, res in enumerate(got):
            o0, o1 = band(out.shape[2], ex["sp"], r)
            b0, b1 = band(ex["h"], ex["sp"], r)
            if op == "in":
                _tol_close(res["out"], out[:, :, o0:o1], 1e-12 if fp64 else 1e-6, (op, i, r))
            elif fp64 or op == "pool":
                assert torch.equal(res["out"], out[:, :, o0:o1]), (op, i, r, ex)
            else:
                _tol_close(res["out"], out[:, :, o0:o1], 1e-6, (op, i, r))
            tol = 1e-12 if fp64 else 1e-5
            _tol_close(res["dx"], dx[:, :, b0:b1], tol, (op, i, r, "dx"))
            for k, g in dparams.items():
                _tol_close(res["dparams"][k], g, tol, (op, i, r, k))


@pytest.mark.parametrize("kind", ["bilinear", "nearest"])
def test_band_tables_are_the_global_tables_rows(kind):
    """Every band of every rank of a split over 2, 3 or 4, at the model's
    uneven heights (the OC chain at 768 px, 45 rows) and at scales whose
    band of the global rule differs from the rule applied to the band: the
    band table plus its first input row is the global table's rows; the
    plain resize of the band's input rows is exactly the global resize's
    rows, and the bands' backward gradients, placed at their input rows,
    sum to the global backward. The kernels' plans, made from the band
    table, stage every row it reads."""
    cases_ = [(192, 231), (231, 277), (277, 332), (332, 384), (384, 321), (321, 256),
              (256, 192), (45, 90), (1, 48), (48, 12), (13, 5)]
    gen = torch.Generator().manual_seed(0)
    for h, oh in cases_:
        for sp in (2, 3, 4):
            if oh < sp:
                continue
            x = torch.randn(1, 2, h, 5, generator=gen)
            g = torch.randn(1, 2, oh, 5, generator=gen)
            if kind == "bilinear":
                full_t = bilinear_taps(h, oh, "cpu")
                wt = bilinear_taps(5, 5, "cpu")
                full = cuda_resize.resize_bilinear_plain(x, full_t, wt)
                gfull = cuda_resize.resize_bilinear_bwd_plain(g, full_t, wt, h, 5)
                i0, i1, f = bilinear_ac_weights(h, oh)
            else:
                rule, arg = ("size", oh) if (h, oh) in ((48, 12), (13, 5)) else \
                    ("scale", oh / h + 1e-9)
                full_t = nearest_table(h, rule, arg, "cpu")
                oh = full_t.idx.numel()
                g = g[:, :, :oh]
                wt = nearest_table(5, "size", 5, "cpu")
                full = cuda_resize.resize_nearest_plain(x, full_t, wt)
                gfull = cuda_resize.resize_nearest_bwd_plain(g, full_t, wt, h, 5)
                idx = nearest_index(h, rule, arg)
            summed = torch.zeros_like(gfull)
            for r in range(sp):
                o0, o1 = band(oh, sp, r)
                if kind == "bilinear":
                    lo, hi = bilinear_band_rows(h, oh, o0, o1)
                    b0, b1, bf = bilinear_band_weights(h, oh, (o0, o1))
                    np.testing.assert_array_equal(b0 + lo, i0[o0:o1])
                    np.testing.assert_array_equal(b1 + lo, i1[o0:o1])
                    np.testing.assert_array_equal(bf, f[o0:o1])
                    t = bilinear_taps(h, oh, "cpu", (o0, o1))
                    out = cuda_resize.resize_bilinear_plain(x[:, :, lo:hi], t, wt)
                    grad = cuda_resize.resize_bilinear_bwd_plain(
                        g[:, :, o0:o1].contiguous(), t, wt, hi - lo, 5)
                    plan = cuda_resize.bilinear_fwd_plan(h, 5, oh, 5, 4, True, (o0, o1))
                    for oy0 in range(0, o1 - o0, plan.band):
                        rows = np.arange(oy0, min(oy0 + plan.band, o1 - o0))
                        assert b1[rows].max() - b0[oy0] < plan.stage_rows <= hi - lo
                else:
                    lo, hi = nearest_band_rows(h, rule, arg, o0, o1)
                    np.testing.assert_array_equal(
                        nearest_index(h, rule, arg, (o0, o1)) + lo, idx[o0:o1])
                    t = nearest_table(h, rule, arg, "cpu", (o0, o1))
                    assert t.spec == (h, rule, arg, (o0, o1))
                    out = cuda_resize.resize_nearest_plain(x[:, :, lo:hi], t, wt)
                    grad = cuda_resize.resize_nearest_bwd_plain(
                        g[:, :, o0:o1].contiguous(), t, wt, hi - lo, 5)
                    plan = cuda_resize.nearest_fwd_plan(t.spec, 5, 5, 4)
                    band_idx = nearest_index(*t.spec)
                    for oy0 in range(0, o1 - o0, plan.band):
                        rows = band_idx[oy0:oy0 + plan.band]
                        assert rows.max() - rows[0] < plan.stage_rows <= hi - lo
                assert torch.equal(out, full[:, :, o0:o1]), (kind, h, oh, sp, r)
                summed[:, :, lo:hi] += grad
            _tol_close(summed, gfull, 1e-6, (kind, h, oh, sp))


# -- the step -----------------------------------------------------------------

@pytest.fixture(scope="module")
def one_process(refs):
    """The one-process step on the whole batch, its 1e-7-input control and
    JAX's one-device step, from the same state."""
    step = dict(sd=refs["sd"], lbl=refs["lbl"], draws=refs["draws"])
    one = cases.step_case(img=refs["img"], **step)
    control = cases.step_case(img=perturbed(refs["img"]), **step)
    jcfg = jax_cfg("base")
    with pytest.MonkeyPatch.context() as mp:
        reduced_trunk(mp, "bottleneck")
        jmodel = JaxMRFP(trunk=refs["trunk"], variant="D16", hrfp_plus=True)
        jstate = jax_create_train_state(jmodel, jcfg.train, (1, HW, HW, 3),
                                        oc_params=jax.tree_util.tree_map(jnp.asarray,
                                                                         refs["oc"]))
        jstate = jstate.replace(params=jax_vars(refs["params"], refs["stats"])["params"],
                                batch_stats=jax_vars(refs["params"], refs["stats"])["batch_stats"],
                                base_key=jnp.asarray(refs["base_key"]))
        jtrain, _ = make_jitted_steps(jmodel, jcfg, None)
        jstate, m = jtrain(jstate, jnp.asarray(refs["img"].numpy()),
                           jnp.asarray(refs["lbl"].numpy()))
        after = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                                    jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
        jax_logits = np.asarray(jmodel.apply(jax_vars(refs["params"], refs["stats"]),
                                             jnp.asarray(refs["x_eval"].numpy().transpose(
                                                 0, 2, 3, 1)), train=False,
                                             mutable=False)["logits"])
    return dict(one=one, control=control, jax_loss=float(m["loss"]), jax_after=after,
                lr=float(lr_schedule(jcfg.train)(0)), wd=jcfg.train.weight_decay,
                jax_logits=nchw(jax_logits))


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_spatial_step_takes_the_one_process_step_and_jax_s(refs, groups, one_process, mesh):
    """One fp32 MRFP+ step, every gate on, on a (dp, sp) mesh of bands
    against one process on the whole batch, and against JAX's step. The
    halo rows cross the spatial group, the statistics the world (and the
    pooled means and instance norms the spatial group)."""
    dp, sp = (int(v) for v in mesh.split("x"))
    group = groups[dp * sp]
    got = group.take(f"step_{mesh}")
    two, others = got[0], got[1:]
    for other in others:
        assert other["loss"] == two["loss"]
        for part in ("grads", "state"):
            assert other[part] == {k: digest(v) for k, v in two[part].items()}, part
    halo = two["collectives"]["spatial"]["halo"]
    assert halo["count"] > 0 and "halo" not in two["collectives"].get("world", {})
    one, control = one_process["one"], one_process["control"]
    assert abs(two["loss"] - one["loss"]) <= 1e-4 * abs(one["loss"]), (two["loss"], one["loss"])
    for part in ("grads", "state"):
        as_close_as_the_control(two[part], one[part], control[part], f"{mesh} {part}")
    assert abs(two["loss"] - one_process["jax_loss"]) < 5e-4
    against_jax(two, one, control, state_dict_from_jax(refs["params"], refs["stats"]),
                one_process["jax_after"], one_process["lr"], one_process["wd"], False)


# -- eval ---------------------------------------------------------------------

_EVAL = {}


def _eval(groups, refs):
    if not _EVAL:
        _EVAL["ranks"] = groups[4].take("eval")
        _EVAL["one"] = cases.eval_case(refs["eval_sd"], refs["x_eval"], sp=1)
    return _EVAL["ranks"], _EVAL["one"]


def test_spatial_eval_logits_match_unsharded(refs, groups, one_process):
    """The eval forward with H split 4 ways (resnet-50 at reduced depth,
    D16, 64 px: layer4's 4 rows, one a rank) against the unsharded
    forward, and against JAX's one-device forward."""
    ranks, one = _eval(groups, refs)
    got = torch.cat([r["logits"] for r in ranks], dim=2)
    torch.testing.assert_close(got, one["logits"], atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), one_process["jax_logits"].numpy(), atol=5e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("eval_batch", [1, 2])
def test_meshed_evaluator_hist_matches_single_device(refs, groups, eval_batch):
    """``SegEvaluator(mesh=)``: each of 3 synthetic images split over 4
    ranks (with eval_batch 2 the partial group too) gives every rank the
    one-process histogram, bit for bit."""
    ranks, one = _eval(groups, refs)
    for r in ranks:
        assert torch.equal(r["hists"][eval_batch], one["hists"][eval_batch])
    assert one["hists"][eval_batch].sum() == 3 * HW * HW


# -- the entry points ---------------------------------------------------------

def _losses(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])["losses"]


def test_cli_train_on_a_spatial_mesh_matches_one_process(tmp_path):
    """``cli.train --device cpu --num-processes 2 --spatial-parallel 2``
    (r18-D32 at crop 64, fp32, global batch 2, the DSN head: its dropout
    mask the band's rows of the global mask, its labels the band of the
    global nearest resize): both ranks take two steps with rc 0, and the
    first loss is one process's within 1e-4."""
    argv = ["-m", "mrfp_tpu_torch.cli.train", "--device", "cpu", "--synthetic", "--trunk",
            "resnet-18", "--variant", "D32", "--crop-size", "64", "--batch-size", "2",
            "--no-bf16", "--log-every", "1", "--use-dsn"]
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


def test_cli_eval_on_a_spatial_mesh_prints_one_process_s_results(tmp_path):
    """``cli.eval --spatial-parallel 2`` starts its two ranks itself and
    prints what one process prints, the speed apart."""
    argv = ["-m", "mrfp_tpu_torch.cli.eval", "--device", "cpu", "--synthetic",
            "--synthetic-hw", "64", "64", "--max-images", "1", "--trunk", "resnet-18",
            "--domains", "cityscapes"]
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


@pytest.mark.parametrize("argv,error", [
    (["--num-processes", "2", "--spatial-parallel", "2", "--jointwtborder"], None),
    (["--num-processes", "2", "--spatial-parallel", "2", "--freq-transform", "phot"], None),
    (["--num-processes", "2", "--spatial-parallel", "2", "--model-parallel", "2"],
     ValueError),
    (["--num-processes", "4", "--spatial-parallel", "4", "--crop-size", "48", "--batch-size",
      "4"], ValueError),
    (["--num-processes", "2", "--spatial-parallel", "3"], ValueError),
])
def test_cli_train_refuses_what_bands_cannot_run(argv, error, tmp_path):
    """A model axis under --spatial-parallel runs where M x S divides the
    processes (tests/test_torch_tensor_parallel.py) and raises where it does
    not (2 x 2 over 2 processes); an S above the deepest map's rows (3 at
    crop 48, D16) or one that does not divide the processes raises before
    any process starts. The extras
    whose windows or transforms cross rows, refused until they ran on
    bands (``--jointwtborder``, ``--freq-transform``), now run: two ranks
    (r18-D32 at crop 64, fp32, global batch 2) take a step with rc 0 and
    log the same finite loss."""
    if error is None:
        flags = argv[4:]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "mrfp_tpu_torch.cli.train", "--device", "cpu", "--synthetic",
             "--trunk", "resnet-18", "--variant", "D32", "--crop-size", "64", "--batch-size",
             "2", "--no-bf16", "--log-every", "1", "--max-iter", "1", "--runs-dir",
             str(tmp_path / "runs"), "--num-processes", "2", "--process-id", str(r),
             "--coordinator-address", f"file://{tmp_path}/rdv", "--spatial-parallel", "2",
             *flags], cwd=REPO, env=env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(2)]
        outs = [p.communicate(timeout=600) for p in procs]
        assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
        got = [_losses(o[0]) for o in outs]
        assert got[0] == got[1] and np.isfinite(got[0]["1"]), got
        return
    with pytest.raises(error, match="spatial-parallel"):
        cli_train.main(["--device", "cpu", "--synthetic", *argv])


def test_the_other_entry_points_refuse_what_bands_cannot_run():
    """Nothing else refuses bands now: ``cli.eval --spatial-parallel`` takes
    a zoo model (``--arch``; it runs in tests/test_torch_spatial_zoo.py),
    and the step's knobs that used to refuse bands run on them (tests/
    test_torch_spatial_extras.py): the FFT transforms act on the whole
    images before the band is cut (``band_batch``), so a band is the
    transformed image's rows. ``--model-parallel`` runs with them
    (tests/test_torch_tensor_parallel.py)."""
    for arch in ("DeepR50V3PlusD", "DeepSEResNext50V3PlusD"):
        cli_eval.check_spatial(cli_eval.parse_args(["--spatial-parallel", "2", "--arch", arch]))
    import dataclasses

    from mrfp_tpu_torch.core.mesh import Mesh
    from mrfp_tpu_torch.parallel.dist import Group
    from mrfp_tpu_torch.perturb.fft_style import apply_freq_transform
    cfg = mrfp_plus_config()
    img = torch.rand((2, 13, 9, 3), generator=torch.Generator().manual_seed(0)) * 255
    lbl = torch.randint(0, 19, (2, 13, 9), generator=torch.Generator().manual_seed(1))
    for index in (0, 1):
        mesh = Mesh(1, 2, Group("data", None, 1, 0), Group("spatial", None, 2, index))
        lo, hi = band(13, 2, index)
        for transform in ("hpf", "lpf", "phot"):
            tcfg = cfg.replace(data=dataclasses.replace(cfg.data, freq_transform=transform))
            x, y, hw = band_batch(mesh, img, lbl, tcfg)
            assert hw == (13, 9) and torch.equal(y, lbl[:, lo:hi])
            assert torch.equal(x, apply_freq_transform(img, transform)[:, lo:hi])
    assert os.environ.get("WORLD_SIZE") is None
