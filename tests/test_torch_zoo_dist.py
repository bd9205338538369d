"""The zoo on several processes on the CPU: a 2-rank gloo group against one
process on the same global batch, and against the JAX package.

One group of two ranks (``torch_dist_group.Group``, the cases of
``torch_zoo_dist_cases.py``) runs every case once for the module, while
this process computes the same cases on the whole batch and runs the JAX
step and statistics pass:

- ``SwitchWhiten2d`` types 2, 3 and 5 in train mode, whose batch mean and
  covariance the ranks combine (``nn/norms.py::_GlobalMeanCov``), against
  the layer on the whole batch; a map offset by 1e3 against fp64;
- one fp32 zoo step (r18-D32, ISW in slots 2-3, SwitchWhiten in slot 4,
  the whitening loss, the DSN head with JAX's dropout mask) against one
  process and against JAX's ``zoo_train_step``;
- the statistics pass's masks against one process at the local batch and
  against JAX's ``covstat_pass`` on the same pairs.

Also ``cli.train_zoo --num-processes 2`` (two subprocesses, a ``file://``
rendezvous): rank 0 alone writes, both ranks log the same losses, a
resume runs the statistics pass again, the sharded validation gives the
one-process mIoU, and a global batch the processes cannot share raises.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.core.config import Config as JaxConfig
from mrfp_tpu.models import deepv3_zoo as jax_zoo
from mrfp_tpu.train import create_train_state as jax_create_train_state
from mrfp_tpu.train.zoo_step import covstat_pass as jax_covstat_pass
from mrfp_tpu.train.zoo_step import zoo_train_step as jax_zoo_train_step
from mrfp_tpu_torch.cli import train_zoo
from mrfp_tpu_torch.data import SyntheticDataset
from mrfp_tpu_torch.models.deepv3_zoo import SLOT_CHANNELS, DeepV3Plus
from mrfp_tpu_torch.nn.norms import SW_PERGROUP, GlobalBatchNorm2d
from mrfp_tpu_torch.train.evaluator import SegEvaluator
from mrfp_tpu_torch.weights import state_dict_from_jax

import torch_zoo_dist_cases as cases
from torch_dist_group import REPO, Group, env
from torch_zoo_fixture import jax_vars, nchw, random_variables, spd_running_cov

torch.set_num_threads(2)

HW, N, LOCAL = 64, 4, 2  # the step's crop, global batch and each rank's batch
SW_TYPES = (2, 3, 5)


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _keep_mask(jmodel, variables, img, key) -> torch.Tensor:
    """JAX's DSN dropout keep mask for ``key`` on the global batch, read
    back from the dropout's output."""
    _out, mut = jmodel.apply(variables, jnp.asarray(img), train=True,
                             mutable=["batch_stats", "intermediates"],
                             capture_intermediates=True, rngs={"dropout": key})
    return nchw(np.asarray(mut["intermediates"]["dsn"]["Dropout_0"]["__call__"][0]) != 0)


def _sw_state(gen, features: int, sw_type: int) -> dict:
    g = features // SW_PERGROUP
    m = 0.3 * torch.randn(g, SW_PERGROUP, SW_PERGROUP, generator=gen)
    return {"sw_mean_weight": torch.randn(sw_type, generator=gen),
            "sw_var_weight": torch.randn(sw_type, generator=gen),
            "weight": 1 + 0.1 * torch.randn(features, generator=gen),
            "bias": 0.1 * torch.randn(features, generator=gen),
            "running_mean": 0.1 * torch.randn(g, SW_PERGROUP, 1, generator=gen),
            "running_cov": torch.eye(SW_PERGROUP) + m @ m.transpose(1, 2) / SW_PERGROUP}


@pytest.fixture(scope="module")
def setup():
    """JAX's r18-D32 zoo model with SwitchWhiten in slot 4 and one damped
    random tree (SwitchWhiten's running covariances made covariances), the
    port's state from it, the batch, JAX's masks from its statistics pass
    and its dropout mask for the step-0 key."""
    jmodel = jax_zoo.DeepV3Plus(trunk=cases.TRUNK, variant=cases.VARIANT, wt_layer=cases.WT,
                                use_dsn=True)
    params, stats = random_variables(jmodel, np.zeros((1, HW, HW, 3), np.float32), seed=2,
                                     damp=True, train=False)
    stats = spd_running_cov(stats)
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 255, (N, HW, HW, 3)).astype(np.float32)
    lbl = rng.integers(0, 19, (N, HW, HW)).astype(np.int32)
    lbl[0, :5] = 255
    pairs = cases.view_pairs(2, LOCAL, HW)
    jl = jax_zoo.build_cov_layers(cases.TRUNK, cases.WT, clusters=5)
    masks, nrc = jax_covstat_pass(jmodel, jax.tree_util.tree_map(jnp.asarray, params),
                                  jax.tree_util.tree_map(jnp.asarray, stats), jl,
                                  [(jnp.asarray(a), jnp.asarray(b)) for a, b in pairs])
    key = jax.random.fold_in(jax.random.PRNGKey(17), 0)  # zoo_train_step's draw
    return dict(jmodel=jmodel, params=params, stats=stats, pairs=pairs,
                sd=state_dict_from_jax(params, stats), img=torch.from_numpy(img),
                lbl=torch.from_numpy(lbl), jax_masks=[np.asarray(m) for m in masks],
                jax_nrc=nrc, keep=_keep_mask(jmodel, jax_vars(params, stats), img, key))


def _job(s) -> dict:
    gen = torch.Generator().manual_seed(0)
    job = {}
    for t in SW_TYPES:
        x = torch.randn(4, 32, 6, 5, generator=gen)
        dy = torch.randn(4, 32, 6, 5, generator=gen)
        sd = _sw_state(gen, 32, t)
        for name, xi in ((f"sw{t}", x), (f"sw{t}_offset", 1e3 + x)):
            job[name] = ("sw_case", dict(x=xi, dy=dy, sw_type=t, sd=sd))
            job[name + "64"] = ("sw_case", dict(x=xi.double(), dy=dy.double(), sw_type=t,
                                                sd=sd))
    masks = [torch.tensor(m) for m in s["jax_masks"]]
    job["zoo_step"] = ("zoo_step_case", dict(sd=s["sd"], img=s["img"], lbl=s["lbl"],
                                             masks=masks, nrc=s["jax_nrc"], keep=s["keep"]))
    pairs = [tuple(torch.from_numpy(v) for v in pair) for pair in s["pairs"]]
    job["covstat"] = ("covstat_case", dict(sd=s["sd"], pairs=pairs))
    return job


@pytest.fixture(scope="module", autouse=True)
def group(setup, tmp_path_factory):
    directory = tmp_path_factory.mktemp("zoo_dist")
    g = Group(_job(setup), directory, cases="torch_zoo_dist_cases")
    yield g
    g.close()


def _one_process(group, name, **change):
    case, kwargs = group.job[name]
    return getattr(cases, case)(**dict(kwargs, **change))


def _merged(got: list, k: str, v: torch.Tensor) -> torch.Tensor:
    """The 2 ranks' ``k``: their rows of a per-sample tensor, the sum of a
    parameter's gradient parts, else rank 0's (equal on both ranks)."""
    if k in ("out", "dx"):
        return torch.cat([g[k] for g in got])
    if k.startswith("d_"):
        return got[0][k] + got[1][k]
    assert torch.equal(got[0][k], got[1][k]), k
    return got[0][k]


# -- SwitchWhiten's batch statistics across ranks -----------------------------

# the gradients of the softmax mixing weights: the difference of sums over
# every value of the map, so any two summation orders differ by ~1e-6 of
# them in fp32; they are held against fp64 instead
MIXING = ("d_sw_mean_weight", "d_sw_var_weight")


def _sw_results(group, name: str):
    """The 2 ranks' fp32 result of ``name`` merged, the one-process fp32
    and fp64 results, and the 2 ranks' fp64 result merged."""
    got, got64 = group.take(name), group.take(name + "64")
    one, truth = _one_process(group, name), _one_process(group, name + "64")
    return ({k: _merged(got, k, v) for k, v in one.items()}, one, truth,
            {k: _merged(got64, k, v) for k, v in truth.items()})


def _as_near_fp64(two: torch.Tensor, one: torch.Tensor, truth: torch.Tensor) -> float:
    """``two``'s distance from ``truth`` over the bound 3x ``one``'s plus
    1e-6 (relative): at most 1 if the ranks' fp32 result lies as near the
    fp64 one as the one-process fp32 result does."""
    return _rel(two, truth) / (3 * _rel(one, truth) + 1e-6)


@pytest.mark.parametrize("sw_type", SW_TYPES)
def test_switchwhiten_on_two_ranks_is_the_layer_on_the_whole_batch(group, sw_type):
    """``SwitchWhiten2d`` in train mode on 2 ranks x 2 samples against the
    layer on the 4 samples, fp32: the output, the input gradient, the
    weight's and bias's gradients (the ranks' parts summed) and the running
    mean and covariance within 1e-6 relative, the running statistics equal
    on both ranks; the mixing weights' gradients no further from the fp64
    layer than 3x the one-process fp32 layer's distance + 1e-6; in fp64 the
    2 ranks equal the one-process layer to 1e-10."""
    two, one, truth, two64 = _sw_results(group, f"sw{sw_type}")
    for k, v in one.items():
        if k in MIXING:
            assert _as_near_fp64(two[k], v, truth[k]) <= 1, (k, _rel(two[k], truth[k]),
                                                             _rel(v, truth[k]))
        else:
            assert _rel(two[k], v) <= 1e-6, (k, _rel(two[k], v))
        assert _rel(two64[k], truth[k]) <= 1e-10, (k, _rel(two64[k], truth[k]))


@pytest.mark.parametrize("sw_type", SW_TYPES)
def test_switchwhiten_combines_moments_exactly(group, sw_type):
    """A map offset by 1e3 (1e3 times its spread): the ranks' centred
    moments and Chan's combination keep the covariance. In fp32 the
    running mean and covariance lie within 1e-6 relative of the one-process
    layer's; every other tensor no further from the fp64 layer on the same
    values than 3x the one-process fp32 layer's distance + 1e-6 (the
    input's own rounding at 1e3, 6e-5 of the spread, sets both), the
    output, input gradient, weight and bias gradients within 1e-3 of it;
    the covariance from summed moments, ``E[x x^T] - E[x] E[x]^T`` in fp32,
    is off by more than 1e-3. In fp64 the 2 ranks equal the one-process
    layer to 1e-10."""
    two, one, truth, two64 = _sw_results(group, f"sw{sw_type}_offset")
    for k, v in one.items():
        if k.startswith("running"):
            assert _rel(two[k], v) <= 1e-6, (k, _rel(two[k], v))
        else:
            ours, theirs = _rel(two[k], truth[k]), _rel(v, truth[k])
            print(f"type {sw_type} {k} from fp64: 2 ranks {ours:.3e}, one process {theirs:.3e}")
            assert _as_near_fp64(two[k], v, truth[k]) <= 1, (k, ours, theirs)
            assert k in MIXING or ours <= 1e-3, (k, ours)
        assert _rel(two64[k], truth[k]) <= 1e-10, (k, _rel(two64[k], truth[k]))
    x = group.job[f"sw{sw_type}_offset"][1]["x"]
    xg = x.reshape(4, -1, SW_PERGROUP, 30).permute(1, 2, 0, 3).reshape(-1, SW_PERGROUP, 120)
    mean = xg.mean(dim=2, keepdim=True)
    summed = xg @ xg.transpose(1, 2) / 120 - mean @ mean.transpose(1, 2)
    centred = xg.double() - xg.double().mean(dim=2, keepdim=True)
    assert _rel(summed, centred @ centred.transpose(1, 2) / 120) > 1e-3


# -- the zoo step -------------------------------------------------------------

def _within_control(two: dict, one: dict, control: dict, what: str) -> None:
    """Every tensor of ``two`` (2 ranks) within 3x the distance of
    ``control`` (one process on the input x (1 + 1e-7 noise)) from ``one``
    (one process), plus 1e-4 of its norm: tests/test_torch_dist.py's rule
    (fp32 flips a few ReLUs, ROADMAP C3)."""
    worst = 0.0
    for k, v in one.items():
        if not v.is_floating_point():
            assert torch.equal(two[k], v), (what, k)
            continue
        err = float((two[k] - v).norm())
        bound = 3 * float((control[k] - v).norm()) + 1e-4 * float(v.norm()) + 1e-9
        worst = max(worst, err / bound)
        assert err <= bound, (what, k, err, bound)
    print(f"{what}: worst error / bound {worst:.3f}")


def _perturbed(img: torch.Tensor) -> torch.Tensor:
    noise = torch.randn(img.shape, generator=torch.Generator().manual_seed(1))
    return img * (1 + 1e-7 * noise)


@pytest.fixture(scope="module")
def steps(setup, group):
    """The zoo step on 2 ranks (rank 0's result, rank 1's digests), in one
    process, and in one process on the input moved by 1e-7 (the control)."""
    two, other = group.take("zoo_step")
    one = _one_process(group, "zoo_step")
    control = _one_process(group, "zoo_step", img=_perturbed(setup["img"]))
    return two, other, one, control


def test_zoo_step_on_two_ranks_is_the_one_process_step(steps):
    """One fp32 zoo step, 2 ranks x 2 images against 1 process x 4: every
    loss (the global batch's on both ranks) and every gradient and
    updated tensor within 3x the 1e-7-input control's distance plus 1e-4;
    both ranks hold the same losses, gradients and state bit for bit."""
    two, other, one, control = steps
    assert other["losses"] == two["losses"]
    for part in ("grads", "state"):
        assert other[part] == {k: cases.digest(v) for k, v in two[part].items()}, part
    assert sorted(two["losses"]) == ["loss", "loss_aux", "loss_main", "loss_wt"]
    for k, v in one["losses"].items():
        err, ctrl = abs(two["losses"][k] - v), abs(control["losses"][k] - v)
        assert err <= 3 * ctrl + 1e-4 * abs(v), (k, two["losses"][k], v, control["losses"][k])
    for part in ("grads", "state"):
        _within_control(two[part], one[part], control[part], f"zoo step {part}")


def test_zoo_step_on_two_ranks_is_jax_s_step(setup, steps):
    """The 2-rank step against JAX's ``zoo_train_step`` on the 4 images on
    one device (JAX's mesh step equals it, tests/test_spatial.py): the
    losses within 5e-4; every gradient (read back from JAX's update at lr
    1) within 1e-2 of its norm (norm scales 5e-2), BN and SwitchWhiten
    running statistics 2e-3 relative, tests/test_torch_zoo.py's bounds, or,
    where the one-process port step already lies further from JAX, within
    that distance plus 3x the control's."""
    two, _other, one, control = steps
    jmodel = setup["jmodel"]
    jcfg = JaxConfig()
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, use_wtloss=True),
                        train=dataclasses.replace(jcfg.train, lr=1.0))
    jstate = jax_create_train_state(jmodel, jcfg.train, (1, HW, HW, 3))
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, setup["params"]),
                            batch_stats=jax.tree_util.tree_map(jnp.asarray, setup["stats"]))
    step = jax.jit(functools.partial(jax_zoo_train_step, model=jmodel, cfg=jcfg,
                                     wt_masks=[jnp.asarray(m) for m in setup["jax_masks"]],
                                     wt_nrc=setup["jax_nrc"]))
    jstate, m = step(jstate, jnp.asarray(setup["img"].numpy()), jnp.asarray(setup["lbl"].numpy()))
    for k, v in two["losses"].items():
        assert abs(v - float(m[k])) < 5e-4, (k, v, float(m[k]))
    after = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                                jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    start, wd = setup["sd"], cases.zoo_cfg().train.weight_decay
    over = []
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
        if allow > 0:
            over.append(k)
        assert err <= max(0.0, allow) + slack, (k, err, allow, slack)
    print(f"against JAX: the one-process step over the bounds at {over}")


# -- the statistics pass ------------------------------------------------------

def test_statistics_pass_masks_on_two_ranks(setup, group):
    """Each rank runs the statistics pass over the same pairs at the local
    batch and takes rank 0's masks: every rank's masks and counts equal,
    bit for bit, the one-process pass at the local batch and JAX's
    ``covstat_pass`` on the same pairs."""
    want = _one_process(group, "covstat")
    for got in group.take("covstat"):
        assert got["nrc"] == want["nrc"] == setup["jax_nrc"]
        for a, b, j in zip(got["masks"], want["masks"], setup["jax_masks"]):
            assert torch.equal(a, b)
            np.testing.assert_array_equal(a.numpy(), j)


@pytest.mark.parametrize("trunk", sorted(SLOT_CHANNELS))
def test_every_zoo_batch_norm_takes_the_global_batch(trunk):
    """Each of the 15 zoo trunks in ``DeepV3Plus`` (heads and DSN
    included) builds its BatchNorms as ``GlobalBatchNorm2d``, whose
    train-mode moments are the global batch's: no plain
    ``nn.BatchNorm2d`` would take a rank's alone."""
    with torch.device("meta"):
        model = DeepV3Plus(trunk=trunk, variant="D16", use_dsn=True)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    assert bns and all(type(m) is GlobalBatchNorm2d for m in bns), \
        sorted({type(m).__name__ for m in bns})


# -- the CLI ------------------------------------------------------------------

ZOO = ["--device", "cpu", "--synthetic", "--trunk", "resnet-18", "--variant", "D32",
       "--wt-layer", "0", "0", "2", "2", "5", "0", "0", "--use-wtloss", "--covstat-batches",
       "1", "--clusters", "5", "--batch-size", "4", "--crop-size", "48", "--no-bf16",
       "--log-every", "1"]


def test_cli_train_zoo_refuses_a_batch_the_processes_cannot_share(tmp_path):
    with pytest.raises(ValueError, match="not divisible"):
        train_zoo.main(ZOO + ["--num-processes", "2", "--batch-size", "3",
                              "--runs-dir", str(tmp_path)])


def test_cli_train_zoo_on_two_processes_writes_once_resumes_and_evaluates(tmp_path):
    """``cli.train_zoo --device cpu --num-processes 2`` at crop 48, global
    batch 4: 2 steps with a sharded validation at step 2, then a rerun to
    3 that resumes and runs the statistics pass again; both ranks exit 0
    and report the same losses and masks, rank 0 alone writes the
    checkpoints, the log and ``--json-out``, and the validation's mIoU is
    the one-process evaluator's on the step-2 checkpoint."""
    runs = tmp_path / "runs"
    for max_iter, steps_run in ((2, ["1", "2"]), (3, ["3"])):
        rendezvous = f"file://{tmp_path}/rendezvous_{max_iter}"
        procs = [subprocess.Popen(
            [sys.executable, "-m", "mrfp_tpu_torch.cli.train_zoo", *ZOO, "--eval-every", "2",
             "--eval-max-images", "3", "--max-iter", str(max_iter), "--runs-dir", str(runs),
             "--json-out", str(tmp_path / f"result{max_iter}.json"), "--num-processes", "2",
             "--process-id", str(r), "--coordinator-address", rendezvous, "--data-parallel",
             "-1"], cwd=REPO, env=env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(2)]
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=600) + (p.returncode,))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
        for out, err, rc in outs:
            assert rc == 0, err[-3000:]
        results = [json.loads(out.strip().splitlines()[-1]) for out, _, _ in outs]
        assert results[0]["losses"] == results[1]["losses"]
        assert sorted(results[0]["losses"]) == steps_run and results[0]["step"] == max_iter
        assert all(np.isfinite(v) for v in results[0]["losses"].values())
        for res in results:  # the statistics pass ran again on resume, at the local batch
            assert res["covstat"]["pairs"] == 1
            assert res["covstat"]["masks"] == results[0]["covstat"]["masks"]
            assert [m["dim"] for m in res["covstat"]["masks"]] == [64, 64]
        with open(tmp_path / f"result{max_iter}.json") as f:
            assert json.load(f) == results[0]
    run_dir = Path(results[0]["run_dir"])
    assert sorted(f for f in os.listdir(run_dir / "ckpt") if f != "best") == \
        ["step_1.pt", "step_2.pt", "step_3.pt"]
    assert len([f for f in os.listdir(run_dir) if f.startswith("log_")]) == 2  # one a run
    lines = [json.loads(line) for line in open(run_dir / "metrics.jsonl")]
    assert [line["step"] for line in lines if line["tag"] == "train/loss"] == [1, 2, 3]
    assert {line["step"] for line in lines if line["tag"] == "train/loss_wt"} == {1, 2, 3}
    val = [line["value"] for line in lines if line["tag"] == "val/mean_iu" and line["step"] == 2]
    model = DeepV3Plus(trunk="resnet-18", variant="D32", wt_layer=(0, 0, 2, 2, 5, 0, 0))
    blob = torch.load(run_dir / "ckpt" / "step_2.pt", map_location="cpu", weights_only=True)
    model.load_state_dict(blob["model"], strict=True)
    want = SegEvaluator(model.eval(), device=torch.device("cpu")).run(
        SyntheticDataset(length=4, hw=(48, 48), seed=7), max_images=3,
        log=lambda *a, **k: None)
    assert val and all(v == want["mean_iu"] for v in val), (val, want["mean_iu"])
