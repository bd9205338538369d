"""The port's launch planner (``cli.plan``) and collective count
(``parallel/audit.py``) on the CPU.

``cli.plan --device cpu`` must meet the contract of tests/test_cli_plan.py
(the JAX planner's): its mesh, the all-reduce bill of a data-parallel step
against the fp32 gradient set, no other collective, replicated
parameters, roofline inputs of a conv net, and the human-readable report
before the JSON line. Its state bytes and FLOPs are held against the JAX
planner's figures for the same launch. A 2-rank gloo group (``torch_dist_group.Group``,
the cases of ``torch_zoo_dist_cases.py``) shows what the planner assumes:
the rollup does not depend on the crop, and every collective the count
sees is one the model's own modules imply.
"""

import dataclasses
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu_torch.cli import plan

import torch_zoo_dist_cases as cases
from torch_dist_group import REPO, Group, env

torch.set_num_threads(2)

PLAN = ["--device", "cpu", "--trunk", "resnet-18", "--variant", "D32", "--batch-size", "4",
        "--crop-size", "64", "--data-parallel", "2"]
CROPS = (64, 96)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The plan's rank step at both crops, and the zoo step (r18-D32,
    SwitchWhiten in slot 4, the whitening loss with upper-triangle masks,
    the DSN head, seeded random weights), each under the count on 2 ranks."""
    from mrfp_tpu_torch.models.deepv3_zoo import SLOT_CHANNELS, DeepV3Plus
    from mrfp_tpu_torch.nn.layers import init_random_
    job = {f"plan{c}": ("audited_step_case", dict(argv=[str(c) if a == "64" else a
                                                        for a in PLAN]))
           for c in CROPS}
    gen = torch.Generator().manual_seed(0)
    net = DeepV3Plus(trunk=cases.TRUNK, variant=cases.VARIANT, wt_layer=cases.WT)
    init_random_(net, gen)
    masks = [torch.triu(torch.ones(d, d), 1)
             for d in (SLOT_CHANNELS[cases.TRUNK][i] for i, c in enumerate(cases.WT) if c == 2)]
    job["zoo"] = ("audited_zoo_step_case", dict(
        sd=net.state_dict(), img=torch.rand(4, 48, 48, 3, generator=gen) * 255,
        lbl=torch.randint(0, 19, (4, 48, 48), generator=gen), masks=masks,
        nrc=[float(m.sum()) for m in masks]))
    g = Group(job, tmp_path_factory.mktemp("plan_dist"), cases="torch_zoo_dist_cases")
    try:
        yield {name: g.take(name) for name in job}
    finally:
        g.close()


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    out = tmp_path_factory.mktemp("plan") / "plan.json"
    proc = subprocess.run([sys.executable, "-m", "mrfp_tpu_torch.cli.plan", *PLAN,
                           "--json-out", str(out)], cwd=REPO, env=env(), capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f), proc.stdout


def test_plan_cli_dp_slice(report):
    """tests/test_cli_plan.py's contract, on the port's 2-rank gloo plan."""
    rep, stdout = report
    assert rep["mesh"] == {"data": 2, "model": 1, "spatial": 1}
    assert rep["devices"] == 2 and rep["platform"] == "cpu"
    assert (rep["global_batch"], rep["crop"], rep["accum_steps"]) == (4, 64, 1)
    ar = rep["collectives_per_step"]["all-reduce"]
    grad_mb = rep["fp32_grad_set_bytes"] / 1e6
    assert grad_mb <= ar["mbytes"] <= 1.1 * grad_mb + 16
    assert sorted(rep["collectives_per_step"]) == ["all-reduce"], rep
    assert rep["per_chip_bytes"]["params"] == rep["fp32_grad_set_bytes"]
    assert rep["per_chip_bytes"]["momentum"] == rep["fp32_grad_set_bytes"]
    assert rep["flops_per_step"] > 1e9
    assert rep["hbm_bytes_per_step"] > 1e8
    assert stdout.index("grad-sync check") < stdout.index(json.dumps(rep))


def test_plan_matches_the_jax_planner(report):
    """The report against what mrfp_tpu/cli/plan.py reports for the same
    launch (MRFP+ r18-D32, bf16, global batch 4 at 64 px), rebuilt here
    without compiling the sharded step.

    State: params, BN statistics and the fp32 gradient set equal the JAX
    TrainState's (``jax.eval_shape``, no weights made), byte for byte; the
    momentum equals its optax trace. JAX's ``opt_state`` also holds the
    schedule's int32 count (4 bytes), which the port keeps in its
    TrainState's ``step``.

    FLOPs: XLA's cost analysis of the one-device step on the global batch
    over the port's figure lies in [0.85, 1.0]; it read 0.908 here (0.950
    at 128 px, 0.976 at 256). XLA counts only the taps that land inside the
    padded input (at 64 px the D32 ASPP's dilated 3x3s run on a 2x2 map
    and read mostly padding; torch's counter counts every tap), adds
    elementwise work, and takes JAX's stem as a 4x4 conv over a
    space-to-depth input. A port that counted the forward only would read
    ~2.2, one that counted the backward twice ~0.57."""
    from mrfp_tpu.core.config import mrfp_plus_config
    from mrfp_tpu.models import MRFP
    from mrfp_tpu.perturb import oc_init
    from mrfp_tpu.train import create_train_state, make_jitted_steps
    rep, _ = report
    batch, crop = rep["global_batch"], rep["crop"]
    cfg = mrfp_plus_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, trunk="resnet-18", variant="D32"),
                      data=dataclasses.replace(cfg.data, batch_size=batch, crop_size=crop))
    model = MRFP(num_classes=cfg.model.num_classes, trunk=cfg.model.trunk,
                 variant=cfg.model.variant, wt_layer=cfg.model.wt_layer,
                 hrfp_plus=cfg.model.hrfp_plus, use_dsn=cfg.model.use_dsn_aux,
                 dtype=jnp.bfloat16)
    state = jax.eval_shape(lambda: create_train_state(
        model, cfg.train, (1, 64, 64, 3), oc_params=oc_init(jax.random.PRNGKey(1))))

    def size(tree) -> int:
        return sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
                   for x in jax.tree_util.tree_leaves(tree))

    trace = [s for s in state.opt_state if type(s).__name__ == "TraceState"]
    assert rep["per_chip_bytes"] == {"params": size(state.params), "momentum": size(trace),
                                     "batch_stats": size(state.batch_stats)}
    assert size(state.opt_state) == size(trace) + 4
    assert rep["fp32_grad_set_bytes"] == sum(int(np.prod(x.shape)) * 4 for x in
                                             jax.tree_util.tree_leaves(state.params))
    jtrain, _ = make_jitted_steps(model, cfg, None)
    cost = jtrain.lower(state, jax.ShapeDtypeStruct((batch, crop, crop, 3), np.float32),
                        jax.ShapeDtypeStruct((batch, crop, crop), np.int32)).cost_analysis()
    ratio = cost["flops"] / rep["flops_per_step"]
    assert 0.85 <= ratio <= 1.0, (cost["flops"], rep["flops_per_step"])


def _rollup(res) -> dict:
    out = {}
    for op, dtype, nbytes in res["log"]:
        d = out.setdefault((op, dtype), [0, 0])
        d[0] += 1
        d[1] += nbytes
    return out


def test_the_rollup_does_not_depend_on_the_crop(group, report):
    """The plan's rank step at crops 64 and 96 pays the same collectives,
    op for op and byte for byte, on both ranks, and the CLI's report reads
    that rollup."""
    logs = {c: group[f"plan{c}"] for c in CROPS}
    for c in CROPS:
        assert logs[c][0]["log"] == logs[c][1]["log"], c
    assert logs[64][0]["log"] == logs[96][0]["log"]
    rolled = _rollup(logs[64][0])
    rep, _ = report
    assert rep["collectives_per_step"]["all-reduce"]["count"] == sum(
        v[0] for (op, _), v in rolled.items() if op == "all-reduce")
    assert rep["collectives_by_dtype"]["all-reduce"] == {
        dtype: {"count": v[0], "bytes": v[1]} for (op, dtype), v in rolled.items()}


def test_the_count_is_what_the_modules_imply(group):
    """One 2-rank step of the MRFP+ recipe (gates on) pays one all_reduce
    per train-mode BatchNorm forward and one per its backward, the same
    for NP+'s gathered means, one for the CE's valid-pixel count, one for
    the global loss and one flat gradient per parameter dtype; the zoo
    step pays the same per BatchNorm and per SwitchWhiten, one for each of
    the two CEs' counts and the whitening loss's sample count, one for the
    four losses and one flat gradient. Nothing else."""
    res = group["plan64"][0]
    seen = res["seen"]
    assert seen["bn"] > 0 and seen["gathers"] == 2 and seen["sw"] == 0
    assert len(res["log"]) == 2 * seen["bn"] + 2 * seen["gathers"] + 2 + res["grad_dtypes"]
    zoo = group["zoo"][0]
    seen = zoo["seen"]
    assert seen["bn"] > 0 and seen["sw"] == 1 and seen["gathers"] == 0
    assert len(zoo["log"]) == 2 * seen["bn"] + 2 * seen["sw"] + 3 + 1 + zoo["grad_dtypes"]
    assert {op for op, _, _ in res["log"] + zoo["log"]} == {"all-reduce"}


@pytest.mark.parametrize("flag", ["--model-parallel", "--spatial-parallel"])
def test_other_meshes_are_refused(flag, tmp_path):
    """Tensor parallelism, refused until it was ported, reports: one data
    rank and a model axis of 2 count the channel gathers over the model
    group, and a rank's parameters are about half the gradient set (the
    shards; tests/test_torch_tensor_parallel.py holds them to JAX's). A
    spatial axis wider than the rows of the deepest map (2 for r18-D32 at
    64 px), where a rank would hold no row of it, is refused."""
    if flag == "--model-parallel":
        out = tmp_path / "plan.json"
        assert plan.main(PLAN[:-1] + ["1", flag, "2", "--json-out", str(out)]) == 0
        rep = json.load(open(out))
        assert rep["mesh"] == {"data": 1, "model": 2, "spatial": 1}
        assert rep["collectives_by_group"]["model"]["channels"]["count"] > 0
        assert rep["per_chip_bytes"]["params"] < 0.51 * rep["fp32_grad_set_bytes"]
    else:
        with pytest.raises(ValueError, match="exceeds the 2 rows"):
            plan.main(PLAN + [flag, "4"])


def test_plan_of_a_spatial_mesh(tmp_path):
    """``cli.plan --spatial-parallel 2`` (one data rank, r18-D32, global
    batch 2 at 64 px) runs the two ranks of the mesh: it reports the mesh
    and 2 devices, the halo all-reduces over the spatial group apart from
    the statistics, and the state bytes of the JAX planner's TrainState for
    the same launch (spatial parallelism replicates the state,
    mrfp_tpu/cli/plan.py:57-58,74-75), byte for byte."""
    from mrfp_tpu.core.config import mrfp_plus_config
    from mrfp_tpu.models import MRFP
    from mrfp_tpu.perturb import oc_init
    from mrfp_tpu.train import create_train_state
    out = tmp_path / "plan.json"
    argv = ["--device", "cpu", "--trunk", "resnet-18", "--variant", "D32", "--batch-size", "2",
            "--crop-size", "64", "--data-parallel", "1", "--spatial-parallel", "2"]
    proc = subprocess.run([sys.executable, "-m", "mrfp_tpu_torch.cli.plan", *argv,
                           "--json-out", str(out)], cwd=REPO, env=env(), capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rep = json.load(open(out))
    assert rep["mesh"] == {"data": 1, "model": 1, "spatial": 2} and rep["devices"] == 2
    groups = rep["collectives_by_group"]
    assert groups["spatial"]["halo"]["count"] > 0 and groups["spatial"]["stats"]["count"] > 0
    assert set(groups) == {"spatial", "world"} and set(groups["world"]) == {"stats"}
    total = sum(v["bytes"] for d in groups.values() for v in d.values())
    assert total == rep["collectives_by_dtype"]["all-reduce"]["f32"]["bytes"] + \
        rep["collectives_by_dtype"]["all-reduce"].get("s64", {"bytes": 0})["bytes"]
    assert "over the spatial group: halo" in proc.stdout
    cfg = mrfp_plus_config()
    model = MRFP(num_classes=cfg.model.num_classes, trunk="resnet-18", variant="D32",
                 wt_layer=cfg.model.wt_layer, hrfp_plus=cfg.model.hrfp_plus,
                 dtype=jnp.bfloat16)
    state = jax.eval_shape(lambda: create_train_state(
        model, cfg.train, (1, 64, 64, 3), oc_params=oc_init(jax.random.PRNGKey(1))))

    def size(tree) -> int:
        return sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
                   for x in jax.tree_util.tree_leaves(tree))

    trace = [t for t in state.opt_state if type(t).__name__ == "TraceState"]
    assert rep["per_chip_bytes"] == {"params": size(state.params), "momentum": size(trace),
                                     "batch_stats": size(state.batch_stats)}


def test_without_a_group_nothing_is_issued_or_counted():
    """With no process group every helper returns its input, so a count
    stays empty; counts do not nest, and closing one leaves no hook."""
    from mrfp_tpu_torch.parallel import dist
    from mrfp_tpu_torch.parallel.audit import count_collectives
    t = torch.arange(3.0)
    with count_collectives() as log:
        assert dist.broadcast(t) is t and dist.all_reduce_sum(t) is t
        with pytest.raises(RuntimeError, match="already open"):
            with count_collectives():
                pass
    assert log == [] and dist._audit is None
