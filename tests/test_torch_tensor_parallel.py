"""Tensor parallelism of the port on the CPU: every conv's output channels
split across gloo ranks (``core/mesh.py``, ``weights.shard_model``),
against one process and against the JAX package (whose sharded results
tests/test_tensor_parallel.py holds to its one-device ones).

Two process groups (``torch_dist_group.Group``: file rendezvous, gloo, one
torch thread a rank) run the cases of ``torch_tensor_parallel_cases.py``
while this process computes the one-process results and the JAX ones:

- a world of 4: the shard round trip at M = 2 and 4, the three channel
  conjugates on a model group of 4, the MRFP+ steps on the (dp, mp, sp)
  meshes (1, 4, 1), (2, 2, 1) and (1, 2, 2), and the eval forward at M = 4;
- a world of 2: the ``fuse_bn_stats`` + DSN step at M = 2, ResNeXt's
  grouped convs at M = 2, and ``cli.plan``'s counted rank step.

Bounds:

- Placement: each rank's shard of every parameter, momentum buffer and BN
  statistic has the shape of its leaf's shard under JAX's
  ``state_shardings`` on a (1, M, 1) mesh, through the key map; the OC
  buffers are whole; ``shard_state_dict`` then ``whole_state_dict`` gives
  the state back bit for bit.
- The conjugates, in fp64, against slicing and concatenating one
  process's tensor: the forward bit-equal, the backward within 1e-12.
- The MRFP+ step (resnet-50 at depth (1, 1, 1, 1), D16, 64 px, batch 4,
  every gate on, JAX's OC re-draw and NP+ draws injected, the damped
  fixture, fp32, rate 1): the loss within 1e-4 relative of one process's
  (JAX's test_tp_train_step_loss_invariant bound); every gradient and
  updated parameter within ``torch_step_checks.as_close_as_the_control``'s
  rule, or, where the ASPP image pool's BatchNorm over the batch's 1x1
  maps amplifies the ranks' last bits past what the 1e-7-input control
  moves (``bot_aspp.0.weight`` at 2 x 2 x 1 lies at 2x that bound), no
  further from the same step in fp64 than 3x the one-process step + 1e-4
  of its norm (``as_close_as_the_control_or_fp64``, the spatial tests'
  rule); and within 3e-3 (JAX's bound on the updated parameters); the
  replicated tensors bit-identical across each model group; against
  JAX's one-device step as the one-process step lies
  (``torch_step_checks.against_jax``).
- The fused + DSN step at M = 2 under the same rules against one process.
- ResNeXt-50's grouped convs at M = 2, fp64: the logits and gradients
  within 1e-10 of one process's.
- Eval at M = 4: the logits within atol 2e-4, rtol 1e-4 of the unsharded
  forward (test_tp_eval_logits_match_unsharded), within atol 5e-4 of JAX's.
- Entry points: ``cli.train --num-processes 2 --model-parallel 2`` (fp32,
  r18-D32, crop 64) takes two steps, its first loss within 1e-4 of one
  process's; its checkpoint loads ``strict=True`` into a one-process
  model; a one-process checkpoint resumes at M = 2; ``cli.plan
  --model-parallel 2`` reports JAX's per-device state bytes and the bill
  the ranks counted.
"""

import json
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.core.config import MeshConfig as JaxMeshConfig
from mrfp_tpu.core.config import mrfp_plus_config as jax_mrfp_plus_config
from mrfp_tpu.core.mesh import create_mesh as jax_create_mesh
from mrfp_tpu.core.mesh import state_shardings
from mrfp_tpu.core.rng import step_keys
from mrfp_tpu.models import MRFP as JaxMRFP
from mrfp_tpu.perturb import oc_init as jax_oc_init
from mrfp_tpu.perturb.oc_branch import oc_maybe_resample as jax_oc_maybe_resample
from mrfp_tpu.train import create_train_state as jax_create_train_state
from mrfp_tpu.train import make_jitted_steps
from mrfp_tpu.train.state import lr_schedule
from mrfp_tpu_torch.core.mesh import Mesh
from mrfp_tpu_torch.models import MRFP
from mrfp_tpu_torch.nn.layers import init_random_
from mrfp_tpu_torch.parallel.dist import Group
from mrfp_tpu_torch.weights import (oc_state_from_jax, shard_state_dict, state_dict_from_jax,
                                    tp_placement)

import torch_tensor_parallel_cases as cases
from torch_dist_cases import digest
from torch_dist_group import REPO, Group as RankGroup, env
from torch_port_fixture import add_dsn_head, np_draws
from torch_step_checks import (against_jax, all_gates_key, as_close_as_the_control_or_fp64,
                               jax_cfg, perturbed)
from torch_zoo_fixture import jax_vars, nchw, random_variables, reduced_trunk

torch.set_num_threads(2)

HW, N = cases.HW, 4
MESHES = {"1x4x1": (1, 4, 1), "2x2x1": (2, 2, 1), "1x2x2": (1, 2, 2)}
DSN_SEED = 8
PLAN = ["--device", "cpu", "--trunk", "resnet-18", "--variant", "D32", "--batch-size", "2",
        "--crop-size", "64", "--data-parallel", "1", "--model-parallel", "2"]


def _tensor(seed: int, shape, dtype=torch.float64) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)).to(dtype)


@pytest.fixture(scope="module")
def refs():
    """The damped fixture's weights (resnet-50 at reduced depth) as JAX trees
    and the port's state_dicts, JAX's OC re-draw and NP+ draws of a step
    whose gates all fire, the step's batch, the eval input, and the JAX
    train state's shapes (no weights made)."""
    with pytest.MonkeyPatch.context() as mp:
        trunk = reduced_trunk(mp, "bottleneck")
        jmodel = JaxMRFP(trunk=trunk, variant="D16", hrfp_plus=True)
        params, stats = random_variables(jmodel, np.zeros((1, HW, HW, 3), np.float32),
                                         seed=11, damp=True, train=False)
        oc = jax.tree_util.tree_map(np.asarray, jax_oc_init(jax.random.PRNGKey(1)))
        jstate = jax.eval_shape(lambda: jax_create_train_state(
            jmodel, jax_cfg("base").train, (1, HW, HW, 3),
            oc_params=jax.tree_util.tree_map(jnp.asarray, oc)))
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
    with cases.reduced_resnext50():
        grouped = MRFP(trunk="resnext-50")
    init_random_(grouped, torch.Generator().manual_seed(4))
    return dict(trunk=trunk, params=params, stats=stats, oc=oc, base_key=np.asarray(base_key),
                sd=sd, eval_sd=eval_sd, img=torch.from_numpy(img), lbl=torch.from_numpy(lbl),
                draws={"np0": np_draws(keys["np_l0"], 64, N),
                       "np1": np_draws(keys["np_l1"], 256, N)},
                x_eval=_tensor(3, (2, 3, HW, HW), torch.float32), jstate=jstate,
                dsn_sd={k.removeprefix("module."): v for k, v in add_dsn_head(sd).items()},
                grouped_sd=grouped.state_dict(), x_grouped=_tensor(5, (2, 3, HW, HW)),
                dy_grouped=_tensor(6, (2, 19, HW, HW)))


CONJ = dict(x=_tensor(20, (2, 12, 3, 5)), parts=(4, 8), dys=[_tensor(21 + m, (2, 12, 3, 5))
                                                             for m in range(4)])


def _jobs(r):
    step = dict(sd=r["sd"], img=r["img"], lbl=r["lbl"], draws=r["draws"])
    mesh = {name: ("tp_step_case", dict(step, dp=dp, mp=mp, sp=sp))
            for name, (dp, mp, sp) in MESHES.items()}
    # in the order the tests read them
    four = {"step_2x2x1": mesh["2x2x1"],
            "round_trip2": ("round_trip_case", dict(sd=r["sd"], mp=2)),
            "step_1x4x1": mesh["1x4x1"],
            "round_trip4": ("round_trip_case", dict(sd=r["sd"], mp=4)),
            "conjugates": ("conjugates_case", dict(CONJ, mp=4)),
            "step_1x2x2": mesh["1x2x2"],
            "eval": ("tp_eval_case", dict(sd=r["eval_sd"], x=r["x_eval"], mp=4))}
    two = {"step_fused_dsn": ("tp_step_case", dict(step, sd=r["dsn_sd"], mp=2, fused=True,
                                                   dsn_seed=DSN_SEED)),
           "grouped": ("grouped_case", dict(sd=r["grouped_sd"], x=r["x_grouped"],
                                            dy=r["dy_grouped"], mp=2)),
           "plan": ("plan_step_case", dict(argv=PLAN))}
    return four, two


@pytest.fixture(scope="module")
def groups(refs, tmp_path_factory):
    four, two = _jobs(refs)
    g4 = RankGroup(four, tmp_path_factory.mktemp("tp4"), cases="torch_tensor_parallel_cases",
                   world=4)
    g2 = RankGroup(two, tmp_path_factory.mktemp("tp2"), cases="torch_tensor_parallel_cases",
                   world=2)
    yield {4: g4, 2: g2}
    g4.close()
    g2.close()


_TAKEN = {}


def _take(groups, world: int, name: str, keep: bool = True) -> list:
    """Every rank's result of ``name``, read once for the module, the jobs
    before it first (a group's ranks write its large results in job
    order); with ``keep`` False the module lets it go."""
    job = list(groups[world].job)
    for earlier in job[:job.index(name) + 1]:
        if earlier not in _TAKEN:
            _TAKEN[earlier] = groups[world].take(earlier)
    got = _TAKEN[name]
    if not keep:
        _TAKEN[name] = None
    return got


def _model_groups(dp: int, mp: int, sp: int) -> list:
    """The ranks of each model group, rank ``(d * mp + m) * sp + s``."""
    return [[(d * mp + m) * sp + s for m in range(mp)] for d in range(dp) for s in range(sp)]


def _same_across_ranks(got: list, mesh) -> None:
    """Every rank's whole gradients and state equal rank 0's bit for bit
    (the worker hashes the other ranks'), and each model group's
    replicated tensors are one."""
    first = got[0]
    for other in got[1:]:
        assert other["loss"] == first["loss"]
        for part in ("grads", "state"):
            assert other[part] == {k: digest(v) for k, v in first[part].items()}, part
    for members in _model_groups(*mesh):
        assert all(got[r]["replicated"] == got[members[0]]["replicated"] for r in members)


# -- placement ------------------------------------------------------------------

def _jax_shards(jstate, mp: int) -> dict:
    """JAX's shard shape of every leaf of the train state on a (1, mp, 1)
    mesh, under the port's keys: ``param:``, ``momentum:`` (the optax
    trace) and ``buffer:`` (the BN statistics)."""
    mesh = jax_create_mesh(JaxMeshConfig(data_parallel=1, model_parallel=mp),
                           jax.devices()[:mp])
    sh = state_shardings(mesh, jstate)

    def zeros(tree, shardings):
        return jax.tree_util.tree_map(lambda x, s: np.zeros(s.shard_shape(x.shape), np.float32),
                                      tree, shardings)

    i = next(i for i, s in enumerate(jstate.opt_state) if type(s).__name__ == "TraceState")
    params = state_dict_from_jax(zeros(jstate.params, sh.params),
                                 zeros(jstate.batch_stats, sh.batch_stats))
    trace = state_dict_from_jax(zeros(jstate.opt_state[i].trace, sh.opt_state[i].trace))
    for s in jax.tree_util.tree_leaves(sh.oc_params, is_leaf=lambda s: hasattr(s, "spec")):
        assert s.spec == jax.sharding.PartitionSpec()
    out = {f"momentum:{k}": tuple(v.shape) for k, v in trace.items()}
    for k, v in params.items():
        kind = "buffer" if k.rsplit(".", 1)[-1] in ("running_mean", "running_var",
                                                    "num_batches_tracked") else "param"
        out[f"{kind}:{k}"] = tuple(v.shape)
    return out


@pytest.mark.parametrize("mp", [2, 4])
def test_placement_is_jax_s_leaf_for_leaf(refs, groups, mp):
    """Each rank's shard of every parameter, momentum buffer and BN
    statistic (read off the (2, 2, 1) and (1, 4, 1) steps' states) has the
    shape of JAX's ``state_shardings`` shard of that leaf; the OC buffers
    are whole; the whole state round-trips through the shards bit for
    bit on every rank, and ``shard_state_dict`` cuts what ``shard_model``
    cuts."""
    got = _take(groups, 4, "step_2x2x1" if mp == 2 else "step_1x4x1")
    want = _jax_shards(refs["jstate"], mp)
    for res in got:
        shapes = res["shapes"]
        for k, shape in want.items():
            assert shapes[k] == shape, (mp, k, shapes[k], shape)
        oc = {k: v for k, v in shapes.items() if k.startswith("buffer:OC")}
        assert len(oc) == 32 and all(v == tuple(refs["sd"][k[len("buffer:"):]].shape)
                                     for k, v in oc.items())
        extra = set(shapes) - set(want) - set(oc)
        assert all(k.endswith("num_batches_tracked") and shapes[k] == () for k in extra), extra
    sharded = [k for k, d in tp_placement(refs["sd"], mp).items() if d is not None]
    assert sharded and all(refs["sd"][k].shape[0] % mp == 0 for k in sharded)
    for res in _take(groups, 4, f"round_trip{mp}"):
        assert res == {"same_cut": True, "whole": True, "keys": True}
    cuts = [shard_state_dict(refs["sd"], Mesh(1, 1, Group("data", None, 1, 0),
                                              Group("spatial", None, 1, 0), mp,
                                              Group("model", None, mp, m)))
            for m in range(mp)]
    for k, v in refs["sd"].items():
        assert torch.equal(torch.cat([c[k] for c in cuts]) if k in sharded else cuts[0][k], v)


# -- the conjugates ---------------------------------------------------------------

def test_the_channel_conjugates_are_slicing_and_concatenation(groups):
    """On a model group of 4, fp64: ``gather_channels`` of each rank's slice
    of two blocks is the whole map (blocks in the global order) and its
    backward each rank's slice of the cotangent; ``copy_to_group`` is the
    identity whose backward sums the ranks' cotangents; ``slice_channels``
    is the rank's slice whose backward concatenates them."""
    got = _take(groups, 4, "conjugates")
    x, parts, dys = CONJ["x"], CONJ["parts"], CONJ["dys"]
    starts = [sum(parts[:i]) for i in range(len(parts))]

    def own(t, m):  # rank m's channels of each block of ``t``, in its local order
        return torch.cat([t[:, a + m * (s // 4):a + (m + 1) * (s // 4)]
                          for a, s in zip(starts, parts)], dim=1)

    for m, res in enumerate(got):
        assert torch.equal(res["gathered"], x)
        torch.testing.assert_close(res["d_gathered"], own(dys[m], m), atol=1e-12, rtol=0)
        assert torch.equal(res["copied"], x)
        torch.testing.assert_close(res["d_copied"], sum(dys), atol=1e-12, rtol=0)
        assert torch.equal(res["sliced"], x[:, 3 * m:3 * (m + 1)])
        torch.testing.assert_close(res["d_sliced"], torch.cat(
            [dys[r][:, 3 * r:3 * (r + 1)] for r in range(4)], dim=1), atol=1e-12, rtol=0)


# -- the step ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_process(refs):
    """The one-process step on the whole batch, its 1e-7-input control, its
    gradients in fp64, and JAX's one-device step and eval forward, from the
    same state."""
    step = dict(sd=refs["sd"], lbl=refs["lbl"], draws=refs["draws"])
    one = cases.tp_step_case(img=refs["img"], **step)
    control = cases.tp_step_case(img=perturbed(refs["img"]), **step)
    ref64 = cases.tp_step_case(img=refs["img"], dtype="float64", **step)["grads"]
    jcfg = jax_cfg("base")
    with pytest.MonkeyPatch.context() as mp:
        reduced_trunk(mp, "bottleneck")
        jmodel = JaxMRFP(trunk=refs["trunk"], variant="D16", hrfp_plus=True)
        jstate = jax_create_train_state(jmodel, jcfg.train, (1, HW, HW, 3),
                                        oc_params=jax.tree_util.tree_map(jnp.asarray,
                                                                         refs["oc"]))
        variables = jax_vars(refs["params"], refs["stats"])
        jstate = jstate.replace(params=variables["params"],
                                batch_stats=variables["batch_stats"],
                                base_key=jnp.asarray(refs["base_key"]))
        jtrain, _ = make_jitted_steps(jmodel, jcfg, None)
        jstate, m = jtrain(jstate, jnp.asarray(refs["img"].numpy()),
                           jnp.asarray(refs["lbl"].numpy()))
        after = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                                    jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
        # the step donated its state's buffers
        jax_logits = np.asarray(jmodel.apply(jax_vars(refs["params"], refs["stats"]), jnp.asarray(
            refs["x_eval"].numpy().transpose(0, 2, 3, 1)), train=False,
            mutable=False)["logits"])
    return dict(one=one, control=control, ref64=ref64, jax_loss=float(m["loss"]),
                jax_after=after,
                lr=float(lr_schedule(jcfg.train)(0)), wd=jcfg.train.weight_decay,
                jax_logits=nchw(jax_logits))


def _as_one_process(two: dict, one: dict, control: dict, ref64: dict, what: str) -> None:
    """Every gradient and state tensor of ``two`` by the control rule or
    fp64 (``as_close_as_the_control_or_fp64``), and within 3e-3 of one
    process's: JAX's bound on the updated parameters
    (test_tensor_parallel.py:73)."""
    for part in ("grads", "state"):
        as_close_as_the_control_or_fp64(two[part], one[part], control[part], ref64,
                                        None if part == "grads" else one["grads"],
                                        f"{what} {part}")
        worst = max(float((two[part][k].double() - v.double()).abs().max())
                    for k, v in one[part].items() if v.is_floating_point())
        assert worst <= 3e-3, (what, part, worst)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tp_step_takes_the_one_process_step_and_jax_s(refs, groups, one_process, mesh):
    """One fp32 MRFP+ step, every gate on, with the channels split over the
    model axis of a (dp, mp, sp) mesh, against one process on the whole
    batch and against JAX's step. The channel gathers cross the model
    group only, the statistics and the gradient the replica group."""
    got = _take(groups, 4, f"step_{mesh}", keep=False)
    _same_across_ranks(got, MESHES[mesh])
    two = got[0]
    colls = two["collectives"]
    assert colls["model"]["channels"]["count"] > 0 and set(colls["model"]) == {"channels"}
    assert "channels" not in colls.get("replica", {}) and "world" not in colls
    one, control = one_process["one"], one_process["control"]
    assert abs(two["loss"] - one["loss"]) <= 1e-4 * abs(one["loss"]), (two["loss"], one["loss"])
    _as_one_process(two, one, control, one_process["ref64"], mesh)
    assert abs(two["loss"] - one_process["jax_loss"]) < 5e-4
    against_jax(two, one, control, state_dict_from_jax(refs["params"], refs["stats"]),
                one_process["jax_after"], one_process["lr"], one_process["wd"], False)


def test_fused_dsn_step_at_m2_takes_the_one_process_step(refs, groups):
    """``fuse_bn_stats`` (``dot_with_stats`` on each rank's rows of the
    1x1 kernels) with the DSN head (its dropout mask this rank's channels
    of the whole mask, drawn from one seed) at M = 2 against one process."""
    got = _take(groups, 2, "step_fused_dsn")
    _same_across_ranks(got, (1, 2, 1))
    step = dict(sd=refs["dsn_sd"], lbl=refs["lbl"], draws=refs["draws"], fused=True,
                dsn_seed=DSN_SEED)
    one = cases.tp_step_case(img=refs["img"], **step)
    control = cases.tp_step_case(img=perturbed(refs["img"]), **step)
    ref64 = cases.tp_step_case(img=refs["img"], dtype="float64", **step)["grads"]
    two = got[0]
    assert abs(two["loss"] - one["loss"]) <= 1e-4 * abs(one["loss"]), (two["loss"], one["loss"])
    _as_one_process(two, one, control, ref64, "fused dsn")


def test_resnext_grouped_convs_run_on_their_own_slice(refs, groups):
    """ResNeXt-50's grouped 3x3s at M = 2 take ``groups / 2`` groups of
    their own input slice, with no gather: one train forward and backward,
    fp64, equal to one process's within 1e-10."""
    got = _take(groups, 2, "grouped")
    one = cases.grouped_case(refs["grouped_sd"], refs["x_grouped"], refs["dy_grouped"], 1)
    for res in got[:1]:
        for k in ("logits", "dx"):
            torch.testing.assert_close(res[k], one[k], atol=1e-10, rtol=1e-10)
        for k, g in one["grads"].items():
            torch.testing.assert_close(res["grads"][k], g, atol=1e-10 * max(1.0, float(
                g.abs().max())), rtol=1e-10)
    assert got[1]["grads"] == {k: digest(v) for k, v in got[0]["grads"].items()}


# -- eval -------------------------------------------------------------------------

def test_tp_eval_logits_match_unsharded(refs, groups, one_process):
    """The eval forward with the channels split 4 ways against the unsharded
    forward (JAX's test_tp_eval_logits_match_unsharded bound), and against
    JAX's one-device forward; the logits are whole on every rank."""
    got = _take(groups, 4, "eval")
    one = cases.tp_eval_case(refs["eval_sd"], refs["x_eval"], 1)
    for res in got:
        torch.testing.assert_close(res["logits"], one["logits"], atol=2e-4, rtol=1e-4)
        np.testing.assert_allclose(res["logits"].numpy(), one_process["jax_logits"].numpy(),
                                   atol=5e-4, rtol=1e-3)


# -- the entry points ---------------------------------------------------------------

def _train(tmp_path, runs: str, nproc: int, max_iter: int) -> list:
    """Start ``cli.train`` (fp32, r18-D32, crop 64, global batch 2) in
    ``nproc`` processes, with ``--model-parallel nproc``; ``_results``
    waits for them."""
    argv = [sys.executable, "-m", "mrfp_tpu_torch.cli.train", "--device", "cpu", "--synthetic",
            "--trunk", "resnet-18", "--variant", "D32", "--crop-size", "64", "--batch-size",
            "2", "--no-bf16", "--log-every", "1", "--max-iter", str(max_iter), "--runs-dir",
            str(tmp_path / runs)]
    if nproc > 1:
        rdv = tmp_path / f"rdv-{runs}-{max_iter}"
        cmds = [argv + ["--num-processes", str(nproc), "--process-id", str(r),
                        "--coordinator-address", f"file://{rdv}", "--model-parallel", str(nproc)]
                for r in range(nproc)]
    else:
        cmds = [argv]
    return [subprocess.Popen(c, cwd=REPO, env=env(), stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True) for c in cmds]


def _results(procs: list) -> list:
    """Each process's result line, once all have exited 0."""
    outs = [p.communicate(timeout=600) for p in procs]
    assert [p.returncode for p in procs] == [0] * len(procs), [o[1][-2000:] for o in outs]
    return [json.loads(o[0].strip().splitlines()[-1]) for o in outs]


def test_cli_train_on_a_model_axis_matches_one_process_and_keeps_checkpoints_whole(tmp_path):
    """``cli.train --num-processes 2 --model-parallel 2``: both ranks take
    two steps and log the same losses, the first within 1e-4 of one
    process's; the checkpoint holds the whole state (the momentum of every
    parameter at its whole shape) and loads ``strict=True`` into a
    one-process model, whose eval forward is finite; a one-process run's
    checkpoint resumes at M = 2, its second step within 1e-4 of the same
    checkpoint resumed in one process."""
    try:
        tp_run = _train(tmp_path, "tp", 2, 2)
        one = _results(_train(tmp_path, "one", 1, 1))[0]
        shutil.copytree(tmp_path / "one", tmp_path / "one_again")
        resumed_run = _train(tmp_path, "one", 2, 2)
        again = _results(_train(tmp_path, "one_again", 1, 2))[0]
        tp, resumed = _results(tp_run), _results(resumed_run)
        assert tp[0]["losses"] == tp[1]["losses"] and sorted(tp[0]["losses"]) == ["1", "2"]
        assert abs(tp[0]["losses"]["1"] - one["losses"]["1"]) <= 1e-4 * abs(one["losses"]["1"])
        assert sorted(resumed[0]["losses"]) == sorted(again["losses"]) == ["2"], resumed
        assert abs(resumed[0]["losses"]["2"] - again["losses"]["2"]) <= \
            1e-4 * abs(again["losses"]["2"])
        blob = torch.load(f"{tp[0]['run_dir']}/ckpt/step_2.pt", weights_only=True)
    finally:  # the runs' checkpoints take about 0.8 GB
        for runs in ("tp", "one", "one_again"):
            shutil.rmtree(tmp_path / runs, ignore_errors=True)
    model = MRFP(trunk="resnet-18", variant="D32", oc_branch=True)
    model.load_state_dict(blob["model"], strict=True)
    params = [p for p in model.parameters() if p.requires_grad]
    momentum = blob["optimizer"]["state"]
    assert len(momentum) == len(params)
    assert all(momentum[i]["momentum_buffer"].shape == p.shape for i, p in enumerate(params))
    with torch.no_grad():
        logits = model.eval()(torch.rand(1, 3, 64, 64) * 255)
    assert logits.shape == (1, 19, 64, 64) and torch.isfinite(logits).all()


def test_cli_plan_on_a_model_axis_reports_jax_s_state_bytes_and_the_ranks_bill(groups,
                                                                            tmp_path):
    """``cli.plan --model-parallel 2`` (r18-D32, MRFP+, global batch 2 at
    64 px): a rank's bytes of parameters, momentum and BN statistics are
    the JAX planner's per-device bytes under ``state_shardings`` on a
    (1, 2, 1) mesh, and its bill by group is what two ranks counted in the
    same step: channel gathers over the model group, nothing over a
    replica group of one."""
    from mrfp_tpu.models import MRFP as JaxModel
    from mrfp_tpu.train import create_train_state
    out = tmp_path / "plan.json"
    proc = subprocess.run([sys.executable, "-m", "mrfp_tpu_torch.cli.plan", *PLAN,
                           "--json-out", str(out)], cwd=REPO, env=env(), capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rep = json.load(open(out))
    assert rep["mesh"] == {"data": 1, "model": 2, "spatial": 1} and rep["devices"] == 2
    cfg = jax_mrfp_plus_config()
    model = JaxModel(num_classes=19, trunk="resnet-18", variant="D32",
                     wt_layer=cfg.model.wt_layer, hrfp_plus=True, dtype=jnp.bfloat16)
    state = jax.eval_shape(lambda: create_train_state(
        model, cfg.train, (1, 64, 64, 3), oc_params=jax_oc_init(jax.random.PRNGKey(1))))
    mesh = jax_create_mesh(JaxMeshConfig(data_parallel=1, model_parallel=2),
                           jax.devices()[:2])
    sh = state_shardings(mesh, state)

    def per_device(tree, shardings) -> int:
        return sum(int(np.prod(s.shard_shape(x.shape))) * np.dtype(x.dtype).itemsize
                   for x, s in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(
                       shardings, is_leaf=lambda s: hasattr(s, "spec"))))

    i = next(i for i, s in enumerate(state.opt_state) if type(s).__name__ == "TraceState")
    assert rep["per_chip_bytes"] == {
        "params": per_device(state.params, sh.params),
        "momentum": per_device(state.opt_state[i], sh.opt_state[i]),
        "batch_stats": per_device(state.batch_stats, sh.batch_stats)}
    assert rep["per_chip_bytes"]["params"] < rep["fp32_grad_set_bytes"] // 2 + 200_000
    ranks = _take(groups, 2, "plan")
    assert ranks[0]["by_group"] == ranks[1]["by_group"] == rep["collectives_by_group"]
    assert set(rep["collectives_by_group"]) == {"model"}
