"""Tensor parallelism of the zoo on the CPU: the DeepV3Plus zoo with its
channels split over the model axis of a (data, model, spatial) mesh of gloo
ranks (``core/mesh.py``, ``weights.shard_model``), against one process and
against the JAX package.

Two process groups (``torch_dist_group.Group``: file rendezvous, gloo, one
torch thread a rank) run the cases of ``torch_zoo_tensor_parallel_cases.py``
while this process computes the one-process results and JAX's:

- a world of 4: the zoo steps on the (2, 2, 1) and (1, 2, 2) meshes,
  ShuffleNetV2 at M = 4 and the eval forward at M = 4;
- a world of 2: the zoo step on (1, 2, 1), one step of each other trunk,
  WiderResNet's blocks and the statistics pass at M = 2.

Bounds:

- Placement, for each family (resnet-50 at depth (1, 1, 1, 1) with
  SwitchWhiten in slot 4, MobileNetV2, MNASNet-0.5, ShuffleNetV2,
  SE-ResNeXt-101 at (1, 1, 2, 1), WiderResNet-16) at M = 2 and 4: the
  shard of every parameter, its momentum and every BN statistic has the
  shape of JAX's ``state_shardings`` shard on a (1, M, 1) mesh, through
  the key map, but SwitchWhiten's ``running_mean`` and ``running_cov``,
  which the port cuts by group (dim 0) where M divides the group count
  and keeps whole elsewhere (ROADMAP C14); the shards join back bit for bit.
- The zoo step (resnet-50 at depth (1, 1, 1, 1), D16, 64 px, batch 4, ISW
  in slots 2-3 with the whitening loss and its masks, SwitchWhiten in
  slot 4, the DSN head with JAX's keep mask, the damped fixture, fp32,
  rate 1) on (1, 2, 1), (2, 2, 1) and (1, 2, 2): the losses within 1e-4
  relative of one process's; every gradient and updated tensor by
  ``torch_step_checks.as_close_as_the_control_or_fp64`` and within 3e-3;
  the replicated tensors bit-identical across each model group; the
  ranks' whole results equal; against JAX's one-device ``zoo_train_step``
  as the one-process step lies (``against_jax``).
- The same step on (1, 2, 2) from the fixture drawn at seed 3, where the
  ranks' fp32 flips one ReLU of ``bot_fine``: the same rule but for the
  three tensors of ``FLIPPED``, named, which lie past the control-or-fp64
  rule (within 3e-3); the ranks' fp64 step, those included, within 3e-3
  of one process's fp64 step and its losses within 1e-10.
- MobileNetV2 (ISW, SwitchWhiten, affine IN), MNASNet-0.5, SE-ResNeXt-101
  and ShuffleNetV2 (D; non-affine and affine IN, ISW, SwitchWhiten) at M
  = 2: one zoo step each, in fp32 under the same rule but 3e-3 (JAX
  apart: MobileNetV2's fp32 step lies up to 0.17 from fp64 in one
  process, so 3e-3 there would read the fixture's rounding), and in fp64
  within 3e-3 and its losses within 1e-10.
- ShuffleNetV2 at M = 4, where stage 2's 58-channel branch convs and
  their BNs stay whole: one train forward and backward, fp64, the logits
  and every gradient within 1e-10 of one process's.
- WiderResNet's identity-residual blocks (the pre-activation shortcut,
  the strided projection, the bottleneck) at M = 2, fp64: the output and
  every gradient within 1e-10 of one process's.
- The statistics pass at M = 2 (on the whole model ``cli.train_zoo``
  gathers): the masks and counts bit-equal to one process's.
- Eval at M = 4 (r18-D32, ISW and SwitchWhiten): the logits within atol
  2e-4, rtol 1e-4 of the unsharded forward.
- The entry point: ``cli.train_zoo --num-processes 2 --model-parallel 2``
  (fp32, r18-D32, crop 48, ``--use-wtloss``) takes two steps, both ranks
  logging the same losses, its masks and first loss those of two
  data-parallel processes (whose statistics pass takes the same pairs,
  and which tests/test_torch_zoo_dist.py holds to one process) within
  1e-4; its checkpoint loads ``strict=True`` into a one-process
  ``DeepV3Plus``; a one-process checkpoint resumes at M = 2.
"""

import dataclasses
import functools
import json
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.core.config import Config as JaxConfig
from mrfp_tpu.core.config import MeshConfig as JaxMeshConfig
from mrfp_tpu.core.mesh import create_mesh as jax_create_mesh
from mrfp_tpu.core.mesh import state_shardings
from mrfp_tpu.models import deepv3_zoo as jax_zoo
from mrfp_tpu.nn import seresnext as jax_seresnext
from mrfp_tpu.nn import wider_resnet as jax_wrn
from mrfp_tpu.train import create_train_state as jax_create_train_state
from mrfp_tpu.train.zoo_step import zoo_train_step as jax_zoo_train_step
from mrfp_tpu_torch.core.mesh import Mesh
from mrfp_tpu_torch.models.deepv3_zoo import DeepV3Plus
from mrfp_tpu_torch.nn.norms import SW_PERGROUP, SwitchWhiten2d
from mrfp_tpu_torch.nn.wider_resnet import WiderResNet
from mrfp_tpu_torch.parallel.dist import Group
from mrfp_tpu_torch.weights import (shard_model, shard_state_dict, state_dict_from_jax,
                                    tree_state_from_jax)

import torch_zoo_tensor_parallel_cases as cases
from torch_dist_cases import digest
from torch_dist_group import REPO, Group as RankGroup, env
from torch_step_checks import against_jax, as_close_as_the_control_or_fp64, perturbed
from torch_zoo_fixture import (ZOO_TRUNK_CASES, jax_vars, nchw, random_variables,
                               reduced_trunk, spd_running_cov, zoo_trunk_reference)

torch.set_num_threads(2)

HW, N, WT = cases.HW, 4, cases.WT
MESHES = {"1x2x1": (1, 2, 1), "2x2x1": (2, 2, 1), "1x2x2": (1, 2, 2)}
TRUNKS = ("mobilenetv2", "mnasnet_05", "se_resnext-101", "shufflenetv2")
SW_BUFFERS = ("running_mean", "running_cov")
# the parameters whose fp32 gradient (and update at rate 1) on the ranks
# lies past 3e-3 of one process's, each held instead by the fp64 step
# the tensors that the ranks' fp32 step from the seed-3 fixture moves past
# the control-or-fp64 rule through a ReLU that their summation order flips
# (the fp64 steps hold them instead)
FLIPPED = ("bot_fine.0.weight", "bot_fine.1.weight", "bot_fine.1.bias")


def _tensor(seed: int, shape, dtype=torch.float64) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)).to(dtype)


def _masks(rng, dims) -> list:
    return [torch.from_numpy(np.triu(rng.random((c, c)) < 0.3, 1).astype(np.float32))
            for c in dims]


def _isw_dims(trunk: str, wt) -> list:
    from mrfp_tpu_torch.models.deepv3_zoo import SLOT_CHANNELS
    return [SLOT_CHANNELS[trunk][i] for i, code in enumerate(wt) if code == 2]


@pytest.fixture(scope="module")
def setup():
    """The damped resnet-50 fixture (JAX tree and port state), the batch,
    the masks, JAX's DSN keep mask and zoo step, the other trunks' states,
    WiderResNet's blocks, the statistics pass's pairs and r18-D32's eval
    state."""
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 255, (N, HW, HW, 3)).astype(np.float32)
    lbl = rng.integers(0, 19, (N, HW, HW)).astype(np.int32)
    lbl[0, :5] = 255
    out = dict(img=torch.from_numpy(img), lbl=torch.from_numpy(lbl))
    masks = _masks(np.random.default_rng(9), _isw_dims("resnet-50", WT))
    out["masks"] = masks
    with pytest.MonkeyPatch.context() as mp:
        reduced_trunk(mp, "bottleneck")
        jmodel = jax_zoo.DeepV3Plus(trunk="resnet-50", variant="D16", wt_layer=WT, use_dsn=True)
        params, stats = random_variables(jmodel, np.zeros((1, HW, HW, 3), np.float32), seed=11,
                                         damp=True, train=False)
        stats = spd_running_cov(stats)
        out["sd"] = state_dict_from_jax(params, stats)
        p3, s3 = random_variables(jmodel, np.zeros((1, HW, HW, 3), np.float32), seed=3,
                                  damp=True, train=False)
        out["sd_flip"] = state_dict_from_jax(p3, spd_running_cov(s3))
        key = jax.random.fold_in(jax.random.PRNGKey(17), 0)  # zoo_train_step's draw
        _o, mut = jmodel.apply(jax_vars(params, stats), jnp.asarray(img), train=True,
                               mutable=["batch_stats", "intermediates"],
                               capture_intermediates=True, rngs={"dropout": key})
        out["keep"] = nchw(np.asarray(mut["intermediates"]["dsn"]["Dropout_0"]["__call__"][0])
                           != 0)
        jcfg = JaxConfig()
        jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, use_wtloss=True),
                            train=dataclasses.replace(jcfg.train, lr=1.0))
        jstate = jax_create_train_state(jmodel, jcfg.train, (1, HW, HW, 3))
        jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                                batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
        step = jax.jit(functools.partial(jax_zoo_train_step, model=jmodel, cfg=jcfg,
                                         wt_masks=[jnp.asarray(m.numpy()) for m in masks],
                                         wt_nrc=[float(m.sum()) for m in masks]))
        jstate, m = step(jstate, jnp.asarray(img), jnp.asarray(lbl))
        out["jax_loss"] = {k: float(v) for k, v in m.items() if k.startswith("loss")}
        out["jax_after"] = state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, jstate.params),
            jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
        out["trunks"] = {}
        rng = np.random.default_rng(10)
        for trunk in TRUNKS:
            variant, wt, wtloss, _jm, p, s = zoo_trunk_reference(mp, trunk, HW)
            tm = _masks(rng, _isw_dims(trunk, wt)) if wtloss else None
            out["trunks"][trunk] = dict(variant=variant, wt=wt, wtloss=wtloss, masks=tm,
                                        sd=state_dict_from_jax(p, s))
    blocks = cases.wider_blocks()
    torch.manual_seed(5)
    with torch.no_grad():  # BatchNorm scales and shifts off their init
        for name, p in blocks.named_parameters():
            if "bn" in name:
                p.copy_(1 + 0.2 * torch.randn_like(p) if name.endswith("weight")
                        else 0.1 * torch.randn_like(p))
    out["wider_sd"] = blocks.state_dict()
    out["x_wider"] = _tensor(31, (2, 3, 16, 16))
    out["dy_wider"] = _tensor(32, (2, 64, 8, 8))
    out["pairs"] = [tuple(torch.from_numpy(rng.uniform(0, 255, (2, HW, HW, 3))
                                           .astype(np.float32)) for _ in range(2))
                    for _ in range(2)]
    shuffle = out["trunks"]["shufflenetv2"]
    out["shuffle_sd"] = {k: v for k, v in shuffle["sd"].items() if not k.startswith("dsn.")}
    out["x_shuffle"] = _tensor(33, (2, 3, HW, HW))
    out["dy_shuffle"] = _tensor(34, (2, 19, HW, HW))
    r18 = jax_zoo.DeepV3Plus(trunk="resnet-18", variant="D32", wt_layer=WT, use_dsn=True)
    p, s = random_variables(r18, np.zeros((1, HW, HW, 3), np.float32), seed=4, train=False)
    out["r18_sd"] = state_dict_from_jax(p, spd_running_cov(s))
    out["x_eval"] = _tensor(35, (2, 3, HW, HW), torch.float32)
    return out


def _step(s, **change) -> dict:
    masks = s["masks"]
    return dict(dict(sd=s["sd"], img=s["img"], lbl=s["lbl"], masks=masks,
                     nrc=[float(m.sum()) for m in masks], keep=s["keep"]), **change)


def _trunk_step(s, trunk: str, **change) -> dict:
    t = s["trunks"][trunk]
    return dict(dict(sd=t["sd"], img=s["img"], lbl=s["lbl"], masks=t["masks"],
                     nrc=None if t["masks"] is None else [float(m.sum()) for m in t["masks"]],
                     keep=None, trunk=trunk, variant=t["variant"], wt=t["wt"],
                     use_wtloss=t["wtloss"]), **change)


def _jobs(s):
    # in the order the tests read them
    four = {"step_2x2x1": ("zoo_step_case", _step(s, dp=2, mp=2)),
            "step_1x2x2": ("zoo_step_case", _step(s, dp=1, mp=2, sp=2)),
            "step_flip": ("zoo_step_case", _step(s, sd=s["sd_flip"], dp=1, mp=2, sp=2)),
            "step_flip64": ("zoo_step_case", _step(s, sd=s["sd_flip"], dp=1, mp=2, sp=2,
                                                   dtype="float64")),
            "shuffle_m4": ("zoo_grad_case", dict(sd=s["shuffle_sd"], trunk="shufflenetv2",
                                                 variant="D", wt=s["trunks"]["shufflenetv2"]["wt"],
                                                 x=s["x_shuffle"], dy=s["dy_shuffle"], mp=4)),
            "eval_m4": ("eval_case", dict(sd=s["r18_sd"], trunk="resnet-18", variant="D32",
                                          wt=WT, x=s["x_eval"], mp=4))}
    two = {"step_1x2x1": ("zoo_step_case", _step(s, dp=1, mp=2))}
    for trunk in TRUNKS:
        two[f"trunk_{trunk}"] = ("zoo_step_case", _trunk_step(s, trunk, mp=2))
        two[f"trunk_{trunk}64"] = ("zoo_step_case", _trunk_step(s, trunk, mp=2,
                                                                dtype="float64"))
    two["wider"] = ("wider_case", dict(sd=s["wider_sd"], x=s["x_wider"], dy=s["dy_wider"], mp=2))
    two["covstat"] = ("covstat_case", dict(sd=s["sd"], pairs=s["pairs"], mp=2))
    return four, two


@pytest.fixture(scope="module")
def groups(setup, tmp_path_factory):
    four, two = _jobs(setup)
    g4 = RankGroup(four, tmp_path_factory.mktemp("zoo_tp4"),
                   cases="torch_zoo_tensor_parallel_cases", world=4)
    g2 = RankGroup(two, tmp_path_factory.mktemp("zoo_tp2"),
                   cases="torch_zoo_tensor_parallel_cases", world=2)
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
        assert other["losses"] == first["losses"]
        for part in ("grads", "state"):
            assert other[part] == {k: digest(v) for k, v in first[part].items()}, part
    for members in _model_groups(*mesh):
        assert all(got[r]["replicated"] == got[members[0]]["replicated"] for r in members)


# -- placement ------------------------------------------------------------------

def _family(monkey, family: str):
    """``(JAX module, key map, a function that makes the port's model)`` of
    a placement family; SE-ResNeXt-101 cut to (1, 1, 2, 1) and resnet-50 to
    (1, 1, 1, 1) in JAX's tables through ``monkey``, and in the port's
    while that function runs."""
    if family == "wider_resnet16":
        return (jax_wrn.WiderResNet(structure=(1,) * 6), tree_state_from_jax,
                lambda: WiderResNet((1,) * 6))
    if family == "resnet-50":
        trunk, variant, wt = reduced_trunk(monkey, "bottleneck"), "D16", WT
    else:
        if family == "se_resnext-101":
            monkey.setitem(jax_zoo._TRUNKS, family, dict(jax_zoo._TRUNKS[family], build=(
                functools.partial(jax_seresnext.SENet, layers=(1, 1, 2, 1), kind="seresnext",
                                  groups=32))))
        trunk, (variant, wt, _wtloss) = family, ZOO_TRUNK_CASES[family]
    jm = jax_zoo.DeepV3Plus(trunk=trunk, variant=variant, wt_layer=wt, use_dsn=True)

    def port():
        with cases.reduced_resnet50(), cases.reduced_trunks():
            return DeepV3Plus(trunk=trunk, variant=variant, wt_layer=wt, use_dsn=True)
    return jm, state_dict_from_jax, port


def _jax_shards(module, key_map, mp: int) -> dict:
    """JAX's shard shape of every leaf on a (1, mp, 1) mesh under the port's
    keys: ``param:``, ``momentum:`` (the optax trace, a tree of the
    parameters' shapes, which ``_tp_spec`` places by shape as it places
    them) and ``buffer:`` (the BN and SwitchWhiten statistics)."""
    variables = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0)},
                                                   jnp.zeros((1, HW, HW, 3)), train=False))
    mesh = jax_create_mesh(JaxMeshConfig(data_parallel=1, model_parallel=mp),
                           jax.devices()[:mp])
    sh = state_shardings(mesh, variables)

    def zeros(coll):
        return jax.tree_util.tree_map(
            lambda x, s: np.zeros(s.shard_shape(x.shape), np.float32), variables[coll],
            sh[coll])

    out = {}
    for k, v in key_map(zeros("params"), zeros("batch_stats")).items():
        if k.endswith("num_batches_tracked"):  # JAX keeps no count
            continue
        buffer = k.rsplit(".", 1)[-1] in ("running_mean", "running_var", "running_cov")
        out[f"{'buffer' if buffer else 'param'}:{k}"] = tuple(v.shape)
        if not buffer:
            out[f"momentum:{k}"] = tuple(v.shape)
    return out


FAMILIES = ("resnet-50", "mobilenetv2", "mnasnet_05", "shufflenetv2", "se_resnext-101",
            "wider_resnet16")


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("family", FAMILIES)
def test_zoo_placement_is_jax_s_but_switchwhiten_s_running_buffers(family, mp):
    """Each rank's shard of every parameter, its momentum (a mirror of the
    parameter: SGD's buffer is made at its shape) and every statistic has
    the shape of JAX's ``state_shardings`` shard of that leaf on a (1, M, 1)
    mesh; SwitchWhiten's running buffers alone differ (cut by group where M
    divides the group count, else whole); the shards join back into the
    whole state bit for bit."""
    with pytest.MonkeyPatch.context() as monkey:
        jmod, key_map, port = _family(monkey, family)
        want = _jax_shards(jmod, key_map, mp)
        whole_model = port()
    whole = {k: v.clone() for k, v in whole_model.state_dict().items()}
    cuts, differ = [], set()
    for m in range(mp):
        mesh = Mesh(1, 1, Group("data", None, 1, 0), Group("spatial", None, 1, 0), mp,
                    Group("model", None, mp, m))
        with pytest.MonkeyPatch.context() as monkey:
            model = shard_model(_family(monkey, family)[2](), mesh)
        model.load_state_dict(shard_state_dict(whole, mesh), strict=True)
        cuts.append(model.state_dict())
        got = {f"param:{k}": tuple(p.shape) for k, p in model.named_parameters()}
        got.update({f"momentum:{k}": tuple(p.shape) for k, p in model.named_parameters()})
        got.update({f"buffer:{k}": tuple(b.shape) for k, b in model.named_buffers()
                    if not k.endswith("num_batches_tracked")})
        assert set(got) == set(want), (family, set(got) ^ set(want))
        for k, shape in want.items():
            if got[k] != shape:
                differ.add(k)
        for name, layer in model.named_modules():
            if isinstance(layer, SwitchWhiten2d):
                g = layer.num_features // SW_PERGROUP
                for b in SW_BUFFERS:
                    key = f"buffer:{name}.{b}"
                    cut = g // mp if g % mp == 0 else g
                    assert got[key][0] == cut, (key, got[key])
    sw = {k for k in want if k.rsplit(".", 1)[-1] in SW_BUFFERS}
    assert differ <= sw, (family, sorted(differ - sw))
    if family == "resnet-50":  # its 512-channel SwitchWhiten: JAX cuts running_cov's columns
        assert any(k.endswith("running_cov") for k in differ)
    keys = whole_model.state_dict()
    for k, v in whole.items():
        placed = torch.cat([c[k] for c in cuts]) if cuts[0][k].shape != v.shape else cuts[0][k]
        assert torch.equal(placed, v), k
    assert set(keys) == set(whole)


# -- the zoo step -----------------------------------------------------------------

@pytest.fixture(scope="module")
def one_process(setup):
    """The one-process step on the whole batch, its 1e-7-input control and
    its gradients in fp64."""
    step = _step(setup)
    return dict(one=cases.zoo_step_case(**step),
                control=cases.zoo_step_case(**dict(step, img=perturbed(step["img"]))),
                ref64=cases.zoo_step_case(**dict(step, dtype="float64"))["grads"])


def _as_one_process(two: dict, one: dict, control: dict, ref64: dict, what: str,
                    past: tuple = ()) -> None:
    """The losses within 1e-4 relative; every gradient and state tensor of
    ``two`` but those named in ``past`` by the control rule or fp64
    (``as_close_as_the_control_or_fp64``)."""
    for k, v in one["losses"].items():
        assert abs(two["losses"][k] - v) <= 1e-4 * abs(v), (what, k, two["losses"][k], v)
    for part in ("grads", "state"):
        held = {k: v for k, v in one[part].items() if k not in past}
        as_close_as_the_control_or_fp64(two[part], held, control[part], ref64,
                                        None if part == "grads" else one["grads"],
                                        f"{what} {part}")


def _within_3e3(two: dict, one: dict, what: str, past: tuple = ()) -> None:
    """Every gradient and updated tensor of ``two`` but those named in
    ``past`` within 3e-3 of one process's, largest difference: JAX's bound
    on the updated parameters (test_tensor_parallel.py:73), held here to
    the gradients and the update at rate 1 (100x tighter than JAX's own,
    at rate 1e-2)."""
    worst = max((float((two[part][k].double() - v.double()).abs().max()), part, k)
                for part in ("grads", "state") for k, v in one[part].items()
                if v.is_floating_point() and k not in past)
    assert worst[0] <= 3e-3, (what, worst)


def _fp64_as_one_process(two: dict, one: dict, what: str) -> None:
    """The fp64 step of the ranks against one process's fp64 step, where
    rounding no longer hides a difference: the losses within 1e-10
    relative (the bound of this file's other fp64 comparisons), every
    gradient and updated tensor within 3e-3 (``_within_3e3``)."""
    for k, v in one["losses"].items():
        assert abs(two["losses"][k] - v) <= 1e-10 * abs(v), (what, k, two["losses"][k], v)
    _within_3e3(two, one, what)
    worst = max((float((two[part][k] - v).abs().max()), part, k)
                for part in ("grads", "state") for k, v in one[part].items()
                if v.is_floating_point())
    print(f"{what}: largest difference {worst}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_zoo_tp_step_takes_the_one_process_step_and_jax_s(setup, groups, one_process, mesh):
    """One fp32 zoo step (ISW and the whitening loss, SwitchWhiten, the DSN
    head) with the channels split over the model axis of a (dp, mp, sp)
    mesh, against one process on the whole batch and against JAX's step.
    The channel gathers cross the model group only, the statistics and
    the gradient the replica group; the shards' shapes are JAX's but
    SwitchWhiten's running buffers."""
    dims = MESHES[mesh]
    got = _take(groups, 4 if dims != (1, 2, 1) else 2, f"step_{mesh}", keep=False)
    _same_across_ranks(got, dims)
    two = got[0]
    colls = two["collectives"]
    assert colls["model"]["channels"]["count"] > 0 and set(colls["model"]) == {"channels"}
    assert "channels" not in colls.get("replica", {}) and "world" not in colls
    one, control = one_process["one"], one_process["control"]
    _as_one_process(two, one, control, one_process["ref64"], mesh)
    _within_3e3(two, one, mesh)
    for k, v in two["losses"].items():
        assert abs(v - setup["jax_loss"][k]) < 5e-4, (k, v, setup["jax_loss"][k])
    wd = cases.zoo_cfg("resnet-50", "D16", WT, True).train.weight_decay
    against_jax(two, one, control, setup["sd"], setup["jax_after"], 1.0, wd, False)
    sw_cov = "layer2.0.instance_norm_layer.running_cov"
    assert two["shapes"][f"buffer:{sw_cov}"] == (512 // SW_PERGROUP // 2, 16, 16)
    assert all(two["shapes"][f"momentum:{k[len('param:'):]}"] == v
               for k, v in two["shapes"].items() if k.startswith("param:"))


def test_zoo_tp_step_through_a_relu_flip_is_held_by_fp64(setup, groups):
    """The (1, 2, 2) step from the resnet-50 fixture drawn at seed 3, where
    the ranks' fp32 step flips a ReLU of ``bot_fine``'s output that one
    process's fp32 and fp64 steps do not (a pre-activation within rounding
    of 0; pure spatial (1, 1, 2) flips the same one: ROADMAP C3's fp32
    fixture effect, not the model axis). That moves the tensors of
    ``FLIPPED`` past the control-or-fp64 rule (here ``bot_fine.0.weight``'s
    gradient lies 1.1e-3 from fp64 in norm, one process's 2.7e-7), though
    within 3e-3. Every other tensor is held as in the seed-11 steps, and
    within 3e-3; the ranks' fp64 step, every tensor of ``FLIPPED``
    included, as one process's fp64 step (``_fp64_as_one_process``)."""
    got = _take(groups, 4, "step_flip", keep=False)
    got64 = _take(groups, 4, "step_flip64", keep=False)
    _same_across_ranks(got, (1, 2, 2))
    _same_across_ranks(got64, (1, 2, 2))
    step = _step(setup, sd=setup["sd_flip"])
    one = cases.zoo_step_case(**step)
    control = cases.zoo_step_case(**dict(step, img=perturbed(step["img"])))
    one64 = cases.zoo_step_case(**dict(step, dtype="float64"))
    _as_one_process(got[0], one, control, one64["grads"], "seed 3", past=FLIPPED)
    _within_3e3(got[0], one, "seed 3")
    for k in FLIPPED:
        print(f"seed 3 {k}: the ranks' fp32 gradient "
              f"{float((got[0]['grads'][k] - one['grads'][k]).abs().max()):.3e} from one "
              f"process's; one process's {float((one['grads'][k] - one64['grads'][k]).norm()):.3e}"
              f" from fp64, the ranks' {float((got[0]['grads'][k] - one64['grads'][k]).norm()):.3e}")
    _fp64_as_one_process(got64[0], one64, "seed 3 fp64")


@pytest.mark.parametrize("trunk", TRUNKS)
def test_zoo_trunk_tp_step_takes_the_one_process_step(setup, groups, trunk):
    """One zoo step of each other trunk with the channels split over 2
    ranks (depthwise convs on their own slices, the SE gates' pooled maps
    gathered, ShuffleNetV2's split, concatenation and shuffle on the whole
    map), against one process on the whole batch: in fp32 the losses and
    every tensor by the control-or-fp64 rule, the replicated tensors
    bit-identical; in fp64 the losses within 1e-10 and every tensor within
    3e-3 (``_fp64_as_one_process``). The
    fp32 step is not held to 3e-3: on MobileNetV2 one process's fp32 step
    itself lies up to 0.17 (a tensor's norm) from its fp64 step, and the
    ranks' no further, so 3e-3 there would measure the fixture's rounding
    (``layer1.feat2.project_bn.weight``'s gradient, of largest value 13.3,
    lies 0.07 from one process's)."""
    got = _take(groups, 2, f"trunk_{trunk}", keep=False)
    got64 = _take(groups, 2, f"trunk_{trunk}64", keep=False)
    _same_across_ranks(got, (1, 2, 1))
    _same_across_ranks(got64, (1, 2, 1))
    step = _trunk_step(setup, trunk)
    one = cases.zoo_step_case(**step)
    control = cases.zoo_step_case(**dict(step, img=perturbed(step["img"])))
    one64 = cases.zoo_step_case(**dict(step, dtype="float64"))
    _as_one_process(got[0], one, control, one64["grads"], trunk)
    _fp64_as_one_process(got64[0], one64, f"{trunk} fp64")


def test_shufflenet_at_m4_runs_its_58_channel_convs_whole(setup, groups):
    """ShuffleNetV2 (D) at M = 4: stage 2's branch convs of 58 channels and
    their BNs stay whole (JAX's rule keeps them whole), and every rank
    computes their maps whole; one train forward and backward, fp64, equal
    to one process's within 1e-10."""
    got = _take(groups, 4, "shuffle_m4")
    kwargs = groups[4].job["shuffle_m4"][1]
    one = cases.zoo_grad_case(**dict(kwargs, mp=1))
    for res in got[:1]:
        for k in ("logits", "dx"):
            torch.testing.assert_close(res[k], one[k], atol=1e-10, rtol=1e-10)
        for k, g in one["grads"].items():
            torch.testing.assert_close(res["grads"][k], g, atol=1e-10 * max(1.0, float(
                g.abs().max())), rtol=1e-10, msg=k)
    assert all(r["grads"] == {k: digest(v) for k, v in got[0]["grads"].items()}
               for r in got[1:])
    assert all(r["replicated"] == got[0]["replicated"] for r in got)
    with pytest.MonkeyPatch.context() as monkey:
        model = shard_model(_family(monkey, "shufflenetv2")[2](),
                            Mesh(1, 1, Group("data", None, 1, 0), Group("spatial", None, 1, 0),
                                 4, Group("model", None, 4, 0)))
    unit = model.layer1.stage2_block1
    assert unit.b2_pw1.conv.weight.shape[0] == 58 and unit.b2_pw1.bn.num_features == 58
    assert not getattr(unit.b2_dw.conv, "tp_local", False)


def test_wider_resnet_blocks_on_channel_slices(setup, groups):
    """WiderResNet's pre-activation blocks (a strided projection shortcut,
    a dilated pair, a bottleneck) at M = 2, train mode, fp64: the output
    and every gradient within 1e-10 of one process's."""
    got = _take(groups, 2, "wider")
    one = cases.wider_case(setup["wider_sd"], setup["x_wider"], setup["dy_wider"], 1)
    for res in got[:1]:
        for k in ("out", "dx"):
            torch.testing.assert_close(res[k], one[k], atol=1e-10, rtol=1e-10)
        for k, g in one["grads"].items():
            torch.testing.assert_close(res["grads"][k], g, atol=1e-10 * max(1.0, float(
                g.abs().max())), rtol=1e-10, msg=k)


def test_statistics_pass_at_m2_gives_one_process_s_masks(setup, groups):
    """The statistics pass of a model cut over 2 ranks, on the whole model
    ``cli.train_zoo`` gathers from the shards: every rank's masks and counts
    equal one process's bit for bit."""
    got = _take(groups, 2, "covstat")
    one = cases.covstat_case(setup["sd"], setup["pairs"], 1)
    assert sum(float(m.sum()) for m in one["masks"]) > 0
    for r in got:
        assert r["nrc"] == one["nrc"]
        for a, b in zip(r["masks"], one["masks"]):
            assert torch.equal(a, b)


def test_zoo_tp_eval_logits_match_unsharded(setup, groups):
    """The eval forward of r18-D32 (ISW, SwitchWhiten in layer2) with the
    channels split 4 ways against the unsharded forward
    (test_tp_eval_logits_match_unsharded's bound); the logits are whole and
    equal on every rank."""
    got = _take(groups, 4, "eval_m4")
    one = cases.eval_case(setup["r18_sd"], "resnet-18", "D32", WT, setup["x_eval"], 1)
    for res in got:
        assert torch.equal(res["logits"], got[0]["logits"])
        torch.testing.assert_close(res["logits"], one["logits"], atol=2e-4, rtol=1e-4)


# -- the entry point ---------------------------------------------------------------

def _train_zoo(tmp_path, runs: str, nproc: int, max_iter: int, mp: int = 1) -> list:
    """Start ``cli.train_zoo`` (fp32, r18-D32, crop 48, global batch 2, ISW
    and SwitchWhiten slots with the whitening loss) in ``nproc``
    processes, with ``--model-parallel mp``; ``_results`` waits."""
    argv = [sys.executable, "-m", "mrfp_tpu_torch.cli.train_zoo", "--device", "cpu",
            "--synthetic", "--trunk", "resnet-18", "--variant", "D32", "--wt-layer",
            *map(str, WT), "--use-wtloss", "--covstat-batches", "1", "--clusters", "5",
            "--crop-size", "48", "--batch-size", "2", "--no-bf16", "--log-every", "1",
            "--max-iter", str(max_iter), "--runs-dir", str(tmp_path / runs)]
    if nproc > 1:
        rdv = tmp_path / f"rdv-{runs}-{max_iter}"
        cmds = [argv + ["--num-processes", str(nproc), "--process-id", str(r),
                        "--coordinator-address", f"file://{rdv}", "--model-parallel", str(mp)]
                + (["--eval-every", "2", "--eval-max-images", "1"] if mp > 1 else [])
                for r in range(nproc)]
    else:
        cmds = [argv]
    return [subprocess.Popen(c, cwd=REPO, env=env(), stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True) for c in cmds]


def _results(procs: list) -> list:
    """Each process's result line, once all have exited 0."""
    outs = [p.communicate(timeout=600) for p in procs]
    assert [p.returncode for p in procs] == [0] * len(procs), "\n".join(
        f"-- rank {r} stderr --\n{o[1][-4000:]}" for r, o in enumerate(outs))
    return [json.loads(o[0].strip().splitlines()[-1]) for o in outs]


def test_cli_train_zoo_on_a_model_axis_matches_data_parallel_and_keeps_checkpoints_whole(
        tmp_path):
    """``cli.train_zoo --num-processes 2 --model-parallel 2``: both ranks take
    two steps and log the same losses and end with the same replicated
    tensors (``replicated_sha256``), validating the sharded model at
    step 2 and again at the end (each rank then keeps the same best score,
    so both join the same checkpoint gathers); its statistics pass's masks are
    those of two data-parallel processes (the same pairs), and its first
    loss theirs within 1e-4; the checkpoint holds the whole state and
    loads ``strict=True`` into a one-process ``DeepV3Plus``, whose eval
    forward is finite; a one-process run's checkpoint resumes at M = 2, its
    second step within 1e-4 of the same checkpoint resumed in one
    process."""
    try:
        tp_run = _train_zoo(tmp_path, "tp", 2, 2, mp=2)
        dp = _results(_train_zoo(tmp_path, "dp", 2, 1))
        one = _results(_train_zoo(tmp_path, "one", 1, 1))[0]
        shutil.copytree(tmp_path / "one", tmp_path / "one_again")
        resumed_run = _train_zoo(tmp_path, "one", 2, 2, mp=2)
        again = _results(_train_zoo(tmp_path, "one_again", 1, 2))[0]
        tp, resumed = _results(tp_run), _results(resumed_run)
        assert tp[0]["losses"] == tp[1]["losses"] and sorted(tp[0]["losses"]) == ["1", "2"]
        assert tp[0]["replicated_sha256"] == tp[1]["replicated_sha256"]
        assert resumed[0]["replicated_sha256"] == resumed[1]["replicated_sha256"]
        assert tp[0]["covstat"]["masks"] == dp[0]["covstat"]["masks"]
        assert abs(tp[0]["losses"]["1"] - dp[0]["losses"]["1"]) <= \
            1e-4 * abs(dp[0]["losses"]["1"])
        assert sorted(resumed[0]["losses"]) == sorted(again["losses"]) == ["2"], resumed
        assert abs(resumed[0]["losses"]["2"] - again["losses"]["2"]) <= \
            1e-4 * abs(again["losses"]["2"])
        blob = torch.load(f"{tp[0]['run_dir']}/ckpt/step_2.pt", weights_only=True)
    finally:
        for runs in ("tp", "dp", "one", "one_again"):
            shutil.rmtree(tmp_path / runs, ignore_errors=True)
    model = DeepV3Plus(trunk="resnet-18", variant="D32", wt_layer=WT, use_dsn=True)
    model.load_state_dict(blob["model"], strict=True)
    params = [p for p in model.parameters() if p.requires_grad]
    momentum = blob["optimizer"]["state"]
    assert len(momentum) == len(params)
    assert all(momentum[i]["momentum_buffer"].shape == p.shape for i, p in enumerate(params))
    with torch.no_grad():
        logits = model.eval()(torch.rand(1, 3, 48, 48) * 255)
    assert logits.shape == (1, 19, 48, 48) and torch.isfinite(logits).all()
