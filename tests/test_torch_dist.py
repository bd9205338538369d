"""Data parallelism of the port on the CPU: 2-process gloo groups against
one process on the same global batch, and against the JAX package.

One group of two ranks (``torch_dist_worker.py``, file rendezvous, one
torch thread each) runs every case of ``torch_dist_cases.py`` once for the
module, while this process computes the same cases on the whole batch (no
group: the single-process path) and the JAX steps:

- the global-batch BatchNorm against ``nn.BatchNorm2d`` on the whole batch
  (forward, input and weight gradients, running statistics), a 1x1 map at
  2 samples a rank included, and a channel whose mean is 1e4 times its
  spread against an fp64 BatchNorm;
- NP+ on 2 ranks against NP+ on the whole batch with the same draws;
- one fp32 MRFP+ step, all gates on, on 2 ranks x 2 images against one
  step on 1 process x 4 images (loss, gradients, updated parameters and
  BN statistics) and against the JAX package's step on the 4 images, with
  its draws injected (the bounds of tests/test_torch_train.py, on its
  damped fixture), for the default step, ``fuse_bn_stats``,
  ``accum_steps=2``, ``batch_weighting`` and ``jointwtborder``;
- two steps with the DSN head and every draw from the run's own streams:
  the same losses and state at 1 and 2 ranks, and ranks that hold equal
  parameters and buffers bit for bit;
- the evaluators' 2-rank histograms, equal to the 1-process ones.

Also the loader's shards against the unsharded batches (and the JAX
loader's), a rendezvous that cannot form, and ``cli.train --num-processes
2`` (rank 0 alone writes, resumes, ``cli.eval`` reads the checkpoint).
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.core.config import mrfp_plus_config as jax_mrfp_plus_config
from mrfp_tpu.core.rng import step_keys
from mrfp_tpu.data.loader import DataLoader as JaxDataLoader
from mrfp_tpu.perturb.oc_branch import oc_maybe_resample as jax_oc_maybe_resample
from mrfp_tpu.train import create_train_state as jax_create_train_state
from mrfp_tpu.train import make_jitted_steps
from mrfp_tpu.train.state import lr_schedule
from mrfp_tpu_torch.cli import train as cli_train
from mrfp_tpu_torch.data.loader import EpochSampler, TrainLoader
from mrfp_tpu_torch.models import MRFP
from mrfp_tpu_torch.weights import state_dict_from_jax

import torch_dist_cases as cases
from torch_dist_group import Group
from torch_step_checks import against_jax as _against_jax
from torch_step_checks import all_gates_key as _all_gates_key
from torch_step_checks import as_close_as_the_control as _as_close_as_the_control
from torch_step_checks import jax_cfg as _jax_cfg
from torch_step_checks import perturbed as _perturbed
from torch_dist_group import env as _env
from torch_port_fixture import np_draws, port_model, reference

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
HW, N, WORLD = 48, 4, 2


def _bn_inputs(gen, n, c, h, w, dtype, mean=0.0, spread=1.0):
    x = mean + spread * torch.randn(n, c, h, w, generator=gen, dtype=torch.float64)
    return dict(x=x.to(dtype), dy=torch.randn(n, c, h, w, generator=gen).to(dtype),
                weight=(1 + 0.1 * torch.randn(c, generator=gen)).to(dtype),
                bias=(0.1 * torch.randn(c, generator=gen)).to(dtype),
                running_mean=(0.1 * torch.randn(c, generator=gen)).to(dtype),
                running_var=(1 + 0.1 * torch.rand(c, generator=gen)).to(dtype))


@pytest.fixture(scope="module")
def setup():
    """The damped fixture's state with JAX's OC re-draw of an all-gates
    step, the batch and JAX's NP+ draws for it, and the JAX trees."""
    ref = reference(seed=11, damped=True, hw=HW)
    _sd, _jmodel, _params, _stats, oc = ref
    rng = np.random.default_rng(7)
    img = rng.standard_normal((N, HW, HW, 3)).astype(np.float32)
    lbl = rng.integers(0, 19, (N, HW, HW)).astype(np.int32)
    lbl[0, :5] = 255
    # skewed toward low classes, so that the class weights differ
    lbl = np.where(lbl == 255, 255, np.minimum(
        lbl, np.random.default_rng(8).integers(0, 19, lbl.shape))).astype(np.int32)
    base_key = _all_gates_key()
    keys = step_keys(base_key, 0)
    new_oc = jax_oc_maybe_resample(jax.tree_util.tree_map(jnp.asarray, oc), jnp.asarray(True),
                                   keys["oc_resample"], jax_mrfp_plus_config().perturb.oc_bn_std)
    new_oc = jax.tree_util.tree_map(np.asarray, new_oc)
    draws = {"np0": np_draws(keys["np_l0"], 64, N), "np1": np_draws(keys["np_l1"], 256, N)}
    draws_mb = {k: [np_draws(jax.random.fold_in(keys[role], i), c, N // 2) for i in range(2)]
                for k, role, c in (("np0", "np_l0", 64), ("np1", "np_l1", 256))}
    sd = port_model(ref, oc_branch=True, hrfp_plus=True, oc=new_oc).state_dict()
    return dict(ref=ref, img=torch.from_numpy(img), lbl=torch.from_numpy(lbl),
                base_key=np.asarray(base_key), draws=draws, draws_mb=draws_mb,
                sd={k: v.clone() for k, v in sd.items()},
                eval_sd=state_dict_from_jax(ref[2], ref[3]))


def _job(s, directory):
    gen = torch.Generator().manual_seed(0)
    job = {}
    for variant in cases.VARIANTS:
        job[f"step_{variant}"] = ("step_case", dict(
            sd=s["sd"], img=s["img"], lbl=s["lbl"],
            draws=s["draws_mb"] if variant == "accum2" else s["draws"], variant=variant))
    rng = np.random.default_rng(17)
    imgs = torch.from_numpy(rng.standard_normal((2, N, 32, 32, 3)).astype(np.float32))
    lbls = torch.from_numpy(rng.integers(0, 19, (2, N, 32, 32)).astype(np.uint8))
    job["steps"] = ("steps_case", dict(imgs=imgs, lbls=lbls))
    job["bn_map"] = ("bn_case", _bn_inputs(gen, 4, 8, 6, 5, torch.float32))
    job["bn_1x1"] = ("bn_case", _bn_inputs(gen, 4, 8, 1, 1, torch.float32))
    job["bn_offset"] = ("bn_case", _bn_inputs(gen, 4, 8, 6, 5, torch.float32, 100.0, 1e-2))
    job["bn_offset64"] = ("bn_case", {k: v.double() for k, v in job["bn_offset"][1].items()})
    job["np_plus"] = ("np_plus_case", dict(feat=torch.randn(4, 64, 12, 12, generator=gen),
                                           dy=torch.randn(4, 64, 12, 12, generator=gen),
                                           seed=9))
    job["eval"] = ("eval_case", dict(sd=s["eval_sd"]))
    job["checkpoint"] = ("checkpoint_case", dict(directory=str(directory)))
    return job


@pytest.fixture(scope="module", autouse=True)
def group(setup, tmp_path_factory):
    directory = tmp_path_factory.mktemp("dist")
    g = Group(_job(setup, directory), directory)
    yield g
    g.close()


def _one_process(group, name):
    """The case ``name`` of the job, run here on the whole batch."""
    case, kwargs = group.job[name]
    return getattr(cases, case)(**kwargs)


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


# -- the loader ---------------------------------------------------------------

def test_loader_shards_are_the_slices_of_the_global_batches(tmp_path):
    """Two shards of batch 2 against one loader of batch 4 over a real train
    pipeline (a fake GTAV tree of 10 images, every augmentation on), two
    epochs: rank 0's images then rank 1's are the global batch, bit for
    bit, and the indices are the JAX loader's shards."""
    from PIL import Image

    from mrfp_tpu_torch.data.datasets import DATASETS, domain_root
    rng = np.random.default_rng(0)
    for i in range(10):
        for sub, arr in (("images", rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)),
                         ("labels", rng.integers(0, 35, (40, 56), dtype=np.uint8))):
            path = tmp_path / "gtav" / sub / "train" / f"{i:05d}.png"
            path.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(arr).save(path)
    ds = DATASETS["gtav"](root=domain_root(str(tmp_path), "gtav"), split="train", train=True,
                          base_size=32, crop_size=32, seed=3)
    whole = TrainLoader(ds, 4, seed=5)
    shards = [TrainLoader(ds, 2, seed=5, shard_rank=r, shard_count=2) for r in range(2)]
    assert len(whole) == len(shards[0]) == len(shards[1]) == 2
    for epoch in range(2):
        for loader in (whole, *shards):
            loader.set_epoch(epoch)
        got = [list(s) for s in shards]
        for i, batch in enumerate(whole):
            for k in ("image", "label"):
                torch.testing.assert_close(torch.cat([got[0][i][k], got[1][i][k]]), batch[k],
                                           rtol=0, atol=0)
        for r, s in enumerate(shards):
            jl = JaxDataLoader(ds, 2, shuffle=True, seed=5, shard_rank=r, shard_count=2)
            jl._epoch = epoch
            want = np.concatenate(jl._index_batches()).tolist()
            s.sampler.epoch = epoch
            assert list(s.sampler) == want


def test_sampler_without_shards_keeps_its_order():
    """One shard of batch 3 over 10 items: the whole batches of the
    ``seed + epoch`` order, as ``drop_last`` over the whole order gave."""
    sampler = EpochSampler(10, 3, seed=1)
    sampler.epoch = 2
    idx = np.arange(10)
    np.random.default_rng(3).shuffle(idx)
    assert list(sampler) == idx[:9].tolist() and len(sampler) == 9
    with pytest.raises(ValueError, match="outside"):
        EpochSampler(10, 3, shard_rank=2, shard_count=2)


# -- the train step -----------------------------------------------------------

@pytest.mark.parametrize("variant", cases.VARIANTS)
def test_two_ranks_take_the_one_process_step_and_jax_s(setup, group, variant):
    """One fp32 MRFP+ step, all gates on: 2 ranks x 2 images against 1
    process x 4 images, and against the JAX step on the 4 images. Against
    one process: the loss within 1e-5 relative (measured <= 7.4e-8), and
    every gradient, updated parameter and BN statistic as close as
    ``_as_close_as_the_control`` says (measured: 0.4-1.4x the control's
    distance; median gradient 6e-4 relative against the control's 3.5e-3);
    both ranks hold the same gradients and state bit for bit. Against JAX:
    the loss within 5e-4, the state as ``_against_jax`` says."""
    _sd, jmodel, params, stats, oc = setup["ref"]
    jcfg = _jax_cfg(variant)
    jstate = jax_create_train_state(jmodel, jcfg.train, (1, HW, HW, 3),
                                    oc_params=jax.tree_util.tree_map(jnp.asarray, oc))
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                            batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                            base_key=jnp.asarray(setup["base_key"]))
    jtrain, _ = make_jitted_steps(jmodel, jcfg, None)
    jstate, m = jtrain(jstate, jnp.asarray(setup["img"].numpy()),
                       jnp.asarray(setup["lbl"].numpy()))
    name = f"step_{variant}"
    one = _one_process(group, name)
    control = cases.step_case(**dict(group.job[name][1], img=_perturbed(setup["img"])))

    two, other = group.take(name)
    assert other["loss"] == two["loss"]
    for part in ("grads", "state"):
        assert other[part] == {k: cases.digest(v) for k, v in two[part].items()}, part
    assert abs(two["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"]), (two["loss"], one["loss"])
    for part in ("grads", "state"):
        _as_close_as_the_control(two[part], one[part], control[part], f"{variant} {part}")

    assert abs(two["loss"] - float(m["loss"])) < 5e-4, (two["loss"], float(m["loss"]))
    after = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                                jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    _against_jax(two, one, control, state_dict_from_jax(params, stats), after,
                 float(lr_schedule(jcfg.train)(0)), jcfg.train.weight_decay, variant == "fused")


def test_streams_do_not_depend_on_the_world_size(group):
    """Two steps of the MRFP+ recipe with the DSN head, every draw from the
    run's streams (gates, OC re-draw, NP+ and the dropout mask drawn for
    the global batch), from seeded random weights: 2 ranks take the
    one-process gates, its first loss within 1e-5 relative, and its later
    loss and final state as ``_as_close_as_the_control`` holds them (on
    these weights the first step's fp32 noise moves the second loss ~1e-4),
    and both ranks hold the same parameters and buffers bit for bit."""
    one = _one_process(group, "steps")
    kwargs = group.job["steps"][1]
    control = cases.steps_case(**dict(kwargs, imgs=_perturbed(kwargs["imgs"])))
    two, other = group.take("steps")
    assert two["gates"] == one["gates"] == other["gates"]
    assert abs(two["losses"][0] - one["losses"][0]) <= 1e-5 * one["losses"][0]
    for a, b, c in zip(two["losses"], one["losses"], control["losses"]):
        assert abs(a - b) <= 3 * abs(c - b) + 1e-5 * b, (a, b, c)
    assert other["losses"] == two["losses"]
    assert other["state"] == {k: cases.digest(v) for k, v in two["state"].items()}
    _as_close_as_the_control(two["state"], one["state"], control["state"], "two steps")


# -- the pieces ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["bn_map", "bn_1x1"])
def test_global_batch_norm_is_batch_norm_on_the_whole_batch(group, name):
    """2 ranks of the port's BatchNorm against ``nn.BatchNorm2d`` on the
    whole batch, fp32 (a 6x5 map, and a 1x1 map at 2 samples a rank, as
    ASPP's image pool): output and input gradient 1e-6 relative, the
    weight's and bias's gradients (the ranks' parts summed) 1e-6, running
    statistics 1e-6, ``num_batches_tracked`` equal (measured <= 1.4e-7)."""
    want = _one_process(group, name)
    got = group.take(name)
    for k, v in want.items():
        if k in ("out", "dx"):
            mine = torch.cat([g[k] for g in got])
        elif k in ("dw", "db"):
            mine = got[0][k] + got[1][k]
        else:
            assert torch.equal(got[0][k], got[1][k]), k
            mine = got[0][k]
        if k == "num_batches_tracked":
            assert int(mine) == int(v) == 1
        else:
            assert _rel(mine, v) <= 1e-6, (k, _rel(mine, v))


def test_global_batch_norm_combines_moments_exactly(group):
    """A channel whose mean (100) is 1e4 times its spread, fp32, on 2
    ranks: each rank's corrected two-pass moments, Chan's combination and
    the centred normalisation keep the variance, so the output lies no
    further from fp64 BatchNorm on the same values than fp32
    ``nn.BatchNorm2d``'s does (measured 2.1e-4 against its 3.2e-4); in
    fp64 the 2 ranks match ``nn.BatchNorm2d`` to 1e-12."""
    truth = _one_process(group, "bn_offset64")
    torch_fp32 = _one_process(group, "bn_offset")
    got = group.take("bn_offset")
    mine = torch.cat([g["out"] for g in got])
    print(f"from fp64: 2 ranks {_rel(mine, truth['out']):.3e}, nn.BatchNorm2d fp32 "
          f"{_rel(torch_fp32['out'], truth['out']):.3e}")
    assert _rel(mine, truth["out"]) <= _rel(torch_fp32["out"], truth["out"])
    got64 = group.take("bn_offset64")
    for k in ("out", "dx"):
        assert _rel(torch.cat([g[k] for g in got64]), truth[k]) <= 1e-12, k
    for k in ("running_mean", "running_var"):
        assert _rel(got64[0][k], truth[k]) <= 1e-12, k


def test_np_plus_takes_its_spread_over_the_global_batch(group):
    """NP+ on 2 ranks x 2 samples with draws from one seeded stream against
    NP+ on the 4 samples: the output equal bit for bit (the gathered means
    are the local ones, the draws the global batch's rows), the input
    gradient within 1e-6 relative (the ranks' terms summed in another
    order)."""
    want = _one_process(group, "np_plus")
    got = group.take("np_plus")
    assert torch.equal(torch.cat([g["out"] for g in got]), want["out"])
    assert _rel(torch.cat([g["dx"] for g in got]), want["dx"]) <= 1e-6


def test_split_evaluation_gives_the_whole_histogram(group):
    """``SegEvaluator`` and ``SlidingEvaluator`` over 5 images on 2 ranks
    (3 and 2 images): every rank returns the one-process histogram, image
    count and mIoU exactly."""
    want = _one_process(group, "eval")
    for r, got in enumerate(group.take("eval")):
        for name in ("seg", "sliding"):
            assert torch.equal(got[name]["hist"], want[name]["hist"]), (r, name)
            assert got[name]["scored"] == want[name]["scored"] == 5
            assert got[name]["mean_iu"] == want[name]["mean_iu"]
            assert int(want[name]["hist"].sum()) == 5 * 48 * 64


# -- process groups and the CLI -----------------------------------------------

def test_only_the_coordinator_writes_and_every_rank_restores(group):
    """Each rank saves into a directory of its own: rank 0's holds the
    checkpoint and the best record, rank 1's nothing; then both restore
    rank 0's checkpoint, past the barrier of ``wait``."""
    for r, got in enumerate(group.take("checkpoint")):
        assert got["written"] == (["best", "step_5.pt"] if r == 0 else []), (r, got)
        assert got["best"] == ({"metric": "mean_iu", "value": 0.5, "step": 5} if r == 0
                               else None)
        assert got["restored_step"] == 5 and got["weight_equal"], (r, got)


def test_a_rendezvous_that_cannot_form_raises(tmp_path):
    """Rank 1 of 2 with no rank 0 raises when the rendezvous times out; it
    never goes on as one process."""
    code = ("from mrfp_tpu_torch.parallel.dist import initialize_distributed, world\n"
            f"initialize_distributed('file://{tmp_path}/rendezvous', 2, 1, 'cpu', "
            "timeout_s=3)\nprint('continued with world', world())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "continued" not in out.stdout, out.stdout + out.stderr


def test_without_a_group_every_helper_is_the_identity():
    from mrfp_tpu_torch.parallel import dist
    assert not torch.distributed.is_initialized()
    assert (dist.world(), dist.rank(), dist.is_coordinator()) == (1, 0, True)
    t = torch.arange(3.0)
    assert dist.all_reduce_sum(t) is t and dist.all_gather_rows(t) is t
    assert not dist.initialize_distributed(device="cpu")  # no flags, no WORLD_SIZE


@pytest.mark.parametrize("device,cards,local,want", [
    ("cpu", 0, None, "gloo"), ("cuda", 1, None, None), ("cuda", 1, "2", "gloo"),
    ("cuda", 8, "8", None), ("cuda", 8, "16", "gloo"), ("cuda", 1, "1", None)])
def test_backend_for_takes_gloo_only_where_ranks_share_a_card(monkeypatch, device, cards,
                                                              local, want):
    """``backend_for``, the one rule of every entry point: gloo off the
    card, or where ``LOCAL_WORLD_SIZE`` exceeds the host's cards; NCCL (the
    default) otherwise, and without ``LOCAL_WORLD_SIZE`` (a launch of one
    process a card, on one host or several); a count given overrides it."""
    from mrfp_tpu_torch.parallel import dist
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    assert dist.backend_for(device) == want
    assert dist.backend_for(device, cards + 1) == "gloo"
    assert dist.backend_for(device, max(cards, 1)) == (None if device == "cuda" else "gloo")


def test_one_process_draws_and_normalises_as_before():
    """Without a group the new paths are the old ones bit for bit: the
    global BatchNorm is ``nn.BatchNorm2d`` (output, gradients, running
    statistics), ``batch_norm_train`` is ``F.batch_norm``, the NP+ draws
    are the (B, C, 1, 1) draws of the generator, and the dropout mask is
    ``torch.rand(x.shape) < keep``."""
    import torch.nn.functional as F

    from mrfp_tpu_torch.nn.deeplab import dropout
    from mrfp_tpu_torch.nn.norms import GlobalBatchNorm2d, batch_norm_train
    from mrfp_tpu_torch.perturb.np_plus import draw_np_plus
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(3, 5, 4, 6, generator=gen)
    ours, ref = GlobalBatchNorm2d(5).train(), torch.nn.BatchNorm2d(5).train()
    outs = []
    for m in (ours, ref):
        xi = x.clone().requires_grad_(True)
        out = m(xi)
        out.square().sum().backward()
        outs.append((out, xi.grad, m.weight.grad, m.running_mean, m.running_var))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    w, b = torch.randn(5, generator=gen), torch.randn(5, generator=gen)
    assert torch.equal(batch_norm_train(x, w, b), F.batch_norm(x, None, None, w, b, True,
                                                               eps=1e-5))
    alpha, beta = draw_np_plus(torch.Generator().manual_seed(9), 3, 5, "cpu")
    g = torch.Generator().manual_seed(9)
    assert torch.equal(alpha, 1.0 + 0.75 * torch.randn((3, 5, 1, 1), generator=g))
    assert torch.equal(beta, 0.75 * torch.randn((3, 5, 1, 1), generator=g))
    keep = torch.rand(x.shape, generator=torch.Generator().manual_seed(2)) < 0.9
    assert torch.equal(dropout(x, 0.1, torch.Generator().manual_seed(2)),
                       torch.where(keep, x / 0.9, 0.0))


def test_cli_train_checks_the_data_parallel_flags():
    """``--data-parallel`` other than -1 or the processes left by the other
    axes raises JAX's ValueError (``mesh dp x mp x sp != n``), and one that
    fits passes the checks; a global batch the processes cannot share
    raises."""
    with pytest.raises(ValueError, match="mesh 4x1x1 != 2 processes"):
        cli_train.main(["--device", "cpu", "--synthetic", "--num-processes", "2",
                        "--batch-size", "4", "--data-parallel", "4"])
    cli_train.check_args(cli_train.parse_args(["--device", "cpu", "--num-processes", "2",
                                               "--batch-size", "4", "--data-parallel", "2"]))
    with pytest.raises(ValueError, match="not divisible"):
        cli_train.main(["--device", "cpu", "--synthetic", "--num-processes", "2",
                        "--batch-size", "3"])


def test_cli_train_on_two_processes_writes_once_resumes_and_evaluates(tmp_path):
    """``cli.train --device cpu --num-processes 2`` at crop 64, global batch
    4: 2 steps with a sharded validation at step 2, then a rerun to 3 that
    resumes; both ranks exit 0 and report the same losses, rank 0 alone
    writes the checkpoints and the log, and ``cli.eval --ckpt`` reads the
    run."""
    from mrfp_tpu_torch.cli import eval as cli_eval

    runs = tmp_path / "runs"
    try:
        for max_iter, steps in ((2, ["1", "2"]), (3, ["3"])):
            rendezvous = f"file://{tmp_path}/rendezvous_{max_iter}"
            procs = [subprocess.Popen(
                [sys.executable, "-m", "mrfp_tpu_torch.cli.train", "--device", "cpu",
                 "--synthetic", "--crop-size", "64", "--batch-size", "4", "--log-every", "1",
                 "--eval-every", "2", "--eval-max-images", "3", "--max-iter", str(max_iter),
                 "--runs-dir", str(runs), "--num-processes", "2", "--process-id", str(r),
                 "--coordinator-address", rendezvous, "--data-parallel", "-1"],
                cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for r in range(2)]
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
            assert sorted(results[0]["losses"]) == steps and results[0]["step"] == max_iter
            assert all(np.isfinite(v) for v in results[0]["losses"].values())
        run_dir = Path(results[0]["run_dir"])
        assert sorted(f for f in os.listdir(run_dir / "ckpt") if f != "best") == \
            ["step_1.pt", "step_2.pt", "step_3.pt"]
        best = sorted(os.listdir(run_dir / "ckpt" / "best"))
        assert len(best) == 2 and best[0] == "metric.json" \
            and best[1] in ("step_2.pt", "step_3.pt")
        assert len([f for f in os.listdir(run_dir) if f.startswith("log_")]) == 2  # one a run
        lines = [json.loads(line) for line in open(run_dir / "metrics.jsonl")]
        assert [line["step"] for line in lines if line["tag"] == "train/loss"] == [1, 2, 3]
        assert [line["step"] for line in lines if line["tag"] == "val/mean_iu"] == [2, 2, 3]
        res = cli_eval.main(["--device", "cpu", "--synthetic", "--synthetic-hw", "64", "64",
                             "--max-images", "2", "--ckpt", str(run_dir)])
        assert res and all(np.isfinite(r["mean_iu"]) and r["images"] == 2 for r in res.values())
    finally:
        shutil.rmtree(runs, ignore_errors=True)  # ~640 MB of checkpoints
