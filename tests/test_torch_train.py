"""The port's train path (CPU, plain resizes) against the JAX package, with
one set of weights driving both and the random draws injected.

- the gates-on train forward, for the gate combinations of
  tests/test_perturbed_parity.py, with that test's bounds (logits 0.05 on
  std ~1 logits after 16 train-mode BN blocks, loss 5e-4);
- the first gradients of a gates-on step;
- three SGD steps of the baseline recipe against the jitted JAX step
  (loss rtol=atol=2e-3, as tests/test_loss_curve_parity.py), with the state
  after the first step compared tensor by tensor;
- the loss on an all-ignore batch, a resume that is bit-identical to an
  unbroken run, and the CLI.

The gradient checks run at batch 4. At batch 2 the ASPP image-pool BN
normalises a 1x1 map over two samples, and in a channel where the two are
alike its variance falls below eps: the JAX package's one-pass fp32
variance then drifts from torch's two-pass one, and the backbone gradients
differ by 10-20% (ROADMAP C1). They also run on a damped copy of the
weights (``ref_damped``): on the plain random weights the fp32 forward
drifts ~4e-4 from fp64 by the decoder, that flips a few dozen ReLUs, and
each flip drops an O(1) gradient term, so the fp32 backbone gradient lies
5% from fp64 (ROADMAP C3). With every residual branch's last BN scale cut
to a tenth, the drift falls 40x and the port's fp32 gradient lies within
3e-3 of its fp64 one, so the checks against JAX can hold 2e-2.
"""

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

from mrfp_tpu.core.config import baseline_config as jax_baseline_config
from mrfp_tpu.models import MRFP as JaxMRFP
from mrfp_tpu.models.mrfp import PerturbArgs as JaxPerturbArgs
from mrfp_tpu.train import create_train_state as jax_create_train_state
from mrfp_tpu.train import make_jitted_steps
from mrfp_tpu.train.import_torch import convert_state_dict
from mrfp_tpu.train.losses import cross_entropy as jax_cross_entropy
from mrfp_tpu_torch.cli import train as cli_train
from mrfp_tpu_torch.core.config import baseline_config, mrfp_plus_config
from mrfp_tpu_torch.models import MRFP
from mrfp_tpu_torch.models.mrfp import PerturbArgs
from mrfp_tpu_torch.train.checkpoint import CheckpointManager
from mrfp_tpu_torch.train.losses import cross_entropy
from mrfp_tpu_torch.train.state import create_train_state
from mrfp_tpu_torch.train.step import train_step
from mrfp_tpu_torch.weights import (oc_state_from_jax, state_dict_from_jax,
                                    train_state_dict)

from torch_oracle import make_reference_state_dict

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
B, HW, STD = 2, 48, 0.75
DAMP = 0.1
GRAD_KEYS = ("layer0.0.weight", "layer1.0.conv1.weight", "aspp.img_conv.0.weight",
             "final2.0.weight")


def _nchw(a):
    return torch.from_numpy(np.transpose(np.asarray(a), (0, 3, 1, 2)).copy())


def _np_draws(key, c, b=B):
    k1, k2 = jax.random.split(key)
    alpha = 1.0 + STD * jax.random.normal(k1, (b, 1, 1, c), jnp.float32)
    beta = STD * jax.random.normal(k2, (b, 1, 1, c), jnp.float32)
    return _nchw(alpha), _nchw(beta)


def _fp32(cfg):
    import dataclasses
    return cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype="float32"))


def _reference(sd):
    """``sd`` as JAX trees, with JAX's MRFP+."""
    jmodel = JaxMRFP(trunk="resnet-50", variant="D16")
    # the importer fills every leaf from sd, so a zero template will do
    variables = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, HW, HW, 3)), train=False))
    variables = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), variables)
    params, stats, oc, report = convert_state_dict(sd, variables)
    assert not report["skipped"]
    return sd, jmodel, params, stats, oc


@pytest.fixture(scope="module")
def ref():
    """The reference state_dict as JAX trees, and JAX's MRFP+."""
    return _reference(make_reference_state_dict(seed=11))


@pytest.fixture(scope="module")
def ref_damped():
    """The same, with every residual branch's last BN scale cut to a tenth
    (as a zero-init-residual start does): the fixture of the gradient
    checks (ROADMAP C3)."""
    sd = make_reference_state_dict(seed=11)
    for k in sd:
        if k.endswith("bn3.weight"):
            sd[k] = sd[k] * DAMP
    return _reference(sd)


def _port_model(ref, oc_branch=True, hrfp_plus=True):
    sd, _jmodel, params, stats, oc = ref
    model = MRFP(oc_branch=oc_branch, hrfp_plus=hrfp_plus)
    state = state_dict_from_jax(params, stats)
    if oc_branch:
        state.update(oc_state_from_jax(oc))
    model.load_state_dict(state, strict=True)
    return model.train()


def test_jax_trees_and_reference_pth_give_one_train_state(ref):
    sd = ref[0]
    from_pth = train_state_dict(sd)
    for k, v in _port_model(ref).state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, from_pth[k]), k


def _jax_perturb(ref, gates, key0, key1):
    oc = jax.tree_util.tree_map(jnp.asarray, ref[4])
    return JaxPerturbArgs(gate_oc=jnp.asarray(gates[0]), gate_np=jnp.asarray(gates[1]),
                          gate_dec=jnp.asarray(gates[2]), key_np0=key0, key_np1=key1,
                          oc_params=oc)


def _jax_vars(ref):
    return {"params": jax.tree_util.tree_map(jnp.asarray, ref[2]),
            "batch_stats": jax.tree_util.tree_map(jnp.asarray, ref[3])}


@pytest.mark.parametrize("gates", [(True, True, True), (True, False, False),
                                   (False, True, False), (False, False, True)])
def test_gates_on_train_forward_matches_jax(ref, gates):
    jmodel = ref[1]
    img = np.random.default_rng(5).standard_normal((B, HW, HW, 3)).astype(np.float32)
    lbl = np.random.default_rng(9).integers(0, 19, (B, HW, HW))
    key0, key1 = jax.random.PRNGKey(21), jax.random.PRNGKey(22)
    out, _ = jmodel.apply(_jax_vars(ref), jnp.asarray(img), train=True,
                          perturb=_jax_perturb(ref, gates, key0, key1),
                          mutable=["batch_stats"])
    want = np.asarray(out["logits"])
    port = _port_model(ref)
    with torch.no_grad():
        got = port(_nchw(img), perturb=PerturbArgs(*gates, np0=_np_draws(key0, 64),
                                                   np1=_np_draws(key1, 256)))
    assert got.dtype == torch.float32 and got.shape == (B, 19, HW, HW)
    got_nhwc = np.transpose(got.numpy(), (0, 2, 3, 1))
    assert np.abs(got_nhwc - want).max() < 0.05, np.abs(got_nhwc - want).max()
    loss_jax = float(jax_cross_entropy(jnp.asarray(want), jnp.asarray(lbl, jnp.int32), 255))
    loss_port = float(cross_entropy(got, torch.from_numpy(lbl)))
    assert abs(loss_jax - loss_port) < 5e-4, (loss_jax, loss_port)


def _rel(a, b):
    return float((torch.as_tensor(a).double() - torch.as_tensor(b).double()).norm()
                 / torch.as_tensor(b).double().norm())


def test_gates_on_gradients_match_jax(ref_damped):
    """One gates-on backward at batch 4, where the image-pool BN is well
    conditioned (ROADMAP C1), on the damped fixture, where fp32 flips few
    ReLUs (ROADMAP C3). Each of the four gradients is held against
    ``jax.grad`` of the JAX loss, and the port's fp32 gradient against its
    fp64 one."""
    ref = ref_damped
    jmodel, b = ref[1], 4
    rng = np.random.default_rng(13)
    img = rng.standard_normal((b, HW, HW, 3)).astype(np.float32)
    lbl = rng.integers(0, 19, (b, HW, HW))
    lbl[0, :4] = 255
    key0, key1 = jax.random.PRNGKey(31), jax.random.PRNGKey(32)
    perturb = _jax_perturb(ref, (True, True, True), key0, key1)
    variables = _jax_vars(ref)

    @jax.jit
    def loss_fn(p):
        out, _ = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]},
                              jnp.asarray(img), train=True, perturb=perturb,
                              mutable=["batch_stats"])
        return jax_cross_entropy(out["logits"], jnp.asarray(lbl, jnp.int32), 255)

    loss_jax, grads = jax.value_and_grad(loss_fn)(variables["params"])
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    draws = (_np_draws(key0, 64, b), _np_draws(key1, 256, b))
    got = {}
    for dtype in (torch.float32, torch.float64):
        port = _port_model(ref).to(dtype)
        loss = cross_entropy(port(_nchw(img).to(dtype), perturb=PerturbArgs(
            True, True, True, *[tuple(t.to(dtype) for t in d) for d in draws])),
            torch.from_numpy(lbl))
        loss.backward()
        got[dtype] = {k: p.grad for k, p in port.named_parameters()}
        assert abs(float(loss.detach()) - float(loss_jax)) < 5e-4
    for k in GRAD_KEYS:
        g32, g64 = got[torch.float32][k], got[torch.float64][k]
        assert _rel(g32, want[k]) <= (1e-4 if k.startswith("final2") else 2e-2), \
            (k, "port vs jax", _rel(g32, want[k]))
        assert _rel(g32, g64) <= 1e-2, (k, "fp32 vs fp64", _rel(g32, g64))


def test_three_baseline_steps_match_jax(ref_damped):
    """Three SGD steps of the baseline recipe, batch 4, on the damped
    fixture, against the jitted JAX step. After the first step the whole
    state is compared: BN running statistics to 2e-3 relative, and each
    parameter's raw gradient, read back from the JAX update as
    ``(p0 - p1) / lr - wd * p0``, against the port's ``.grad`` (1e-2
    relative; measured at most 2.4e-3 for a conv, 4.3e-4 for a bias and
    2.9e-2 for a norm scale). Later steps compare the losses."""
    _sd, _, params, stats, _ = ref_damped
    rng = np.random.default_rng(7)
    b = 4
    batches = [(rng.standard_normal((b, HW, HW, 3)).astype(np.float32),
                rng.integers(0, 19, (b, HW, HW)).astype(np.int32)) for _ in range(3)]
    batches[0][1][0, :5] = 255

    jcfg = jax_baseline_config()
    jmodel = JaxMRFP(trunk="resnet-50", variant="D16", hrfp_plus=False)
    jstate = jax_create_train_state(jmodel, jcfg.train, (1, HW, HW, 3))
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                            batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    jtrain, _ = make_jitted_steps(jmodel, jcfg, None)

    cfg = _fp32(baseline_config())
    state = create_train_state(_port_model(ref_damped, oc_branch=False, hrfp_plus=False),
                               cfg.train)
    start = state_dict_from_jax(params, stats)
    lr, wd = cfg.train.lr, cfg.train.weight_decay
    assert (lr, wd) == (jcfg.train.lr, jcfg.train.weight_decay)
    jax_losses, port_losses = [], []
    for img, lbl in batches:
        jstate, m = jtrain(jstate, jnp.asarray(img), jnp.asarray(lbl))
        jax_losses.append(float(m["loss"]))
        port_losses.append(float(train_step(state, torch.from_numpy(img),
                                            torch.from_numpy(lbl), cfg)["loss"]))
        if len(port_losses) > 1:
            continue
        want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                                   jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
        got = state.model.state_dict()
        grads = {k: p.grad for k, p in state.model.named_parameters()}
        assert sorted(got) == sorted(want)
        worst = {}
        for k, v in want.items():
            if k.endswith("num_batches_tracked"):
                assert int(got[k]) == 1, k
            elif "running" in k:
                assert _rel(got[k], v) <= 2e-3, (k, _rel(got[k], v))
            else:
                p0 = start[k].double()
                g_jax = (p0 - v.double()) / lr - wd * p0
                # a norm scale's gradient sums g * x_hat over as few as 36
                # values a channel (layer4: 3x3, batch 4), which cancel; the
                # atol covers the bn3 biases that feed an IN, whose exact
                # gradient is 0
                bound = 5e-2 if k.endswith("weight") and v.dim() == 1 else 1e-2
                err = float((grads[k].double() - g_jax).norm())
                assert err <= bound * float(g_jax.norm()) + 1e-6, (k, err, float(g_jax.norm()))
    np.testing.assert_allclose(port_losses, jax_losses, rtol=2e-3, atol=2e-3)
    assert state.step == 3 and int(jstate.step) == 3


def test_cross_entropy_all_ignore_is_zero_and_weights_match_jax():
    logits = torch.randn(2, 5, 3, 4, requires_grad=True)
    loss = cross_entropy(logits, torch.full((2, 3, 4), 255))
    loss.backward()
    assert float(loss.detach()) == 0.0 and torch.isfinite(logits.grad).all()
    rng = np.random.default_rng(2)
    lg = rng.standard_normal((2, 5, 3, 4)).astype(np.float32)
    lb = rng.integers(0, 5, (2, 3, 4))
    lb[0, 0] = 255
    w = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    for cw in (None, w):
        want = jax_cross_entropy(jnp.asarray(np.transpose(lg, (0, 2, 3, 1))), jnp.asarray(lb),
                                 255, None if cw is None else jnp.asarray(cw))
        got = cross_entropy(torch.from_numpy(lg), torch.from_numpy(lb), 255,
                            None if cw is None else torch.from_numpy(cw))
        assert abs(float(got) - float(want)) < 1e-5


def _batches(n, hw=32):
    rng = np.random.default_rng(17)
    out = []
    for _ in range(n):
        img = rng.integers(0, 256, (B, hw, hw, 3), dtype=np.uint8)
        lbl = rng.integers(0, 19, (B, hw, hw)).astype(np.uint8)
        lbl[:, :3] = 255
        out.append((torch.from_numpy(img), torch.from_numpy(lbl)))
    return out


def test_resume_is_bit_identical(tmp_path):
    """4 steps in one run == 2 steps, a checkpoint, a fresh process state
    restored from it, and 2 more steps: every draw is a function of
    (seed, step, role), and the checkpoint holds everything else."""
    import dataclasses
    cfg = _fp32(mrfp_plus_config())
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, seed=3, max_iter=10))
    batches = _batches(4)

    one = cli_train.build_state(cfg, torch.device("cpu"))
    losses = [float(train_step(one, *b, cfg)["loss"]) for b in batches]

    two = cli_train.build_state(cfg, torch.device("cpu"))
    resumed = [float(train_step(two, *b, cfg)["loss"]) for b in batches[:2]]
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    ckpt.save(two)
    ckpt.wait()
    three = cli_train.build_state(cfg, torch.device("cpu"))
    assert ckpt.restore(three) and three.step == 2
    resumed += [float(train_step(three, *b, cfg)["loss"]) for b in batches[2:]]
    ckpt.close()

    assert losses == resumed
    assert one.step == three.step == 4
    for k, v in one.model.state_dict().items():
        assert torch.equal(v, three.model.state_dict()[k]), k
    for p, q in zip(one.optimizer.param_groups[0]["params"],
                    three.optimizer.param_groups[0]["params"]):
        assert torch.equal(one.optimizer.state[p]["momentum_buffer"],
                           three.optimizer.state[q]["momentum_buffer"])
    assert one.optimizer.param_groups[0]["lr"] == three.optimizer.param_groups[0]["lr"]


def test_cli_train_cpu_runs_and_resumes(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    args = [sys.executable, "-m", "mrfp_tpu_torch.cli.train", "--device", "cpu",
            "--synthetic", "--crop-size", "64", "--batch-size", "2", "--log-every", "1",
            "--runs-dir", str(tmp_path)]
    for max_iter in (2, 3):
        out = subprocess.run(args + ["--max-iter", str(max_iter)], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["step"] == max_iter and not result["preempted"]
        # the second run resumes at step 2 and takes one step
        assert sorted(int(s) for s in result["losses"]) == \
            ([1, 2] if max_iter == 2 else [3])
        assert all(np.isfinite(v) for v in result["losses"].values())
    ckpts = sorted(os.listdir(os.path.join(result["run_dir"], "ckpt")))
    assert ckpts == ["step_1.pt", "step_2.pt", "step_3.pt"]
    lines = [json.loads(l) for l in open(os.path.join(result["run_dir"], "metrics.jsonl"))]
    assert [l["step"] for l in lines if l["tag"] == "train/loss"] == [1, 2, 3]


def test_unported_flags_raise():
    """Flags of the JAX trainer whose code paths were unported raise and
    named their ROADMAP item until they were ported (the accumulation, the
    training extras, the data-parallel flags, ``--snapshot-every``,
    ``--spatial-parallel`` and ``--model-parallel`` run now). A data axis
    or a model axis that does not fit the processes raises JAX's
    ValueError (``mesh dp x mp x sp != n``, or axes that do not divide
    the processes); one that fits passes the checks. The cross-row extras
    on bands, refused until they were ported, pass the checks (they run in
    tests/test_torch_spatial.py)."""
    for extra, match in ((["--data-parallel", "2"], "mesh 2x1x1 != 1 processes"),
                         (["--model-parallel", "2"], "does not divide 1 processes")):
        with pytest.raises(ValueError, match=match):
            cli_train.main(["--device", "cpu", "--synthetic", *extra])
    for extra in (["--data-parallel", "1"], ["--model-parallel", "2", "--num-processes", "2"],
                  ["--data-parallel", "1", "--model-parallel", "2", "--num-processes", "2"]):
        cli_train.check_args(cli_train.parse_args(["--device", "cpu", *extra]))
    for extra in (["--jointwtborder"], ["--freq-transform", "phot"]):
        cli_train.check_args(cli_train.parse_args(
            ["--device", "cpu", "--num-processes", "2", "--spatial-parallel", "2", *extra]))


EVERY_NEW_FLAG = ["--accum-steps", "2", "--use-dsn", "--jointwtborder", "--border-window", "2",
                  "--reduce-border-iter", "1", "--strict-border-class", "0",
                  "--batch-weighting", "--freq-transform", "hpf", "--no-random-flip",
                  "--no-color-jitter", "--no-gaussian-blur", "--scale-range", "0.75", "1.25",
                  "--class-uniform-pct", "0.5", "--no-oc-conditional"]


def test_cli_train_with_every_new_flag_runs_resumes_and_evaluates(tmp_path):
    """``cli.train --device cpu`` with every flag ported since the first
    train slice at once: 2 steps (the border window at full size), a
    resume to 3 (past ``--reduce-border-iter``, so halved), then ``cli.eval
    --ckpt`` on the run, which drops the DSN head and the OC buffers."""
    from mrfp_tpu_torch.cli import eval as cli_eval
    from mrfp_tpu_torch.models import build_mrfp
    from mrfp_tpu_torch.weights import eval_state_dict

    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    args = [sys.executable, "-m", "mrfp_tpu_torch.cli.train", "--device", "cpu",
            "--synthetic", "--crop-size", "64", "--batch-size", "4", "--log-every", "1",
            "--runs-dir", str(tmp_path), *EVERY_NEW_FLAG]
    for max_iter, steps in ((2, [1, 2]), (3, [3])):
        out = subprocess.run(args + ["--max-iter", str(max_iter)], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["step"] == max_iter and sorted(int(s) for s in result["losses"]) == steps
        assert all(np.isfinite(v) for v in result["losses"].values())
    ckpt = os.path.join(result["run_dir"], "ckpt", "step_3.pt")
    blob = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert blob["recipe"]["use_dsn"] is True
    assert any(k.startswith("dsn.") for k in blob["model"])
    assert all(s["momentum_buffer"].dtype == torch.float32
               for s in blob["optimizer"]["state"].values())

    argv = ["--device", "cpu", "--synthetic", "--synthetic-hw", "64", "64", "--max-images",
            "2", "--domains", "cityscapes", "--step-timeout", "0", "--ckpt", result["run_dir"]]
    model = cli_eval.load_model(cli_eval.parse_args(argv), torch.device("cpu"))
    want, _ = eval_state_dict({k: v for k, v in blob["model"].items()
                               if not k.startswith("dsn.")})
    assert sorted(model.state_dict()) == sorted(build_mrfp("cpu").state_dict()) == sorted(want)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    res = cli_eval.main(argv)["cityscapes"]
    assert res["images"] == 2 and res["pixels"] == 2 * 64 * 64
    assert np.isfinite(res["mean_iu"])
