"""The fused-statistics train step (``cfg.train.fuse_bn_stats``) of the port
(CPU, plain versions) against the JAX package's ``make_jitted_steps`` with
the same flag, which on the CPU takes ``dot_with_stats``'s XLA form
(mrfp_tpu/ops/pallas_dot_stats.py:122-128) through the same BatchNorm
``stats=`` code.

One SGD step of the baseline recipe at 48x48, batch 4, on the damped
fixture of tests/test_torch_train.py (ROADMAP C3): loss 5e-4; BN running
statistics rtol 2e-2, atol 1e-3 (the JAX package's own fused-vs-unfused
bounds, tests/test_train_step.py); every parameter's raw gradient, read back
from the JAX update as ``(p0 - p1) / lr - wd * p0``, 1e-2 relative (norm
scales 5e-2). The port's forward is checked to have taken all 36
bottleneck 1x1s through ``dot_with_stats``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.core.config import baseline_config as jax_baseline_config
from mrfp_tpu.models import MRFP as JaxMRFP
from mrfp_tpu.train import create_train_state as jax_create_train_state
from mrfp_tpu.train import make_jitted_steps
from mrfp_tpu.train.import_torch import convert_state_dict
from mrfp_tpu_torch.core.config import baseline_config
from mrfp_tpu_torch.models import MRFP
from mrfp_tpu_torch.ops import cuda_dot_stats
from mrfp_tpu_torch.train.state import create_train_state
from mrfp_tpu_torch.train.step import train_step
from mrfp_tpu_torch.weights import state_dict_from_jax

from torch_oracle import make_reference_state_dict

torch.set_num_threads(2)

HW, B = 48, 4


def _fused(cfg, fuse=True):
    return cfg.replace(train=dataclasses.replace(cfg.train, fuse_bn_stats=fuse))


@pytest.fixture(scope="module")
def damped():
    """The reference state_dict with every ``bn3.weight`` cut to a tenth,
    as JAX trees."""
    sd = make_reference_state_dict(seed=11)
    for k in sd:
        if k.endswith("bn3.weight"):
            sd[k] = sd[k] * 0.1
    jmodel = JaxMRFP(trunk="resnet-50", variant="D16", hrfp_plus=False)
    variables = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, HW, HW, 3)), train=False))
    variables = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), variables)
    params, stats, _oc, report = convert_state_dict(sd, variables)
    assert not report["skipped"]
    return jmodel, params, stats


def _port_state(params, stats, cfg):
    model = MRFP(oc_branch=False, hrfp_plus=False)
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return create_train_state(model.train(), cfg.train)


def _batch():
    rng = np.random.default_rng(7)
    img = rng.standard_normal((B, HW, HW, 3)).astype(np.float32)
    lbl = rng.integers(0, 19, (B, HW, HW)).astype(np.int32)
    lbl[0, :5] = 255
    return img, lbl


def test_fused_baseline_step_matches_jax(damped, monkeypatch):
    jmodel, params, stats = damped
    img, lbl = _batch()
    jcfg = _fused(jax_baseline_config())
    jstate = jax_create_train_state(jmodel, jcfg.train, (1, HW, HW, 3))
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                            batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    jtrain, _ = make_jitted_steps(jmodel, jcfg, None)
    jstate, m = jtrain(jstate, jnp.asarray(img), jnp.asarray(lbl))

    cfg = baseline_config()
    cfg = _fused(cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype="float32")))
    state = _port_state(params, stats, cfg)
    calls = []
    plain = cuda_dot_stats.dot_with_stats_plain
    monkeypatch.setattr(cuda_dot_stats, "dot_with_stats_plain",
                        lambda x, w: calls.append(tuple(w.shape)) or plain(x, w))
    loss = float(train_step(state, torch.from_numpy(img), torch.from_numpy(lbl), cfg)["loss"])
    assert len(calls) == 36 and len(set(calls)) == 15, calls
    assert abs(loss - float(m["loss"])) < 5e-4, (loss, float(m["loss"]))

    start = state_dict_from_jax(params, stats)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                               jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    got = state.model.state_dict()
    grads = {k: p.grad for k, p in state.model.named_parameters()}
    lr, wd = cfg.train.lr, cfg.train.weight_decay
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 1, k
        elif "running" in k:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=2e-2, atol=1e-3,
                                       err_msg=k)
        else:
            p0 = start[k].double()
            g_jax = (p0 - v.double()) / lr - wd * p0
            bound = 5e-2 if k.endswith("weight") and v.dim() == 1 else 1e-2
            err = float((grads[k].double() - g_jax).norm())
            assert err <= bound * float(g_jax.norm()) + 1e-6, (k, err, float(g_jax.norm()))


def test_fused_step_matches_unfused_step(damped):
    """The port's fused step against its own unfused step from the same
    state: one-pass against two-pass BN moments, 1e-4 on the loss."""
    _, params, stats = damped
    img, lbl = _batch()
    cfg = baseline_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    losses, states = {}, {}
    for fuse in (False, True):
        c = _fused(cfg, fuse)
        states[fuse] = _port_state(params, stats, c)
        losses[fuse] = float(train_step(states[fuse], torch.from_numpy(img),
                                        torch.from_numpy(lbl), c)["loss"])
    assert abs(losses[True] - losses[False]) < 1e-4, losses
    unfused = states[False].model.state_dict()
    for k, v in states[True].model.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), unfused[k].numpy(), rtol=1e-3, atol=1e-5,
                                       err_msg=k)
