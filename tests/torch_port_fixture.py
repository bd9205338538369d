"""Shared set-up of the port's parity tests for the training extras,
accumulation and the sliding evaluator: one reference state_dict (with a
DSN head when asked) drives the JAX model and the port's, and JAX's random
draws are read back so they can be injected into the port."""

from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp

from mrfp_tpu.models import MRFP as JaxMRFP
from mrfp_tpu.train.import_torch import convert_state_dict
from mrfp_tpu_torch.models import MRFP
from mrfp_tpu_torch.weights import oc_state_from_jax, state_dict_from_jax

from torch_oracle import make_reference_state_dict

STD = 0.75
DAMP = 0.1


def add_dsn_head(sd: dict, seed: int = 3, num_classes: int = 19) -> dict:
    """``sd`` plus a random DSN head under the reference's keys."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.1):
        if len(shape) == 4:
            scale = 1.0 / np.sqrt(np.prod(shape[1:]))
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    sd = dict(sd)
    sd["module.dsn.0.weight"] = t(512, 1024, 3, 3)
    sd["module.dsn.0.bias"] = 0.1 * t(512)
    sd["module.dsn.1.weight"] = 1.0 + 0.1 * t(512)
    sd["module.dsn.1.bias"] = 0.1 * t(512)
    sd["module.dsn.1.running_mean"] = 0.1 * t(512)
    sd["module.dsn.1.running_var"] = torch.abs(1.0 + 0.1 * t(512))
    sd["module.dsn.1.num_batches_tracked"] = torch.tensor(100)
    sd["module.dsn.4.weight"] = t(num_classes, 512, 1, 1)
    sd["module.dsn.4.bias"] = 0.1 * t(num_classes)
    return sd


def reference(seed: int = 11, use_dsn: bool = False, damped: bool = False, hw: int = 48,
              hrfp_plus: bool = True):
    """``(sd, jax_model, params, batch_stats, oc)``: the reference
    state_dict as JAX trees. ``damped`` cuts every residual branch's last
    BN scale to a tenth (the gradient checks' fixture, ROADMAP C3)."""
    sd = make_reference_state_dict(seed=seed)
    if use_dsn:
        sd = add_dsn_head(sd)
    if damped:
        sd = {k: v * DAMP if k.endswith("bn3.weight") else v for k, v in sd.items()}
    jmodel = JaxMRFP(trunk="resnet-50", variant="D16", use_dsn=use_dsn, hrfp_plus=hrfp_plus)
    variables = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, hw, hw, 3)), train=False))
    variables = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), variables)
    params, stats, oc, report = convert_state_dict(sd, variables)
    assert not report["skipped"], report["skipped"]
    return sd, jmodel, params, stats, oc


def port_model(ref, oc_branch: bool = False, hrfp_plus: bool = False,
               use_dsn: bool = False, oc=None) -> MRFP:
    """The port's model with ``ref``'s weights (and ``oc``'s OC buffers, if
    given, else ``ref``'s), in train mode."""
    _sd, _jmodel, params, stats, ref_oc = ref
    model = MRFP(oc_branch=oc_branch, hrfp_plus=hrfp_plus, use_dsn=use_dsn)
    state = state_dict_from_jax(params, stats)
    if oc_branch:
        state.update(oc_state_from_jax(ref_oc if oc is None else oc))
    model.load_state_dict(state, strict=True)
    return model.train()


def jax_vars(ref):
    return {"params": jax.tree_util.tree_map(jnp.asarray, ref[2]),
            "batch_stats": jax.tree_util.tree_map(jnp.asarray, ref[3])}


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.transpose(np.asarray(a), (0, 3, 1, 2)).copy())


def np_draws(key, c: int, b: int):
    """JAX NP+'s (alpha, beta_noise) for ``key``, NCHW: what
    mrfp_tpu/perturb/np_plus.py draws from that key."""
    k1, k2 = jax.random.split(key)
    alpha = 1.0 + STD * jax.random.normal(k1, (b, 1, 1, c), jnp.float32)
    beta = STD * jax.random.normal(k2, (b, 1, 1, c), jnp.float32)
    return nchw(alpha), nchw(beta)


def dsn_keep_mask(jmodel, variables, images, dropout_key, perturb=None) -> torch.Tensor:
    """The keep mask JAX's DSN dropout draws for ``dropout_key`` in a train
    forward of ``images``, NCHW bool: read back from the dropout's output
    (a value that is 0 there was dropped, or was 0 before the dropout,
    where the mask changes nothing)."""
    _out, mut = jmodel.apply(variables, jnp.asarray(images), train=True, perturb=perturb,
                             mutable=["batch_stats", "intermediates"],
                             capture_intermediates=True, rngs={"dropout": dropout_key})
    dropped = np.asarray(mut["intermediates"]["dsn"]["Dropout_0"]["__call__"][0])
    return nchw(dropped != 0)


def rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


def assert_step_matches(start: dict, after_jax: dict, model, lr: float, wd: float) -> None:
    """The state after one port step against the JAX one: BN running
    statistics to 2e-3 relative; every parameter's ``.grad`` against the
    gradient read back from the JAX SGD update (first step, fp32 momentum)
    as ``(p0 - p1) / lr - wd * p0``, to 1e-2 of its norm (norm scales 5e-2;
    the atol covers gradients that are exactly 0), the bounds of
    tests/test_torch_train.py::test_three_baseline_steps_match_jax. The
    port's OC buffers, which the JAX tree keeps apart, are not compared."""
    got = {k: v for k, v in model.state_dict().items() if not k.startswith("OC")}
    assert sorted(got) == sorted(after_jax)
    grads = {k: p.grad for k, p in model.named_parameters()}
    for k, v in after_jax.items():
        if "running" in k:
            assert rel(got[k], v) <= 2e-3, (k, rel(got[k], v))
        elif not k.endswith("num_batches_tracked"):
            p0 = start[k].double()
            g_jax = (p0 - v.double()) / lr - wd * p0
            err, norm = float((grads[k].double() - g_jax).norm()), float(g_jax.norm())
            bound = 5e-2 if k.endswith("weight") and v.dim() == 1 else 1e-2
            assert err <= bound * norm + 1e-6, (k, err, norm)
