"""Probes of three reference-side findings (ROADMAP C9, C10, C12), run by hand:

    python tests/torch_reference_probes.py gates-on wide [--jax-init]
    python tests/torch_reference_probes.py kmeans
    python tests/torch_reference_probes.py zoo-step se_resnext-50 [--raw]

``gates-on FAMILY``: one fp32 MRFP+ step with every gate on at batch 4,
48 px, on the damped reduced-depth family of ``torch_zoo_fixture`` (its
kernels He-normal over their fan-in; with ``--jax-init``, JAX's own init,
fan-out), JAX's jitted step against the port's fp32 and fp64 gradients of
the same loss with the same draws; prints the losses and the parameters
whose port-fp32-vs-JAX distance is largest, with the port's fp32-vs-fp64
and fp64-vs-JAX distances, each relative to the JAX gradient's norm.

``zoo-step TRUNK``: one fp32 zoo step of a zoo trunk's case in
tests/test_torch_zoo_trunk_steps.py (batch 4, 64 px, the damped fixture,
JAX's DSN dropout mask; with ``--raw``, raw 0-255 images in place of the
test's normalised ones), JAX's jitted ``zoo_train_step`` against the port's
fp32 and fp64 gradients of the same loss, printed as for ``gates-on``.

``kmeans``: the ISW mask count of ``CovMatrixISW`` (JAX's host code) on 20
seeded upper-triangular variance matrices at C = 64 and 128: how often it
is C(C-1)/2 (every off-diagonal entry) and C * C (the whole matrix).
"""

import argparse
import dataclasses
import os
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mrfp_tpu.core.config import mrfp_plus_config as jax_mrfp_plus_config  # noqa: E402
from mrfp_tpu.core.rng import step_keys  # noqa: E402
from mrfp_tpu.models import MRFP as JaxMRFP  # noqa: E402
from mrfp_tpu.nn.cov_settings import CovMatrixISW  # noqa: E402
from mrfp_tpu.perturb import oc_init  # noqa: E402
from mrfp_tpu.perturb.oc_branch import oc_maybe_resample  # noqa: E402
from mrfp_tpu.train import create_train_state, make_jitted_steps  # noqa: E402
from mrfp_tpu_torch.models import MRFP  # noqa: E402
from mrfp_tpu_torch.models.mrfp import PerturbArgs  # noqa: E402
from mrfp_tpu_torch.train.losses import cross_entropy  # noqa: E402
from mrfp_tpu_torch.weights import oc_state_from_jax, state_dict_from_jax  # noqa: E402

from torch_port_fixture import np_draws  # noqa: E402
from torch_zoo_fixture import DAMP, _is_last_bn, _set, _walk, nchw, random_variables  # noqa: E402
from torch_zoo_fixture import reduced_trunk  # noqa: E402

HW, B, WD = 48, 4, 5e-4
jax.config.update("jax_default_matmul_precision", "highest")  # as tests/conftest.py


class _Patch:
    def setitem(self, d, k, v):
        d[k] = v


def gates_on(family: str, jax_init: bool) -> None:
    trunk = reduced_trunk(_Patch(), family)
    jmodel = JaxMRFP(trunk=trunk, variant="D16")
    x = np.zeros((1, HW, HW, 3), np.float32)
    if jax_init:
        v = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jmodel.init(
            {"params": jax.random.PRNGKey(11)}, jnp.asarray(x), train=False))
        params, stats = v["params"], v["batch_stats"]
        for path, a in list(_walk(params)):
            if path[-1] == "scale" and _is_last_bn(params, path):
                _set(params, path, a * DAMP)
    else:
        params, stats = random_variables(jmodel, x, seed=11, damp=True, train=False)
    rng = np.random.default_rng(7)
    img = rng.standard_normal((B, HW, HW, 3)).astype(np.float32)
    lbl = rng.integers(0, 19, (B, HW, HW)).astype(np.int32)
    lbl[0, :5] = 255
    base_key = next(k for k in map(jax.random.PRNGKey, range(200)) if (np.asarray(
        jax.random.uniform(step_keys(k, 0)["gates"], (3,))) < 0.5).all())
    keys = step_keys(base_key, 0)
    jcfg = jax_mrfp_plus_config()
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, lr=1.0))
    oc = jax.tree_util.tree_map(np.asarray, oc_init(jax.random.PRNGKey(1)))
    new_oc = jax.tree_util.tree_map(np.asarray, oc_maybe_resample(
        jax.tree_util.tree_map(jnp.asarray, oc), jnp.asarray(True), keys["oc_resample"],
        jcfg.perturb.oc_bn_std))
    jstate = create_train_state(jmodel, jcfg.train, (1, HW, HW, 3), oc_params=oc)
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                            batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                            base_key=base_key)
    jstate, m = make_jitted_steps(jmodel, jcfg, None)[0](jstate, jnp.asarray(img),
                                                         jnp.asarray(lbl))
    after = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    start = state_dict_from_jax(params)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        model = MRFP(trunk=trunk, variant="D16", oc_branch=True, hrfp_plus=True)
        sd = state_dict_from_jax(params, stats)
        sd.update(oc_state_from_jax(new_oc))
        model.load_state_dict(sd, strict=True)
        model = model.to(dtype).train()
        draws = [tuple(t.to(dtype) for t in np_draws(keys[k], c, B)) for k, c in
                 (("np_l0", 64), ("np_l1", model.bot_fine[0].in_channels))]
        loss = cross_entropy(model(nchw(img).to(dtype), perturb=PerturbArgs(
            True, True, True, *draws)), torch.from_numpy(lbl))
        loss.backward()
        grads[dtype] = {k: p.grad.double() for k, p in model.named_parameters()}
        print(f"{family}: loss port {dtype} {float(loss):.7f}, JAX {float(m['loss']):.7f}")
    _print_rows(start, after, grads)


def zoo_step(trunk: str, raw: bool) -> None:
    from mrfp_tpu.core.config import Config as JaxConfig
    from mrfp_tpu.train.zoo_step import zoo_train_step as jax_zoo_train_step
    from mrfp_tpu_torch.models.deepv3_zoo import DeepV3Plus
    from mrfp_tpu_torch.train.losses import instance_whitening_loss
    from mrfp_tpu_torch.train.step import dsn_cross_entropy
    from test_torch_zoo_trunk_steps import HW as ZHW, _keep_mask, step_inputs
    from torch_zoo_fixture import jax_vars, zoo_trunk_reference
    variant, wt, wtloss, jmodel, params, stats = zoo_trunk_reference(_Patch(), trunk, ZHW)
    img, lbl, masks, nrc = step_inputs(trunk, wt)
    if raw:
        img = np.random.default_rng(14).uniform(0, 255, img.shape).astype(np.float32)
    jcfg = JaxConfig()
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, use_wtloss=wtloss),
                        train=dataclasses.replace(jcfg.train, lr=1.0))
    jstate = create_train_state(jmodel, jcfg.train, (1, ZHW, ZHW, 3))
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                            batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    keep = _keep_mask(jmodel, jax_vars(params, stats), img,
                      jax.random.fold_in(jax.random.PRNGKey(17), 0))
    jstate, m = jax.jit(lambda st, x, y: jax_zoo_train_step(
        st, x, y, model=jmodel, cfg=jcfg, wt_masks=[jnp.asarray(k) for k in masks],
        wt_nrc=nrc))(jstate, jnp.asarray(img), jnp.asarray(lbl))
    after = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params))
    start = state_dict_from_jax(params)
    grads = {}
    labels = torch.from_numpy(lbl).long()
    for dtype in (torch.float32, torch.float64):
        model = DeepV3Plus(trunk=trunk, variant=variant, wt_layer=wt, use_dsn=True)
        model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
        model = model.to(dtype).train()
        out = model(nchw(img).to(dtype), dropout=keep)
        loss = cross_entropy(out["logits"], labels) + 0.4 * dsn_cross_entropy(
            out["dsn"], labels, 255, None)
        if wtloss:
            loss = loss + 0.6 * instance_whitening_loss(
                out["w_arr"], [torch.from_numpy(k).to(dtype) for k in masks], 0.0,
                nrc) / len(out["w_arr"])
        loss.backward()
        grads[dtype] = {k: p.grad.double() for k, p in model.named_parameters()}
        print(f"{trunk}: loss port {dtype} {float(loss):.7f}, JAX {float(m['loss']):.7f}")
    _print_rows(start, after, grads)


def _print_rows(start, after, grads) -> None:
    rows = []
    for k, v in after.items():
        if k not in grads[torch.float32]:
            continue
        p0 = start[k].double()
        g_jax = (p0 - v.double()) - WD * p0  # lr 1: the raw gradient
        norm = float(g_jax.norm())
        if norm < 1e-6:
            continue  # a bias whose exact gradient is 0 (a BN follows)
        g32, g64 = grads[torch.float32][k], grads[torch.float64][k]
        rows.append((float((g32 - g_jax).norm()) / norm, float((g32 - g64).norm()) / norm,
                     float((g64 - g_jax).norm()) / norm, k))
    for row in sorted(rows, reverse=True)[:6]:
        print("port32-jax %.2e  port32-port64 %.2e  port64-jax %.2e  %s" % row)


def kmeans() -> None:
    for c in (64, 128):
        counts = Counter()
        for seed in range(20):
            layer = CovMatrixISW(dim=c, clusters=50)
            var = np.triu(np.random.default_rng(seed).gamma(2.0, 1e-4, (c, c)), 1)
            layer.set_variance_of_covariance(var.astype(np.float32))
            layer.set_mask_matrix()
            counts[int(layer.num_sensitive)] += 1
        print(f"C = {c}: mask counts {dict(counts)} (C(C-1)/2 = {c * (c - 1) // 2}, "
              f"C * C = {c * c})")


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="probe", required=True)
    g = sub.add_parser("gates-on")
    g.add_argument("family", choices=["basic", "bottleneck", "grouped", "wide"])
    g.add_argument("--jax-init", action="store_true")
    sub.add_parser("kmeans")
    z = sub.add_parser("zoo-step")
    z.add_argument("trunk", choices=sorted(("mobilenetv2", "shufflenetv2", "mnasnet_05",
                                            "mnasnet_10", "se_resnext-50", "se_resnext-101")))
    z.add_argument("--raw", action="store_true")
    args = p.parse_args()
    torch.set_num_threads(4)
    if args.probe == "kmeans":
        kmeans()
    elif args.probe == "zoo-step":
        zoo_step(args.trunk, args.raw)
    else:
        gates_on(args.family, args.jax_init)
