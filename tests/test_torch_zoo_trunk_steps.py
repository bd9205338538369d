"""One fp32 zoo step of each of the zoo's other trunks (MobileNetV2,
ShuffleNetV2, MNASNet 0.5/1.0, SE-ResNeXt-50/101) in the port against JAX's
``zoo_train_step`` on the CPU, from one numpy-seeded JAX tree on the damped
fixture (``torch_zoo_fixture.zoo_trunk_reference``; SE-ResNeXt-101 at depth
(1, 1, 2, 1) in both packages).

Batch 4 at 64 px, lr 1 (JAX's gradient reads back from its update), the
DSN head with JAX's dropout mask for its step-0 key, the whitening loss
with fixed strictly-upper masks where the trunk collects maps. Bounds:
every loss within 5e-4; BN and SwitchWhiten running statistics within
2e-3 relative; every raw gradient within 1e-2 of its norm (norm scales
5e-2), PR 11's bounds, plus 3x both packages' own 1e-7-input controls
(the same step on the input moved by a rounding step, as
tests/test_torch_dist.py holds its fp32 steps): an fp32 step through these
narrow depthwise trunks flips ReLUs near zero in both packages, and on
raw 0-255 images JAX's one-pass BatchNorm variance (ROADMAP C1) puts its
gradient further from the fp64 one than the bound (ROADMAP C12).
"""

import dataclasses
import functools

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.core.config import Config as JaxConfig
from mrfp_tpu.train.state import TrainState as JaxTrainState
from mrfp_tpu.train.state import make_optimizer as jax_make_optimizer
from mrfp_tpu.train.zoo_step import zoo_train_step as jax_zoo_train_step
from mrfp_tpu_torch.core.config import Config
from mrfp_tpu_torch.models import deepv3_zoo
from mrfp_tpu_torch.train.state import create_train_state
from mrfp_tpu_torch.train.zoo_step import zoo_train_step
from mrfp_tpu_torch.weights import state_dict_from_jax

from torch_port_fixture import rel
from torch_zoo_fixture import ZOO_TRUNK_CASES, jax_vars, nchw, zoo_trunk_reference

torch.set_num_threads(2)

HW, BATCH = 64, 4
NUDGE = 1 + 1e-7  # the controls' input: one rounding step away


def _keep_mask(jmodel, variables, img, key) -> torch.Tensor:
    """JAX's DSN dropout keep mask for ``key``, read back from the
    dropout's output (jitted: the eager forward dispatches op by op)."""
    @jax.jit
    def dropout_out(v, x, k):
        _out, mut = jmodel.apply(v, x, train=True, mutable=["batch_stats", "intermediates"],
                                 capture_intermediates=lambda m, _: isinstance(m, flax_nn.Dropout),
                                 rngs={"dropout": k})
        return mut["intermediates"]["dsn"]["Dropout_0"]["__call__"][0]
    return nchw(np.asarray(dropout_out(variables, jnp.asarray(img), key)) != 0)


def _jax_state(jcfg, params, stats):
    """JAX's ``create_train_state`` over the given variables, without its
    initialising forward: the same optimizer, step 0 and base key."""
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                         batch_stats=jax.tree_util.tree_map(jnp.asarray, stats), oc_params=None,
                         opt_state=jax_make_optimizer(jcfg.train).init(params),
                         base_key=jax.random.split(jax.random.PRNGKey(jcfg.train.seed))[1])


def step_inputs(trunk: str, wt, seed: int = 14):
    """Normalised images (as tests/test_torch_resnet_family.py's steps
    take), each of its own contrast and brightness, so that the batch's
    globally pooled features differ. JAX's BatchNorm takes its variance in
    one fp32 pass (ROADMAP C1), which loses digits wherever a batch's mean
    is large beside its spread: on raw 0-255 images, or on images alike
    at the ASPP image pool."""
    rng = np.random.default_rng(seed)
    gain = np.linspace(0.5, 1.5, BATCH, dtype=np.float32)[:, None, None, None]
    offset = np.linspace(-0.5, 0.5, BATCH, dtype=np.float32)[::-1, None, None, None]
    img = (rng.standard_normal((BATCH, HW, HW, 3)) * gain + offset).astype(np.float32)
    lbl = rng.integers(0, 19, (BATCH, HW, HW)).astype(np.int32)
    lbl[0, :5] = 255
    dims = [deepv3_zoo.SLOT_CHANNELS[trunk][i] for i, c in enumerate(wt)
            if c in (1, 2) and i in deepv3_zoo.iw_slots(trunk)]
    masks = [np.triu(np.ones((d, d), np.float32), 1) for d in dims]
    return img, lbl, masks, [float(m.sum()) for m in masks]


@pytest.mark.parametrize("trunk", sorted(ZOO_TRUNK_CASES))
def test_one_zoo_step_matches_jax(monkeypatch, trunk):
    variant, wt, wtloss, jmodel, params, stats = zoo_trunk_reference(monkeypatch, trunk, HW)
    img, lbl, masks, nrc = step_inputs(trunk, wt)
    jcfg = JaxConfig()
    jcfg = jcfg.replace(model=dataclasses.replace(jcfg.model, use_wtloss=wtloss),
                        train=dataclasses.replace(jcfg.train, lr=1.0))
    jstate = _jax_state(jcfg, params, stats)
    key = jax.random.fold_in(jax.random.PRNGKey(17), 0)  # zoo_train_step's draw
    keep = _keep_mask(jmodel, jax_vars(params, stats), img, key)
    step = jax.jit(functools.partial(jax_zoo_train_step, model=jmodel, cfg=jcfg,
                                     wt_masks=[jnp.asarray(m) for m in masks], wt_nrc=nrc))
    start = state_dict_from_jax(params, stats)
    cfg = Config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, use_wtloss=wtloss),
                      train=dataclasses.replace(cfg.train, lr=1.0, compute_dtype="float32"))
    wd = cfg.train.weight_decay
    runs = {}
    for name, x in (("step", img), ("control", img * np.float32(NUDGE))):
        after_state, m = step(jstate, jnp.asarray(x), jnp.asarray(lbl))
        after = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, after_state.params),
                                    jax.tree_util.tree_map(np.asarray, after_state.batch_stats))
        model = deepv3_zoo.DeepV3Plus(trunk=trunk, variant=variant, wt_layer=wt, use_dsn=True)
        model.load_state_dict(start, strict=True)
        state = create_train_state(model, cfg.train)
        got = zoo_train_step(state, torch.from_numpy(x), torch.from_numpy(lbl), cfg,
                             [torch.from_numpy(k) for k in masks], nrc, dropout=keep)
        jax_grad = {k: (start[k].double() - v.double()) - wd * start[k].double()
                    for k, v in after.items() if "running" not in k and "num_batches" not in k}
        runs[name] = (m, got, after, model, jax_grad)
    m, got, after, model, g_jax = runs["step"]
    assert ("loss_wt" in m) == wtloss
    assert sorted(k for k in got if k.startswith("loss")) == sorted(
        k for k in m if k.startswith("loss"))
    for k in m:
        if k.startswith("loss"):
            assert abs(float(got[k]) - float(m[k])) < 5e-4, (k, float(got[k]), float(m[k]))
    port_state = model.state_dict()
    assert sorted(port_state) == sorted(after)
    for k, v in after.items():
        if "running" in k:
            assert rel(port_state[k], v) <= 2e-3, (k, rel(port_state[k], v))
    g_port = {k: p.grad.double() for k, p in model.named_parameters()}
    g_port_ctl = {k: p.grad.double() for k, p in runs["control"][3].named_parameters()}
    g_jax_ctl = runs["control"][4]
    for k, gj in g_jax.items():
        err = float((g_port[k] - gj).norm())
        floor = float((g_port[k] - g_port_ctl[k]).norm()) + float((gj - g_jax_ctl[k]).norm())
        bound = 5e-2 if k.endswith("weight") and gj.dim() == 1 else 1e-2
        assert err <= bound * float(gj.norm()) + 3 * floor + 1e-6, (k, err, float(gj.norm()),
                                                                    floor)
    assert state.step == 1
