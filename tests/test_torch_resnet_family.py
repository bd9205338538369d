"""The port's ResNet family (``nn/resnet.py``, ``nn/norms.py`` iw codes 1-3)
against the JAX package on the CPU, one JAX variable tree driving both
through ``state_dict_from_jax``.

- Blocks at 16-24 px, train mode then eval mode: BasicBlock plain,
  strided with a downsample, dilated, and with a whitening map; a grouped
  32x4d Bottleneck and a ``base_width=128`` one, both narrow. Outputs and
  running statistics within 1e-5 of their scale (fp32 convs summed in
  another order).
- Backbones at depth (1, 1, 1, 1): the deep stem with codes in slots 0-2,
  and iw codes 1, 2 and 3 in the stem and the stages; each stage's output
  and every whitening map, in JAX's order, within 1e-4 of its scale.
- Each of the nine trunks at full depth: the port's state_dict keys and
  shapes are those mapped from ``jax.eval_shape`` of JAX's ``init``.
- Each structural family at reduced depth inside MRFP, on the damped
  fixture of ROADMAP C3: the eval forward (atol 5e-4, rtol 1e-3, argmax
  99.9%, tests/test_torch_model.py); one fp32 SGD step of the baseline
  recipe, loss within 5e-4 and every raw gradient within 1e-2 of its norm
  (norm scales 5e-2), PERF.md section 2; and the gates-on MRFP+ train
  forward with JAX's draws (logits 0.05, loss 5e-4), but for the deep
  stem, whose OC branch neither package runs (ROADMAP C8). The gates-on
  step's gradients are held on R50 by ``tests/test_torch_accum.py``, not
  here: on the wide family JAX's own fp32 gradient lies 1.4% from the
  fp64 one where the port's lies within 1.2e-5 of it (ROADMAP C9,
  ``tests/torch_reference_probes.py``).
- ``--variant`` D, D4, D16 and D32: eval logits against JAX.
- The instance norms' variance: two passes in the port, one in JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.core.config import baseline_config as jax_baseline_config
from mrfp_tpu.core.rng import step_keys
from mrfp_tpu.models import MRFP as JaxMRFP
from mrfp_tpu.nn import norms as jax_norms
from mrfp_tpu.nn import resnet as jax_resnet
from mrfp_tpu.perturb import oc_init as jax_oc_init
from mrfp_tpu.train import create_train_state as jax_create_train_state
from mrfp_tpu.train import make_jitted_steps
from mrfp_tpu.train.losses import cross_entropy as jax_cross_entropy
from mrfp_tpu_torch.core.config import baseline_config
from mrfp_tpu_torch.models import MRFP
from mrfp_tpu_torch.models.mrfp import PerturbArgs
from mrfp_tpu_torch.nn import norms
from mrfp_tpu_torch.nn.resnet import RESNET_TRUNKS, BasicBlock, Bottleneck, ResNet
from mrfp_tpu_torch.train.losses import cross_entropy
from mrfp_tpu_torch.train.state import create_train_state
from mrfp_tpu_torch.train.step import train_step
from mrfp_tpu_torch.weights import (backbone_state_from_jax, block_state_from_jax,
                                    oc_state_from_jax, state_dict_from_jax)

from torch_port_fixture import assert_step_matches, np_draws
from torch_zoo_fixture import (FAMILIES, jax_vars, nchw, nhwc, random_variables,
                               reduced_trunk)

torch.set_num_threads(2)

HW = 48


def _close(got: np.ndarray, want: np.ndarray, tol: float, what: str) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    assert err <= tol * max(scale, 1.0), (what, err, scale)


# name -> (JAX block, port block, input channels)
BLOCKS = {
    "basic": (lambda: jax_resnet.BasicBlock(planes=16),
              lambda: BasicBlock(16, 16), 16),
    "basic_strided_downsample": (
        lambda: jax_resnet.BasicBlock(planes=32, stride=2, downsample=True),
        lambda: BasicBlock(16, 32, stride=2, downsample=True), 16),
    "basic_dilated": (lambda: jax_resnet.BasicBlock(planes=16, dilation=2),
                      lambda: BasicBlock(16, 16, dilation=2), 16),
    "basic_dilated_downsample_iw2": (
        lambda: jax_resnet.BasicBlock(planes=32, dilation=2, downsample=True, iw=2),
        lambda: BasicBlock(16, 32, dilation=2, downsample=True, iw=2), 16),
    "resnext_32x4d": (
        lambda: jax_resnet.Bottleneck(planes=16, stride=2, downsample=True, groups=32,
                                      base_width=4),
        lambda: Bottleneck(32, 16, stride=2, downsample=True, groups=32, base_width=4), 32),
    "wide_base_width_128_iw1": (
        lambda: jax_resnet.Bottleneck(planes=8, dilation=2, downsample=True, base_width=128,
                                      iw=1),
        lambda: Bottleneck(16, 8, dilation=2, downsample=True, base_width=128, iw=1), 16),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name):
    make_jax, make_port, cin = BLOCKS[name]
    jblock, port = make_jax(), make_port()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 24, 20, cin)).astype(np.float32)
    params, stats = random_variables(jblock, x, seed=5, w_arr=[], train=False)
    port.load_state_dict(block_state_from_jax(params, stats), strict=True)
    if name.startswith("resnext"):  # the grouped 3x3's torch layout
        assert tuple(port.conv2.weight.shape) == (32, 1, 3, 3)
    variables = jax_vars(params, stats)
    w_jax = []
    want, mut = jblock.apply(variables, jnp.asarray(x), w_jax, True, mutable=["batch_stats"])
    port.train()
    w_port = []
    got = port(nchw(x), None, w_port)
    _close(nhwc(got), want, 1e-5, "train output")
    assert len(w_port) == len(w_jax) == (1 if "iw" in name else 0)
    for a, b in zip(w_port, w_jax):
        _close(nhwc(a), b, 1e-5, "whitening map")
    after = block_state_from_jax(params, jax.tree_util.tree_map(np.asarray,
                                                                 mut["batch_stats"]))
    for k, v in port.state_dict().items():
        if "running" in k:
            _close(v.numpy(), after[k].numpy(), 1e-5, k)
    port.eval()
    port.load_state_dict(block_state_from_jax(params, stats), strict=True)
    with torch.no_grad():
        got = port(nchw(x))
    want = jblock.apply(variables, jnp.asarray(x), [], False)
    _close(nhwc(got), want, 1e-5, "eval output")


# name -> (ResNet arguments, wt_layer)
BACKBONES = {
    "deep_stem_codes_2_3_4": (dict(block="bottleneck", deep_stem=True), (2, 3, 4, 0, 0, 0, 0)),
    "deep_stem_codes_1_4_2": (dict(block="bottleneck", deep_stem=True), (1, 4, 2, 2, 0, 3, 0)),
    "basic_iw_1_2_3": (dict(block="basic"), (0, 0, 2, 1, 3, 2, 1)),
    "bottleneck_iw_1_2_3": (dict(block="bottleneck"), (0, 0, 3, 2, 1, 0, 2)),
    "grouped_iw_2": (dict(block="bottleneck", groups=32, base_width=4), (0, 0, 0, 2, 2, 2, 0)),
}


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_backbone_and_whitening_maps_match_jax(name):
    """Stem and stages at depth (1, 1, 1, 1), D16, 64 px, batch 2, in train
    mode: each stage's output and every whitening map, in the order JAX
    collects them (stem slots 0-2, then the stages' last blocks)."""
    kw, wt = BACKBONES[name]
    jnet = jax_resnet.ResNet(layers=(1, 1, 1, 1), wt_layer=wt, variant="D16", **kw)
    x = np.random.default_rng(4).standard_normal((2, 64, 64, 3)).astype(np.float32)
    params, stats = random_variables(jnet, x, seed=6, train=False)
    want, _ = jnet.apply(jax_vars(params, stats), jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    net = ResNet(layers=(1, 1, 1, 1), wt_layer=wt, variant="D16", **kw)
    net.load_state_dict(backbone_state_from_jax(params, stats), strict=True)
    net.train()
    w_arr = []
    with torch.no_grad():
        feat = net.layer0(nchw(x), w_arr)
        _close(nhwc(feat), want["stem"], 1e-4, "stem")
        for i in range(1, 5):
            feat = getattr(net, f"layer{i}")(feat, None, w_arr)
            _close(nhwc(feat), want[f"layer{i}"], 1e-4, f"layer{i}")
    n_maps = sum(c in (1, 2) for c in (wt if kw.get("deep_stem") else wt[2:]))
    assert len(w_arr) == len(want["w_arr"]) == n_maps
    for i, (a, b) in enumerate(zip(w_arr, want["w_arr"])):
        _close(nhwc(a), b, 1e-4, f"w_arr[{i}]")


@pytest.mark.parametrize("trunk", RESNET_TRUNKS)
def test_full_depth_keys_and_shapes_match_jax(trunk):
    """The nine trunks inside MRFP with the DSN head, at full depth: the
    port's state_dict equals, key for key and shape for shape, the JAX
    tree's (``jax.eval_shape`` of ``init``: no compute) mapped by
    ``state_dict_from_jax``."""
    jmodel = JaxMRFP(trunk=trunk, variant="D16", use_dsn=True)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                                jnp.zeros((1, 64, 64, 3)), train=False))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes)
    want = state_dict_from_jax(zeros["params"], zeros["batch_stats"])
    got = MRFP(trunk=trunk, variant="D16", use_dsn=True).state_dict()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(want[k].shape), (k, v.shape, want[k].shape)


def _family_reference(monkeypatch, family, damp=False, layers=(1, 1, 1, 1), variant="D16",
                      seed=11):
    trunk = reduced_trunk(monkeypatch, family, layers)
    jmodel = JaxMRFP(trunk=trunk, variant=variant)
    x = np.zeros((1, HW, HW, 3), np.float32)
    params, stats = random_variables(jmodel, x, seed=seed, damp=damp, train=False)
    port = MRFP(trunk=trunk, variant=variant)
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return trunk, jmodel, params, stats, port


def _eval_both(jmodel, params, stats, port, x):
    want = np.asarray(jmodel.apply(jax_vars(params, stats), jnp.asarray(x), train=False,
                                   mutable=False)["logits"])
    with torch.no_grad():
        got = nhwc(port.eval()(nchw(x)))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)
    assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.999


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_eval_forward_matches_jax(monkeypatch, family):
    _trunk, jmodel, params, stats, port = _family_reference(monkeypatch, family)
    x = np.random.default_rng(1).standard_normal((1, 64, 80, 3)).astype(np.float32)
    _eval_both(jmodel, params, stats, port, x)


@pytest.mark.parametrize("variant", ["D", "D4", "D16", "D32"])
def test_variant_eval_logits_match_jax(monkeypatch, variant):
    """The dilation plans, at two blocks a stage so that a stage's later
    blocks carry the dilation too."""
    _trunk, jmodel, params, stats, port = _family_reference(
        monkeypatch, "bottleneck", layers=(2, 2, 2, 2), variant=variant)
    x = np.random.default_rng(2).standard_normal((1, 64, 64, 3)).astype(np.float32)
    _eval_both(jmodel, params, stats, port, x)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_step_matches_jax(monkeypatch, family):
    """One fp32 SGD step of the baseline MRFP recipe at batch 4, lr 1
    (JAX's gradient reads back from its update exactly), on the damped
    fixture, against the jitted JAX step."""
    trunk, _jmodel, params, stats, _ = _family_reference(monkeypatch, family, damp=True)
    jcfg = jax_baseline_config()
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train, lr=1.0))
    cfg = baseline_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, trunk=trunk),
                      train=dataclasses.replace(cfg.train, lr=1.0, compute_dtype="float32"))
    img, lbl = _step_batch()
    jmodel = JaxMRFP(trunk=trunk, variant="D16", hrfp_plus=False)
    jstate = jax_create_train_state(jmodel, jcfg.train, (1, HW, HW, 3))
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                            batch_stats=jax.tree_util.tree_map(jnp.asarray, stats))
    jtrain, _ = make_jitted_steps(jmodel, jcfg, None)
    jstate, m = jtrain(jstate, jnp.asarray(img), jnp.asarray(lbl))

    model = MRFP(trunk=trunk, variant="D16", hrfp_plus=False)
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    state = create_train_state(model.train(), cfg.train)
    got = train_step(state, torch.from_numpy(img), torch.from_numpy(lbl), cfg)
    assert abs(float(got["loss"]) - float(m["loss"])) < 5e-4, (float(got["loss"]),
                                                               float(m["loss"]))
    after = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                                jax.tree_util.tree_map(np.asarray, jstate.batch_stats))
    assert_step_matches(state_dict_from_jax(params, stats), after, model, 1.0,
                        cfg.train.weight_decay)


def _step_batch():
    rng = np.random.default_rng(7)
    img = rng.standard_normal((4, HW, HW, 3)).astype(np.float32)
    lbl = rng.integers(0, 19, (4, HW, HW)).astype(np.int32)
    lbl[0, :5] = 255
    return img, lbl


@pytest.mark.parametrize("family", sorted(set(FAMILIES) - {"deep_stem"}))
def test_family_gates_on_forward_matches_jax(monkeypatch, family):
    """The MRFP+ train forward with every gate on, JAX's OC parameters and
    NP+ draws injected (NP+ at the stem's width and layer1's, 64 or 256):
    logits within 0.05 and the loss within 5e-4, the train-forward bounds
    of tests/test_torch_train.py. The deep stem has no OC branch in either
    package (ROADMAP C8)."""
    from mrfp_tpu.models.mrfp import PerturbArgs as JaxPerturbArgs
    trunk, jmodel, params, stats, _ = _family_reference(monkeypatch, family, damp=True)
    img, lbl = _step_batch()
    oc = jax.tree_util.tree_map(np.asarray, jax_oc_init(jax.random.PRNGKey(1)))
    keys = step_keys(jax.random.PRNGKey(0), 0)
    jp = JaxPerturbArgs(gate_oc=jnp.asarray(True), gate_np=jnp.asarray(True),
                        gate_dec=jnp.asarray(True), key_np0=keys["np_l0"],
                        key_np1=keys["np_l1"], oc_params=jax.tree_util.tree_map(jnp.asarray, oc))
    out, _ = jmodel.apply(jax_vars(params, stats), jnp.asarray(img), train=True, perturb=jp,
                          mutable=["batch_stats"])
    want = np.asarray(out["logits"])
    model = MRFP(trunk=trunk, variant="D16", oc_branch=True, hrfp_plus=True)
    state_dict = state_dict_from_jax(params, stats)
    state_dict.update(oc_state_from_jax(oc))
    model.load_state_dict(state_dict, strict=True)
    perturb = PerturbArgs(True, True, True, np_draws(keys["np_l0"], 64, 4),
                          np_draws(keys["np_l1"], model.bot_fine[0].in_channels, 4))
    with torch.no_grad():
        got = model.train()(nchw(img), perturb=perturb)
    assert np.abs(nhwc(got) - want).max() < 0.05, np.abs(nhwc(got) - want).max()
    loss_jax = float(jax_cross_entropy(jnp.asarray(want), jnp.asarray(lbl), 255))
    loss_port = float(cross_entropy(got, torch.from_numpy(lbl)))
    assert abs(loss_jax - loss_port) < 5e-4, (loss_jax, loss_port)


def test_resnet101_refuses_the_oc_branch_as_jax_cannot_trace_it(monkeypatch):
    """ROADMAP C8: the deep stem gives 128 channels and the OC branch reads
    64. JAX's perturbed forward fails while tracing (both halves of its
    conds are traced, whatever the gates); the port refuses the OC buffers
    at construction with a message that names the cause."""
    from mrfp_tpu.models.mrfp import PerturbArgs as JaxPerturbArgs
    trunk = reduced_trunk(monkeypatch, "deep_stem")
    jmodel = JaxMRFP(trunk=trunk, variant="D16")
    x = jnp.zeros((2, 32, 32, 3))
    variables = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, x,
                                                   train=False))
    gates_off = JaxPerturbArgs(gate_oc=jnp.asarray(False), gate_np=jnp.asarray(False),
                               gate_dec=jnp.asarray(False), key_np0=jax.random.PRNGKey(1),
                               key_np1=jax.random.PRNGKey(2),
                               oc_params=jax_oc_init(jax.random.PRNGKey(3)))
    with pytest.raises((TypeError, ValueError), match="128"):
        jax.eval_shape(lambda v: jmodel.apply(v, x, train=True, perturb=gates_off,
                                              mutable=["batch_stats"]), variables)
    with pytest.raises(ValueError, match="ROADMAP C8"):
        MRFP(trunk=trunk, oc_branch=True)
    MRFP(trunk=trunk, oc_branch=False)  # the baseline builds


def test_iw_codes_and_their_errors():
    """Codes 1-3 carry no parameters, so the state_dict layout is the
    plain one; code 5 builds SwitchWhiten; MRFP raises the JAX package's
    ValueError for a zoo-only trunk, as JAX's MRFP does."""
    for code in (1, 2, 3):
        layer = norms.make_iw_layer(code, 8)
        assert not list(layer.state_dict()) and norms.collects_map(layer) == (code != 3)
    layer = norms.make_iw_layer(5, 32)
    assert isinstance(layer, norms.SwitchWhiten2d) and not norms.collects_map(layer)
    assert tuple(layer.running_cov.shape) == (2, 16, 16)
    for trunk in ("mobilenetv2", "shufflenetv2", "se_resnext-50", "mnasnet_05"):
        jmodel = JaxMRFP(trunk=trunk)
        with pytest.raises(ValueError, match="zoo trunks live in models.deepv3_zoo"):
            jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                               jnp.zeros((1, 32, 32, 3)), train=False))
        with pytest.raises(ValueError, match="zoo trunks live in models.deepv3_zoo"):
            MRFP(trunk=trunk)
    with pytest.raises(ValueError, match="unknown trunk"):
        MRFP(trunk="resnet-9")
    with pytest.raises(ValueError, match="Bottleneck-only"):
        BasicBlock(8, 8)(torch.zeros(1, 8, 4, 4), (1, torch.zeros(1, 8, 4, 4)))


@pytest.mark.parametrize("affine", [False, True])
def test_instance_norm_variance_one_pass_vs_two_pass(affine):
    """The port's instance norms take the variance in two passes (torch's
    ``InstanceNorm2d``), JAX's in one (mrfp_tpu/nn/norms.py:97-98). On maps
    of unit spread around a small mean they agree within 1e-5; on a map
    whose mean is 300 times its spread JAX's one-pass variance loses
    digits (the ROADMAP C1 effect in BatchNorm), and the port stays within
    1e-4 of the fp64 value where JAX's does not."""
    rng = np.random.default_rng(0)
    jnorm = jax_norms.InstanceNorm(8, affine=affine)
    port = norms.make_iw_layer(4 if affine else 3, 8)
    x = rng.standard_normal((2, 12, 10, 8)).astype(np.float32)
    v = jnorm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    with torch.no_grad():
        _close(nhwc(port(nchw(x))), jnorm.apply(v, jnp.asarray(x)), 1e-5, "unit maps")
    off = (300.0 + x).astype(np.float32)
    x64 = off.astype(np.float64)
    truth = (x64 - x64.mean((1, 2), keepdims=True)) / np.sqrt(
        x64.var((1, 2), keepdims=True) + 1e-5)
    with torch.no_grad():
        got = nhwc(port(nchw(off)))
    want = np.asarray(jnorm.apply(v, jnp.asarray(off)))
    assert np.abs(got - truth).max() < 1e-4, np.abs(got - truth).max()
    assert np.abs(want - truth).max() > 1e-3, np.abs(want - truth).max()
