"""The zoo's other trunks in the port (``nn/mobilenet.py``,
``nn/shufflenet.py``, ``nn/mnasnet.py``, ``nn/seresnext.py``,
``nn/wider_resnet.py``; ``models/deepv3_zoo.py``) against the JAX package on
the CPU, one numpy-seeded JAX variable tree driving both through
``weights.tree_state_from_jax`` / ``state_dict_from_jax``.

- Blocks at 16-24 px, batch 2: train mode (output, whitening map, running
  statistics), then eval mode, within 1e-5 of their scale: MobileNetV2's
  inverted residual with and without the residual, dilated, with an ISW
  map; the ShuffleNetV2 unit at stride 1, 2 and dilated, with a map;
  MNASNet's inverted residual (residual, 5x5 strided, dilated); the three
  SE bottlenecks; WiderResNet's identity-residual blocks (the dropout
  ones in eval mode only: two RNGs are not compared). ``max_pool_ceil``
  on odd sizes and ``channel_shuffle`` at widths that are not symmetric,
  exactly.
- WiderResNet-16 and WiderResNetA2-16 whole, eval mode, 1e-4 of their
  scale.
- Every one of the 23 factories: the port's state_dict keys and shapes
  are those mapped from ``jax.eval_shape`` of JAX's ``init`` (no compute).
- Each new trunk's ``DeepV3Plus`` at 64 px, batch 2, on the damped
  fixture (``torch_zoo_fixture.zoo_trunk_reference``): the eval logits
  within 1e-4 of their scale, argmax agreement 99.9%. SE-ResNeXt-101 runs
  at depth (1, 1, 2, 1), both builder tables patched. One zoo step of
  each is in tests/test_torch_zoo_trunk_steps.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.models import deepv3_zoo as jax_zoo
from mrfp_tpu.nn import mnasnet as jax_mnasnet
from mrfp_tpu.nn import mobilenet as jax_mobilenet
from mrfp_tpu.nn import seresnext as jax_seresnext
from mrfp_tpu.nn import shufflenet as jax_shufflenet
from mrfp_tpu.nn import wider_resnet as jax_wrn
from mrfp_tpu_torch.models import deepv3_zoo
from mrfp_tpu_torch.nn import mnasnet, mobilenet, seresnext, shufflenet, wider_resnet
from mrfp_tpu_torch.nn.layers import max_pool_ceil
from mrfp_tpu_torch.weights import (backbone_state_from_jax, state_dict_from_jax,
                                    tree_state_from_jax)

from torch_zoo_fixture import (ZOO_TRUNK_CASES, jax_vars, nchw, nhwc, random_variables,
                               spd_running_cov, zoo_trunk_reference)

torch.set_num_threads(2)

HW = 64


def _close(got: np.ndarray, want, tol: float, what: str) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), (what, err)


# name -> (JAX block, port block, input channels, JAX call kind): "w" blocks
# take (x, w_arr, train), "t" blocks (x, train)
BLOCKS = {
    "mobilenet_ir_residual": (lambda: jax_mobilenet.InvertedResidual(16, 1, 6, in_features=16),
                              lambda: mobilenet.InvertedResidual(16, 16, 1, 6), 16, "w"),
    "mobilenet_ir_strided": (lambda: jax_mobilenet.InvertedResidual(24, 2, 6, in_features=16),
                             lambda: mobilenet.InvertedResidual(16, 24, 2, 6), 16, "w"),
    "mobilenet_ir_t1_iw2": (lambda: jax_mobilenet.InvertedResidual(16, 1, 1, in_features=32,
                                                                   iw=2),
                            lambda: mobilenet.InvertedResidual(32, 16, 1, 1, iw=2), 32, "w"),
    "mobilenet_ir_dilated_iw5": (
        lambda: jax_mobilenet.InvertedResidual(32, 1, 6, in_features=16, iw=5, dilation=2),
        lambda: mobilenet.InvertedResidual(16, 32, 1, 6, iw=5, dilation=2), 16, "w"),
    "shufflenet_stride1_iw2": (lambda: jax_shufflenet.InvertedResidual(24, 1, 1, iw=2),
                               lambda: shufflenet.InvertedResidual(24, 24, 1, 1, iw=2), 24,
                               "w"),
    "shufflenet_stride2": (lambda: jax_shufflenet.InvertedResidual(40, 2, 1),
                           lambda: shufflenet.InvertedResidual(24, 40, 2, 1), 24, "w"),
    "shufflenet_dilated_iw4": (lambda: jax_shufflenet.InvertedResidual(40, 1, 2, iw=4),
                               lambda: shufflenet.InvertedResidual(24, 40, 1, 2, iw=4), 24,
                               "w"),
    "mnasnet_ir_residual": (lambda: jax_mnasnet._InvertedResidual(16, 3, 1, 3),
                            lambda: mnasnet.InvertedResidual(16, 16, 3, 1, 3), 16, "t"),
    "mnasnet_ir_5x5_strided": (lambda: jax_mnasnet._InvertedResidual(24, 5, 2, 6),
                               lambda: mnasnet.InvertedResidual(16, 24, 5, 2, 6), 16, "t"),
    "mnasnet_ir_dilated": (lambda: jax_mnasnet._InvertedResidual(24, 5, 1, 6, dilation=2),
                           lambda: mnasnet.InvertedResidual(16, 24, 5, 1, 6, 2), 16, "t"),
    "se_resnext_strided_downsample": (
        lambda: jax_seresnext.SEBottleneckBlock(16, "seresnext", groups=8, reduction=4,
                                                stride=2, has_downsample=True),
        lambda: seresnext.SEBottleneckBlock(32, 16, "seresnext", 8, 4, 2, has_downsample=True),
        32, "t"),
    "senet_3x3_downsample": (
        lambda: jax_seresnext.SEBottleneckBlock(8, "senet", groups=8, reduction=4, stride=2,
                                                downsample_kernel=3, downsample_pad=1,
                                                has_downsample=True),
        lambda: seresnext.SEBottleneckBlock(16, 8, "senet", 8, 4, 2, 3, 1, True), 16, "t"),
    "seresnet_identity": (
        lambda: jax_seresnext.SEBottleneckBlock(8, "seresnet", groups=1, reduction=4),
        lambda: seresnext.SEBottleneckBlock(32, 8, "seresnet", 1, 4), 32, "t"),
    "wrn_basic_projection": (lambda: jax_wrn.IdentityResidualBlock((32, 32), stride=2),
                             lambda: wider_resnet.IdentityResidualBlock(16, (32, 32), 2), 16,
                             "t"),
    "wrn_basic_identity_dilated": (
        lambda: jax_wrn.IdentityResidualBlock((16, 16), dilation=2),
        lambda: wider_resnet.IdentityResidualBlock(16, (16, 16), 1, 2), 16, "t"),
    "wrn_bottleneck_dilated": (
        lambda: jax_wrn.IdentityResidualBlock((8, 16, 32), dilation=4),
        lambda: wider_resnet.IdentityResidualBlock(16, (8, 16, 32), 1, 4), 16, "t"),
    "wrn_bottleneck_dropout": (
        lambda: jax_wrn.IdentityResidualBlock((8, 16, 32), dilation=2, dropout=0.3),
        lambda: wider_resnet.IdentityResidualBlock(16, (8, 16, 32), 1, 2, 0.3), 16, "t"),
    "wrn_basic_dropout": (
        lambda: jax_wrn.IdentityResidualBlock((16, 16), dropout=0.5),
        lambda: wider_resnet.IdentityResidualBlock(16, (16, 16), 1, 1, 0.5), 16, "t"),
}


def _call_jax(block, kind, variables, x, train, w_arr):
    args = (jnp.asarray(x), w_arr, train) if kind == "w" else (jnp.asarray(x), train)
    if train:
        return block.apply(variables, *args, mutable=["batch_stats"])
    return block.apply(variables, *args), None


def _call_port(block, kind, x, w_arr):
    return block(nchw(x), w_arr) if kind == "w" else block(nchw(x))


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name):
    make_jax, make_port, cin, kind = BLOCKS[name]
    jblock, port = make_jax(), make_port()
    x = np.random.default_rng(3).standard_normal((2, 23, 20, cin)).astype(np.float32)
    kw = dict(w_arr=[], train=False) if kind == "w" else dict(train=False)
    params, stats = random_variables(jblock, x, seed=5, **kw)
    stats = spd_running_cov(stats)
    start = tree_state_from_jax(params, stats)
    port.load_state_dict(start, strict=True)
    variables = jax_vars(params, stats)
    if "dropout" not in name:  # train mode draws masks: two RNGs are not compared
        w_jax, w_port = [], []
        want, mut = _call_jax(jblock, kind, variables, x, True, w_jax)
        with torch.no_grad():
            got = _call_port(port.train(), kind, x, w_port)
        _close(nhwc(got), want, 1e-5, "train output")
        assert len(w_port) == len(w_jax) == (1 if "iw2" in name else 0)
        for a, b in zip(w_port, w_jax):
            _close(nhwc(a), b, 1e-5, "whitening map")
        after = tree_state_from_jax(params, jax.tree_util.tree_map(np.asarray,
                                                                   mut["batch_stats"]))
        moved = [k for k in after if "running" in k]
        assert moved
        for k in moved:
            _close(port.state_dict()[k].numpy(), after[k].numpy(), 1e-5, k)
        port.load_state_dict(start, strict=True)
    want, _ = _call_jax(jblock, kind, variables, x, False, [])
    with torch.no_grad():
        got = _call_port(port.eval(), kind, x, None)
    _close(nhwc(got), want, 1e-5, "eval output")


@pytest.mark.parametrize("hw", [(9, 9), (10, 13), (7, 12), (3, 3)])
def test_max_pool_ceil_matches_jax(hw):
    x = np.random.default_rng(1).standard_normal((2, *hw, 5)).astype(np.float32)
    want = np.asarray(jax_seresnext.max_pool_ceil(jnp.asarray(x)))
    got = nhwc(max_pool_ceil()(nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("c,groups", [(6, 2), (12, 3), (58, 2), (10, 5)])
def test_channel_shuffle_matches_jax(c, groups):
    x = np.random.default_rng(2).standard_normal((2, 3, 4, c)).astype(np.float32)
    want = np.asarray(jax_shufflenet.channel_shuffle(jnp.asarray(x), groups))
    np.testing.assert_array_equal(nhwc(shufflenet.channel_shuffle(nchw(x), groups)), want)
    if c == 6:  # the layout, spelled out: halves (0,1,2 | 3,4,5) interleave
        idx = nchw(np.broadcast_to(np.arange(6, dtype=np.float32), (1, 1, 1, 6)).copy())
        assert shufflenet.channel_shuffle(idx, 2)[0, :, 0, 0].tolist() == [0, 3, 1, 4, 2, 5]


@pytest.mark.parametrize("a2", [False, True])
def test_wider_resnet_16_eval_matches_jax(a2):
    jnet = jax_wrn.wider_resnet16_a2() if a2 else jax_wrn.WiderResNet(structure=(1,) * 6)
    net = wider_resnet.wider_resnet16_a2() if a2 else wider_resnet.WiderResNet((1,) * 6)
    x = np.random.default_rng(4).standard_normal((1, 64, 64, 3)).astype(np.float32)
    params, stats = random_variables(jnet, x, seed=6, train=False)
    net.load_state_dict(tree_state_from_jax(params, stats), strict=True)
    want = jax.jit(lambda v, xx: jnet.apply(v, xx, train=False))(jax_vars(params, stats),
                                                                  jnp.asarray(x))
    with torch.no_grad():
        got = net.eval()(nchw(x))
    if a2:
        assert sorted(got) == sorted(want)
        for k in want:
            _close(nhwc(got[k]), want[k], 1e-4, k)
    else:
        _close(nhwc(got), want, 1e-4, "out")


def _wt_for(trunk: str):
    """A plan with every code the trunk's slots can take: SwitchWhiten needs
    whole groups of 16 (ShuffleNetV2's 24, 116 and 232 are not; 464 is)."""
    if trunk == "shufflenetv2":
        return (0, 0, 4, 2, 1, 5, 3)
    return (0, 0, 5, 2, 4, 1, 3)


@pytest.mark.parametrize("arch", sorted(deepv3_zoo.FACTORIES))
def test_factory_keys_and_shapes_match_jax(arch):
    """Each of the 23 factories with the DSN head and a plan of iw codes:
    the port's state_dict equals, key for key and shape for shape, JAX's
    tree (``jax.eval_shape`` of ``init``: no compute) mapped by
    ``state_dict_from_jax``."""
    trunk, _variant = deepv3_zoo.arch_trunk(arch)
    wt = _wt_for(trunk)
    jmodel = jax_zoo.get_net(arch, wt_layer=wt)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                                jnp.zeros((1, 64, 64, 3)), train=False))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes)
    want = state_dict_from_jax(zeros["params"], zeros["batch_stats"])
    got = deepv3_zoo.get_net(arch, wt_layer=wt).state_dict()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(want[k].shape), (k, v.shape, want[k].shape)


def test_senet154_keys_and_shapes_match_jax():
    """SENet-154, which no factory reaches: its 3x3 stem, 64 groups and 3x3
    downsample give the same keys and shapes as JAX's tree (no compute),
    each under the ``layer<k>`` that its ``stage_of`` names."""
    shapes = jax.eval_shape(lambda: jax_seresnext.senet154().init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3))))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), shapes)
    want = backbone_state_from_jax(zeros["params"], zeros["batch_stats"])
    got = seresnext.senet154().state_dict()
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        assert tuple(v.shape) == tuple(want[k].shape), (k, v.shape, want[k].shape)
    assert {k.split(".")[1] for k in got if k.startswith("layer0.")} >= {"stem_conv3", "stem_bn3"}


@pytest.fixture
def trunk_models(monkeypatch, request):
    """``(trunk, variant, wt, use_wtloss, JAX model, params, stats)``."""
    return (request.param,) + zoo_trunk_reference(monkeypatch, request.param, HW)


def _port(trunk, variant, wt, params, stats):
    model = deepv3_zoo.DeepV3Plus(trunk=trunk, variant=variant, wt_layer=wt, use_dsn=True)
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return model


@pytest.mark.parametrize("trunk_models", sorted(ZOO_TRUNK_CASES), indirect=True)
def test_deepv3plus_eval_logits_match_jax(trunk_models):
    trunk, variant, wt, _, jmodel, params, stats = trunk_models
    x = np.random.default_rng(13).uniform(0, 255, (2, HW, HW, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, xx: jmodel.apply(v, xx, train=False)["logits"])(
        jax_vars(params, stats), jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(_port(trunk, variant, wt, params, stats).eval()(nchw(x)))
    assert got.dtype == np.float32
    _close(got, want, 1e-4, f"{trunk} eval logits")
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999
