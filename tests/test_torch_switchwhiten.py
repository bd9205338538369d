"""The port's SwitchWhiten (``nn/norms.py::SwitchWhiten2d``, iw code 5)
against the JAX package's ``SwitchWhiten2d`` on the CPU, one numpy-seeded
set of variables driving both.

- sw_type 2, 3 and 5 at 2x32x12x10 (two groups of 16): the train output,
  and ``running_mean``/``running_cov`` after the one train update, within
  1e-5 of their scale; the eval output from the running statistics; the
  gradients with respect to the input, ``sw_mean_weight``,
  ``sw_var_weight``, ``weight`` and ``bias`` against ``jax.grad`` within
  1e-4 of their scale.
- Under a bf16 autocast: the input's dtype out, the arithmetic fp32 inside
  (bit-equal to the fp32 call on the same bf16 input).
- A ResNet trunk at depth (1, 1, 1, 1) with code 5 in the stem and three
  stages: stage outputs within 1e-4 of their scale in train mode, the
  updated running statistics within 1e-5, the eval stages too.
- ``cli.export --device cpu --check`` of a zoo model with code 5 slots.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.nn import norms as jax_norms
from mrfp_tpu.nn import resnet as jax_resnet
from mrfp_tpu_torch.cli import export as cli_export
from mrfp_tpu_torch.nn import norms
from mrfp_tpu_torch.nn.resnet import ResNet
from mrfp_tpu_torch.weights import backbone_state_from_jax

from torch_zoo_fixture import jax_vars, nchw, nhwc, random_variables

torch.set_num_threads(2)

C, SHAPE = 32, (2, 12, 10, 32)  # NHWC: two groups of 16


def _close(got: np.ndarray, want, tol: float, what: str) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1.0), (what, err)


def _variables(sw_type: int, seed: int = 0):
    """Softmax weights away from uniform, an affine away from 1/0, running
    statistics away from their start (an SPD covariance)."""
    rng = np.random.default_rng(seed)
    g = C // 16
    params = {"sw_mean_weight": rng.standard_normal(sw_type).astype(np.float32),
              "sw_var_weight": rng.standard_normal(sw_type).astype(np.float32),
              "scale": (1 + 0.2 * rng.standard_normal(C)).astype(np.float32),
              "bias": (0.2 * rng.standard_normal(C)).astype(np.float32)}
    a = 0.3 * rng.standard_normal((g, 16, 16))
    stats = {"running_mean": (0.3 * rng.standard_normal((g, 16, 1))).astype(np.float32),
             "running_cov": (np.eye(16) + a @ a.transpose(0, 2, 1) / 16).astype(np.float32)}
    return params, stats


def _input(seed: int = 1) -> np.ndarray:
    """Channels with their own means and spreads, so every statistic and
    every blend weight matters."""
    rng = np.random.default_rng(seed)
    mean = rng.uniform(-1, 1, C)
    spread = rng.uniform(0.5, 2.0, C)
    return (mean + spread * rng.standard_normal(SHAPE)).astype(np.float32)


def _port(sw_type: int, params, stats) -> norms.SwitchWhiten2d:
    layer = norms.SwitchWhiten2d(C, sw_type=sw_type)
    layer.load_state_dict({
        "sw_mean_weight": torch.from_numpy(params["sw_mean_weight"]),
        "sw_var_weight": torch.from_numpy(params["sw_var_weight"]),
        "weight": torch.from_numpy(params["scale"]), "bias": torch.from_numpy(params["bias"]),
        "running_mean": torch.from_numpy(stats["running_mean"]),
        "running_cov": torch.from_numpy(stats["running_cov"])}, strict=True)
    return layer


@pytest.mark.parametrize("sw_type", [2, 3, 5])
def test_train_output_and_running_statistics_match_jax(sw_type):
    params, stats = _variables(sw_type)
    x = _input()
    jlayer = jax_norms.SwitchWhiten2d(C, sw_type=sw_type)
    want, mut = jlayer.apply(jax_vars(params, stats), jnp.asarray(x), True,
                             mutable=["batch_stats"])
    port = _port(sw_type, params, stats).train()
    with torch.no_grad():
        got = port(nchw(x))
    _close(nhwc(got), want, 1e-5, "train output")
    for k in ("running_mean", "running_cov"):
        _close(getattr(port, k).numpy(), mut["batch_stats"][k], 1e-5, k)
    assert not np.allclose(port.running_cov.numpy(), stats["running_cov"])


@pytest.mark.parametrize("sw_type", [2, 3, 5])
def test_eval_output_matches_jax_and_moves_nothing(sw_type):
    params, stats = _variables(sw_type, seed=2)
    x = _input(seed=3)
    want = jax_norms.SwitchWhiten2d(C, sw_type=sw_type).apply(
        jax_vars(params, stats), jnp.asarray(x), False)
    port = _port(sw_type, params, stats).eval()
    with torch.no_grad():
        got = port(nchw(x))
    _close(nhwc(got), want, 1e-5, "eval output")
    np.testing.assert_array_equal(port.running_cov.numpy(), stats["running_cov"])


@pytest.mark.parametrize("sw_type", [2, 3, 5])
@pytest.mark.parametrize("train", [True, False])
def test_gradients_match_jax_grad(sw_type, train):
    params, stats = _variables(sw_type, seed=4)
    x = _input(seed=5)
    cot = np.random.default_rng(6).standard_normal(SHAPE).astype(np.float32)
    jlayer = jax_norms.SwitchWhiten2d(C, sw_type=sw_type)

    def loss(p, xx):
        out = jlayer.apply({"params": p, "batch_stats": jax.tree_util.tree_map(
            jnp.asarray, stats)}, xx, train, mutable=["batch_stats"])[0]
        return jnp.sum(out * cot)

    gp, gx = jax.grad(loss, argnums=(0, 1))(jax.tree_util.tree_map(jnp.asarray, params),
                                            jnp.asarray(x))
    port = _port(sw_type, params, stats).train(train)
    xt = nchw(x).requires_grad_(True)
    (port(xt) * nchw(cot)).sum().backward()
    _close(nhwc(xt.grad), gx, 1e-4, "d input")
    for jname, pname in (("sw_mean_weight", "sw_mean_weight"), ("sw_var_weight", "sw_var_weight"),
                         ("scale", "weight"), ("bias", "bias")):
        _close(getattr(port, pname).grad.numpy(), gp[jname], 1e-4, f"d {pname}")


def test_bf16_autocast_keeps_fp32_inside():
    """Under autocast the layer computes in fp32 (autocast off inside) and
    returns the input's dtype, bit-equal to the fp32 call on that input."""
    params, stats = _variables(5, seed=7)
    port = _port(5, params, stats).eval()
    x = nchw(_input(seed=8)).to(torch.bfloat16)
    with torch.no_grad():
        with torch.autocast("cpu", dtype=torch.bfloat16):
            got = port(x)
        want = port(x.float())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))
    with torch.no_grad():  # the input's dtype, not autocast's, decides the output's
        assert port(x.float()).dtype == torch.float32


def test_make_iw_layer_builds_code_5_and_refuses_partial_groups():
    layer = norms.make_iw_layer(5, 64)
    assert isinstance(layer, norms.SwitchWhiten2d) and not norms.collects_map(layer)
    assert (layer.sw_type, norms.SW_PERGROUP, norms.SW_T, norms.SW_EPS, norms.SW_MOMENTUM) == \
        (2, 16, 5, 1e-5, 0.99)
    assert {k: tuple(v.shape) for k, v in layer.state_dict().items()} == {
        "sw_mean_weight": (2,), "sw_var_weight": (2,), "weight": (64,), "bias": (64,),
        "running_mean": (4, 16, 1), "running_cov": (4, 16, 16)}
    with pytest.raises(ValueError, match="groups of 16"):
        norms.make_iw_layer(5, 24)  # the JAX package's reshape fails there too


WT5 = (0, 0, 5, 5, 0, 5, 5)


def test_resnet_trunk_with_code_5_matches_jax():
    """A BasicBlock ResNet at depth (1, 1, 1, 1), D16, 48 px, code 5 in the
    stem and three stages: train mode (stage outputs, then every running
    statistic), then eval mode from the start's variables."""
    jnet = jax_resnet.ResNet(block="basic", layers=(1, 1, 1, 1), wt_layer=WT5, variant="D16")
    x = np.random.default_rng(9).standard_normal((2, 48, 48, 3)).astype(np.float32)
    params, stats = random_variables(jnet, x, seed=10, train=False)
    want, mut = jnet.apply(jax_vars(params, stats), jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
    net = ResNet(block="basic", layers=(1, 1, 1, 1), wt_layer=WT5, variant="D16")
    start = backbone_state_from_jax(params, stats)
    assert sum(k.endswith("running_cov") for k in start) == 4
    net.load_state_dict(start, strict=True)
    net.train()
    with torch.no_grad():
        feat = net.layer0(nchw(x))
        _close(nhwc(feat), want["stem"], 1e-4, "stem")
        for i in range(1, 5):
            feat = getattr(net, f"layer{i}")(feat)
            _close(nhwc(feat), want[f"layer{i}"], 1e-4, f"layer{i}")
    after = backbone_state_from_jax(params, jax.tree_util.tree_map(np.asarray,
                                                                    mut["batch_stats"]))
    for k, v in net.state_dict().items():
        if "running" in k:
            _close(v.numpy(), after[k].numpy(), 1e-5, k)
    net.load_state_dict(start, strict=True)
    net.eval()
    want = jnet.apply(jax_vars(params, stats), jnp.asarray(x), train=False)
    with torch.no_grad():
        feat = net.layer0(nchw(x))
        for i in range(1, 5):
            feat = getattr(net, f"layer{i}")(feat)
            _close(nhwc(feat), want[f"layer{i}"], 1e-4, f"eval layer{i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cli_export_checks_a_code_5_model(tmp_path, dtype):
    """``cli.export --check``: the artifact of an r18-D32 zoo model with
    SwitchWhiten in four slots equals the live forward bit for bit."""
    out = str(tmp_path / "sw.pt2x")
    try:
        res = cli_export.main(["--device", "cpu", "--height", "64", "--width", "64",
                               "--trunk", "resnet-18", "--variant", "D32",
                               "--wt-layer", *map(str, WT5), "--dtype", dtype, "--check",
                               "--out", out])
        assert "bit for bit" in res["check"]
        assert res["manifest"]["model"]["wt_layer"] == list(WT5)
        assert res["manifest"]["ops"] == ["mrfp::resize_bilinear"]
    finally:
        if os.path.exists(out):
            os.unlink(out)
