"""The port's fused 1x1 + BN-statistics pieces (plain versions, CPU) against
the JAX package and against torch's own layers.

- ``dot_with_stats`` against the Pallas kernel in interpret mode, at
  tests/test_pallas_dot_stats.py's shapes and tolerances (y 1e-5 fp32 and
  2e-2 bf16; the sums rtol 1e-5 with atol 1e-3 / 1e-2), and its backward
  against ``jax.vjp`` of the kernel's custom VJP with random cotangents for
  all three outputs (1e-4).
- ``batch_norm_from_stats`` against torch's train-mode ``BatchNorm2d`` on
  the same module (the one-pass variance against torch's two-pass one on
  well-conditioned data: 1e-5), running statistics included.
- ``conv1x1_with_stats`` (stride slice, autocast cast) and a fused
  Bottleneck against the unfused one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.ops.pallas_dot_stats import dot_with_stats as jax_dot_with_stats
from mrfp_tpu_torch.nn.layers import conv1x1_with_stats, conv2d
from mrfp_tpu_torch.nn.norms import batch_norm, batch_norm_from_stats
from mrfp_tpu_torch.nn.resnet import Bottleneck
from mrfp_tpu_torch.ops import cuda_dot_stats
from mrfp_tpu_torch.ops.dot_stats import (FUSION_OFF, bn_stats_fusion, bn_stats_fusion_impl,
                                          dot_with_stats)

torch.set_num_threads(2)

# (M, Cin, Cout) of tests/test_pallas_dot_stats.py; M = N * H * W with N = 2
SHAPES = [(256, 64, 256), (128, 256, 64), (512, 128, 128)]


def _operands(m, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    h = 8
    x = rng.standard_normal((2, h, m // (2 * h), cin)).astype(np.float32)  # NHWC
    w = (rng.standard_normal((cin, cout)) * 0.1).astype(np.float32)        # (Cin, Cout)
    return x, w


def _port(x_nhwc, w_io, dtype):
    x = torch.from_numpy(np.transpose(x_nhwc, (0, 3, 1, 2)).copy()).to(dtype)
    w = torch.from_numpy(w_io.T.copy()).to(dtype)
    return x, w


def _flat(y_nchw):
    """(N, C, H, W) -> the JAX layout (N*H*W, C), as float32 numpy."""
    return y_nchw.detach().float().permute(0, 2, 3, 1).reshape(-1, y_nchw.shape[1]).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_pallas(shape, dtype):
    m, cin, cout = shape
    x, w = _operands(m, cin, cout)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    y_j, s1_j, s2_j = jax_dot_with_stats(jnp.asarray(x.reshape(m, cin), jdt),
                                         jnp.asarray(w, jdt), True)
    xt, wt = _port(x, w, getattr(torch, dtype))
    y, s1, s2 = dot_with_stats(xt, wt)
    assert y.dtype == xt.dtype and s1.dtype == s2.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_flat(y), np.asarray(y_j, np.float32), rtol=tol, atol=tol)
    np.testing.assert_allclose(s1.numpy(), np.asarray(s1_j), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s2_j), rtol=1e-5, atol=1e-2)


@pytest.mark.parametrize("shape", [(64, 32, 128), (128, 256, 64)])
def test_backward_matches_pallas_vjp(shape):
    """The stats cotangents fold into dY = dy + ds1 + 2 y ds2, as the JAX
    package's ``_bwd``; dx and dw against ``jax.vjp`` of the kernel."""
    m, cin, cout = shape
    x, w = _operands(m, cin, cout, seed=1)
    rng = np.random.default_rng(2)
    dy = rng.standard_normal((m, cout)).astype(np.float32)
    ds1 = rng.standard_normal(cout).astype(np.float32)
    ds2 = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jax_dot_with_stats(a, b, True),
                     jnp.asarray(x.reshape(m, cin)), jnp.asarray(w))
    gx_j, gw_j = vjp((jnp.asarray(dy), jnp.asarray(ds1), jnp.asarray(ds2)))
    xt, wt = _port(x, w, torch.float32)
    xt.requires_grad_(True)
    wt.requires_grad_(True)
    y, s1, s2 = dot_with_stats(xt, wt)
    dy_t = torch.from_numpy(dy).reshape(x.shape[0], x.shape[1], x.shape[2], cout)
    torch.autograd.backward((y, s1, s2), (dy_t.permute(0, 3, 1, 2), torch.from_numpy(ds1),
                                          torch.from_numpy(ds2)))
    np.testing.assert_allclose(_flat(xt.grad), np.asarray(gx_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy().T, np.asarray(gw_j), rtol=1e-4, atol=1e-4)


def test_plain_sums_are_of_the_rounded_output():
    """The sums are of the stored (rounded) y, taken in fp64 and rounded
    once to fp32, so the order of the terms does not show."""
    x, w = _port(*_operands(128, 64, 64, seed=3), torch.bfloat16)
    y, s1, s2 = cuda_dot_stats.dot_with_stats_plain(x, w)
    yd = y.double()
    assert s1.dtype == s2.dtype == torch.float32
    assert torch.equal(s1, yd.sum(dim=(0, 2, 3)).float())
    assert torch.equal(s2, (yd * yd).sum(dim=(0, 2, 3)).float())
    perm = torch.randperm(y.shape[0] * y.shape[2] * y.shape[3], generator=torch.Generator().manual_seed(0))
    shuffled = yd.permute(1, 0, 2, 3).reshape(y.shape[1], -1)[:, perm]
    assert torch.equal(s1, shuffled.sum(dim=1).float())


def test_batch_norm_from_stats_matches_torch_batch_norm():
    torch.manual_seed(0)
    y = (torch.randn(3, 6, 5, 7) * 2 + 0.5).requires_grad_(True)
    bn, ref = batch_norm(6), batch_norm(6)
    with torch.no_grad():
        for m in (bn, ref):
            m.weight.copy_(torch.linspace(0.5, 1.5, 6))
            m.bias.copy_(torch.linspace(-0.2, 0.3, 6))
    bn.train(), ref.train()
    y2 = y.detach().clone().requires_grad_(True)
    out = batch_norm_from_stats(bn, y, y.sum(dim=(0, 2, 3)), (y * y).sum(dim=(0, 2, 3)),
                                3 * 5 * 7)
    want = ref(y2)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    g = torch.randn_like(out)
    out.backward(g)
    want.backward(g)
    torch.testing.assert_close(y.grad, y2.grad, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(bn.weight.grad, ref.weight.grad, rtol=1e-4, atol=1e-5)
    for k in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(bn, k), getattr(ref, k), rtol=1e-6, atol=1e-6)
    assert int(bn.num_batches_tracked) == int(ref.num_batches_tracked) == 1
    yb = y.detach().to(torch.bfloat16)
    assert batch_norm_from_stats(bn, yb, yb.float().sum((0, 2, 3)),
                                 (yb.float() ** 2).sum((0, 2, 3)), 105).dtype == torch.bfloat16


def test_conv1x1_with_stats_strides_and_autocasts():
    torch.manual_seed(1)
    conv = conv2d(8, 12, 1, 2)
    x = torch.randn(2, 8, 9, 11)
    y, s1, s2, n = conv1x1_with_stats(conv, x)
    want = conv(x)
    assert n == 2 * 5 * 6 and y.shape == want.shape
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s1, want.sum(dim=(0, 2, 3)), rtol=1e-5, atol=1e-4)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        yb, *_ = conv1x1_with_stats(conv, x)
    assert yb.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="1x1"):
        conv1x1_with_stats(conv2d(8, 12, 3, 1, 1), x)


def test_fusion_switch_carries_impl():
    assert bn_stats_fusion_impl() is FUSION_OFF
    with bn_stats_fusion("plain"):
        assert bn_stats_fusion_impl() == "plain"
        with bn_stats_fusion():
            assert bn_stats_fusion_impl() is None
        assert bn_stats_fusion_impl() == "plain"
    assert bn_stats_fusion_impl() is FUSION_OFF
    with pytest.raises(ValueError):
        with bn_stats_fusion("cuda"):
            pass


def test_fused_bottleneck_matches_unfused():
    """A stride-2 bottleneck with a downsample: the fused train forward and
    backward match the unfused ones (one-pass against two-pass variance:
    1e-4), the running statistics too; eval ignores the switch."""
    torch.manual_seed(2)
    block = Bottleneck(32, 16, stride=2, downsample=True)
    twin = Bottleneck(32, 16, stride=2, downsample=True)
    twin.load_state_dict(block.state_dict())
    x = torch.randn(2, 32, 10, 12)
    xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    block.train(), twin.train()
    with bn_stats_fusion():
        out = block(xa)
    want = twin(xb)
    torch.testing.assert_close(out, want, rtol=1e-4, atol=1e-4)
    out.square().sum().backward()
    want.square().sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-4, atol=1e-4)
    grads = {k: p.grad for k, p in twin.named_parameters()}
    for k, p in block.named_parameters():
        torch.testing.assert_close(p.grad, grads[k], rtol=1e-3, atol=1e-4, msg=k)
    ref_state = twin.state_dict()
    for k, v in block.state_dict().items():
        torch.testing.assert_close(v, ref_state[k], rtol=1e-5, atol=1e-6, msg=k)
    twin.load_state_dict(block.state_dict())
    block.eval(), twin.eval()
    with torch.no_grad(), bn_stats_fusion():
        assert torch.equal(block(x), twin(x))
