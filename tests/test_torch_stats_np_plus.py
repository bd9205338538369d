"""The port's per-channel sums and NP+ apply (plain versions, CPU) against
the Pallas kernels in interpret mode (mrfp_tpu/ops/pallas_stats.py,
mrfp_tpu/ops/pallas_np_plus.py), with those files' tests' tolerances:
sums 1e-5 relative (1e-4 absolute), NP+ 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.ops import pallas_stats
from mrfp_tpu.ops.pallas_np_plus import (normalization_perturbation_plus_pallas,
                                         np_plus_apply_pallas)
from mrfp_tpu_torch.ops import cuda_np_plus
from mrfp_tpu_torch.ops.np_plus import normalization_perturbation_plus_fused, np_plus_apply
from mrfp_tpu_torch.ops.stats import channel_stats, channel_sums

torch.set_num_threads(2)
STD = 0.75


def _nchw(a):
    return torch.from_numpy(np.transpose(np.asarray(a, np.float32), (0, 3, 1, 2)).copy())


def _nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


@pytest.mark.parametrize("shape", [(4, 32, 32, 64), (2, 16, 16, 256), (4, 16, 16, 48),
                                   (8, 16, 16, 19)])
def test_channel_sums_match_pallas(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    s1_j, s2_j = pallas_stats._channel_sums_pallas(jnp.asarray(x), interpret=True)
    s1, s2 = channel_sums(_nchw(x))
    assert s1.dtype == s2.dtype == torch.float32
    np.testing.assert_allclose(s1.numpy(), np.asarray(s1_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), np.asarray(s2_j), rtol=1e-5, atol=1e-4)


def test_channel_sums_vjp_and_stats_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    g1 = rng.standard_normal(16).astype(np.float32)
    g2 = rng.standard_normal(16).astype(np.float32)
    _, vjp = jax.vjp(pallas_stats.channel_sums, jnp.asarray(x))
    (gx_j,) = vjp((jnp.asarray(g1), jnp.asarray(g2)))
    xt = _nchw(x).requires_grad_(True)
    torch.autograd.backward(channel_sums(xt), (torch.from_numpy(g1), torch.from_numpy(g2)))
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(gx_j), rtol=1e-5, atol=1e-6)
    mean_j, var_j = pallas_stats.channel_stats(jnp.asarray(x))
    mean, var = channel_stats(_nchw(x))
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hw", [(16, 16), (25, 16)])
def test_np_plus_apply_matches_pallas(hw):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, *hw, 8)).astype(np.float32)
    alpha = rng.standard_normal((3, 1, 1, 8)).astype(np.float32)
    shift = rng.standard_normal((3, 1, 1, 8)).astype(np.float32)
    ref = np_plus_apply_pallas(jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(shift),
                               block_h=16, interpret=True)
    got = np_plus_apply(_nchw(x), _nchw(alpha), _nchw(shift))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-6, atol=1e-6)
    xb = _nchw(x).to(torch.bfloat16)
    out = cuda_np_plus.np_plus_apply_plain(xb, _nchw(alpha), _nchw(shift))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, (xb.float() * _nchw(alpha) + _nchw(shift)).to(torch.bfloat16))


def test_fused_np_plus_matches_pallas_with_injected_draws():
    """NP+ with the fused apply: the JAX draws from one key, injected into
    the port as (alpha, beta_noise)."""
    feat = np.random.default_rng(3).standard_normal((4, 16, 16, 8)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = normalization_perturbation_plus_pallas(key, jnp.asarray(feat), interpret=True)
    k1, k2 = jax.random.split(key)
    alpha = 1.0 + STD * jax.random.normal(k1, (4, 1, 1, 8), jnp.float32)
    beta_noise = STD * jax.random.normal(k2, (4, 1, 1, 8), jnp.float32)
    got = normalization_perturbation_plus_fused((_nchw(alpha), _nchw(beta_noise)),
                                                _nchw(feat))
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-5, atol=1e-5)
    drawn = normalization_perturbation_plus_fused(torch.Generator().manual_seed(0),
                                                  _nchw(feat))
    assert drawn.shape == (4, 8, 16, 16) and torch.isfinite(drawn).all()
