"""The port's perturbations (CPU, plain resizes) against the JAX package:
NP+ with the draws taken from the JAX keys, and the OC branch with the JAX
OC tree mapped by ``oc_state_from_jax``.

NP+ is fp32 elementwise math over the same draws: atol 1e-5. The OC branch
runs eight conv -> nearest -> batch-stat BN -> ReLU stages in fp32; the
frameworks take their sums in different orders and JAX's BN variance is
one-pass (mean(x^2) - mean^2) where torch's is two-pass, hence atol 1e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.perturb.np_plus import normalization_perturbation_plus
from mrfp_tpu.perturb.oc_branch import oc_apply, oc_init as jax_oc_init
from mrfp_tpu_torch.perturb.np_plus import np_plus
from mrfp_tpu_torch.perturb.oc_branch import (_LAYERS, REF_NAMES, FrozenTensors,
                                              add_oc_buffers, oc_decode, oc_encode,
                                              oc_init, oc_maybe_resample, oc_params)
from mrfp_tpu_torch.weights import oc_state_from_jax

torch.set_num_threads(2)

STD = 0.75


def _nchw(a):
    return torch.from_numpy(np.transpose(np.asarray(a), (0, 3, 1, 2)).copy())


def _nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _jax_np_draws(key, b, c):
    """normalization_perturbation_plus's two draws, taken outside it
    (tests/test_perturbed_parity.py:27-32)."""
    k1, k2 = jax.random.split(key)
    alpha = 1.0 + STD * jax.random.normal(k1, (b, 1, 1, c), jnp.float32)
    beta = STD * jax.random.normal(k2, (b, 1, 1, c), jnp.float32)
    return _nchw(alpha), _nchw(beta)


@pytest.mark.parametrize("b,c,hw", [(2, 64, (12, 12)), (4, 16, (7, 9))])
def test_np_plus_matches_jax(b, c, hw):
    key = jax.random.PRNGKey(3)
    feat = np.random.default_rng(1).standard_normal((b, *hw, c)).astype(np.float32) * 2 + 0.5
    ref = np.asarray(normalization_perturbation_plus(key, jnp.asarray(feat), STD, 1.5))
    got = np_plus(_nchw(feat), _jax_np_draws(key, b, c), STD, 1.5)
    np.testing.assert_allclose(_nhwc(got), ref, atol=1e-5, rtol=1e-5)


def test_np_plus_generator_draws_and_dtype():
    feat = torch.randn(3, 8, 5, 5).to(torch.bfloat16)
    a = np_plus(feat, torch.Generator().manual_seed(4))
    b = np_plus(feat, torch.Generator().manual_seed(4))
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert not torch.equal(a, np_plus(feat, torch.Generator().manual_seed(5)))


def _port_oc(jparams):
    holder = torch.nn.Module()
    add_oc_buffers(holder)
    holder.load_state_dict(oc_state_from_jax(jax.tree_util.tree_map(np.asarray, jparams)),
                           strict=True)
    return oc_params(holder)


@pytest.mark.parametrize("h,w", [(64, 64), (66, 98)])
def test_oc_encode_decode_match_jax(h, w):
    jparams = jax_oc_init(jax.random.PRNGKey(0))
    xp = np.random.default_rng(0).standard_normal(
        (2, math.ceil(h / 4), math.ceil(w / 4), 64)).astype(np.float32)
    ref_out, ref_dec = oc_apply(jparams, jnp.asarray(xp), (h, w))
    params = _port_oc(jparams)
    dec, = oc_encode(params, _nchw(xp), (h, w))
    out = oc_decode(params, dec, (h, w))
    assert dec.shape == (2, 256, h // 2, w // 2)
    assert out.shape == (2, 64, math.ceil(h / 4), math.ceil(w / 4))
    np.testing.assert_allclose(_nhwc(dec), np.asarray(ref_dec), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref_out), atol=1e-4, rtol=1e-3)


def test_oc_gradient_reaches_the_input_only():
    holder = torch.nn.Module()
    add_oc_buffers(holder)
    holder.load_state_dict(oc_init(torch.Generator().manual_seed(0)))
    xp = torch.randn(2, 64, 12, 12, requires_grad=True)
    params = oc_params(holder)
    dec, = oc_encode(params, xp, (48, 48))
    oc_decode(params, dec, (48, 48)).square().sum().backward()
    assert xp.grad is not None and xp.grad.abs().sum() > 0
    assert all(not b.requires_grad and b.grad is None for b in holder.buffers())
    assert list(holder.parameters()) == []


def test_oc_init_statistics():
    """Kaiming fan_in std for convs; N(0, 0.5) BN weight (mynn.py:57-74)."""
    sd = oc_init(torch.Generator().manual_seed(42))
    assert len(sd) == 8 * 4
    k = sd["OClayer4.weight"]  # 128 -> 256, fan_in = 128*9
    assert k.shape == (256, 128, 3, 3)
    assert abs(k.std().item() - math.sqrt(2.0 / (128 * 9))) < 0.002
    g = torch.cat([sd[f"{bn}.weight"] for _conv, bn in REF_NAMES.values()])
    assert abs(g.std().item() - 0.5) < 0.05
    assert all((sd[f"{conv}.bias"] == 0).all() and (sd[f"{bn}.bias"] == 0).all()
               for conv, bn in REF_NAMES.values())
    assert [REF_NAMES[n][0] for n, *_ in _LAYERS] == \
        [f"OClayer{i}" for i in range(1, 5)] + [f"OCdeclayer{i}" for i in range(1, 5)]


def test_oc_resample_gate():
    holder = torch.nn.Module()
    add_oc_buffers(holder)
    before = {k: v.clone() for k, v in holder.state_dict().items()}
    oc_maybe_resample(holder, False, torch.Generator().manual_seed(1))
    assert all(torch.equal(v, before[k]) for k, v in holder.state_dict().items())
    oc_maybe_resample(holder, True, torch.Generator().manual_seed(1))
    fresh = oc_init(torch.Generator().manual_seed(1))
    assert all(torch.equal(v, fresh[k]) for k, v in holder.state_dict().items())
    assert isinstance(holder.OC1_decbn, FrozenTensors)
