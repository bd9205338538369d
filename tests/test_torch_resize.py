"""The port's bilinear resize (plain version, CPU) against the JAX package:
the Pallas kernel it replaces, run in interpret mode, and the gather form.

Both sides compute the same fp32 two-tap lerp from the same float64 tap
rule, in a different order for the gather form, hence atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.ops.pallas_resize import resize_bilinear_fused
from mrfp_tpu.ops.resize import _bilinear_taps, resize_bilinear_align_corners as jax_resize
from mrfp_tpu_torch.ops import cuda_resize
from mrfp_tpu_torch.ops.resize import (bilinear_ac_weights, bilinear_taps,
                                       resize_bilinear_align_corners)

torch.set_num_threads(2)

CASES = [
    ((1, 1), (6, 10)),     # the ASPP image-pool broadcast
    ((7, 9), (13, 21)),    # a plain upsample
    ((7, 9), (7, 15)),     # identity H axis
    ((7, 9), (1, 5)),      # out = 1 on H
    ((7, 9), (11, 1)),     # out = 1 on W
]


def _nchw(x_nhwc):
    return torch.from_numpy(np.transpose(x_nhwc, (0, 3, 1, 2)).copy())


def _nhwc(t):
    return np.transpose(t.numpy(), (0, 2, 3, 1))


@pytest.mark.parametrize("in_hw,out_hw", CASES)
def test_plain_matches_pallas_and_gather(in_hw, out_hw):
    x = np.random.default_rng(3).standard_normal((2, *in_hw, 8)).astype(np.float32)
    got = _nhwc(resize_bilinear_align_corners(_nchw(x), out_hw))
    pallas = np.asarray(resize_bilinear_fused(
        jnp.asarray(x), _bilinear_taps(in_hw[0], out_hw[0]),
        _bilinear_taps(in_hw[1], out_hw[1]), True))
    gather = np.asarray(jax_resize(jnp.asarray(x), out_hw, impl="gather"))
    assert got.shape == pallas.shape == (2, *out_hw, 8)
    np.testing.assert_allclose(got, pallas, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, gather, atol=1e-6, rtol=0)


def test_same_size_returns_input():
    x = torch.randn(1, 4, 5, 6)
    assert resize_bilinear_align_corners(x, (5, 6)) is x


def test_bf16_rounds_once():
    """bf16 in, bf16 out: the fp32 lerp rounded once to bf16."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 3, 5, 7)).astype(np.float32)).to(torch.bfloat16)
    got = resize_bilinear_align_corners(x, (9, 13))
    ref = resize_bilinear_align_corners(x.float(), (9, 13)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref)


def test_taps_follow_the_float64_rule():
    i0, i1, f = bilinear_ac_weights(64, 256)
    src = np.arange(256) * (63 / 255)
    np.testing.assert_array_equal(i0, np.floor(src).astype(np.int64))
    np.testing.assert_array_equal(i1, np.minimum(i0 + 1, 63))
    np.testing.assert_allclose(f, src - np.floor(src), atol=1e-7)
    # cached per (in, out, device): the same tensors come back
    assert bilinear_taps(64, 256, torch.device("cpu"))[0] is \
        bilinear_taps(64, 256, torch.device("cpu"))[0]


def test_impl_plain_is_the_cpu_path():
    x = torch.randn(2, 3, 4, 5)
    ty, tx = bilinear_taps(4, 8, x.device), bilinear_taps(5, 9, x.device)
    assert torch.equal(resize_bilinear_align_corners(x, (8, 9), impl="plain"),
                       cuda_resize.resize_bilinear_plain(x, ty, tx))
    with pytest.raises(ValueError):
        resize_bilinear_align_corners(x, (8, 9), impl="cuda")
