"""The port's row mix and ``take_rows`` (plain versions, CPU) against the
Pallas kernel in interpret mode (mrfp_tpu/ops/pallas_resize.py). A one-hot
row mix is a copy and its transpose sums at most two terms per element at
these scales, so forward and gradient are bit-exact in fp32 and bf16; a
general P sums in another order, hence 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.ops.pallas_resize import row_mix_pallas, take_rows as jax_take_rows
from mrfp_tpu.ops.resize import _nearest_idx_from_scale, _nearest_idx_from_size
from mrfp_tpu_torch.ops import cuda_row_mix
from mrfp_tpu_torch.ops.resize import onehot_rows, row_mix, take_rows

torch.set_num_threads(2)

# (NHWC axis, scale, dtype): tests/test_pallas_resize.py's cases
CASES = [(1, 1.205, "float32"), (2, 1.205, "bfloat16"), (1, 0.798, "float32"),
         (2, 0.838, "bfloat16")]


def _nchw(a):
    return torch.from_numpy(np.transpose(np.asarray(a, np.float32), (0, 3, 1, 2)).copy())


def _nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


@pytest.mark.parametrize("axis,scale,dtype", CASES)
def test_take_rows_matches_pallas_bit_for_bit(axis, scale, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, 20, 8)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    idx = tuple(int(i) for i in _nearest_idx_from_scale(x.shape[axis], scale))
    ref, vjp = jax.vjp(lambda a: jax_take_rows(a, idx, axis, True), jnp.asarray(x, jdt))
    xt = _nchw(x).to(getattr(torch, dtype)).requires_grad_(True)
    got = take_rows(xt, idx, axis + 1)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(_nhwc(got), np.asarray(ref, np.float32))
    g = rng.standard_normal(ref.shape).astype(np.float32)
    (gx_j,) = vjp(jnp.asarray(g, jdt))
    got.backward(_nchw(g).to(xt.dtype))
    assert xt.grad.dtype == xt.dtype
    np.testing.assert_array_equal(_nhwc(xt.grad), np.asarray(gx_j, np.float32))


def test_take_rows_size_rule():
    x = np.random.default_rng(2).standard_normal((1, 9, 5, 4)).astype(np.float32)
    idx = tuple(int(i) for i in _nearest_idx_from_size(9, 13))
    ref = jax_take_rows(jnp.asarray(x), idx, 1, True)
    np.testing.assert_array_equal(_nhwc(take_rows(_nchw(x), idx, 2)), np.asarray(ref))
    with pytest.raises(ValueError, match="outside"):
        take_rows(_nchw(x), (0, 9), 2)


@pytest.mark.parametrize("dim", [2, 3])
def test_row_mix_general_matrix_matches_pallas(dim):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    p = rng.standard_normal((11, 16)).astype(np.float32)
    ref = row_mix_pallas(jnp.asarray(x), p, dim - 1, interpret=True)
    got = row_mix(_nchw(x), torch.from_numpy(p), dim)
    np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # the plain version is the dense product, rounded once for bf16
    xb = _nchw(x).to(torch.bfloat16)
    want = torch.einsum("oh,nchw->ncow" if dim == 2 else "ow,nchw->ncho",
                        torch.from_numpy(p), xb.float()).to(torch.bfloat16)
    assert torch.equal(cuda_row_mix.row_mix_plain(xb, torch.from_numpy(p), dim), want)


def test_onehot_rows_cached_and_transposed():
    dev = torch.device("cpu")
    p = onehot_rows((0, 0, 2), 3, dev)
    assert p is onehot_rows((0, 0, 2), 3, dev)
    assert torch.equal(p, torch.tensor([[1., 0, 0], [1, 0, 0], [0, 0, 1]]))
    assert torch.equal(onehot_rows((0, 0, 2), 3, dev, transpose=True), p.t())
