"""The port's eval forward against the JAX MRFP (R50-D16, wt_layer
(0,0,4,4,4,0,0)) on the CPU, with one set of weights driving both.

Inputs are made with numpy and transposed at the boundary (NHWC for JAX,
NCHW for the port). The tolerance is the one the repo already holds JAX to
against the torch oracle (tests/test_checkpoint_parity.py:65): both sides
run fp32 convs whose sums are taken in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.models import MRFP as JaxMRFP
from mrfp_tpu.train.import_torch import convert_state_dict
from mrfp_tpu_torch.models import MRFP
from mrfp_tpu_torch.weights import eval_state_dict

from torch_oracle import make_reference_state_dict

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    sd = make_reference_state_dict(seed=0)
    jmodel = JaxMRFP(trunk="resnet-50", variant="D16")
    variables = jmodel.init({"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, 64, 64, 3)), train=False)
    params, stats, _oc, _ = convert_state_dict(sd, variables)
    port = MRFP(trunk="resnet-50", variant="D16")
    port.load_state_dict(eval_state_dict(sd)[0], strict=True)
    return jmodel, {"params": params, "batch_stats": stats}, port


def _both(models, x, valid_hw=None):
    jmodel, variables, port = models
    kw = {} if valid_hw is None else {"valid_hw": jnp.asarray(valid_hw, jnp.int32)}
    ours = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False,
                                   mutable=False, **kw)["logits"])
    with torch.inference_mode():
        got = port(torch.from_numpy(np.transpose(x, (0, 3, 1, 2)).copy()),
                   valid_hw=valid_hw)
    return ours, np.transpose(got.numpy(), (0, 2, 3, 1))


def _check(ref, got):
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=5e-4, rtol=1e-3)
    assert (got.argmax(-1) == ref.argmax(-1)).mean() > 0.999


@pytest.mark.parametrize("hw", [(64, 64), (66, 98)])
def test_eval_logits_match_jax(models, hw):
    x = np.random.default_rng(1).standard_normal((1, *hw, 3)).astype(np.float32)
    _check(*_both(models, x))


@pytest.mark.parametrize("valid", [(50, 60), (30, 40)])
def test_valid_hw_masked_pool_matches_jax(models, valid):
    """An image zero-padded to 64x64: ASPP pools over the valid region,
    (v + 15) // 16 feature rows/cols (4x4 for 50x60, 2x3 for 30x40)."""
    vh, vw = valid
    x = np.zeros((1, 64, 64, 3), np.float32)
    x[:, :vh, :vw] = np.random.default_rng(2).standard_normal((1, vh, vw, 3))
    ref, got = _both(models, x, valid_hw=valid)
    _check(ref, got)
    if valid == (30, 40):  # the mask covers part of the 4x4 map: it matters
        _, unmasked = _both(models, x)
        assert np.abs(unmasked - got).max() > 1e-3


def test_train_mode_forward_raises(models):
    port = models[2]
    port.train()
    try:
        with pytest.raises(NotImplementedError, match="A4-A5"):
            port(torch.zeros(1, 3, 32, 32))
    finally:
        port.eval()
