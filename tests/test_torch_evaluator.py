"""The port's SegEvaluator (CPU, plain kernels) against the JAX SegEvaluator
on the same synthetic domain and weights, in the exact-shape protocol at
eval_batch 1 and 2 and in bucket mode.

The histograms may differ only where a near-tie argmax flips between the
two frameworks' fp32 sums: the bound is |delta hist| <= 0.002 x scored
pixels (each flip moves two entries by one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.data.datasets import SyntheticDataset as JaxSynthetic
from mrfp_tpu.models import MRFP as JaxMRFP
from mrfp_tpu.train.evaluator import SegEvaluator as JaxSegEvaluator
from mrfp_tpu.train.import_torch import convert_state_dict
from mrfp_tpu_torch.data import SyntheticDataset
from mrfp_tpu_torch.models import MRFP
from mrfp_tpu_torch.train.evaluator import SegEvaluator
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
    port = MRFP()
    port.load_state_dict(eval_state_dict(sd)[0], strict=True)
    return jmodel, params, stats, port


def _quiet(*_a, **_k):
    pass


@pytest.mark.parametrize("eval_batch,bucket", [(1, None), (2, None), (1, 32)])
def test_hist_matches_jax_evaluator(models, eval_batch, bucket):
    jmodel, params, stats, port = models
    ref = JaxSegEvaluator(jmodel, params, stats, bucket=bucket,
                          eval_batch=eval_batch).run(
        JaxSynthetic(length=3, hw=(48, 64)), log=_quiet)
    beats = []
    got = SegEvaluator(port, bucket=bucket, eval_batch=eval_batch, device="cpu").run(
        SyntheticDataset(length=3, hw=(48, 64)), log=_quiet,
        heartbeat=lambda: beats.append(1))
    pixels = 3 * 48 * 64
    assert got["hist"].sum() == ref["hist"].sum() == pixels
    assert np.abs(got["hist"] - ref["hist"]).sum() <= 0.002 * pixels
    assert got["dropped"] == ref["dropped"] == 0
    assert got["scored"] == 3
    assert abs(got["mean_iu"] - ref["mean_iu"]) < 0.01


class _Mismatched:
    """Item 1's label is one row short of its image."""

    name = "mismatched"

    def __init__(self):
        self.base = SyntheticDataset(length=3, hw=(32, 32))

    def __len__(self):
        return 3

    def __getitem__(self, i):
        s = self.base[i]
        return {"image": s["image"], "label": s["label"][:-1] if i == 1 else s["label"]}


@pytest.mark.parametrize("strict", [True, False])
def test_strict_pairs_drop_and_count(models, strict):
    port = models[3]
    got = SegEvaluator(port, strict_pairs=strict, device="cpu").run(
        _Mismatched(), log=_quiet)
    if strict:
        assert got["dropped"] == 1 and got["scored"] == 2
        assert got["hist"].sum() == 2 * 32 * 32
    else:
        assert got["dropped"] == 0 and got["scored"] == 3
        assert got["hist"].sum() == 2 * 32 * 32 + 31 * 32


def test_heartbeat_every_four_images(models):
    beats = []
    SegEvaluator(models[3], eval_batch=2, device="cpu").run(
        SyntheticDataset(length=9, hw=(32, 32)), log=_quiet,
        heartbeat=lambda: beats.append(1))
    assert len(beats) == 2  # after images 4 and 8; the last (9th) is < 4 later
