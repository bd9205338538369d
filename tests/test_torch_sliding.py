"""The port's SlidingEvaluator (CPU, plain kernels) against the JAX one on
the same synthetic domain and weights.

The histograms may differ only where a near-tie argmax flips between the
two frameworks' fp32 sums: |delta hist| <= 0.002 x scored pixels, the bound
of tests/test_torch_evaluator.py. Within the port the tile batch changes
nothing, and a one-tile image scores what ``SegEvaluator`` scores.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.data.datasets import SyntheticDataset as JaxSynthetic
from mrfp_tpu.models import MRFP as JaxMRFP
from mrfp_tpu.train.evaluator import SlidingEvaluator as JaxSlidingEvaluator
from mrfp_tpu.train.import_torch import convert_state_dict
from mrfp_tpu_torch.data import SyntheticDataset
from mrfp_tpu_torch.models import MRFP
from mrfp_tpu_torch.train.evaluator import SegEvaluator, SlidingEvaluator
from mrfp_tpu_torch.weights import eval_state_dict

from torch_oracle import make_reference_state_dict

torch.set_num_threads(2)

CROP = 32


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


@pytest.mark.parametrize("hw,tile_batch", [((48, 80), 1), ((48, 80), 3), ((24, 40), 2)])
def test_hist_matches_jax_sliding_evaluator(models, hw, tile_batch):
    """8 tiles of a 48x80 image, one by one and in chunks of 3 (the last
    chunk zero-padded); a 24x40 image smaller than the crop in one
    zero-padded tile."""
    jmodel, params, stats, port = models
    ref = JaxSlidingEvaluator(jmodel, params, stats, crop_size=CROP,
                              tile_batch=tile_batch).run(JaxSynthetic(length=2, hw=hw),
                                                         log=_quiet)
    beats = []
    got = SlidingEvaluator(port, crop_size=CROP, tile_batch=tile_batch, device="cpu").run(
        SyntheticDataset(length=2, hw=hw), log=_quiet, heartbeat=lambda: beats.append(1))
    pixels = 2 * hw[0] * hw[1]
    assert got["hist"].sum() == ref["hist"].sum() == pixels
    assert np.abs(got["hist"] - ref["hist"]).sum() <= 0.002 * pixels
    assert got["dropped"] == ref["dropped"] == 0 and got["scored"] == 2 and len(beats) == 2
    assert abs(got["mean_iu"] - ref["mean_iu"]) < 0.01


def test_tile_batch_changes_nothing(models):
    port = models[3]
    ds = SyntheticDataset(length=1, hw=(48, 80))
    hists = [SlidingEvaluator(port, crop_size=CROP, tile_batch=tb, device="cpu").run(
        ds, log=_quiet)["hist"] for tb in (1, 3, 8)]
    np.testing.assert_array_equal(hists[0], hists[1])
    np.testing.assert_array_equal(hists[0], hists[2])


def test_one_tile_image_scores_what_seg_evaluator_scores(models):
    port = models[3]
    ds = SyntheticDataset(length=2, hw=(CROP, CROP))
    sliding = SlidingEvaluator(port, crop_size=CROP, tile_batch=1, device="cpu")
    assert len(sliding.spans(CROP, CROP)) == 1
    got = sliding.run(ds, log=_quiet)
    want = SegEvaluator(port, device="cpu").run(ds, log=_quiet)
    np.testing.assert_array_equal(got["hist"], want["hist"])


@pytest.mark.parametrize("h,w", [(1024, 2048), (48, 80), (24, 40), (100, 33), (32, 32)])
def test_spans_cover_the_image(h, w):
    """Windows start on the stride ``ceil(crop * 2/3)``, the last of each
    axis clamped to the edge; together they cover every pixel; 1024x2048
    at crop 1024 is three tiles."""
    cs = 32 if h < 1024 else 1024
    ev = SlidingEvaluator(torch.nn.Identity(), crop_size=cs, device="cpu")
    spans = ev.spans(h, w)
    cover = np.zeros((h, w), np.int32)
    stride = math.ceil(cs * 2 / 3)
    for y0, x0, y1, x1 in spans:
        assert 0 <= y0 < y1 <= h and 0 <= x0 < x1 <= w
        assert y1 - y0 == min(cs, h) and x1 - x0 == min(cs, w)
        assert (y0 % stride == 0 or y1 == h) and (x0 % stride == 0 or x1 == w)
        cover[y0:y1, x0:x1] += 1
    assert cover.min() >= 1
    if (h, w) == (1024, 2048):
        assert spans == [(0, 0, 1024, 1024), (0, 683, 1024, 1707), (0, 1024, 1024, 2048)]


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


def test_mismatched_pairs_are_dropped_and_counted(models):
    got = SlidingEvaluator(models[3], crop_size=CROP, device="cpu").run(_Mismatched(),
                                                                        log=_quiet)
    assert got["dropped"] == 1 and got["scored"] == 2
    assert got["hist"].sum() == 2 * 32 * 32
