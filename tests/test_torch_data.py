"""The port's copy of the dataset catalog (``mrfp_tpu_torch/data``) against
the JAX package's: on fake on-disk trees of every domain, both give the same
images and labels, bit for bit, through the eval pipelines, the train
pipelines (flip, color jitter, scale-crop, blur, class-uniform crops, the
frequency tail) and the synthetic weather corruptions."""

import os

import numpy as np
import pytest
from PIL import Image

from mrfp_tpu.data import datasets as jax_ds
from mrfp_tpu.data import label_maps as jax_label_maps
from mrfp_tpu.data import weather as jax_weather
from mrfp_tpu_torch.data import datasets as port_ds
from mrfp_tpu_torch.data import label_maps as port_label_maps
from mrfp_tpu_torch.data import weather as port_weather


def _png(path, arr):  # the format follows the suffix
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _rgb(seed, h=48, w=64):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8)


def _ids(seed, h=48, w=64, hi=34):
    return np.random.default_rng(seed + 100).integers(0, hi, (h, w), dtype=np.uint8)


SPLIT = "val"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """One shared data root with a ``<root>/<domain>/`` tree per domain,
    two images each, in each domain's own layout (tests/test_dataset_layout.py)."""
    base = tmp_path_factory.mktemp("data")
    for i in range(2):
        stem = f"frankfurt_00000{i}_000294"
        _png(str(base / f"cityscapes/leftImg8bit/{SPLIT}/frankfurt/{stem}_leftImg8bit.png"),
             _rgb(i))
        _png(str(base / f"cityscapes/gtFine/{SPLIT}/frankfurt/{stem}_gtFine_labelIds.png"),
             _ids(i))
        _png(str(base / f"rainy_cityscapes/leftImg8bit/{SPLIT}/lindau/{stem}_leftImg8bit.png"),
             _rgb(10 + i))
        _png(str(base / f"rainy_cityscapes/gtFine_trainvaltest/gtFine/{SPLIT}/lindau/"
                        f"{stem}_gtFine_labelIds.png"), _ids(10 + i))
        _png(str(base / f"foggy_cityscapes/leftImg8bit_foggy/{SPLIT}/zurich/"
                        f"{stem}_leftImg8bit_foggy_beta_0.01.png"), _rgb(20 + i))
        _png(str(base / f"foggy_cityscapes/gtFine_trainvaltest/gtFine/{SPLIT}/zurich/"
                        f"{stem}_gtFine_labelIds.png"), _ids(20 + i))
        _png(str(base / f"gtav/images/{SPLIT}/0000{i}.png"), _rgb(30 + i, 96, 128))
        _png(str(base / f"gtav/labels/{SPLIT}/0000{i}.png"), _ids(30 + i, 96, 128, hi=35))
        _png(str(base / f"bdd100k/images/{SPLIT}/0a0{i}.jpg"), _rgb(40 + i))
        _png(str(base / f"bdd100k/labels/{SPLIT}/0a0{i}_train_id.png"), _ids(40 + i, hi=19))
        _png(str(base / f"synthia/RGB/{SPLIT}/00000{i}.png"), _rgb(50 + i))
        _png(str(base / f"synthia/GT/LABELS/{SPLIT}/00000{i}.png"),
             np.stack([_ids(50 + i, hi=23)] * 3, -1))
        _png(str(base / f"mapillary/{SPLIT}/images/ab{i}.jpg"), _rgb(60 + i, 64, 96))
        _png(str(base / f"mapillary/{SPLIT}/labels/ab{i}.png"), _ids(60 + i, 64, 96, hi=66))
    return str(base)


DOMAINS = sorted(set(port_ds.DATASETS) - {"synthetic"})


def _pair(root, domain, **kw):
    kw = dict(split=SPLIT, base_size=64, crop_size=64, eval_size=96, **kw)
    return (jax_ds.DATASETS[domain](root=jax_ds.domain_root(root, domain), **kw),
            port_ds.DATASETS[domain](root=port_ds.domain_root(root, domain), **kw))


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_catalog_tables_match():
    assert port_ds.DATASETS.keys() == jax_ds.DATASETS.keys()
    assert port_ds.TRAIN_SPLITS == jax_ds.TRAIN_SPLITS
    assert port_ds.VAL_SPLITS == jax_ds.VAL_SPLITS
    for name in port_ds.DATASETS:
        ours, ref = port_ds.DATASETS[name], jax_ds.DATASETS[name]
        assert ours.__name__ == ref.__name__
        assert (ours.num_classes, ours.ignore_index, ours.id2cat) == \
            (ref.num_classes, ref.ignore_index, ref.id2cat)
    np.testing.assert_array_equal(port_label_maps.CITYSCAPES_PALETTE,
                                  jax_label_maps.CITYSCAPES_PALETTE)
    ids = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(port_label_maps.decode_segmap(ids),
                                  jax_label_maps.decode_segmap(ids))


@pytest.mark.parametrize("domain", DOMAINS)
def test_eval_pipeline_matches(root, domain):
    ref, ours = _pair(root, domain, train=False)
    assert len(ours) == len(ref) == 2
    for i in range(len(ref)):
        _assert_same(ref[i], ours[i])


@pytest.mark.parametrize("domain", DOMAINS)
def test_train_pipeline_matches(root, domain):
    """Several epochs, so that the per-sample draws take both sides of the
    color-jitter gate (brightness, contrast, saturation and hue run)."""
    ref, ours = _pair(root, domain, train=True, seed=3)
    for epoch in range(4):
        ref.set_epoch(epoch)
        ours.set_epoch(epoch)
        for i in range(len(ref)):
            _assert_same(ref[i], ours[i])


@pytest.mark.parametrize("kw", [{"class_uniform_pct": 1.0}, {"freq_transform": "hpf"},
                                {"freq_transform": "phot", "random_flip": False}],
                         ids=["class_uniform", "hpf", "phot"])
def test_train_options_match(root, kw):
    ref, ours = _pair(root, "gtav", train=True, seed=5, **kw)
    for epoch in range(2):
        ref.set_epoch(epoch)
        ours.set_epoch(epoch)
        for i in range(len(ref)):
            _assert_same(ref[i], ours[i])


def test_concat_matches(root):
    parts = [_pair(root, d, train=True) for d in ("gtav", "bdd100k")]
    ref = jax_ds.ConcatDataset([p[0] for p in parts])
    ours = port_ds.ConcatDataset([p[1] for p in parts])
    assert len(ours) == len(ref) == 4
    for i in range(len(ref)):
        _assert_same(ref[i], ours[i])


@pytest.mark.parametrize("kind", ["fog", "rain"])
@pytest.mark.parametrize("severity", [1, 4])
def test_weather_corruption_matches(root, kind, severity):
    ref, ours = _pair(root, "cityscapes", train=False)
    ref = jax_weather.CorruptedDataset(ref, kind, severity)
    ours = port_weather.CorruptedDataset(ours, kind, severity)
    for i in range(len(ref)):
        _assert_same(ref[i], ours[i])
