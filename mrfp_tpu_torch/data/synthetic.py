"""Data-free stand-in dataset, numpy only.

A copy of mrfp_tpu/data/datasets.py::SyntheticDataset: the same seeds give
the same images and labels. It lives apart from the real domains
(``data/datasets.py``, ``data/weather.py``) because those import PIL, which
loads only inside the function that needs real data (``cli/train.py``,
``cli/eval.py``).
"""

from __future__ import annotations

import numpy as np

# the 19 Cityscapes train classes (mrfp_tpu/data/label_maps.py:59-62)
CLASS_NAMES = ['road', 'sidewalk', 'building', 'wall', 'fence', 'pole',
               'traffic_light', 'traffic_sign', 'vegetation', 'terrain',
               'sky', 'person', 'rider', 'car', 'truck', 'bus', 'train',
               'motorcycle', 'bicycle']


class SyntheticDataset:
    """Data-free stand-in with the same protocol (tests/benchmarks)."""

    name = "synthetic"
    num_classes = 19
    ignore_index = 255
    id2cat = {i: n for i, n in enumerate(CLASS_NAMES)}

    def __init__(self, length: int = 64, hw=(768, 768), seed: int = 0,
                 num_classes: int = 19):
        self.length = length
        self.hw = tuple(hw)
        self.seed = seed
        self.num_classes = num_classes

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        rng = np.random.default_rng(self.seed * 100003 + index)
        h, w = self.hw
        img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
        lbl = rng.integers(0, self.num_classes, (h, w)).astype(np.float32)
        return {"image": img, "label": lbl}
