"""ClassUniform, the peak-detection centroid sampler of the reference's
transforms/joint_transforms.py:552-685: the one joint transform the dataset
catalog wires (``class_uniform_pct``). A copy of the class in
mrfp_tpu/data/joint_transforms.py, whose other pair transforms no pipeline
uses.
"""

from __future__ import annotations

import random as _random
from typing import Optional

import numpy as np
from PIL import Image
from scipy.ndimage import (
    binary_erosion,
    generate_binary_structure,
    maximum_filter,
)

from mrfp_tpu_torch.data.transforms import RandomCrop


def detect_peaks(image: np.ndarray) -> np.ndarray:
    """8-connected local-maximum peaks minus the eroded background
    (joint_transforms.py:572-606)."""
    neighborhood = generate_binary_structure(2, 2)
    local_max = maximum_filter(image, footprint=neighborhood) == image
    background = image == 0
    eroded = binary_erosion(background, structure=neighborhood, border_value=1)
    return local_max ^ eroded


class ClassUniform:
    """Scale + class-centroid-biased crop (joint_transforms.py:552-685).

    With upscale factors, finds spatial density peaks of the classes of
    interest (default truck/train/bus trainIds 14/15/16) over a 250px sliding
    window and crops around a randomly chosen peak; downscales fall back to a
    plain random crop.
    """

    def __init__(self, size, crop_nopad, scale_min=0.5, scale_max=2.0,
                 ignore_index=0, class_list="16,15,14",
                 rng: Optional[_random.Random] = None):
        self.size = size
        self.rng = rng or _random
        self.crop = RandomCrop(size, ignore_index=ignore_index,
                               nopad=crop_nopad, rng=self.rng)
        if isinstance(class_list, str):
            class_list = class_list.replace(" ", "").split(",")
        self.class_list = [int(c) for c in class_list]
        self.scale_min = scale_min
        self.scale_max = scale_max
        self.window_size = 250

    def __call__(self, img, mask):
        assert img.size == mask.size
        scale_amt = self.rng.uniform(self.scale_min, self.scale_max)
        w = int(scale_amt * img.size[0])
        h = int(scale_amt * img.size[1])
        img_new = img.resize((w, h), Image.BICUBIC)
        mask_new = mask.resize((w, h), Image.NEAREST)
        if scale_amt < 1.0:
            return self.crop(img_new, mask_new)

        origw, origh = mask.size
        data = np.asarray(mask, dtype=np.float64)
        arr = np.zeros_like(data)
        for cls in self.class_list:
            m = np.where(data == cls, data, 0.0)
            s = m.sum()
            if s > 0:
                arr += m / s / cls

        ws = self.window_size
        sum_arr = np.zeros_like(arr, dtype=np.float32)
        for x in range(0, max(arr.shape[0] - ws, 0), ws):
            for y in range(0, max(arr.shape[1] - ws, 0), ws):
                sum_arr[x + ws // 2, y + ws // 2] = arr[x:x + ws, y:y + ws].sum()

        coords = np.column_stack(np.where(detect_peaks(sum_arr))).tolist()
        if not coords:
            return self.crop(img_new, mask_new)

        ratio = (float(origw) / w, float(origh) / h)
        # peak choice flows from the injected rng (thread-deterministic),
        # not the global numpy state
        y, x = coords[self.rng.randrange(len(coords))]
        y, x = int(y * ratio[0]), int(x * ratio[1])
        wsr = ws * ratio[0]
        cropx = self.rng.uniform(
            max(0, (x - wsr / 2) - (self.size - wsr)),
            max((x - wsr / 2), (x - wsr / 2) - ((w - wsr) - x + wsr / 2)))
        cropy = self.rng.uniform(
            max(0, (y - wsr / 2) - (self.size - wsr)),
            max((y - wsr / 2), (y - wsr / 2) - ((h - wsr) - y + wsr / 2)))
        box = (cropx, cropy, cropx + self.size, cropy + self.size)
        return img_new.crop(box), mask_new.crop(box)


