"""Label-ID remapping tables for every dataset the reference supports, and
the Cityscapes palette with ``decode_segmap`` (a copy of
mrfp_tpu/data/label_maps.py without its label metadata table).

Three distinct remap mechanisms exist in the reference and each is
reproduced exactly:

1. Sequential in-place (Cityscapes family + GTAV, main.py:106-112):
   void ids -> 255 first, then valid ids -> train ids IN LIST ORDER on the
   same array — later rules observe earlier writes (the aliasing quirk noted
   in SURVEY.md §7). Implemented as a precomputed 256-entry LUT derived by
   simulating the sequential algorithm on the identity table, which is
   equivalent because each rule is a pure value substitution.
2. Copy-from-original with 255 fill (SYNTHIA, main.py:560-564).
3. Copy-from-original with explicit 66->19 dict (Mapillary, main.py:635-726).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

IGNORE = 255

CITYSCAPES_VOID = [0, 1, 2, 3, 4, 5, 6, 9, 10, 14, 15, 16, 18, 29, 30, -1]
CITYSCAPES_VALID = [7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27,
                    28, 31, 32, 33]
GTAV_VOID = [0, 1, 2, 3, 4, 5, 6, 9, 10, 14, 15, 16, 18, 29, 30, 34, -1]
GTAV_VALID = CITYSCAPES_VALID
BDD_VOID = [0, 1, 2, 3, 4, 5, 6, 9, 10, 14, 15, 16, 18, 29, 30, -1]
BDD_VALID = list(range(19))  # labels are pre-mapped *_train_id.png files

# SYNTHIA: raw id (column 0 of the PNG-FI label) -> train id (main.py:536-537)
SYNTHIA_VALID = [3, 4, 2, 21, 5, 7, 15, 9, 6, 16, 1, 10, 17, 8, 18, 19, 20, 12, 11]
SYNTHIA_MAP: Dict[int, int] = {v: i for i, v in enumerate(SYNTHIA_VALID)}

# Mapillary 66 -> 19 (main.py:642-726)
MAPILLARY_MAP: Dict[int, int] = {
    13: 0, 24: 0, 41: 0,          # road / lane marking / manhole
    2: 1, 15: 1,                   # curb / sidewalk
    17: 2,                         # building
    6: 3,                          # wall
    3: 4,                          # fence
    45: 5, 47: 5,                  # pole / utility pole
    48: 6,                         # traffic light
    50: 7,                         # traffic sign
    30: 8,                         # vegetation
    29: 9,                         # terrain
    27: 10,                        # sky
    19: 11,                        # person
    20: 12, 21: 12, 22: 12,        # riders
    55: 13,                        # car
    61: 14,                        # truck
    54: 15,                        # bus
    58: 16,                        # train (on rails)
    57: 17,                        # motorcycle
    52: 18,                        # bicycle
}

CLASS_NAMES = ['road', 'sidewalk', 'building', 'wall', 'fence', 'pole',
               'traffic_light', 'traffic_sign', 'vegetation', 'terrain',
               'sky', 'person', 'rider', 'car', 'truck', 'bus', 'train',
               'motorcycle', 'bicycle']

# trainId -> RGB (utils_main.py:28-63)
CITYSCAPES_PALETTE = np.array([
    [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
    [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
    [107, 142, 35], [152, 251, 152], [0, 130, 180], [220, 20, 60],
    [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100], [0, 80, 100],
    [0, 0, 230], [119, 11, 32]], dtype=np.uint8)


def sequential_lut(void: Sequence[int], valid: Sequence[int],
                   ignore: int = IGNORE) -> np.ndarray:
    """Simulate the reference's sequential in-place encode_segmap on the
    uint8 identity table, yielding an equivalent single-gather LUT."""
    lut = np.arange(256, dtype=np.int64)
    for v in void:
        if 0 <= v < 256:
            lut[lut == v] = ignore
    for i, v in enumerate(valid):
        lut[lut == v] = i
    return lut.astype(np.uint8)


_CITYSCAPES_LUT = sequential_lut(CITYSCAPES_VOID, CITYSCAPES_VALID)
_GTAV_LUT = sequential_lut(GTAV_VOID, GTAV_VALID)


def dict_lut(mapping: Dict[int, int], size: int = 256,
             default: int = IGNORE) -> np.ndarray:
    lut = np.full(size, default, dtype=np.uint8)
    for k, v in mapping.items():
        lut[k] = v
    return lut


_SYNTHIA_LUT = dict_lut(SYNTHIA_MAP)
_MAPILLARY_LUT = dict_lut(MAPILLARY_MAP)


def encode_cityscapes(mask: np.ndarray) -> np.ndarray:
    return _CITYSCAPES_LUT[mask]


def encode_gtav(mask: np.ndarray) -> np.ndarray:
    return _GTAV_LUT[mask]


def encode_synthia(mask: np.ndarray) -> np.ndarray:
    return _SYNTHIA_LUT[mask]


def encode_mapillary(mask: np.ndarray) -> np.ndarray:
    return _MAPILLARY_LUT[mask]


def encode_bdd(mask: np.ndarray) -> np.ndarray:
    """BDD labels ship pre-mapped; passthrough (main.py:465-471)."""
    return mask


def decode_segmap(label: np.ndarray) -> np.ndarray:
    """trainId (H,W) -> RGB uint8 (H,W,3); ignore -> black (utils_main.py:28-63)."""
    out = np.zeros((*label.shape, 3), dtype=np.uint8)
    valid = label < 19
    out[valid] = CITYSCAPES_PALETTE[label[valid]]
    return out
