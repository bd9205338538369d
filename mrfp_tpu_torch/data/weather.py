"""Synthetic adverse-weather corruptions (eval-time), the executable analog
of the reference's pre-rendered Foggy/Rainy Cityscapes protocol: a copy of
mrfp_tpu/data/weather.py (tests/test_torch_data.py holds it to the original).

The reference's Table 2 evaluates clean-trained models on the Foggy and
Rainy Cityscapes datasets (loaders at main.py:242-341 and main.py:146-237;
the weather itself is baked into the images on disk — Foggy Cityscapes
renders attenuation at beta ∈ {0.005, 0.01, 0.02}). Those datasets cannot
ship with a framework, so the runnable analog is parameterized corruption
applied at eval time: fog as the standard atmospheric-scattering alpha
blend toward an airlight estimated from the image (luminance-preserving in
the sense that the veil brightens toward the scene's own light, it does not
gray-crush), and rain as oriented bright streaks plus a light veil.

Both are host-side numpy on uint8/float 0..255 images, deterministic per
(seed, severity), label-free (corruptions never touch labels), and
severity-monotone (the original is tested in tests/test_weather.py). Severity 0 is the
identity; 1..4 roughly track the beta/density ladders of the rendered
datasets.
"""

from __future__ import annotations

import numpy as np

# fog: transmission t = 1 - alpha (uniform veil; rendered fog datasets vary
# t with scene depth, which synthetic/unknown-depth eval cannot)
_FOG_ALPHA = (0.25, 0.45, 0.65, 0.80)
# rain: (streak density per px, streak length px, extra veil alpha)
_RAIN = ((0.0012, 10, 0.04), (0.003, 14, 0.08),
         (0.006, 18, 0.12), (0.012, 22, 0.18))


def _as_float(img):
    arr = np.asarray(img)
    return arr.astype(np.float32), arr.dtype


def _restore(out, dtype):
    out = np.clip(out, 0.0, 255.0)
    return out.astype(dtype) if np.issubdtype(dtype, np.integer) \
        else out.astype(dtype)


def apply_fog(img, severity: int, seed: int = 0):
    """Atmospheric-scattering fog: ``I' = I*t + A*(1-t)`` with airlight A
    estimated from the image's bright tail (standard dehazing convention),
    modulated by a smooth spatial field so the veil has patch structure."""
    if severity == 0:
        return img
    x, dtype = _as_float(img)
    h, w = x.shape[:2]
    lum = x.mean(-1)
    # airlight: mean of the brightest 5% of pixels, floored so dark scenes
    # still fog toward light (fog scatters skylight, not scene light)
    a = max(float(np.partition(lum.ravel(), -max(1, lum.size // 20))
                  [-max(1, lum.size // 20):].mean()), 170.0)
    alpha = _FOG_ALPHA[severity - 1]
    rng = np.random.default_rng(seed * 7 + severity)
    # low-frequency patchiness: bilinear-upsampled coarse noise in
    # [0.8, 1.2] x alpha, clipped to [0, 0.95]
    g = rng.uniform(0.8, 1.2, (4, 4))
    ys = np.linspace(0, 3, h)
    xs = np.linspace(0, 3, w)
    y0 = np.clip(ys.astype(int), 0, 2)
    x0 = np.clip(xs.astype(int), 0, 2)
    fy, fx = ys - y0, xs - x0
    field = (g[y0][:, x0] * (1 - fy)[:, None] * (1 - fx)[None, :]
             + g[y0 + 1][:, x0] * fy[:, None] * (1 - fx)[None, :]
             + g[y0][:, x0 + 1] * (1 - fy)[:, None] * fx[None, :]
             + g[y0 + 1][:, x0 + 1] * fy[:, None] * fx[None, :])
    veil = np.clip(alpha * field, 0.0, 0.95)[..., None]
    out = x * (1.0 - veil) + a * veil
    return _restore(out, dtype)


def _streak_layer(h: int, w: int, density: float, length: int,
                  rng: np.random.Generator) -> np.ndarray:
    """Oriented rain streaks: sparse seeds convolved with a line kernel
    (sum of shifted copies — no scipy dependency)."""
    seeds = (rng.random((h, w)) < density).astype(np.float32)
    seeds *= rng.uniform(0.6, 1.0, (h, w)).astype(np.float32)
    angle = np.deg2rad(rng.uniform(70.0, 110.0))  # near-vertical fall
    acc = np.zeros((h, w), np.float32)
    for k in range(length):
        dy = int(round(np.sin(angle) * k))
        dx = int(round(np.cos(angle) * k))
        acc[max(dy, 0):h + min(dy, 0), max(dx, 0):w + min(dx, 0)] += \
            seeds[max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)]
    return np.clip(acc, 0.0, 1.0)


def apply_rain(img, severity: int, seed: int = 0):
    """Rain streaks (bright, near-vertical, motion-blurred) plus a light
    fog-like veil — the visual recipe of rendered rainy datasets."""
    if severity == 0:
        return img
    x, dtype = _as_float(img)
    h, w = x.shape[:2]
    density, length, veil = _RAIN[severity - 1]
    rng = np.random.default_rng(seed * 13 + severity)
    streaks = _streak_layer(h, w, density, length, rng)[..., None]
    out = x * (1.0 - 0.6 * streaks) + 235.0 * streaks  # streaks overlay
    out = out * (1.0 - veil) + 190.0 * veil
    return _restore(out, dtype)


CORRUPTIONS = {"fog": apply_fog, "rain": apply_rain}


class CorruptedDataset:
    """Wrap an eval dataset, corrupting each sample's image (labels and
    every other field pass through). Deterministic per index."""

    def __init__(self, dataset, kind: str, severity: int, seed: int = 0):
        if kind not in CORRUPTIONS:
            raise ValueError(f"unknown corruption {kind!r}; "
                             f"options: {sorted(CORRUPTIONS)}")
        if not 0 <= severity <= 4:
            raise ValueError(f"severity must be 0..4, got {severity}")
        self.dataset, self.kind, self.severity = dataset, kind, severity
        self.seed = seed
        self.name = f"{getattr(dataset, 'name', 'dataset')}" \
                    f"_{kind}{severity}"

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index: int):
        sample = dict(self.dataset[index])
        sample["image"] = CORRUPTIONS[self.kind](
            sample["image"], self.severity, seed=self.seed * 100003 + index)
        return sample
