"""Host-side image/label transform library (dataloaders.py:24-660): a copy
of mrfp_tpu/data/transforms.py trimmed to the transforms the dataset
catalog's pipelines use.

Same sample-dict API as the reference ({'image','label'}), same PIL
resampling kernels and probability semantics, with two deliberate changes:

- randomness flows through an explicit ``random.Random``/numpy Generator so
  worker pipelines are reproducible (the reference uses process-global RNGs);
- the terminal ``ToTensor`` yields numpy HWC float32 (NHWC is the TPU
  layout), raw 0..255 scale — the reference's ToTensor also keeps raw pixel
  scale (dataloaders.py:118-136; its Normalize is commented out of every
  active pipeline).
"""

from __future__ import annotations

import random as _random
from typing import Optional

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter, ImageOps


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


class ToArray:
    """Terminal transform: PIL -> numpy (image HWC, label HW).

    Integer sources stay integral ON THE WIRE — uint8 image, uint8/int32
    label — and the jitted steps cast on DEVICE (train/step.py,
    train/evaluator.py). uint8 -> float32 is exact, so results are
    bit-identical to a float32 wire while host->device transfers ship 4x
    fewer bytes (every active pipeline ends on PIL uint8; the reference's
    ToTensor keeps the same raw 0..255 scale, dataloaders.py:118-136).
    Float sources (e.g. after the inactive Normalize) keep the float32
    contract."""

    def __call__(self, sample):
        img = np.asarray(sample["image"])
        if img.dtype != np.uint8:
            img = img.astype(np.float32)
        if img.ndim == 2:
            img = img[..., None]
        mask = np.asarray(sample["label"])
        if mask.dtype != np.uint8:
            mask = (mask.astype(np.int32)
                    if np.issubdtype(mask.dtype, np.integer)
                    else mask.astype(np.float32))
        return {"image": img, "label": mask}


# alias matching the reference name
ToTensor = ToArray


class RandomHorizontalFlip:
    def __init__(self, rng: Optional[_random.Random] = None):
        self.rng = rng or _random

    def __call__(self, sample):
        if self.rng.random() < 0.5:
            return {"image": sample["image"].transpose(Image.FLIP_LEFT_RIGHT),
                    "label": sample["label"].transpose(Image.FLIP_LEFT_RIGHT)}
        return sample


class RandomGaussianBlur:
    def __init__(self, rng: Optional[_random.Random] = None):
        self.rng = rng or _random

    def __call__(self, sample):
        img = sample["image"]
        if self.rng.random() < 0.5:
            img = img.filter(ImageFilter.GaussianBlur(radius=self.rng.random()))
        return {"image": img, "label": sample["label"]}


class Resize:
    """PIL-order (size1, size2) == (width, height), BILINEAR/NEAREST
    (dataloaders.py:467-483)."""

    def __init__(self, size1, size2):
        self.size = (size1, size2)

    def __call__(self, sample):
        return {"image": sample["image"].resize(self.size, Image.BILINEAR),
                "label": sample["label"].resize(self.size, Image.NEAREST)}


class ResizeHeight:
    def __init__(self, size):
        self.target_h = size

    def __call__(self, sample):
        w, h = sample["image"].size
        tw = int(w / h * self.target_h)
        return {"image": sample["image"].resize((tw, self.target_h), Image.BICUBIC),
                "label": sample["label"].resize((tw, self.target_h), Image.NEAREST)}


class CenterCropPad:
    """Pad-then-center-crop (dataloaders.py:354-394). Reproduces the
    reference quirk of computing the crop origin from the PRE-pad size."""

    def __init__(self, size, ignore_index=0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.ignore_index = ignore_index

    def __call__(self, sample):
        img, mask = sample["image"], sample["label"]
        w, h = img.size
        tw, th = self.size
        pad_x = max(tw - w, 0)
        pad_y = max(th - h, 0)
        if pad_x or pad_y:
            img = ImageOps.expand(img, border=(pad_x, pad_y, pad_x, pad_y), fill=0)
            mask = ImageOps.expand(mask, border=(pad_x, pad_y, pad_x, pad_y),
                                   fill=self.ignore_index)
        x1 = int(round((w - tw) / 2.0))
        y1 = int(round((h - th) / 2.0))
        return {"image": img.crop((x1, y1, x1 + tw, y1 + th)),
                "label": mask.crop((x1, y1, x1 + tw, y1 + th))}


class RandomCropP:
    """Mapillary train crop: width=crop_size, height=base_size
    (dataloaders.py:216-234, RandomCrop_p)."""

    def __init__(self, base_size, crop_size, rng: Optional[_random.Random] = None):
        self.base_size = base_size
        self.crop_size = crop_size
        self.rng = rng or _random

    def __call__(self, sample):
        img, mask = sample["image"], sample["label"]
        w, h = img.size
        x0 = self.rng.randint(0, w - self.crop_size)
        y0 = self.rng.randint(0, h - self.base_size)
        box = (x0, y0, x0 + self.crop_size, y0 + self.base_size)
        return {"image": img.crop(box), "label": mask.crop(box)}


class RandomCrop:
    """Centroid-aware random crop with pad/nopad (dataloaders.py:257-337)."""

    def __init__(self, size, ignore_index=0, nopad=True,
                 rng: Optional[_random.Random] = None):
        self.size = (int(size), int(size)) if isinstance(size, (int, float)) \
            else tuple(size)
        self.ignore_index = ignore_index
        self.nopad = nopad
        self.rng = rng or _random

    def __call__(self, img, mask, centroid=None):
        w, h = img.size
        th, tw = self.size
        if w == tw and h == th:
            return img, mask
        if self.nopad:
            if th > h or tw > w:
                shorter = min(w, h)
                th, tw = shorter, shorter
        else:
            pad_h = (th - h) // 2 + 1 if th > h else 0
            pad_w = (tw - w) // 2 + 1 if tw > w else 0
            if pad_h or pad_w:
                border = (pad_w, pad_h, pad_w, pad_h)
                img = ImageOps.expand(img, border=border, fill=(0, 0, 0))
                mask = ImageOps.expand(mask, border=border, fill=self.ignore_index)
                w, h = img.size
        if centroid is not None:
            cx, cy = centroid
            x1 = min(max(0, self.rng.randint(cx - tw, cx)), w - tw)
            y1 = min(max(0, self.rng.randint(cy - th, cy)), h - th)
        else:
            x1 = 0 if w == tw else self.rng.randint(0, w - tw)
            y1 = 0 if h == th else self.rng.randint(0, h - th)
        box = (x1, y1, x1 + tw, y1 + th)
        return img.crop(box), mask.crop(box)


class RandomSizeAndCrop:
    """Random scale in [0.5, 2.0] then crop (dataloaders.py:398-434).

    GTAV active pipeline: size=768, crop_nopad=False, ignore_index=255,
    pre_size=None (main.py:414).

    ``fused=True`` (default) resamples only the cropped region via PIL's
    ``resize(box=...)`` instead of materializing the full scaled frame —
    ~8x faster per image (63->8 ms at GTAV resolution). The sampling grid is
    mathematically identical; float coefficient rounding can differ by <=2
    uint8 LSB on <0.5% of pixels (bounded by a test). The rng draw sequence
    is preserved exactly, and the pad / centroid / nopad-shrink cases fall
    back to the reference two-step path.
    """

    def __init__(self, size, crop_nopad, scale_min=0.5, scale_max=2.0,
                 ignore_index=0, pre_size=None,
                 rng: Optional[_random.Random] = None, fused: bool = True):
        self.rng = rng or _random
        self.crop = RandomCrop(size, ignore_index=ignore_index,
                               nopad=crop_nopad, rng=self.rng)
        self.scale_min, self.scale_max = scale_min, scale_max
        self.pre_size = pre_size
        self.fused = fused

    def __call__(self, sample, centroid=None):
        img, mask = sample["image"], sample["label"]
        if self.pre_size is None:
            scale_amt = 1.0
        elif img.size[1] < img.size[0]:
            scale_amt = self.pre_size / img.size[1]
        else:
            scale_amt = self.pre_size / img.size[0]
        scale_amt *= self.rng.uniform(self.scale_min, self.scale_max)
        w, h = (int(d * scale_amt) for d in img.size)
        if centroid is not None:
            centroid = [int(c * scale_amt) for c in centroid]

        th, tw = self.crop.size
        if self.fused and centroid is None and w >= tw and h >= th \
                and not (w == tw and h == th):
            # same draw order as RandomCrop.__call__ (x then y)
            x1 = 0 if w == tw else self.rng.randint(0, w - tw)
            y1 = 0 if h == th else self.rng.randint(0, h - th)
            W, H = img.size
            box = (x1 * W / w, y1 * H / h,
                   (x1 + tw) * W / w, (y1 + th) * H / h)
            # label: PIL's NEAREST index rule has version-specific tie
            # behavior — recover ITS OWN mapping from index-ramp resizes
            # (cheap: W+H pixels), then gather just the cropped window; this
            # is exactly full-resize-then-crop.
            ix = np.asarray(Image.fromarray(
                np.arange(W, dtype=np.int32)[None, :], "I")
                .resize((w, 1), Image.NEAREST))[0]
            iy = np.asarray(Image.fromarray(
                np.arange(H, dtype=np.int32)[:, None], "I")
                .resize((1, h), Image.NEAREST))[:, 0]
            m = np.asarray(mask)[iy[y1:y1 + th][:, None],
                                 ix[x1:x1 + tw][None, :]]
            return {"image": img.resize((tw, th), Image.BICUBIC, box=box),
                    "label": Image.fromarray(m)}

        img = img.resize((w, h), Image.BICUBIC)
        mask = mask.resize((w, h), Image.NEAREST)
        img, mask = self.crop(img, mask, centroid)
        return {"image": img, "label": mask}


class ColorJitter:
    """Brightness/contrast/saturation/hue jitter in random order, applied
    with probability 0.5 (dataloaders.py:596-660)."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 rng: Optional[np.random.Generator] = None,
                 prng: Optional[_random.Random] = None):
        self.b, self.c, self.s, self.h = brightness, contrast, saturation, hue
        self.rng = rng or np.random
        self.prng = prng or _random

    @staticmethod
    def _brightness(img: Image.Image, f: float) -> Image.Image:
        """Bit-exact ImageEnhance.Brightness via a 256-entry LUT (~13x
        faster at 2MP). PIL's C blend computes trunc(f32(f) * i), clipped."""
        i = np.arange(256, dtype=np.float32)
        lut = np.clip(np.trunc(np.float32(f) * i), 0, 255).astype(np.uint8)
        return img.point(lut.tolist() * len(img.getbands()))

    @staticmethod
    def _contrast(img: Image.Image, f: float) -> Image.Image:
        """Bit-exact ImageEnhance.Contrast via LUT: blend toward the L-mean
        gray, trunc(mean + f32(f)*(i-mean)) clipped."""
        from PIL import ImageStat
        mean = int(ImageStat.Stat(img.convert("L")).mean[0] + 0.5)
        i = np.arange(256, dtype=np.float32)
        lut = np.clip(np.trunc(np.float32(mean) + np.float32(f) *
                               (i - np.float32(mean))), 0, 255).astype(np.uint8)
        return img.point(lut.tolist() * len(img.getbands()))

    @staticmethod
    def _saturation(img: Image.Image, f: float) -> Image.Image:
        """ImageEnhance.Color. The JAX package's copy runs a native host
        kernel here where a toolchain is present, bit-exact with PIL
        (mrfp_tpu/data/color.py); the port keeps PIL's own passes."""
        return ImageEnhance.Color(img).enhance(f)

    @staticmethod
    def _adjust_hue(img: Image.Image, factor: float) -> Image.Image:
        if img.mode in {"L", "1", "I", "F"}:
            return img
        # PIL's HSV round trip; the JAX package's copy swaps in a native
        # host kernel, bit-exact with it, where a toolchain is present
        h, s, v = img.convert("HSV").split()
        np_h = np.array(h, dtype=np.uint8)
        # uint8 wraparound handles the cyclic hue shift; modern numpy rejects
        # negative np.uint8(...) scalars, so wrap explicitly (the reference's
        # np.uint8(factor*255) relied on numpy<2 cast semantics)
        with np.errstate(over="ignore"):
            np_h += np.uint8(int(factor * 255) & 0xFF)
        return Image.merge("HSV", (Image.fromarray(np_h, "L"), s, v)) \
            .convert(img.mode)

    def __call__(self, sample):
        if self.prng.random() >= 0.5:
            return sample
        img, mask = sample["image"], sample["label"]
        ops = []
        if self.b > 0:
            f = self.rng.uniform(max(0, 1 - self.b), 1 + self.b)
            ops.append(lambda im, f=f: self._brightness(im, f))
        if self.c > 0:
            f = self.rng.uniform(max(0, 1 - self.c), 1 + self.c)
            ops.append(lambda im, f=f: self._contrast(im, f))
        if self.s > 0:
            f = self.rng.uniform(max(0, 1 - self.s), 1 + self.s)
            ops.append(lambda im, f=f: self._saturation(im, f))
        if self.h > 0:
            f = self.rng.uniform(-self.h, self.h)
            ops.append(lambda im, f=f: self._adjust_hue(im, f))
        self.rng.shuffle(ops)
        for op in ops:
            img = op(img)
        return {"image": img, "label": mask}


class HPF:
    """FFT high-pass (dataloaders.py:24-45); numpy host version — the
    on-device jnp version is mrfp_tpu/perturb/fft_style.py::hpf."""

    def __init__(self, radius=16):
        self.radius = radius

    def __call__(self, sample):
        img = np.asarray(sample["image"], np.float32)
        out = _fft_mask(img, self.radius, highpass=True)
        return {"image": out, "label": sample["label"]}


class LPF:
    def __init__(self, radius=16):
        self.radius = radius

    def __call__(self, sample):
        img = np.asarray(sample["image"], np.float32)
        out = _fft_mask(img, self.radius, highpass=False)
        return {"image": out, "label": sample["label"]}


class PHOT:
    def __call__(self, sample):
        img = np.asarray(sample["image"], np.float32)
        f = np.fft.fftn(img)
        out = np.fft.ifftn(f / np.abs(f))
        return {"image": (out * 5 * 255).astype(np.float32),
                "label": sample["label"]}


# --- extended single-image transforms (transforms/transforms.py:126-182) ---
# The reference versions use skimage (gaussian / random_noise /
# denoise_bilateral); this environment has scipy, so the filters are
# reproduced with scipy.ndimage / numpy with the same parameter conventions.


def _fft_mask(img: np.ndarray, r: int, highpass: bool) -> np.ndarray:
    h, w = img.shape[0], img.shape[1]
    f = np.fft.fftshift(np.fft.fftn(img))
    cy, cx = h // 2, w // 2
    y, x = np.ogrid[:h, :w]
    d2 = (y - cy) ** 2 + (x - cx) ** 2
    # the reference drops the ring exactly at r^2 from both filters: HPF
    # zeroes d2 <= r^2 (dataloaders.py:38-39), LPF zeroes d2 >= r^2 (:72-73)
    mask = np.where(d2 <= r * r, 0.0, 1.0) if highpass \
        else np.where(d2 < r * r, 1.0, 0.0)
    out = np.fft.ifftn(np.fft.ifftshift(f * mask[..., None]))
    return out.astype(np.float32)  # complex->float keeps the real part
