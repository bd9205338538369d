"""Dataset catalog — the seven domains of the reference (main.py:54-783).

A copy of mrfp_tpu/data/datasets.py, so that the port imports nothing of
that package (whose ``__init__`` also loads its jax data loader).

Each dataset yields {'image': HWC float32 (raw 0..255), 'label': HW float32}
after its transform pipeline, mirroring the reference's per-domain:

- file discovery (recursive glob per suffix)
- image->label path derivation rules (Cityscapes gtFine suffix surgery,
  foggy beta-suffix stripping, BDD *_train_id, SYNTHIA PNG-FI channel 0,
  Mapillary same-stem png)
- label encoding (data.label_maps)
- active train/val transform pipelines (the reference's commented-out
  transforms are in mrfp_tpu/data/transforms.py only, not wired there
  either)

A SyntheticDataset (data/synthetic.py) provides data-free operation for
tests and benchmarks.
"""

from __future__ import annotations

import os
import random as _random
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from mrfp_tpu_torch.data import label_maps as lm
from mrfp_tpu_torch.data import transforms as tr
from mrfp_tpu_torch.data.synthetic import SyntheticDataset


def recursive_glob(rootdir: str, suffix: str) -> List[str]:
    return sorted(
        os.path.join(root, fn)
        for root, _dirs, files in os.walk(rootdir)
        for fn in files if fn.endswith(suffix))


class _JointAdapter:
    """Bridge a (img, mask) joint transform into the sample-dict protocol."""

    def __init__(self, joint):
        self.joint = joint

    def __call__(self, sample):
        img, mask = self.joint(sample["image"], sample["label"])
        return {"image": img, "label": mask}


class _SegDataset:
    """Common skeleton: file list + label-path rule + encode + transforms."""

    name = "base"
    ignore_index = 255
    num_classes = 19
    id2cat = {i: n for i, n in enumerate(lm.CLASS_NAMES)}

    def __init__(self, root: str, split: str, train: bool,
                 base_size: int = 768, crop_size: int = 768,
                 eval_size: int = 1536, seed: int = 0,
                 freq_transform: Optional[str] = None,
                 random_flip: bool = True,
                 color_jitter=(0.5, 0.2, 0.2, 0.3),
                 scale_range=(0.5, 2.0),
                 gaussian_blur: bool = True,
                 class_uniform_pct: float = 0.0,
                 class_uniform_classes=(16, 15, 14)):
        self.root = root
        self.split = split
        self.train = train
        self.base_size = base_size
        self.crop_size = crop_size
        self.eval_size = eval_size
        # train-time augmentation knobs (DataConfig; defaults = the
        # reference's active GTAV pipeline, main.py:410-419).
        # color_jitter order: (brightness, contrast, saturation, hue)
        self.random_flip = random_flip
        self.color_jitter = tuple(color_jitter) if color_jitter else None
        self.scale_range = tuple(scale_range)
        self.gaussian_blur = gaussian_blur
        # CLASS_UNIFORM_PCT (reference config.py:53-54; dead in its live
        # path, so 0.0 default): fraction of train samples whose scale+crop
        # is the centroid-biased ClassUniform instead of RandomSizeAndCrop
        self.class_uniform_pct = float(class_uniform_pct)
        self.class_uniform_classes = tuple(class_uniform_classes)
        # optional HPF/LPF/PHOT slot (the reference keeps these commented in
        # its pipelines, dataloaders.py:24-79 / main.py:325-327)
        self.freq_transform = freq_transform
        self.seed = seed
        self.epoch = 0
        # default (shared) RNGs used when the pipeline is deterministic;
        # stochastic train pipelines get per-sample RNGs in __getitem__ so
        # multi-threaded loading stays bitwise reproducible
        self.rng = _random.Random(seed)
        self.nprng = np.random.default_rng(seed)
        self.files = self._discover()
        if not self.files:
            raise FileNotFoundError(
                f"No files for split={split!r} under {self._images_base()}")
        self.transform = self._build_transform()

    def set_epoch(self, epoch: int):
        """Make per-sample augmentation draws epoch-dependent."""
        self.epoch = epoch

    # --- per-dataset hooks ---
    def _images_base(self) -> str:
        raise NotImplementedError

    def _discover(self) -> List[str]:
        raise NotImplementedError

    def _label_path(self, img_path: str) -> str:
        raise NotImplementedError

    def _encode(self, mask: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _build_transform(self, rng=None, nprng=None):
        return tr.Compose([tr.ToArray()])

    # --- protocol ---
    def __len__(self):
        return len(self.files)

    def _load_label(self, lbl_path: str) -> Image.Image:
        raw = np.array(Image.open(lbl_path), dtype=np.uint8)
        return Image.fromarray(self._encode(raw))

    def _sample_rngs(self, index: int):
        """Per-sample RNGs: multi-threaded loading stays deterministic
        (shared-RNG draws would race across workers). zlib.crc32 is a stable
        hash (builtin hash() is salted per process)."""
        import zlib
        tag = f"{self.seed}:{self.epoch}:{index}".encode()
        h = zlib.crc32(tag)
        return _random.Random(h), np.random.default_rng(h)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        img_path = self.files[index]
        img = Image.open(img_path).convert("RGB")
        target = self._load_label(self._label_path(img_path))
        if self.train:
            rng, nprng = self._sample_rngs(index)
            transform = self._build_transform(rng, nprng)
        else:
            transform = self.transform
        return transform({"image": img, "label": target})

    def _freq_tail(self):
        tail = []
        if self.freq_transform:
            tail.append({"hpf": tr.HPF(), "lpf": tr.LPF(),
                         "phot": tr.PHOT()}[self.freq_transform])
        tail.append(tr.ToArray())
        return tail

    def _aug_head(self, rng, nprng):
        """Flip + color jitter, honoring the DataConfig knobs."""
        head = []
        if self.random_flip:
            head.append(tr.RandomHorizontalFlip(rng))
        if self.color_jitter:
            b, c, s, h = self.color_jitter
            head.append(tr.ColorJitter(brightness=b, contrast=c, saturation=s,
                                       hue=h, rng=nprng, prng=rng))
        return head

    # the standard "GTAV-style" train pipeline (main.py:410-419)
    def _train_tf_scalecrop(self, rng=None, nprng=None):
        rng = rng or self.rng
        nprng = nprng if nprng is not None else self.nprng
        scale_crop = tr.RandomSizeAndCrop(
            self.crop_size, crop_nopad=False,
            scale_min=self.scale_range[0], scale_max=self.scale_range[1],
            ignore_index=255, pre_size=None, rng=rng)
        if self.class_uniform_pct > 0.0 and rng.random() < self.class_uniform_pct:
            # centroid-biased crop for this sample (CLASS_UNIFORM_PCT wiring;
            # the gate draw rides the per-sample rng so threading stays
            # deterministic)
            from mrfp_tpu_torch.data.joint_transforms import ClassUniform
            scale_crop = _JointAdapter(ClassUniform(
                self.crop_size, crop_nopad=False,
                scale_min=self.scale_range[0], scale_max=self.scale_range[1],
                ignore_index=255,
                class_list=list(self.class_uniform_classes), rng=rng))
        return tr.Compose(self._aug_head(rng, nprng) + [
            scale_crop,
            tr.Resize(self.crop_size, self.crop_size),
        ] + ([tr.RandomGaussianBlur(rng)] if self.gaussian_blur else [])
            + self._freq_tail())

    # the "resize-only" train pipeline (BDD/SYNTHIA/foggy, main.py:319-328)
    def _train_tf_resize(self, rng=None, nprng=None):
        rng = rng or self.rng
        nprng = nprng if nprng is not None else self.nprng
        return tr.Compose(self._aug_head(rng, nprng) + [
            tr.Resize(self.base_size, self.crop_size),
        ] + ([tr.RandomGaussianBlur(rng)] if self.gaussian_blur else [])
            + self._freq_tail())


class Cityscapes(_SegDataset):
    """main.py:54-143. Train tf = ToTensor only (perturbation-free domain)."""

    name = "cityscapes"

    def _images_base(self):
        return os.path.join(self.root, "leftImg8bit", self.split)

    def _discover(self):
        return recursive_glob(self._images_base(), ".png")

    def _label_path(self, img_path):
        city = img_path.split(os.sep)[-2]
        base = os.path.basename(img_path)[:-len("leftImg8bit.png")]
        return os.path.join(self.root, "gtFine", self.split, city,
                            base + "gtFine_labelIds.png")

    def _encode(self, mask):
        return lm.encode_cityscapes(mask)

    def _build_transform(self, rng=None, nprng=None):
        return tr.Compose([tr.ToArray()])


class RainyCityscapes(Cityscapes):
    """main.py:146-237: gtFine under gtFine_trainvaltest."""

    name = "rainy_cityscapes"

    def _label_path(self, img_path):
        city = img_path.split(os.sep)[-2]
        base = os.path.basename(img_path)[:-len("leftImg8bit.png")]
        return os.path.join(self.root, "gtFine_trainvaltest", "gtFine",
                            self.split, city, base + "gtFine_labelIds.png")


class FoggyCityscapes(_SegDataset):
    """main.py:242-341: images under leftImg8bit_foggy with beta suffixes."""

    name = "foggy_cityscapes"

    def _images_base(self):
        return os.path.join(self.root, "leftImg8bit_foggy", self.split)

    def _discover(self):
        return recursive_glob(self._images_base(), ".png")

    def _label_path(self, img_path):
        city = img_path.split(os.sep)[-2]
        base = os.path.basename(img_path)
        # 'x_leftImg8bit_foggy_beta_0.01.png' -> strip 31 chars;
        # beta_0.005 variants are one char longer (main.py:279-286)
        cut = 32 if "beta_0.005" in base else 31
        return os.path.join(self.root, "gtFine_trainvaltest", "gtFine",
                            self.split, city, base[:-cut] + "gtFine_labelIds.png")

    def _encode(self, mask):
        return lm.encode_cityscapes(mask)

    def _build_transform(self, rng=None, nprng=None):
        return self._train_tf_resize(rng, nprng) if self.train else \
            tr.Compose([tr.ToArray()])


class GTAV(_SegDataset):
    """main.py:343-431 — the source domain with the full aug pipeline."""

    name = "gtav"

    def _images_base(self):
        return os.path.join(self.root, "images", self.split)

    def _discover(self):
        return recursive_glob(self._images_base(), ".png")

    def _label_path(self, img_path):
        return os.path.join(self.root, "labels", self.split,
                            os.path.basename(img_path))

    def _encode(self, mask):
        return lm.encode_gtav(mask)

    def _build_transform(self, rng=None, nprng=None):
        return self._train_tf_scalecrop(rng, nprng) if self.train else \
            tr.Compose([tr.ToArray()])


class BDD100k(_SegDataset):
    """main.py:433-519: jpg images, pre-mapped *_train_id.png labels."""

    name = "bdd100k"

    def _images_base(self):
        return os.path.join(self.root, "images", self.split)

    def _discover(self):
        return recursive_glob(self._images_base(), ".jpg")

    def _label_path(self, img_path):
        return os.path.join(self.root, "labels", self.split,
                            os.path.basename(img_path)[:-4] + "_train_id.png")

    def _encode(self, mask):
        return lm.encode_bdd(mask)

    def _build_transform(self, rng=None, nprng=None):
        return self._train_tf_resize(rng, nprng) if self.train else \
            tr.Compose([tr.ToArray()])


class Synthia(_SegDataset):
    """main.py:521-615: PNG-FI 16-bit labels, channel 0, copy-remap."""

    name = "synthia"

    def _images_base(self):
        return os.path.join(self.root, "RGB", self.split)

    def _discover(self):
        return recursive_glob(self._images_base(), ".png")

    def _label_path(self, img_path):
        return os.path.join(self.root, "GT", "LABELS", self.split,
                            os.path.basename(img_path))

    def _encode(self, mask):
        return lm.encode_synthia(mask)

    def _load_label(self, lbl_path):
        try:
            import imageio.v2 as imageio
            raw = np.asarray(imageio.imread(lbl_path, format="PNG-FI"))[:, :, 0]
        except Exception:
            # PIL fallback: 16-bit palette/RGB PNG, take channel 0
            arr = np.array(Image.open(lbl_path))
            raw = arr[:, :, 0] if arr.ndim == 3 else arr
        raw = raw.astype(np.int64)
        label = np.full(raw.shape, 255.0, dtype=np.float32)
        for k, v in lm.SYNTHIA_MAP.items():
            label[raw == k] = v
        return Image.fromarray(label)

    def _build_transform(self, rng=None, nprng=None):
        return self._train_tf_resize(rng, nprng) if self.train else \
            tr.Compose([tr.ToArray()])


class Mapillary(_SegDataset):
    """main.py:618-783: 66->19 map; val = ResizeHeight + CenterCropPad."""

    name = "mapillary"

    def _images_base(self):
        return os.path.join(self.root, self.split, "images")

    def _discover(self):
        return recursive_glob(self._images_base(), ".jpg")

    def _label_path(self, img_path):
        return os.path.join(self.root, self.split, "labels",
                            os.path.basename(img_path)[:-4] + ".png")

    def _encode(self, mask):
        return lm.encode_mapillary(mask)

    def _build_transform(self, rng=None, nprng=None):
        rng = rng or self.rng
        nprng = nprng if nprng is not None else self.nprng
        if self.train:
            return tr.Compose([
                tr.RandomHorizontalFlip(rng),
                tr.ColorJitter(brightness=0.5, hue=0.3, contrast=0.2,
                               saturation=0.2, rng=nprng, prng=rng),
                tr.RandomCropP(self.base_size, self.crop_size, rng),
                tr.RandomGaussianBlur(rng),
                tr.ToArray(),
            ])
        return tr.Compose([
            tr.ResizeHeight(self.eval_size),
            tr.CenterCropPad(self.eval_size),
            tr.ToArray(),
        ])


class ConcatDataset:
    """torch.utils.data.ConcatDataset equivalent (main.py:821 concatenates
    GTAV + SYNTHIA for multi-source training)."""

    name = "concat"

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self._offsets.append(total)
        self._len = total
        self.num_classes = getattr(self.datasets[0], "num_classes", 19)
        self.ignore_index = getattr(self.datasets[0], "ignore_index", 255)
        self.id2cat = getattr(self.datasets[0], "id2cat", None)

    def set_epoch(self, epoch: int):
        for d in self.datasets:
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)

    def __len__(self):
        return self._len

    def __getitem__(self, index):
        lo = 0
        for di, hi in enumerate(self._offsets):
            if index < hi:
                return self.datasets[di][index - lo]
            lo = hi
        raise IndexError(index)


def domain_root(data_root: str, domain: str) -> str:
    """Resolve one domain's dataset dir under a shared ``--data-root``.

    ``<data_root>/<domain>/`` when that exists (the conventional
    multi-domain tree — needed because e.g. GTAV and BDD100k both expect
    ``root/images/<split>`` and cannot share one root), else ``data_root``
    itself (pointing straight at a single dataset dir, the reference's
    per-dataset ``config.py:70-80`` CITYSCAPES_DIR-style usage)."""
    sub = os.path.join(data_root, domain)
    return sub if os.path.isdir(sub) else data_root


DATASETS = {
    "cityscapes": Cityscapes,
    "rainy_cityscapes": RainyCityscapes,
    "foggy_cityscapes": FoggyCityscapes,
    "gtav": GTAV,
    "bdd100k": BDD100k,
    "synthia": Synthia,
    "mapillary": Mapillary,
    "synthetic": SyntheticDataset,
}

# default split names per domain (main.py:798-811)
TRAIN_SPLITS = {"cityscapes": "train", "gtav": "train", "bdd100k": "train",
                "synthia": "train", "mapillary": "training",
                "foggy_cityscapes": "train", "rainy_cityscapes": "train"}
VAL_SPLITS = {"cityscapes": "val", "gtav": "test", "bdd100k": "val",
              "synthia": "val", "mapillary": "validation",
              "foggy_cityscapes": "val", "rainy_cityscapes": "val"}
