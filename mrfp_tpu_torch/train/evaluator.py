"""Multi-domain evaluation driver (main.py:876-913 + metrics.py), PyTorch.

Per domain: stream images, run the eval forward, accumulate the C x C
confusion matrix ON THE DEVICE (only the final histogram crosses to the
host). Images whose label size differs from the image are dropped and
counted, like main.py:894,910-911 (``strict_pairs=False`` crops them to the
common extent instead).

Eval shape protocol, as in mrfp_tpu/train/evaluator.py: every image runs at
its EXACT native shape by default (main.py:896). ``eval_batch=N`` groups N
same-shape images per forward (exact: eval-mode BN has no cross-image
coupling; partial groups are padded with all-ignore dummies). ``bucket=N``
pads images up to a multiple of N with label 255 and masks ASPP's image
pooling to the valid region; logits near the padded border still differ
from the exact-shape protocol.

Images cross host->device as they come off the dataset (uint8 for real
data, 4x fewer bytes than float32), from pinned memory with
``non_blocking=True`` and two batches in flight; the device casts them to
float NCHW.

``SlidingEvaluator`` (mrfp_tpu/train/evaluator.py:300-385) cuts every
image into crop-size tiles and runs them at one shape, averaging the
tiles' logits per pixel on the device.

Both split a sweep across processes as the JAX package does
(mrfp_tpu/train/evaluator.py:65-78,206,293): with ``shard_count`` > 1 a
process scores only the images ``i % shard_count == shard_rank``, and
``merge_shard_hists`` sums the partial histograms (and the image counts)
with one int64 ``all_reduce``, so every rank returns the same mIoU, equal
to a one-process sweep's.

``SegEvaluator(..., mesh=)`` with a spatial axis (``core/mesh.py``, ``sp >
1``) is the counterpart of the JAX evaluator's meshed path
(mrfp_tpu/train/evaluator.py:103-127): every rank of a spatial group reads
the same images and feeds the model its band of each image's rows (the
batch, ``eval_batch`` and ``bucket`` as without a mesh), the confusion
matrix kernel runs on the band's prediction and labels, and the histogram
is summed over the spatial group (then over the data shards), so every rank
returns the same metrics as one process.
"""

from __future__ import annotations

import contextlib
import logging
import math
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from mrfp_tpu_torch.core.mesh import band
from mrfp_tpu_torch.ops.hist import confusion_matrix_update
from mrfp_tpu_torch.parallel.dist import Group, all_reduce_sum
from mrfp_tpu_torch.utils.profiling import span
from mrfp_tpu_torch.utils.transfer import to_device


def pad_to_bucket(img: np.ndarray, lbl: np.ndarray, bucket: int = 128,
                  ignore_index: int = 255):
    """Pad HWC image + HW label up to the next bucket multiple (bottom/right)."""
    h, w = lbl.shape
    bh = int(math.ceil(h / bucket)) * bucket
    bw = int(math.ceil(w / bucket)) * bucket
    if (bh, bw) == (h, w):
        return img, lbl
    pimg = np.zeros((bh, bw, img.shape[-1]), img.dtype)
    pimg[:h, :w] = img
    plbl = np.full((bh, bw), ignore_index, lbl.dtype)
    plbl[:h, :w] = lbl
    return pimg, plbl


def merge_shard_hists(hist: torch.Tensor, shard_count: int,
                      group: Optional[Group] = None) -> torch.Tensor:
    """The sum over the processes of ``group`` (the world by default) of the
    int64 tensor ``hist`` (a partial confusion matrix, or anything counted
    beside it); ``hist`` itself for an unsplit sweep or a single process.
    Every rank gets the sum, exact."""
    return all_reduce_sum(hist, group) if shard_count > 1 else hist


class SegEvaluator:
    """Streaming per-domain mIoU evaluator on one device.

    ``model``: an eval-mode module mapping NCHW float images to NCHW logits,
    already on ``device``. ``autocast_dtype``: run the forward under
    ``torch.autocast`` in that dtype (e.g. ``torch.bfloat16``); None keeps
    float32. ``mesh``: a process mesh with a spatial axis, each image split
    in bands of rows across its spatial group (the model takes ``hw=``), or
    with a model axis, each image scored by every rank of its model group
    (a model that ``weights.shard_model`` cut), whose histograms merge over
    the data group only.
    """

    def __init__(self, model, num_classes: int = 19, bucket: Optional[int] = None,
                 strict_pairs: bool = True, eval_batch: int = 1,
                 device="cuda", autocast_dtype: Optional[torch.dtype] = None, mesh=None):
        self.model = model
        self.num_classes = num_classes
        self.bucket = bucket
        self.strict_pairs = strict_pairs
        self.eval_batch = max(1, int(eval_batch))
        self.device = torch.device(device)
        self.autocast_dtype = autocast_dtype
        self.mesh = mesh if mesh is not None and mesh.sp > 1 else None
        # the ranks that score different images: the data group under a model axis
        self.data_group = mesh.data if mesh is not None and mesh.mp > 1 else None

    def _band(self, img: np.ndarray, lbl: np.ndarray):
        """This rank's rows of a host batch (NHWC images, NHW labels), and
        the batch's global (H, W); the batch itself without a spatial mesh."""
        hw = lbl.shape[1:3]
        if self.mesh is None:
            return img, lbl, hw
        lo, hi = band(hw[0], self.mesh.sp, self.mesh.spatial_index)
        return img[:, lo:hi], lbl[:, lo:hi], hw

    def _step(self, hist: torch.Tensor, image: torch.Tensor, label: torch.Tensor,
              valid_hw: Optional[Tuple[int, int]] = None,
              hw: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        # wire format -> float NCHW on the device
        x = image.permute(0, 3, 1, 2).float().contiguous()
        amp = (contextlib.nullcontext() if self.autocast_dtype is None else
               torch.autocast(self.device.type, dtype=self.autocast_dtype))
        with amp:
            if self.mesh is None:
                logits = self.model(x, valid_hw=valid_hw)
            else:
                logits = self.model(x, valid_hw=valid_hw, hw=hw)
        pred = logits.argmax(dim=1)
        return confusion_matrix_update(hist, pred, label, self.num_classes)

    @torch.inference_mode()
    def run(self, dataset, max_images: Optional[int] = None, log=print,
            heartbeat=None, shard_rank: int = 0, shard_count: int = 1) -> Dict[str, object]:
        """Evaluate ``dataset``. ``heartbeat`` is called every few images,
        after a device sync, so a step watchdog can tell a slow sweep from a
        wedged device. With ``shard_count`` > 1 this process scores every
        ``shard_count``-th image from ``shard_rank``, and the result is the
        whole sweep's, merged over the processes."""
        hist = torch.zeros((self.num_classes, self.num_classes), dtype=torch.int32,
                           device=self.device)
        tally = {"dropped": 0}
        scored = 0
        synced_at = 0
        # bucket mode takes one valid_hw per forward, so it runs batch 1
        eb = self.eval_batch if self.bucket is None else 1
        pad_total = 0  # dummy slots spent padding partial groups
        shapes_seen = set()
        t0 = time.perf_counter()

        def _sync_heartbeat():
            nonlocal synced_at
            if heartbeat is not None and scored - synced_at >= 4:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                heartbeat()
                synced_at = scored

        def _groups():
            """Host batches: (images NHWC, labels NHW, real count, valid_hw)."""
            pending: Dict[tuple, list] = {}
            for img, lbl in self._host_samples(dataset, max_images, tally, shard_rank,
                                               shard_count):
                if self.bucket is not None:
                    vh, vw = lbl.shape
                    img, lbl = pad_to_bucket(img, lbl, self.bucket)
                    yield img[None], lbl[None], 1, (vh, vw)
                    continue
                shapes_seen.add(lbl.shape)
                pending.setdefault(lbl.shape, []).append((img, lbl))
                if len(pending[lbl.shape]) == eb:
                    yield _stack(pending.pop(lbl.shape)) + (eb, None)
            for items in pending.values():  # final partial groups
                yield _stack(items) + (len(items), None)

        def _stack(items):
            nonlocal pad_total
            real = len(items)
            pad_total += eb - real
            if real < eb:
                # all-ignore dummies (label 255 never touches the hist)
                pad = (np.zeros_like(items[0][0]), np.full_like(items[0][1], 255))
                items = items + [pad] * (eb - real)
            return (np.stack([im for im, _ in items]),
                    np.stack([lb for _, lb in items]))

        # two batches in flight: batch i+1 is copied while batch i runs
        buf = []
        groups = _groups()
        while True:
            with span("eval.input") as s:  # the host batch, read and stacked
                group = next(groups, None)
                if group is None:
                    break
                img, lbl, real, valid_hw = group
                img, lbl, hw = self._band(img, lbl)
                s.add(images=real)
            buf.append((to_device(img, self.device), to_device(lbl, self.device), real,
                        valid_hw, hw))
            if len(buf) >= 2:
                image, label, real, vhw, hw = buf.pop(0)
                hist = self._step(hist, image, label, vhw, hw)
                scored += real
                _sync_heartbeat()
        while buf:
            image, label, real, vhw, hw = buf.pop(0)
            hist = self._step(hist, image, label, vhw, hw)
            scored += real
            _sync_heartbeat()

        n_shapes = len(shapes_seen)
        if eb > 1 and pad_total > 0 and (n_shapes > 3 or pad_total * 2 > max(scored, 1)):
            logging.getLogger(__name__).warning(
                "eval_batch=%d on a mixed-shape domain: %d distinct shapes, "
                "%d padded dummy forwards for %d real images — consider "
                "eval_batch=1 or bucket mode for this domain", eb, n_shapes,
                pad_total, scored)
        return self._result(hist, dataset, log, t0, tally["dropped"], scored, shard_count,
                            self.mesh, self.data_group)

    def _host_samples(self, dataset, max_images: Optional[int], tally: Dict[str, int],
                      shard_rank: int = 0, shard_count: int = 1
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """The dataset's (image HWC, label HW) pairs in their wire dtypes
        (uint8 ships as it is; other images float32, other labels int32),
        every ``shard_count``-th from ``shard_rank``. A pair whose sizes
        differ is counted in ``tally["dropped"]`` and skipped
        (main.py:910-911), or with ``strict_pairs=False`` cropped to the
        common extent."""
        n = len(dataset) if max_images is None else min(len(dataset), max_images)
        for i in range(shard_rank, n, max(1, shard_count)):
            sample = dataset[i]
            img = np.asarray(sample["image"])
            if img.dtype != np.uint8:
                img = img.astype(np.float32)
            lbl = np.asarray(sample["label"])
            if lbl.dtype != np.uint8:
                lbl = lbl.astype(np.int32)
            if img.shape[:2] != lbl.shape:
                if self.strict_pairs:
                    tally["dropped"] += 1
                    continue
                h = min(img.shape[0], lbl.shape[0])
                w = min(img.shape[1], lbl.shape[1])
                img, lbl = img[:h, :w], lbl[:h, :w]
            yield img, lbl

    @staticmethod
    def _result(hist: torch.Tensor, dataset, log, t0: float, dropped: int,
                scored: int, shard_count: int = 1, mesh=None,
                data_group: Optional[Group] = None) -> Dict[str, object]:
        shape = hist.shape
        hist = hist.reshape(-1).long()
        if mesh is not None:  # the bands' histograms: the images' whole
            hist = all_reduce_sum(hist, mesh.spatial)
        counts = torch.cat([hist, torch.tensor([dropped, scored], device=hist.device)])
        counts = merge_shard_hists(counts, shard_count,
                                   mesh.data if mesh is not None else data_group
                                   ).cpu()  # syncs the device
        hist_np = counts[:-2].numpy().reshape(shape)
        dropped, scored = (int(v) for v in counts[-2:])
        seconds = time.perf_counter() - t0
        result = evaluate_hist(hist_np, dataset_name=getattr(dataset, "name", "?"),
                               id2cat=getattr(dataset, "id2cat", None), log=log)
        result.update(dropped=dropped, scored=scored, seconds=seconds)
        return result


class SlidingEvaluator(SegEvaluator):
    """Tile inference: every image is cut into ``crop_size`` windows with
    ``SlidingCrop``'s geometry (stride ``ceil(crop_size * stride_rate)``,
    the last window of each axis clamped to the edge), the windows run
    through the model ``tile_batch`` at a time at one (tile_batch, 3, cs, cs)
    shape (the last chunk zero-padded; eval mode, so padding tiles never
    touch real ones; an image smaller than the crop is zero-padded too), and
    each pixel's logits are summed in tile order in fp32 and divided by its
    tile count before the argmax. Tiles cross to the device in the
    sample's wire dtype (uint8 for real data); the sums, the argmax and the
    histogram (``confusion_matrix_update``) stay on the device. Samples are
    read as ``SegEvaluator`` reads them, ``strict_pairs`` included (the
    JAX package's sliding evaluator drops a mismatched pair either way)."""

    def __init__(self, model, num_classes: int = 19, crop_size: int = 1024,
                 stride_rate: float = 2 / 3, strict_pairs: bool = True,
                 tile_batch: int = 8, device="cuda",
                 autocast_dtype: Optional[torch.dtype] = None):
        super().__init__(model, num_classes=num_classes, strict_pairs=strict_pairs,
                         device=device, autocast_dtype=autocast_dtype)
        self.crop_size = crop_size
        self.stride_rate = stride_rate
        self.tile_batch = max(1, int(tile_batch))

    def spans(self, h: int, w: int):
        """The windows ``(y0, x0, y1, x1)`` of an h x w image, in tile order."""
        cs = self.crop_size
        stride = int(math.ceil(cs * self.stride_rate))
        ys = list(range(0, max(h - cs, 0) + 1, stride)) or [0]
        xs = list(range(0, max(w - cs, 0) + 1, stride)) or [0]
        if ys[-1] + cs < h:
            ys.append(h - cs)
        if xs[-1] + cs < w:
            xs.append(w - cs)
        out = []
        for sy in ys:
            for sx in xs:
                y0, x0 = max(0, min(sy, h - cs)), max(0, min(sx, w - cs))
                out.append((y0, x0, min(y0 + cs, h), min(x0 + cs, w)))
        return out

    def predict(self, img: np.ndarray) -> torch.Tensor:
        """The (h, w) int64 prediction for one HWC image, on the device."""
        cs, tb = self.crop_size, self.tile_batch
        h, w = img.shape[:2]
        spans = self.spans(h, w)
        acc = torch.zeros((self.num_classes, h, w), dtype=torch.float32, device=self.device)
        cnt = torch.zeros((h, w), dtype=torch.float32, device=self.device)
        amp = (contextlib.nullcontext() if self.autocast_dtype is None else
               torch.autocast(self.device.type, dtype=self.autocast_dtype))
        for lo in range(0, len(spans), tb):
            chunk = spans[lo:lo + tb]
            batch = np.zeros((tb, cs, cs, img.shape[-1]), img.dtype)
            for k, (y0, x0, y1, x1) in enumerate(chunk):
                batch[k, :y1 - y0, :x1 - x0] = img[y0:y1, x0:x1]
            x = to_device(batch, self.device).permute(0, 3, 1, 2).float().contiguous()
            with amp:
                logits = self.model(x).float()
            for k, (y0, x0, y1, x1) in enumerate(chunk):
                acc[:, y0:y1, x0:x1] += logits[k, :, :y1 - y0, :x1 - x0]
                cnt[y0:y1, x0:x1] += 1
        return (acc / cnt.clamp_min(1)).argmax(dim=0)

    @torch.inference_mode()
    def run(self, dataset, max_images: Optional[int] = None, log=print,
            heartbeat=None, shard_rank: int = 0, shard_count: int = 1) -> Dict[str, object]:
        """Evaluate ``dataset`` image by image; ``heartbeat`` is called after
        each image's device sync; the shards as ``SegEvaluator.run``'s."""
        hist = torch.zeros((self.num_classes, self.num_classes), dtype=torch.int32,
                           device=self.device)
        tally = {"dropped": 0}
        scored = 0
        t0 = time.perf_counter()
        for img, lbl in self._host_samples(dataset, max_images, tally, shard_rank,
                                           shard_count):
            hist = confusion_matrix_update(hist, self.predict(img),
                                           to_device(lbl, self.device), self.num_classes)
            scored += 1
            if heartbeat is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                heartbeat()
        return self._result(hist, dataset, log, t0, tally["dropped"], scored, shard_count)


def evaluate_hist(hist: np.ndarray, dataset_name: str = "?",
                  id2cat=None, log=print) -> Dict[str, object]:
    """metrics.evaluate_eval/print_evaluate_results (metrics.py:60-120):
    acc, acc_cls, per-class IoU table with precision/recall/TP/FP/FN, mIoU,
    fwavacc. Rows of ``hist`` are ground truth, columns prediction."""
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = np.diag(hist).sum() / hist.sum()
        acc_cls = np.nanmean(np.diag(hist) / hist.sum(axis=1))
        iu = np.diag(hist) / (hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist))
        freq = hist.sum(axis=1) / hist.sum()
        mean_iu = np.nanmean(iu)
        fwavacc = (freq[freq > 0] * iu[freq > 0]).sum()

        tp = np.diag(hist).astype(np.float64)
        fp = hist.sum(axis=1) - tp
        fn = hist.sum(axis=0) - tp
        precision = tp / (tp + fp)
        recall = tp / (tp + fn)

    id2cat = id2cat or {i: str(i) for i in range(hist.shape[0])}
    log(f"Dataset name: {dataset_name}")
    log("label_id      label    iU    Precision Recall TP     FP    FN")
    total = hist.sum()
    for idx in range(hist.shape[0]):
        with np.errstate(divide="ignore", invalid="ignore"):
            # fp/tp and fn/tp print inf/nan at tp=0, like the reference
            # (metrics.py:110-113)
            log(f"{idx:2d}    {str(id2cat.get(idx, '')):>13}   "
                f"{iu[idx] * 100:5.1f}  {precision[idx]:5.1f}     "
                f"{recall[idx]:5.1f}  {100 * tp[idx] / total:5.1f}  "
                f"{fp[idx] / tp[idx]:5.1f}   {fn[idx] / tp[idx]:5.1f}")
    log(f"mean {mean_iu}")
    logging.info("[dataset %s], [acc %.5f], [acc_cls %.5f], [mean_iu %.5f], "
                 "[fwavacc %.5f]", dataset_name, acc, acc_cls, mean_iu, fwavacc)
    return {"acc": float(acc), "acc_cls": float(acc_cls),
            "mean_iu": float(mean_iu), "fwavacc": float(fwavacc),
            "iu": iu, "hist": hist}
