"""The training data loader, in PyTorch's idiom (mrfp_tpu/data/loader.py).

``torch.utils.data.DataLoader`` runs the dataset's pipelines in worker
processes; the collate keeps the uint8 wire format (integer images and
labels cross to the device as they are and are cast there, 4x fewer bytes
than float32 and bit-identical after the cast). ``EpochSampler`` draws the
JAX loader's shuffle: ``np.random.default_rng(seed + epoch)`` over the
indices, with ``drop_last``; ``set_epoch`` pins the epoch, so a resumed run
replays the order a fresh run would use, and forwards it to the dataset for
its per-sample augmentation RNG. ``prefetch_to_device`` keeps two batches
in flight to the device from pinned memory, with the evaluator's copy.

Under data parallelism (``shard_count`` processes, as
mrfp_tpu/data/loader.py:57-108) ``batch_size`` counts this process's
images: every process draws the same shuffle of the whole dataset and takes
its ``shard_rank`` slice of each global batch of ``batch_size *
shard_count``. The datasets key their augmentation draws by ``(seed, epoch,
index)`` (``data/datasets.py::_sample_rngs``), so an image comes out the
same whichever process loads it.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch
from torch.utils.data import DataLoader, Sampler

from mrfp_tpu_torch.utils.transfer import to_device


def collate(samples) -> Dict[str, torch.Tensor]:
    """Stack a batch, keeping uint8 images and labels as uint8 (others:
    float32 images, int32 labels)."""
    imgs = np.stack([np.asarray(s["image"]) for s in samples])
    if imgs.dtype != np.uint8:
        imgs = imgs.astype(np.float32)
    lbls = np.stack([np.asarray(s["label"]) for s in samples])
    if lbls.dtype != np.uint8:
        lbls = lbls.astype(np.int32)
    return {"image": torch.from_numpy(imgs), "label": torch.from_numpy(lbls)}


class EpochSampler(Sampler):
    """Shuffled indices, a fresh order per epoch from ``seed + epoch``: the
    whole global batches of ``batch_size * shard_count`` in that order,
    and of each this shard's ``batch_size``."""

    def __init__(self, n: int, batch_size: int, seed: int = 0, shuffle: bool = True,
                 shard_rank: int = 0, shard_count: int = 1):
        if not 0 <= shard_rank < shard_count:
            raise ValueError(f"shard {shard_rank} outside {shard_count} shards")
        self.n, self.seed, self.shuffle = n, seed, shuffle
        self.batch_size, self.shard_rank, self.shard_count = batch_size, shard_rank, shard_count
        self.epoch = 0

    def __len__(self) -> int:
        return self.n // (self.batch_size * self.shard_count) * self.batch_size

    def __iter__(self) -> Iterator[int]:
        idx = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        gbs = self.batch_size * self.shard_count
        batches = idx[:self.n // gbs * gbs].reshape(-1, self.shard_count, self.batch_size)
        return iter(batches[:, self.shard_rank].reshape(-1).tolist())


class TrainLoader:
    """Batches of a dataset in a seeded per-epoch order, ``drop_last``;
    ``batch_size`` images a process, the ``shard_rank`` slice of each
    global batch. Under spatial parallelism the shards are the data
    ranks (``core/mesh.py``): every rank of a spatial group loads and
    augments the same samples and keeps its band of their rows, so the
    host work is repeated ``sp`` times (a cost, not yet removed)."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, num_workers: int = 0,
                 pin_memory: bool = False, shard_rank: int = 0, shard_count: int = 1):
        self.dataset = dataset
        self.sampler = EpochSampler(len(dataset), batch_size, seed, shard_rank=shard_rank,
                                    shard_count=shard_count)
        self._loader = DataLoader(
            dataset, batch_size=batch_size, sampler=self.sampler, drop_last=True,
            collate_fn=collate, num_workers=num_workers, pin_memory=pin_memory,
            multiprocessing_context="spawn" if num_workers > 0 else None)

    def set_epoch(self, epoch: int) -> None:
        self.sampler.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self._loader)

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        return iter(self._loader)


def prefetch_to_device(iterator, device, size: int = 2):
    """Yield the batches of ``iterator`` on ``device``, ``size`` in flight:
    batch i+1 is copied while batch i runs."""
    buf = []
    for batch in iterator:
        buf.append({k: to_device(v, device) for k, v in batch.items()})
        if len(buf) >= size:
            yield buf.pop(0)
    while buf:
        yield buf.pop(0)
