"""Checkpoint / resume on ``torch.save`` (mrfp_tpu/train/checkpoint.py).

A checkpoint is one file, ``step_<N>.pt``, holding the step, the model's
state_dict (parameters, BN running statistics, OC buffers), the optimizer's
and the schedule's state and the run seed. It is written to a temporary
file and renamed into place, so a crash leaves the previous checkpoints
whole and never a half-written one under a checkpoint's name. Saves run on
one background thread after the state has been copied to host memory, so
training goes on while the file is written; ``wait`` joins them and raises
what a save raised.

A manager given a ``recipe`` (what the run trains on: ``cli.train`` gives
the source, or synthetic data, the crop, the seed and the mode) writes it
into every checkpoint and resumes only a checkpoint of the same recipe, so
a smoke run's checkpoint never seeds a real run that shares its
directory. ``max_iter`` is not part of it: a run extended with a larger
``--max-iter`` resumes.

The newest ``keep`` checkpoints stay. With metrics (``--eval-every``), a new
best by ``best_metric`` is also written to ``best/`` and recorded in
``best/metric.json``; the new best is committed before the old one is
deleted, so a restart never loses the best (the RobustNet rotation,
utils/misc.py:162-231).

Under data parallelism (``parallel/dist.py``) every rank holds the same
state, so only the coordinator (rank 0) snapshots and writes, the best
record included; every rank restores. Under tensor parallelism
(``core/mesh.py``, ``mp > 1``) a rank holds its shards of the parameters,
the momentum and the BN statistics: every rank gathers the whole state
over its model group (``weights.whole_state_dict``), which rank 0 writes
in the reference key layout, so a checkpoint loads ``strict=True`` into
one process; ``restore`` reads the whole state and keeps this rank's
shards (``weights.shard_state_dict``), so a run resumes at any M.
``wait`` ends in a barrier, after the coordinator's writes have finished,
so no rank reads a step that is still being written (``restore`` waits
first).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from mrfp_tpu_torch.core.mesh import current_mesh
from mrfp_tpu_torch.parallel.dist import barrier, gather_rows, is_coordinator
from mrfp_tpu_torch.train.state import TrainState
from mrfp_tpu_torch.weights import shard_state_dict, whole_state_dict

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _to_host(obj):
    """A deep copy of a state_dict tree with every tensor on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def blob_nbytes(obj) -> int:
    """The bytes of every tensor in a state_dict tree."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(blob_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(blob_nbytes(v) for v in obj)
    return 0


def _atomic_save(blob, path: str) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        torch.save(blob, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _steps(directory: str) -> List[int]:
    """The steps of the ``step_<N>.pt`` files in ``directory``, in order."""
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def find_checkpoint(path: str) -> str:
    """The checkpoint file ``path`` names: a file itself; in a directory of
    ``step_<N>.pt`` files (a run's ``ckpt/``, or its ``ckpt/best/``), the
    latest; in a run directory of ``cli.train``, the latest of its
    ``ckpt/``. Raises FileNotFoundError where there is none."""
    if os.path.isfile(path):
        return path
    for directory in (path, os.path.join(path, "ckpt")):
        steps = _steps(directory) if os.path.isdir(directory) else []
        if steps:
            return os.path.join(directory, f"step_{steps[-1]}.pt")
    raise FileNotFoundError(
        f"{path}: no step_<N>.pt here or under ckpt/. The JAX trainer's Orbax run "
        f"directories do not load into the port (reading them imports jax): export "
        f"one with python -m mrfp_tpu.cli.convert --run and pass the .pth (ROADMAP A13)")


def _optimizer_state(state: TrainState, mesh, whole: bool = False,
                     blob: Optional[dict] = None) -> dict:
    """The optimizer's state_dict with each momentum buffer whole (gathered
    over the model group, ``whole``), or ``blob``'s whole buffers cut to
    this rank's shards: a buffer mirrors its parameter, whose placement
    the whole model's state_dict gives. As it is at ``mp == 1``."""
    sd = state.optimizer.state_dict() if blob is None else blob
    if mesh.mp == 1:
        return sd
    names = [k for k, p in state.model.named_parameters() if p.requires_grad]

    def placed(v, sharded: bool):
        if not (sharded and isinstance(v, torch.Tensor) and v.dim() > 0):
            return v
        if whole:
            return gather_rows(v, mesh.model)
        return v.chunk(mesh.mp, 0)[mesh.model_index].clone()

    out = {**sd, "state": {}}
    for i, entry in sd["state"].items():
        sharded = names[int(i)] in state.model.tp_keys
        out["state"][i] = {k: placed(v, sharded) for k, v in entry.items()}
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, best_metric: str = "mean_iu",
                 recipe: Optional[Dict[str, object]] = None):
        self.directory = os.path.abspath(directory)
        self.recipe = recipe
        os.makedirs(self.directory, exist_ok=True)
        self.keep = max(1, keep)
        self.best_metric = best_metric
        self._best_value = -np.inf
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: List[concurrent.futures.Future] = []
        self._last_saved: Optional[int] = None
        try:
            with open(self._best_record_path) as f:
                self._best_value = float(json.load(f)["value"])
        except (OSError, ValueError, KeyError):
            pass

    @property
    def _best_record_path(self) -> str:
        return os.path.join(self.directory, "best", "metric.json")

    def all_steps(self) -> List[int]:
        return _steps(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, state: TrainState, metrics: Optional[Dict[str, float]] = None) -> None:
        """Snapshot ``state`` to host memory now and write it in the
        background; with ``metrics``, rotate ``best/`` on a new best. A step
        already saved by this manager is not written again. Only the
        coordinator writes."""
        best = bool(metrics) and metrics.get(self.best_metric, -np.inf) > self._best_value
        if state.step == self._last_saved and not best:
            return
        self._last_saved = state.step
        if best:  # on every rank: the next save's decision, and its gathers, are alike
            self._best_value = float(metrics[self.best_metric])
        sharded = bool(getattr(state.model, "tp_keys", None))
        if not is_coordinator() and not sharded:
            return
        blob = self.host_blob(state)  # under a model axis, a gather every rank joins
        if not is_coordinator():
            return
        self._pending.append(self._pool.submit(self._write, blob, state.step,
                                               self._best_value if best else None))

    def host_blob(self, state: TrainState) -> dict:
        """What a checkpoint of ``state`` holds, copied to host memory now:
        the whole state, gathered over the model group where the model is
        sharded (every rank of the group must call it then)."""
        mesh = current_mesh()
        return _to_host({"step": state.step, "seed": state.seed,
                         "model": whole_state_dict(state.model, mesh),
                         "optimizer": _optimizer_state(state, mesh, whole=True),
                         "scheduler": state.scheduler.state_dict(),
                         "recipe": self.recipe})

    def write_blob(self, blob: dict) -> None:
        """Write a ``host_blob`` as its step's checkpoint, after the saves
        already in flight, and wait for it. It touches no device, so the
        watchdog's thread can persist a snapshot while the main thread is
        stuck in a device call."""
        self._pool.submit(self._write, blob, blob["step"], None).result()

    def _write(self, blob, step: int, best_value: Optional[float]) -> None:
        if not os.path.exists(self._path(step)):
            _atomic_save(blob, self._path(step))
        for old in self.all_steps()[:-self.keep]:
            os.unlink(self._path(old))
        if best_value is None:
            return
        best_dir = os.path.join(self.directory, "best")
        os.makedirs(best_dir, exist_ok=True)
        _atomic_save(blob, os.path.join(best_dir, f"step_{step}.pt"))
        tmp = self._best_record_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"metric": self.best_metric, "value": best_value, "step": step}, f)
        os.replace(tmp, self._best_record_path)
        for name in os.listdir(best_dir):
            if _NAME.match(name) and name != f"step_{step}.pt":
                os.unlink(os.path.join(best_dir, name))

    def wait(self) -> None:
        """Block until every save has been written; raise the first error.
        With more than one process, every rank then waits for the others:
        past this point every checkpoint file is whole."""
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()
        barrier()

    def restore(self, state: TrainState, step: Optional[int] = None) -> bool:
        """Load the given (or latest) checkpoint into ``state`` in place;
        False when there is none (a fresh start). Raises ValueError, and
        leaves ``state`` as it was, for a checkpoint of another recipe."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return False
        device = next(state.model.parameters()).device
        blob = torch.load(self._path(step), map_location=device, weights_only=True)
        if self.recipe is not None and blob.get("recipe") != self.recipe:
            raise ValueError(
                f"{self._path(step)} was written by a run of recipe {blob.get('recipe')}, "
                f"not this run's {self.recipe}: refusing to resume it. Give this run "
                f"another --runs-dir, or remove {self.directory}")
        mesh = current_mesh()
        state.model.load_state_dict(shard_state_dict(blob["model"], mesh), strict=True)
        state.optimizer.load_state_dict(_optimizer_state(state, mesh, blob=blob["optimizer"]))
        sched = state.scheduler
        sched.load_state_dict(blob["scheduler"])
        # the rate follows this run's schedule, as optax's does: a run
        # resumed with a larger max_iter must not keep the old end's rate
        for group, base, fn in zip(state.optimizer.param_groups, sched.base_lrs,
                                   sched.lr_lambdas):
            group["lr"] = base * fn(sched.last_epoch)
        state.step, state.seed = int(blob["step"]), int(blob["seed"])
        return True

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()
