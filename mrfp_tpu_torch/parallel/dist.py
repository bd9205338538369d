"""Process groups and the collectives of the data-parallel train step
(mrfp_tpu/parallel/dist.py).

The JAX package shards the batch over a mesh axis and lets GSPMD turn every
reduction over the batch into one over the global batch. The port runs one
process per card instead, and each such reduction calls a collective of
this module explicitly: the BatchNorm moments (``nn/norms.py``), NP+'s
spread of the channel means (``perturb/np_plus.py``), the loss
denominators (``train/losses.py``), the gradient (``train/step.py``) and the
eval histogram (``train/evaluator.py``).

Only ``all_reduce`` and ``broadcast`` are used, on fp32, fp64 or int64
tensors: gloo supports those two collectives on CUDA tensors, so two ranks
can share one card through gloo, where NCCL refuses two ranks on one
device. With no process group, or a group of one, every helper returns its
input as it is: a single-process run computes what it computed before this
module existed.

Every collective goes through ``_issue``, which also reports it (its op,
dtype and bytes) to the count that ``parallel/audit.py`` opens; with no
count open that is one ``is None`` test a call.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Callable, Optional

import torch
import torch.distributed as dist

_COLLECTIVE_DTYPES = (torch.float32, torch.float64, torch.int64)
# the open count's recorder, ``(op, tensor) -> None`` (parallel/audit.py)
_audit: Optional[Callable[[str, torch.Tensor], None]] = None


def world() -> int:
    """The number of processes in the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_coordinator() -> bool:
    """Whether this process writes the run's files (rank 0)."""
    return rank() == 0


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device: str = "cuda",
                           backend: Optional[str] = None,
                           timeout_s: float = 1800.0) -> bool:
    """Join the default process group; returns whether the run is
    multi-process.

    Without arguments the group comes from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``), the
    counterpart of ``jax.distributed.initialize``'s discovery; with neither
    arguments nor ``WORLD_SIZE`` the run is one process and no group is
    made. ``coordinator_address`` is ``host:port`` (TCP rendezvous) or a
    ``file://`` path. The backend follows ``device`` (``nccl`` for cuda,
    ``gloo`` for cpu) unless ``backend`` names one. On cuda the process
    takes card ``LOCAL_RANK % device_count`` (``LOCAL_RANK`` defaults to the
    rank). A group that cannot form raises: the run never goes on as one
    process."""
    env = os.environ
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    if not explicit and "WORLD_SIZE" not in env:
        return False
    if dist.is_initialized():
        raise RuntimeError("initialize_distributed: a process group already exists")
    size = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    me = int(process_id if process_id is not None else env.get("RANK", 0))
    if not 0 <= me < size:
        raise ValueError(f"process id {me} is outside a group of {size}")
    if coordinator_address is None:
        method = "env://"
    elif "://" in coordinator_address:
        method = coordinator_address
    else:
        method = f"tcp://{coordinator_address}"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: device cuda, but "
                               "torch.cuda.is_available() is False")
        local = int(env.get("LOCAL_RANK", me))
        torch.cuda.set_device(local % torch.cuda.device_count())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=method, world_size=size, rank=me,
                            timeout=datetime.timedelta(seconds=timeout_s))
    logging.info("process %d of %d (%s, %s)", me, size, backend, method)
    return size > 1


def local_device(device: str) -> torch.device:
    """The device this process computes on: its card for ``cuda`` (the one
    ``initialize_distributed`` set), else ``device`` itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the processes, in place (and returned); ``t``
    itself at world size 1. Not differentiable: for statistics that carry
    no gradient (counts, detached denominators, the gradient itself)."""
    return t if world() == 1 else _issue("all-reduce", t)


def broadcast(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``t`` on every process, in place (and returned); ``t``
    itself at world size 1. Not differentiable."""
    return t if world() == 1 else _issue("broadcast", t)


def _issue(op: str, t: torch.Tensor) -> torch.Tensor:
    """Run the collective ``op`` ("all-reduce", a sum, or "broadcast" from
    rank 0) on ``t`` in place, reported to the open count."""
    if t.dtype not in _COLLECTIVE_DTYPES:
        raise TypeError(f"{op} takes {_COLLECTIVE_DTYPES}, got {t.dtype}")
    if _audit is not None:
        _audit(op, t)
    if op == "all-reduce":
        dist.all_reduce(t)
    else:
        dist.broadcast(t, src=0)
    return t


class _AllReduceSum(torch.autograd.Function):
    """The sum over the processes, whose gradient is the sum over the
    processes of the gradient: each rank's loss reads the global sum, so
    the global objective (the sum of the ranks' losses) reaches each
    rank's input through every rank's loss."""

    @staticmethod
    def forward(ctx, t):
        return all_reduce_sum(t.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone())


def all_reduce_sum_grad(t: torch.Tensor) -> torch.Tensor:
    """``all_reduce_sum`` of a copy of ``t``, differentiable; ``t`` itself
    at world size 1."""
    return t if world() == 1 else _AllReduceSum.apply(t)


def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The ranks' ``t`` (every rank the same shape) stacked along dim 0 in
    rank order, differentiable: rank r's rows go into a zero buffer at
    ``r * len(t)``, and one ``all_reduce`` fills in the rest. ``t`` itself
    at world size 1."""
    n = world()
    if n == 1:
        return t
    rows = t.shape[0]
    buf = t.new_zeros((rows * n,) + tuple(t.shape[1:]))
    lo = rank() * rows
    buf = torch.cat([buf[:lo], t, buf[lo + rows:]])
    return _AllReduceSum.apply(buf)


def barrier() -> None:
    """Wait until every process gets here: a one-value ``all_reduce``,
    read back on the host (on the card under nccl, on the CPU under gloo)."""
    if world() == 1:
        return
    dev = local_device("cuda") if dist.get_backend() == "nccl" else torch.device("cpu")
    float(all_reduce_sum(torch.zeros(1, device=dev)))


def all_reduce_grads(params) -> None:
    """Sum the gradients of ``params`` over the processes, one flat
    ``all_reduce`` per dtype, after the backward (and, under accumulation,
    after the last microbatch's only). A parameter that got no gradient on
    this rank takes zeros, as a dense JAX gradient has them, so every rank
    reduces the same layout whatever its gates skipped. Nothing at world
    size 1."""
    if world() == 1:
        return
    groups = {}
    for p in params:
        if not p.requires_grad:
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        groups.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in groups.values():
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]))
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))
