"""Process groups and the collectives of the data-parallel train step
(mrfp_tpu/parallel/dist.py).

The JAX package shards the batch over a mesh axis and lets GSPMD turn every
reduction over the batch into one over the global batch. The port runs one
process per card instead, and each such reduction calls a collective of
this module explicitly: the BatchNorm moments (``nn/norms.py``), NP+'s
spread of the channel means (``perturb/np_plus.py``), the loss
denominators (``train/losses.py``), the gradient (``train/step.py``) and the
eval histogram (``train/evaluator.py``).

Every collective takes a ``Group``: the world (the default), or the data,
spatial, model or replica group of the process mesh (``core/mesh.py``).
Under spatial parallelism the ranks of a spatial group hold the bands of
rows of one image's maps, and ``rows_from_group`` fetches the rows an
operation reads from their owners: the halo of a conv, a pool or a resize.
Under tensor parallelism the ranks of a model group hold slices of the
channels of one batch's maps, and three conjugate operations move them:
``gather_channels`` (all-gather forward, the rank's slice backward),
``copy_to_group`` (identity forward, the group's sum backward) and
``slice_channels`` (the rank's slice forward, all-gather backward).

Only ``all_reduce`` and ``broadcast`` are used, on fp32, fp64 or int64
tensors: gloo supports those two collectives on CUDA tensors, so two ranks
can share one card through gloo, where NCCL refuses two ranks on one
device. No send or receive is used, for the same reason. With no process
group, or a group of one, every helper returns its input as it is: a
single-process run computes what it computed before this module existed.

Every collective goes through ``_issue``, which also reports it (its op,
dtype, bytes, group and kind: a halo, channels or statistics) to the count that
``parallel/audit.py`` opens; with no count open that is one ``is None``
test a call.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_COLLECTIVE_DTYPES = (torch.float32, torch.float64, torch.int64)
# the open count's recorder, ``(op, tensor, group name, kind) -> None``
# (parallel/audit.py)
_audit: Optional[Callable[[str, torch.Tensor, str, str], None]] = None


@dataclasses.dataclass(frozen=True)
class Group:
    """Processes that reduce together: ``name`` ("world", "data",
    "spatial", "model" or "replica"), the torch process group (None: the
    default group, or no group at all for a group of one), its ``size`` and
    this process's ``rank`` in it."""
    name: str
    pg: Optional[object]
    size: int
    rank: int


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


def backend_for(device: str, local_ranks: Optional[int] = None) -> Optional[str]:
    """The backend for ``initialize_distributed`` when ``local_ranks`` of
    the group's processes run on this host: ``gloo`` off the card, or where
    they outnumber the host's cards (NCCL refuses two ranks on one card),
    else None (the device's own: NCCL). ``local_ranks`` defaults to
    ``LOCAL_WORLD_SIZE`` (torchrun's, or set by the launcher), else 1:
    nothing else says that ranks share a card, so a launch with a card a
    process, on one host or several, keeps NCCL."""
    if torch.device(device).type != "cuda":
        return "gloo"
    if local_ranks is None:
        local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    return "gloo" if torch.cuda.device_count() < local_ranks else None


def local_device(device: str) -> torch.device:
    """The device this process computes on: its card for ``cuda`` (the one
    ``initialize_distributed`` set), else ``device`` itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def world_group() -> Group:
    """Every process: the default group."""
    return Group("world", None, world(), rank())


def all_reduce_sum(t: torch.Tensor, group: Optional[Group] = None,
                   kind: str = "stats") -> torch.Tensor:
    """The sum of ``t`` over the processes of ``group`` (the world by
    default), in place (and returned); ``t`` itself in a group of one. Not
    differentiable: for statistics that carry no gradient (counts,
    detached denominators, the gradient itself)."""
    group = group or world_group()
    return t if group.size == 1 else _issue("all-reduce", t, group, kind)


def broadcast(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``t`` on every process, in place (and returned); ``t``
    itself at world size 1. Not differentiable."""
    return t if world() == 1 else _issue("broadcast", t, world_group(), "stats")


def _issue(op: str, t: torch.Tensor, group: Group, kind: str) -> torch.Tensor:
    """Run the collective ``op`` ("all-reduce", a sum, or "broadcast" from
    rank 0) on ``t`` in place over ``group``, reported to the open count
    as ``kind`` ("halo", "channels" or "stats")."""
    if t.dtype not in _COLLECTIVE_DTYPES:
        raise TypeError(f"{op} takes {_COLLECTIVE_DTYPES}, got {t.dtype}")
    if _audit is not None:
        _audit(op, t, group.name, kind)
    if op == "all-reduce":
        dist.all_reduce(t, group=group.pg)
    else:
        dist.broadcast(t, src=0)
    return t


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group, whose gradient is the sum over the group of
    the gradient: each rank's loss reads the group's sum, so the global
    objective (the sum of the ranks' losses) reaches each rank's input
    through every rank's loss."""

    @staticmethod
    def forward(ctx, t, group: Group, kind: str):
        ctx.group, ctx.kind = group, kind
        return all_reduce_sum(t.clone(), group, kind)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.group, ctx.kind), None, None


def all_reduce_sum_grad(t: torch.Tensor, group: Optional[Group] = None) -> torch.Tensor:
    """``all_reduce_sum`` of a copy of ``t`` over ``group`` (the world by
    default), differentiable; ``t`` itself in a group of one."""
    group = group or world_group()
    return t if group.size == 1 else _AllReduceSum.apply(t, group, "stats")


def all_gather_rows(t: torch.Tensor, group: Optional[Group] = None) -> torch.Tensor:
    """The ranks' ``t`` (every rank of ``group``, the world by default, the
    same shape) stacked along dim 0 in rank order, differentiable: rank r's
    rows go into a zero buffer at ``r * len(t)``, and one ``all_reduce``
    fills in the rest. ``t`` itself in a group of one."""
    group = group or world_group()
    n = group.size
    if n == 1:
        return t
    rows = t.shape[0]
    buf = t.new_zeros((rows * n,) + tuple(t.shape[1:]))
    lo = group.rank * rows
    buf = torch.cat([buf[:lo], t, buf[lo + rows:]])
    return _AllReduceSum.apply(buf, group, "stats")


def _wire(dtype: torch.dtype) -> torch.dtype:
    """The dtype a tensor crosses in: its own where collectives take it,
    else fp32 (bf16 and fp16 exactly)."""
    return dtype if dtype in _COLLECTIVE_DTYPES else torch.float32


def _channel_spans(parts: Tuple[int, ...], n: int, r: int):
    """Where rank ``r``'s channels lie in the whole map: for each part of
    its local channels (``parts``, in order), ``(local offset, global
    offset, size)``. The whole map puts every rank's part 0 first, in rank
    order, then every rank's part 1, and so on: the channel order of the
    concatenation of the whole parts."""
    spans, local, base = [], 0, 0
    for size in parts:
        spans.append((local, base + r * size, size))
        local += size
        base += n * size
    return spans


def _gather_channels(x: torch.Tensor, group: Group, parts: Tuple[int, ...]) -> torch.Tensor:
    """Every rank's ``x`` put in its place of the whole map (dim 1), by one
    ``all_reduce`` of a zeroed buffer; in the wire dtype."""
    n = group.size
    buf = x.new_zeros((x.shape[0], n * x.shape[1]) + tuple(x.shape[2:]), dtype=_wire(x.dtype))
    for lo, at, size in _channel_spans(parts, n, group.rank):
        buf[:, at:at + size] = x[:, lo:lo + size]
    return _issue("all-reduce", buf, group, "channels")


def _own_channels(t: torch.Tensor, group: Group, parts: Tuple[int, ...]) -> torch.Tensor:
    """This rank's channels of the whole map ``t`` (dim 1), in its local
    order."""
    spans = _channel_spans(parts, group.size, group.rank)
    return torch.cat([t[:, at:at + size] for _lo, at, size in spans], dim=1)


class _GatherChannels(torch.autograd.Function):
    """The whole map of the channel slices of a model group: forward the
    all-gather, backward this rank's slice of the cotangent, which every
    rank of the group holds whole (the map's consumers compute alike)."""

    @staticmethod
    def forward(ctx, x, group: Group, parts: Tuple[int, ...]):
        ctx.group, ctx.parts = group, parts
        return _gather_channels(x, group, parts).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return _own_channels(g, ctx.group, ctx.parts).contiguous(), None, None


class _CopyToGroup(torch.autograd.Function):
    """A map every rank of a model group holds whole, handed to a
    computation of which each rank computes its own part (a conv's slice of
    output channels): forward the identity, backward the group's sum of
    the ranks' cotangents."""

    @staticmethod
    def forward(ctx, x, group: Group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _issue("all-reduce", g.to(_wire(g.dtype), copy=True).contiguous(), ctx.group,
                      "channels").to(g.dtype), None


class _SliceChannels(torch.autograd.Function):
    """This rank's channels of a map every rank of a model group holds
    whole: forward the slice, backward the all-gather of the ranks'
    cotangents."""

    @staticmethod
    def forward(ctx, x, group: Group):
        ctx.group = group
        c = x.shape[1] // group.size
        return x[:, group.rank * c:(group.rank + 1) * c].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_channels(g.contiguous(), ctx.group, (g.shape[1],)).to(g.dtype), None


def gather_channels(x: torch.Tensor, group: Group,
                    parts: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The whole NC... map whose channels (dim 1) are split over the model
    ``group``, ``x`` this rank's slice: one ``all_reduce`` of a zeroed
    buffer into which each rank writes its channels. ``parts``: the sizes
    of the blocks of ``x``'s channels when ``x`` is a concatenation of
    slices (``ASPP``'s five branches), so that the whole map is the
    concatenation of the whole blocks; one block by default.
    Differentiable: the backward is this rank's slice of the cotangent, for
    consumers that every rank of the group computes alike (wrap the result
    in ``copy_to_group`` for consumers of which each rank computes a part).
    bf16 crosses as fp32, exactly. ``x`` itself in a group of one."""
    if group.size == 1:
        return x
    parts = (x.shape[1],) if parts is None else tuple(int(p) for p in parts)
    if sum(parts) != x.shape[1]:
        raise ValueError(f"gather_channels: parts {parts} of {x.shape[1]} channels")
    return _GatherChannels.apply(x, group, parts)


def copy_to_group(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x``, which every rank of the model ``group`` holds whole, as the
    input of a computation of which each rank computes its own part: the
    backward sums the ranks' cotangents over the group (one ``all_reduce``,
    bf16 in fp32). ``x`` itself in a group of one."""
    return x if group.size == 1 else _CopyToGroup.apply(x, group)


def slice_channels(x: torch.Tensor, group: Group) -> torch.Tensor:
    """This rank's slice of the channels (dim 1) of ``x``, which every rank
    of the model ``group`` holds whole: rank ``m`` keeps channels ``[m c,
    (m + 1) c)``, ``c`` = C / size. The backward gathers the ranks'
    cotangents (one ``all_reduce``). ``x`` itself in a group of one."""
    if group.size == 1:
        return x
    if x.shape[1] % group.size:
        raise ValueError(f"slice_channels: {x.shape[1]} channels over {group.size} ranks")
    return _SliceChannels.apply(x, group)


def gather_rows(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The ranks' ``t`` stacked along dim 0 in rank order, not
    differentiable (a checkpoint's shards): one ``all_reduce`` of a zeroed
    buffer, any float dtype crossing as fp32 exactly. ``t`` itself in a
    group of one."""
    if group.size == 1:
        return t
    rows = t.shape[0]
    buf = t.new_zeros((rows * group.size,) + tuple(t.shape[1:]), dtype=_wire(t.dtype))
    buf[group.rank * rows:(group.rank + 1) * rows] = t
    return _issue("all-reduce", buf, group, "stats").to(t.dtype)


def band(h: int, parts: int, index: int) -> Tuple[int, int]:
    """The rows ``[lo, hi)`` that part ``index`` of ``parts`` owns of a map
    of ``h`` rows: the even split of that map's own height,
    ``[floor(index * h / parts), floor((index + 1) * h / parts))``."""
    return index * h // parts, (index + 1) * h // parts


def _halo_segments(h: int, lo: Sequence[int], hi: Sequence[int], n: int):
    """Every rank's wanted rows outside its own band (at most a segment
    above it and one below), in rank order: ``(rank, first, end, offset)``,
    ``offset`` the segment's first row in the exchange buffer; and the
    buffer's rows."""
    segments, at = [], 0
    for r in range(n):
        a0, a1 = max(lo[r], 0), min(hi[r], h)
        r0, r1 = band(h, n, r)
        for a, b in ((a0, min(a1, r0)), (max(a0, r1), a1)):
            if b > a:
                segments.append((r, a, b, at))
                at += b - a
    return segments, at


class _RowsFromGroup(torch.autograd.Function):
    """``rows_from_group`` as one node of the graph on every rank, so every
    rank runs its backward exchange, in the same order as the others."""

    @staticmethod
    def forward(ctx, x, h: int, lo: Tuple[int, ...], hi: Tuple[int, ...], group: Group,
                fill: float):
        n, me = group.size, group.rank
        b0, b1 = band(h, n, me)
        if x.shape[2] != b1 - b0:
            raise ValueError(f"rows_from_group: {x.shape[2]} rows, but rank {me} of {n} owns "
                             f"{b1 - b0} of {h}")
        segments, total = _halo_segments(h, lo, hi, n)
        wire = _wire(x.dtype)
        lead, width = tuple(x.shape[:2]), x.shape[3]
        buf = None
        if segments:
            buf = x.new_zeros(lead + (total, width), dtype=wire)
            for _r, a, b, at in segments:  # the rows this rank owns of every segment
                o0, o1 = max(a, b0), min(b, b1)
                if o1 > o0:
                    buf[:, :, at + o0 - a:at + o1 - a] = x[:, :, o0 - b0:o1 - b0]
            all_reduce_sum(buf, group, "halo")
        want0, want1 = lo[me], hi[me]
        out = torch.full(lead + (want1 - want0, width), fill, dtype=x.dtype, device=x.device)
        o0, o1 = max(want0, b0), min(want1, b1)
        if o1 > o0:
            out[:, :, o0 - want0:o1 - want0] = x[:, :, o0 - b0:o1 - b0]
        for r, a, b, at in segments:
            if r == me:
                out[:, :, a - want0:b - want0] = buf[:, :, at:at + b - a]
        ctx.args = (h, lo, hi, group, b0, b1, wire)
        return out

    @staticmethod
    def backward(ctx, g):
        h, lo, hi, group, b0, b1, wire = ctx.args
        n, me = group.size, group.rank
        want0, want1 = lo[me], hi[me]
        segments, total = _halo_segments(h, lo, hi, n)
        lead, width = tuple(g.shape[:2]), g.shape[3]
        gx = g.new_zeros(lead + (b1 - b0, width), dtype=wire)
        o0, o1 = max(want0, b0), min(want1, b1)
        if o1 > o0:
            gx[:, :, o0 - b0:o1 - b0] += g[:, :, o0 - want0:o1 - want0]
        if segments:
            buf = g.new_zeros(lead + (total, width), dtype=wire)
            for r, a, b, at in segments:  # this rank's cotangents of its fetched rows
                if r == me:
                    buf[:, :, at:at + b - a] = g[:, :, a - want0:b - want0]
            all_reduce_sum(buf, group, "halo")
            for _r, a, b, at in segments:  # each owner adds its rows' cotangents
                o0, o1 = max(a, b0), min(b, b1)
                if o1 > o0:
                    gx[:, :, o0 - b0:o1 - b0] += buf[:, :, at + o0 - a:at + o1 - a]
        return gx.to(g.dtype), None, None, None, None, None


def rows_from_group(x: torch.Tensor, h: int, lo: Sequence[int], hi: Sequence[int],
                    group: Group, fill: float = 0.0) -> torch.Tensor:
    """The global rows ``[lo[s], hi[s])`` of an NCHW map of ``h`` rows whose
    rows are split over ``group`` by ``band`` (``x``: this rank's band),
    ``s`` this rank's index in the group; rows outside ``[0, h)`` are
    ``fill`` (the caller's padding). Every rank passes the same ``lo`` and
    ``hi``, one entry per rank of the group. Differentiable.

    Only halo rows cross: each rank's rows outside its own band, at most a
    segment above it and one below, are laid end to end in one zeroed
    buffer; every owner writes the rows it holds of every segment, and one
    ``all_reduce`` over the group fills the buffer in on every rank (the
    way ``all_gather_rows`` gathers). Its backward is one ``all_reduce`` of
    the segments' cotangents, from which each owner adds its rows' share:
    each fetched row's cotangent is summed back to its owner. Where no rank
    reads a row it does not own, nothing is issued. A dtype that
    collectives do not take (bf16) crosses as fp32, exactly, and is cast
    back (its cotangents are summed in fp32 and rounded once)."""
    return _RowsFromGroup.apply(x, int(h), tuple(int(v) for v in lo),
                                tuple(int(v) for v in hi), group, float(fill))


def barrier() -> None:
    """Wait until every process gets here: a one-value ``all_reduce``,
    read back on the host (on the card under nccl, on the CPU under gloo)."""
    if world() == 1:
        return
    dev = local_device("cuda") if dist.get_backend() == "nccl" else torch.device("cpu")
    float(all_reduce_sum(torch.zeros(1, device=dev)))


def all_reduce_grads(params, group: Optional[Group] = None) -> None:
    """Sum the gradients of ``params`` over ``group`` (the world by default;
    the mesh's replica group, the ranks that share the model index, under
    tensor parallelism), one flat ``all_reduce`` per dtype, after the
    backward (and, under accumulation, after the last microbatch's only).
    A parameter that got no gradient on this rank takes zeros, as a dense
    JAX gradient has them, so every rank reduces the same layout whatever
    its gates skipped. Nothing in a group of one."""
    group = group or world_group()
    if group.size == 1:
        return
    groups = {}
    for p in params:
        if not p.requires_grad:
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        groups.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in groups.values():
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))
