"""The collectives a process issues, counted where they are issued
(mrfp_tpu/parallel/audit.py).

The JAX package learns what a sharded step pays on the wire by reading
the collectives GSPMD inserted into the compiled HLO. The port inserts
none: every collective of a data- or spatial-parallel step is an explicit
call of ``parallel/dist.py`` (the BatchNorm and SwitchWhiten statistics,
NP+'s gathered means, the loss denominators, the gradient, the eval
histogram, the statistics pass's masks, and under spatial parallelism the
halo rows of the convs, pools, resizes and the relaxed CE's label window,
and over the spatial group the statistics that span the bands: the
instance norms' and SwitchWhiten's per-sample moments, the whitening
loss's and the statistics pass's ``f f^T``, the pooled means, and under
tensor parallelism the channel gathers of every sharded map and their
backward sums over the model group), so it is counted at the call and no
parser of a program text is needed. A halo is reported as kind "halo", a
channel gather or its conjugate as "channels", everything else as
"stats", each with its group.

    with count_collectives() as log:
        train_step(...)
    summarize(log)            # {"all-reduce": {"count": 145, "bytes": ...}}
    summarize_by_group(log)   # {"world": {"stats": {...}}, "spatial": {"halo": ...},
                              #  "model": {"channels": ...}}

A count holds the collectives this process issues while it is open, in
order; at world size 1 the helpers issue none, so it stays empty. With no
count open ``parallel/dist.py`` pays one ``is None`` test a call.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

import torch

from mrfp_tpu_torch.parallel import dist

# torch dtypes under the HLO names the JAX audit reports
_DTYPE_NAMES = {torch.float32: "f32", torch.float64: "f64", torch.int64: "s64"}


@dataclass
class Collective:
    op: str                  # "all-reduce" or "broadcast"
    dtype: str               # "f32", "f64" or "s64"
    bytes: int               # the tensor's bytes, sent once by each rank
    shape: Tuple[int, ...]
    group: str = "world"     # "world", "data", "spatial", "model" or "replica"
    kind: str = "stats"      # "halo" (rows_from_group), "channels" (the model group's
                             # gathers and sums) or "stats" (everything else)


@contextlib.contextmanager
def count_collectives() -> Iterator[List[Collective]]:
    """Record every collective issued through ``parallel/dist.py`` while
    open into the yielded list. Counts do not nest."""
    if dist._audit is not None:
        raise RuntimeError("count_collectives: a count is already open")
    log: List[Collective] = []

    def record(op: str, t: torch.Tensor, group: str, kind: str) -> None:
        log.append(Collective(op, _DTYPE_NAMES[t.dtype], t.numel() * t.element_size(),
                              tuple(t.shape), group, kind))

    dist._audit = record
    try:
        yield log
    finally:
        dist._audit = None


def summarize(colls: List[Collective]) -> Dict[str, Dict[str, int]]:
    """``{op: {"count", "bytes"}}``, the JAX audit's rollup."""
    out: Dict[str, Dict[str, int]] = {}
    for c in colls:
        d = out.setdefault(c.op, {"count": 0, "bytes": 0})
        d["count"] += 1
        d["bytes"] += c.bytes
    return out


def summarize_by_dtype(colls: List[Collective]) -> Dict[str, Dict[str, Dict[str, int]]]:
    """``{op: {dtype: {"count", "bytes"}}}``: the rollup split by dtype."""
    out: Dict[str, Dict[str, Dict[str, int]]] = {}
    for c in colls:
        d = out.setdefault(c.op, {}).setdefault(c.dtype, {"count": 0, "bytes": 0})
        d["count"] += 1
        d["bytes"] += c.bytes
    return out


def summarize_by_group(colls: List[Collective]) -> Dict[str, Dict[str, Dict[str, int]]]:
    """``{group: {kind: {"count", "bytes"}}}``: the rollup by process group,
    the halo rows and the channel gathers apart from the statistics."""
    out: Dict[str, Dict[str, Dict[str, int]]] = {}
    for c in colls:
        d = out.setdefault(c.group, {}).setdefault(c.kind, {"count": 0, "bytes": 0})
        d["count"] += 1
        d["bytes"] += c.bytes
    return out
