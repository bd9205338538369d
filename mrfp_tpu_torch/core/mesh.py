"""The process mesh and the bands of a spatially split forward
(mrfp_tpu/core/mesh.py:23-111).

The JAX package builds a (data, model, spatial) device mesh and lets GSPMD
shard image H over the 'spatial' axis, inserting the conv halo exchanges.
The port runs one process per card and lays the processes out as the JAX
mesh lays out devices (``reshape(dp, mp, sp)`` with ``mp = 1``): rank
``r = d * sp + s``. The ranks that share ``d`` form a spatial group: they
take the same samples, and rank ``s`` of the group owns the rows
``band(H, sp, s)`` of every map of height ``H``, the even split of that
map's own height. The ranks that share ``s`` form a data group.

Inside ``bands(h, w)`` (entered by the model's forward when it is handed
a band, and by the train step around its loss) the convs, pools, resizes,
instance norms and the pooled means of ``nn/``, ``ops/resize.py`` and
``perturb/`` compute the rows of their output band, fetching from their
owners the input rows the band reads (``parallel/dist.py::rows_from_group``).
Each needs the global height of its input, which a band's row count alone
does not give (rank 0 holds 7 rows of a 14-row map and of a 15-row one):
the scope keeps every (height, width) that the forward made, and a band is
read back as the one map of its width whose band on this rank has its rows.
Where two maps of one width could be told apart on no rank, the lookup
raises, on every rank alike.

With one process, or ``sp == 1``, every helper is the identity and no scope
is entered: today's paths compute what they computed before this module.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List, Optional, Tuple

import torch
import torch.distributed as tdist

from mrfp_tpu_torch.core.config import MeshConfig
from mrfp_tpu_torch.parallel.dist import Group, band, rank, world, world_group

__all__ = ["Mesh", "Bands", "active_bands", "band", "bands", "create_mesh", "current_mesh",
           "shard_batch", "spatial_sharding"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the (data, spatial) layout: the axis sizes,
    its data group (the ranks with its spatial index) and its spatial group
    (the ranks with its data index)."""
    dp: int
    sp: int
    data: Group
    spatial: Group

    @property
    def data_index(self) -> int:
        return self.data.rank

    @property
    def spatial_index(self) -> int:
        return self.spatial.rank


_MESH: Optional[Mesh] = None


def create_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """The (dp, sp) layout over the processes of the default group, which
    becomes this process's mesh (``current_mesh``). Every rank must call it,
    with the same ``cfg``: it creates every data and spatial subgroup with
    ``dist.new_group`` in one order on every rank. Raises where ``dp * sp``
    is not the number of processes, or for a model axis above 1."""
    global _MESH
    cfg = cfg or MeshConfig()
    if cfg.model_parallel > 1:
        raise NotImplementedError(f"model_parallel {cfg.model_parallel}: tensor parallelism "
                                  f"is not ported (ROADMAP A14)")
    n = world()
    sp = max(1, cfg.spatial_parallel)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else n // sp
    if dp * sp != n:
        raise ValueError(f"mesh {dp}x1x{sp} != {n} processes")
    me = rank()
    mine = {}
    for kind, layout in (("data", [[e * sp + t for e in range(dp)] for t in range(sp)]),
                         ("spatial", [[e * sp + t for t in range(sp)] for e in range(dp)])):
        for members in layout:
            # a group of every process is the default one, a group of one
            # needs none; torch wants every rank to create every other
            pg = tdist.new_group(members) if 1 < len(members) < n else None
            if me in members:
                mine[kind] = Group(kind, pg, len(members), members.index(me))
    _MESH = Mesh(dp, sp, mine["data"], mine["spatial"])
    return _MESH


def current_mesh() -> Mesh:
    """This process's mesh: the one ``create_mesh`` made, else data
    parallelism over every process (``sp = 1``)."""
    if _MESH is not None and _MESH.dp * _MESH.sp == world():
        return _MESH
    return Mesh(world(), 1, world_group(), Group("spatial", None, 1, 0))


def reset_mesh() -> None:
    """Forget the mesh (``current_mesh`` is pure data parallelism again)."""
    global _MESH
    _MESH = None


def spatial_sharding(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's band of rows (dim 1) of NHWC images or NHW labels whose
    samples every rank of the spatial group holds: the batch replicated, H
    split (the batch-1 eval sharding). ``x`` itself at ``sp == 1``."""
    if mesh.sp == 1:
        return x
    lo, hi = band(x.shape[1], mesh.sp, mesh.spatial_index)
    return x[:, lo:hi].contiguous()


def shard_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's part of a global batch of NHWC images or NHW labels:
    its data index's samples, then its band of their rows."""
    b = x.shape[0] // mesh.dp
    d = mesh.data_index
    return spatial_sharding(mesh, x[d * b:(d + 1) * b])


class Bands:
    """The maps of one spatially split forward: ``group`` is the spatial
    group, ``sp`` and ``index`` its size and this rank's place in it."""

    def __init__(self, mesh: Mesh):
        self.mesh, self.group = mesh, mesh.spatial
        self.sp, self.index = mesh.sp, mesh.spatial_index
        self.maps: List[Tuple[int, int]] = []
        self.replicated = False

    def add(self, h: int, w: int) -> None:
        """Record a map of ``h`` x ``w`` that the forward made; raises where
        a rank would hold no row of it."""
        if h < self.sp:
            raise ValueError(f"a map of {h} rows cannot be split over {self.sp} ranks: "
                             f"--spatial-parallel must not exceed the smallest map's rows")
        if (h, w) not in self.maps:
            self.maps.append((h, w))

    def rows(self, h: int) -> Tuple[int, int]:
        """The rows ``[lo, hi)`` of a map of ``h`` rows that this rank owns."""
        return band(h, self.sp, self.index)

    def every(self, h: int) -> List[Tuple[int, int]]:
        """Every rank's rows of a map of ``h`` rows, in rank order."""
        return [band(h, self.sp, r) for r in range(self.sp)]

    def height(self, rows: int, w: int) -> int:
        """The global height of the map whose band on this rank has ``rows``
        rows and whose width is ``w``."""
        heights = [h for h, ww in self.maps if ww == w]
        for r in range(self.sp):
            lens = [band(h, self.sp, r)[1] - band(h, self.sp, r)[0] for h in heights]
            if len(set(lens)) != len(lens):
                raise RuntimeError(f"spatial bands: maps of {sorted(heights)} rows at width "
                                   f"{w} have bands of one length on rank {r}, so a band "
                                   f"cannot name its map")
        for h in heights:
            lo, hi = self.rows(h)
            if hi - lo == rows:
                return h
        raise RuntimeError(f"spatial bands: no map of width {w} has a band of {rows} rows "
                           f"on rank {self.index} (maps {self.maps})")

    def global_hw(self, t: torch.Tensor) -> Tuple[int, int]:
        """The global (H, W) of the NCHW band ``t``."""
        return self.height(t.shape[2], t.shape[3]), t.shape[3]

    @contextlib.contextmanager
    def replicated_maps(self) -> Iterator[None]:
        """A block whose maps every rank of the group holds whole (the ASPP
        image pool's 1x1 map): its BatchNorm reduces over the data group."""
        outer, self.replicated = self.replicated, True
        try:
            yield
        finally:
            self.replicated = outer


_BANDS: Optional[Bands] = None


def active_bands() -> Optional[Bands]:
    """The open spatial scope, or None (the forward sees whole maps)."""
    return _BANDS


@contextlib.contextmanager
def bands(h: int, w: int, mesh: Optional[Mesh] = None) -> Iterator[Optional[Bands]]:
    """Open the scope of a forward on this rank's band of an ``h`` x ``w``
    image; yields the scope, or None where the mesh has ``sp == 1``. An
    inner call while a scope is open adds its map to that scope."""
    global _BANDS
    mesh = mesh or current_mesh()
    if mesh.sp == 1:
        yield None
        return
    outer = _BANDS
    scope = outer if outer is not None else Bands(mesh)
    scope.add(int(h), int(w))
    _BANDS = scope
    try:
        yield scope
    finally:
        _BANDS = outer
