"""The process mesh, the bands of a spatially split forward and the channel
slices of a tensor-parallel one (mrfp_tpu/core/mesh.py:23-186).

The JAX package builds a (data, model, spatial) device mesh and lets GSPMD
shard image H over the 'spatial' axis and channels over the 'model' axis,
inserting the conv halo exchanges and the channel collectives. The port
runs one process per card and lays the processes out as the JAX mesh lays
out devices (``reshape(dp, mp, sp)``): rank ``r = (d * mp + m) * sp + s``.
Four groups follow from it:

- the spatial group, the ranks that share ``(d, m)``: they take the same
  samples, and rank ``s`` of the group owns the rows ``band(H, sp, s)`` of
  every map of height ``H``, the even split of that map's own height;
- the model group, the ranks that share ``(d, s)``: they take the same
  samples and rows, and rank ``m`` of the group holds slice ``m`` of the
  channels of every map whose producer's weight is sharded (``tp_spec``);
- the data group, the ranks that share ``(m, s)``;
- the replica group, the ranks that share ``m``: data x spatial, the
  ranks whose samples and rows partition the global batch, over which the
  batch's statistics, the loss denominators and the gradient reduce.

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

Inside ``channels()`` (entered by the model's forward when the mesh has
``mp > 1``) each conv of a sharded model computes its slice of output
channels from the whole input map, which ``Channels`` gathers over the
model group once per map, however many convs read it. A conv whose kernel
M does not divide (``tp_spec`` keeps it whole, as JAX's rule does) computes
its whole map on every rank, and its consumers read that map whole.

With one process, or ``sp == mp == 1``, every helper is the identity and
no scope is entered: today's paths compute what they computed before this
module.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

from mrfp_tpu_torch.core.config import MeshConfig
from mrfp_tpu_torch.parallel.dist import (Group, band, copy_to_group, gather_channels, rank,
                                          slice_channels, world, world_group)

__all__ = ["Mesh", "Bands", "Channels", "active_bands", "active_channels", "band", "bands",
           "channels", "create_mesh", "current_mesh", "shard_batch", "spatial_sharding",
           "state_placement", "tp_spec"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the (data, model, spatial) layout: the axis
    sizes and its four groups (the data group: the ranks with its model
    and spatial indices; the spatial group: those with its data and model
    indices; the model group: those with its data and spatial indices;
    the replica group: those with its model index). A mesh without a model
    axis may leave ``model`` and ``replica`` out: a group of one and the
    world."""
    dp: int
    sp: int
    data: Group
    spatial: Group
    mp: int = 1
    model: Optional[Group] = None
    replica: Optional[Group] = None

    def __post_init__(self):
        if self.model is None:
            object.__setattr__(self, "model", Group("model", None, 1, 0))
        if self.replica is None:
            object.__setattr__(self, "replica", world_group())

    @property
    def data_index(self) -> int:
        return self.data.rank

    @property
    def spatial_index(self) -> int:
        return self.spatial.rank

    @property
    def model_index(self) -> int:
        return self.model.rank


_MESH: Optional[Mesh] = None


def create_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """The (dp, mp, sp) layout over the processes of the default group,
    which becomes this process's mesh (``current_mesh``). Every rank must
    call it, with the same ``cfg``: it creates every data, spatial, model
    and replica subgroup with ``dist.new_group`` in one order on every
    rank. Raises, as the JAX package's does, where ``dp * mp * sp`` is not
    the number of processes."""
    global _MESH
    cfg = cfg or MeshConfig()
    n = world()
    mp = max(1, cfg.model_parallel)
    sp = max(1, cfg.spatial_parallel)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else n // (mp * sp)
    if dp * mp * sp != n:
        raise ValueError(f"mesh {dp}x{mp}x{sp} != {n} processes")

    def at(d: int, m: int, s: int) -> int:
        return (d * mp + m) * sp + s

    layouts = (
        ("data", [[at(e, m, t) for e in range(dp)] for m in range(mp) for t in range(sp)]),
        ("spatial", [[at(e, m, t) for t in range(sp)] for e in range(dp) for m in range(mp)]),
        ("model", [[at(e, k, t) for k in range(mp)] for e in range(dp) for t in range(sp)]),
        # data x spatial: with mp == 1 the world, under its old name
        ("replica" if mp > 1 else "world",
         [[at(e, m, t) for e in range(dp) for t in range(sp)] for m in range(mp)]),
    )
    me = rank()
    mine = {}
    for kind, layout in layouts:
        for members in layout:
            # a group of every process is the default one, a group of one
            # needs none; torch wants every rank to create every other
            pg = tdist.new_group(members) if 1 < len(members) < n else None
            if me in members:
                mine[kind] = Group(kind, pg, len(members), members.index(me))
    _MESH = Mesh(dp, sp, mine["data"], mine["spatial"], mp, mine["model"],
                 mine["replica" if mp > 1 else "world"])
    return _MESH


def current_mesh() -> Mesh:
    """This process's mesh: the one ``create_mesh`` made, else data
    parallelism over every process (``mp = sp = 1``)."""
    if _MESH is not None and _MESH.dp * _MESH.mp * _MESH.sp == world():
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


def tp_spec(t: torch.Tensor, mp: int) -> Optional[int]:
    """The dim of a state tensor that tensor parallelism shards over ``mp``
    ranks, or None (replicated): JAX's ``_tp_spec`` (mrfp_tpu/core/mesh.py:
    122-141) by shape and dtype alone, in the port's layout. A float tensor
    of 2 or more dims shards its output features, dim 0 of an OIHW conv
    kernel (HWIO's last dim), where they divide by ``mp``; a 1-D float
    tensor (a BN scale, bias or running statistic, a conv bias) shards its
    only dim where it divides; anything else is replicated: integer
    counters (``num_batches_tracked``) and the 19-channel classifier."""
    if mp <= 1 or not t.is_floating_point() or t.dim() == 0:
        return None
    return 0 if t.shape[0] % mp == 0 and t.shape[0] >= mp else None


def state_placement(sd: Mapping[str, torch.Tensor], mp: int,
                    replicated: Sequence[str] = ()) -> Dict[str, Optional[int]]:
    """``tp_spec`` of every entry of a whole state_dict (parameters, BN
    buffers, or the momentum of each parameter, which mirrors it), JAX's
    ``state_shardings`` (:144-168): the entries under a module named in
    ``replicated`` stay whole, as JAX keeps ``oc_params`` whole."""
    out = {}
    for k, t in sd.items():
        whole = any(k == r or k.startswith(r + ".") for r in replicated)
        out[k] = None if whole else tp_spec(t, mp)
    return out


class Channels:
    """The channel slices of one forward under tensor parallelism: the
    model group, its size ``mp`` and this rank's ``index`` in it.

    A map that a sharded conv made holds this rank's slice of its channels.
    ``whole`` gathers it over the group, once per map (for a consumer that
    every rank computes alike: the OC branch, the classifier, a map's
    maximum); ``shared`` hands the whole map to a consumer of which each
    rank computes its own output channels (a sharded conv), whose backward
    sums the ranks' cotangents, once per map however many convs read it.
    ``cat`` concatenates slices and remembers the blocks, so the whole map
    is the concatenation of the whole blocks (the global channel order of
    the ASPP and decoder concatenations); ``own`` slices a map every rank
    holds whole down to this rank's channels, and remembers that map as
    the slice's whole, so that gathering the slice again costs nothing.
    ``whole_of`` reads a map of a known whole width: the map itself where
    it holds every channel, else its gather (a slice has 1/M of them, so
    the two cannot be confused); ``vector`` is the whole of a 1-D
    parameter shard."""

    def __init__(self, mesh: Mesh):
        self.mesh, self.group = mesh, mesh.model
        self.mp, self.index = mesh.mp, mesh.model_index
        # id(map) -> (map, result): the map is held, so its id stays its own
        self._whole: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._shared: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._parts: Dict[int, Tuple[torch.Tensor, Tuple[int, ...]]] = {}

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """The whole map of this rank's slice ``x`` (its blocks in the
        global order where ``cat`` made it)."""
        got = self._whole.get(id(x))
        if got is None:
            parts = self._parts.get(id(x), (None, None))[1]
            got = self._whole[id(x)] = (x, gather_channels(x, self.group, parts))
        return got[1]

    def shared(self, x: torch.Tensor, sliced: bool = True) -> torch.Tensor:
        """The whole map of ``x`` (this rank's slice, or with ``sliced``
        False a map it holds whole) as the input of a computation of which
        each rank computes its own part."""
        got = self._shared.get(id(x))
        if got is None:
            got = self._shared[id(x)] = (x, copy_to_group(self.whole(x) if sliced else x,
                                                          self.group))
        return got[1]

    def cat(self, slices: Sequence[torch.Tensor]) -> torch.Tensor:
        """``torch.cat(slices, dim=1)``, remembered as that many blocks."""
        out = torch.cat(list(slices), dim=1)
        self._parts[id(out)] = (out, tuple(t.shape[1] for t in slices))
        return out

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's channels of ``x``, which every rank holds whole
        (differentiable: the backward gathers the ranks' cotangents).
        ``whole`` of the result is ``x`` itself: the gather of identical
        slices of one map, whose backward (a consumer every rank computes
        alike) reaches ``x`` as it would through the slice's."""
        out = slice_channels(x, self.group)
        self._whole[id(out)] = (out, x)
        return out

    def whole_of(self, x: torch.Tensor, c: int) -> torch.Tensor:
        """The whole map of ``c`` channels of which ``x`` is this rank's
        slice, or ``x`` itself where it already holds all ``c``."""
        return x if x.shape[1] == c else self.whole(x)

    def vector(self, v: torch.Tensor) -> torch.Tensor:
        """The whole of a 1-D parameter of which ``v`` is this rank's
        shard, for a computation every rank runs alike (the backward keeps
        this rank's part of the gradient)."""
        return gather_channels(v[None], self.group)[0]

    def span(self, c: int) -> Tuple[int, int, int]:
        """This rank's channels ``[lo, hi)`` of a map of ``c`` channels a
        rank, and the whole map's channel count."""
        return self.index * c, (self.index + 1) * c, self.mp * c


_CHANNELS: Optional[Channels] = None


def active_channels() -> Optional[Channels]:
    """The open channel scope, or None (the forward's maps are whole)."""
    return _CHANNELS


@contextlib.contextmanager
def channels(mesh: Optional[Mesh] = None) -> Iterator[Optional[Channels]]:
    """Open the channel scope of one forward; yields it, or None where the
    mesh has ``mp == 1``. An inner call while a scope is open keeps it."""
    global _CHANNELS
    mesh = mesh or current_mesh()
    if mesh.mp == 1 or _CHANNELS is not None:
        yield _CHANNELS
        return
    _CHANNELS = Channels(mesh)
    try:
        yield _CHANNELS
    finally:
        _CHANNELS = None
