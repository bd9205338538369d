"""Row mix along H or W: the CUDA kernel's wrappers, its launch plan and its
plain PyTorch version.

The kernel (``csrc/row_mix.cu``) replaces
mrfp_tpu/ops/pallas_resize.py::row_mix_pallas. Both versions compute ``out =
P @ x`` along dim 2 (H) or dim 3 (W) of NCHW ``x`` for an fp32 (out, in)
``P``, summing in fp32 and rounding once to ``x.dtype``.

The kernel reads P as a ``RowTable``: per output row its non-zero weights
and their columns, in column order, stored term-major. ``take_rows`` builds
the table of its one-hot P (and of P transposed) on the host once
(``row_table_np``; ``ops/resize.py`` caches it on the device), so it
launches the mix alone; ``row_mix_cuda`` takes a caller's general P and
compacts it on the device first (``row_mix_compact_cuda``, a launch of its
own). ``row_mix_plan`` decides each launch's route, band and shared memory
on the host.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mrfp_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x: torch.Tensor, p_shape, dim: int) -> None:
    if dim not in (2, 3):
        raise ValueError(f"dim must be 2 (H) or 3 (W), got {dim}")
    if x.dim() != 4 or len(p_shape) != 2 or p_shape[1] != x.shape[dim]:
        raise ValueError(f"row_mix takes NCHW x and (out, x.shape[dim]) P, got "
                         f"{tuple(x.shape)}, {tuple(p_shape)}, dim {dim}")


def row_mix_plain(x: torch.Tensor, p: torch.Tensor, dim: int) -> torch.Tensor:
    """One fp32 ``torch.matmul`` (exact for a one-hot P when TF32 is off),
    rounded once to ``x.dtype``."""
    _check(x, p.shape, dim)
    xf = x.float()
    out = torch.matmul(p, xf) if dim == 2 else torch.matmul(xf, p.t())
    return out.to(x.dtype)


class RowTable(NamedTuple):
    """P as the kernel reads it: ``data`` int32 (1 + 2 * terms, out), row 0
    the count of non-zeros per output, rows 1..terms their columns, rows
    terms+1..2*terms their fp32 weights' bits; entry t of output o sits at
    column o (term-major). ``size_in`` is P's number of columns. For a
    table built on the host, ``first`` and ``last`` hold each output's
    first and last column (-1 where it has none), from which the H mix
    plans the input rows a band of outputs reads; None for a table
    compacted on the card. ``first`` and ``last`` must be ``data``'s own
    (``row_table`` makes them so): the H mix's stage is sized from them."""
    data: torch.Tensor
    terms: int
    size_in: int
    first: Optional[np.ndarray] = None
    last: Optional[np.ndarray] = None


def row_table_np(p: np.ndarray) -> np.ndarray:
    """The table of a dense (out, in) fp32 ``p`` on the host: each row's
    non-zeros (a NaN counts as one) in column order, ``terms`` = the most a
    row has."""
    p = np.asarray(p, np.float32)
    nz = p != 0
    cnt = nz.sum(axis=1)
    terms = int(cnt.max(initial=0))
    rows, cols = np.nonzero(nz)  # row-major: each row's columns in order
    rank = np.arange(rows.size) - np.concatenate(([0], np.cumsum(cnt)[:-1]))[rows]
    table = np.zeros((1 + 2 * terms, p.shape[0]), np.int32)
    table[0] = cnt
    table[1 + rank, rows] = cols
    table[1 + terms + rank, rows] = p[rows, cols].view(np.int32)
    return table


def row_table(p: np.ndarray, device) -> RowTable:
    """``row_table_np(p)`` on ``device``, with its rows' first and last
    columns on the host."""
    table = row_table_np(p)
    terms, cnt = (table.shape[0] - 1) // 2, table[0]
    first = last = np.full(cnt.size, -1)
    if terms:  # row 1 holds each output's first column, row cnt its last
        first = np.where(cnt > 0, table[1], -1)
        last = np.where(cnt > 0, table[np.maximum(cnt, 1), np.arange(cnt.size)], -1)
    return RowTable(torch.as_tensor(table, device=device), terms, int(np.shape(p)[1]),
                    first, last)


def row_band_span(first: np.ndarray, last: np.ndarray, band: int) -> int:
    """The most input rows [lo, hi] that a band of ``band`` consecutive
    output rows reads (rows without terms read none), as the staged H mix
    finds them per band."""
    if first.size == 0:
        return 0
    starts = np.arange(0, first.size, band)
    lo = np.minimum.reduceat(np.where(first >= 0, first, np.iinfo(np.int64).max), starts)
    hi = np.maximum.reduceat(last, starts)
    return int(np.where(hi >= 0, hi - lo + 1, 0).max())


# the kernel's launch plan: H-mix units (16-byte vectors, or values on the
# scalar route) a band aims at; the values a staged band aims at, along W
# (the larger of a band's input and output; in effect as many rows as the
# budget holds) and along H (its output); and the shared-memory budget in
# bytes. Chosen on an H100 at the OC shapes: larger W bands cut the
# per-band barriers, larger H bands read more rows twice.
ROW_MIX_H_UNITS = 2048
ROW_MIX_W_ELEMS = 16384
ROW_MIX_H_ELEMS = 8192
ROW_MIX_SMEM_CAP = 64 * 1024
_ROUTES = {"h vector": 0, "h scalar": 1, "w staged": 2, "w direct": 3, "h staged": 4}


class RowMixPlan(NamedTuple):
    """``route``: "h vector" (16-byte loads and stores of whole rows), "h
    staged" (rows that start mid-vector: a band's input rows staged in
    shared memory, 16-byte stores), "h scalar" (the same rows where the
    input rows a band reads are not known on the host or do not fit: one
    value an access, 16 bytes' worth a thread), "w staged" (a band of rows
    staged in shared memory) or "w direct" (rows whose stage does not fit:
    from device memory). ``vec``: values an access moves. ``band``: output
    rows (H) or rows (W) a block takes per step. ``stage_rows``: input rows
    the stage holds. ``table_words``: the table's int32 words staged in
    shared memory (0: it is read from device memory). ``smem``: the
    launch's dynamic shared memory in bytes."""
    route: str
    vec: int
    band: int
    stage_rows: int
    table_words: int
    smem: int


def row_mix_staged_smem_bytes(table_words: int, stage_elems: int, out_elems: int,
                              itemsize: int) -> int:
    """Shared memory of the staged mix (the kernel's ``staged_layout``): the
    staged table, then two stages of whole 16-byte granules that hold
    ``stage_elems`` values from any offset into a granule (one band's, and
    the next band's in flight), then the band's outputs with room for one
    vector more, 16-byte aligned."""
    vec = 16 // itemsize
    stage = (stage_elems + 2 * vec - 1) // vec * 16
    s_in = (4 * table_words + 15) // 16 * 16
    return s_in + 2 * stage + (out_elems + vec - 1) * itemsize


def _staged(table_words: int, want: int, fits) -> Optional[Tuple[int, int, int]]:
    """(band, table words staged, smem) of the tallest band up to ``want``
    that ``fits(band, table_words)`` (its smem, or None), with the table
    staged where that leaves room for one band row; None where none fits."""
    for staged in (table_words, 0):
        if fits(1, staged) is None:
            continue
        band = want
        while fits(band, staged) is None:
            band -= 1
        return band, staged, fits(band, staged)
    return None


def row_mix_plan(dim: int, size_in: int, size_out: int, width: int, terms: int,
                 itemsize: int, aligned: bool, rows: int = 1 << 62,
                 first: Optional[np.ndarray] = None,
                 last: Optional[np.ndarray] = None) -> RowMixPlan:
    """Plan one launch for P of (``size_out``, ``size_in``) with ``terms``
    table terms (``first``/``last`` as ``RowTable``'s). dim 2: ``width`` is
    the row width W; the vector route where a row is whole 16-byte vectors
    and ``aligned`` (both pointers 16-byte aligned), a band of about
    ``ROW_MIX_H_UNITS`` vectors; else the staged route where the host knows
    the rows a band reads, a band of about ``ROW_MIX_H_ELEMS`` outputs
    whose input rows and outputs fit the budget; else the scalar route.
    dim 3: ``rows`` is the number of rows (planes x H); a band of about
    ``ROW_MIX_W_ELEMS`` values, as many rows as fit the budget beside
    the table, or the direct route where not one row fits. The table is
    staged where it fits the budget (on a staged route, with one band row)."""
    vec = 16 // itemsize
    table_words = (1 + 2 * terms) * size_out
    cap = ROW_MIX_SMEM_CAP
    if dim == 2:
        if aligned and width % vec == 0:
            band = max(1, min(size_out, ROW_MIX_H_UNITS // (width // vec)))
            staged = table_words if 4 * table_words <= cap else 0
            return RowMixPlan("h vector", vec, band, 0, staged, 4 * staged)
        if first is not None and size_out > 0:
            def fits(band, staged):
                stage = max(1, row_band_span(first, last, band))
                smem = row_mix_staged_smem_bytes(staged, stage * width, band * width, itemsize)
                return (stage, smem) if smem <= cap else None
            want = max(1, min(size_out, ROW_MIX_H_ELEMS // max(width, 1)))
            found = _staged(table_words, want, fits)
            if found is not None:
                band, staged, (stage, smem) = found
                return RowMixPlan("h staged", vec, band, stage, staged, smem)
        band = max(1, min(size_out, ROW_MIX_H_UNITS // max(width, 1)))
        staged = table_words if 4 * table_words <= cap else 0
        return RowMixPlan("h scalar", 1, band, 0, staged, 4 * staged)
    if dim != 3:
        raise ValueError(f"dim must be 2 (H) or 3 (W), got {dim}")

    def fits(band, staged):
        smem = row_mix_staged_smem_bytes(staged, band * size_in, band * size_out, itemsize)
        return smem if smem <= cap else None
    want = max(1, min(rows, ROW_MIX_W_ELEMS // max(size_in, size_out, 1)))
    found = _staged(table_words, want, fits)
    if found is None:
        return RowMixPlan("w direct", 1, 0, 0, 0, 0)
    band, staged, smem = found
    return RowMixPlan("w staged", vec, band, band, staged, smem)


@functools.lru_cache(maxsize=4096)
def _plan_cached(dim, size_in, size_out, width, terms, itemsize, aligned, rows, spans):
    first, last = (None, None) if spans is None else (np.frombuffer(b, np.int64)
                                                      for b in spans)
    plan = row_mix_plan(dim, size_in, size_out, width, terms, itemsize, aligned, rows,
                        first, last)
    # the staged H mix stages the input rows each band reads and does not
    # check the span itself (a release build has no device assert)
    if plan.route == "h staged" and row_band_span(first, last, plan.band) > plan.stage_rows:
        raise ValueError(f"row_mix: a band of {plan.band} output rows reads "
                         f"{row_band_span(first, last, plan.band)} input rows, the stage "
                         f"holds {plan.stage_rows}")
    return plan


def _table_plan(table: RowTable, dim: int, width: int, itemsize: int, aligned: bool,
                rows: int) -> RowMixPlan:
    """``row_mix_plan`` for ``table``, computed once per shape (a host-built
    table's band spans take a few numpy passes)."""
    spans = None if table.first is None else (
        np.asarray(table.first, np.int64).tobytes(), np.asarray(table.last, np.int64).tobytes())
    return _plan_cached(dim, table.size_in, table.data.shape[1], width, table.terms, itemsize,
                        aligned, rows if dim == 3 else 0, spans)


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{what} needs CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} takes float32/bfloat16 x, got {x.dtype}")


def row_mix_compact_cuda(p: torch.Tensor) -> RowTable:
    """P's table on the card (terms = P's columns), from the compaction
    kernel; raises if it cannot launch."""
    lib = _build.load_library()
    if not p.is_cuda:
        raise ValueError(f"row_mix_compact_cuda needs a CUDA tensor, got {p.device}")
    if p.dtype != torch.float32 or p.dim() != 2:
        raise TypeError(f"row_mix_compact_cuda takes a 2-D float32 P, got {p.dtype} "
                        f"{tuple(p.shape)}")
    p = p.contiguous()
    on, size_in = p.shape
    table = torch.empty((1 + 2 * size_in, on), dtype=torch.int32, device=p.device)
    with torch.cuda.device(p.device):
        err = lib.mrfp_row_mix_compact(p.data_ptr(), table.data_ptr(), on, size_in,
                                       torch.cuda.current_stream(p.device).cuda_stream)
    _build.check(err, "row_mix_compact")
    _build.LAUNCHES["row_mix_compact"] += 1
    return RowTable(table, size_in, size_in)


def row_mix_table_cuda(x: torch.Tensor, table: RowTable, dim: int) -> torch.Tensor:
    """Launch the mix on a CUDA tensor with P given as its table; raises if
    it cannot."""
    lib = _build.load_library()
    _check_cuda(x, "row_mix_table_cuda")
    on = table.data.shape[1]
    _check(x, (on, table.size_in), dim)
    if table.data.dtype != torch.int32 or table.data.shape[0] != 1 + 2 * table.terms \
            or table.data.device != x.device:
        raise ValueError(f"row_mix_table_cuda: a table of {tuple(table.data.shape)} "
                         f"{table.data.dtype} on {table.data.device} for {table.terms} terms "
                         f"and x on {x.device}")
    x = x.contiguous()
    n, c, h, w = x.shape
    out = torch.empty((n, c, on, w) if dim == 2 else (n, c, h, on), dtype=x.dtype,
                      device=x.device)
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    plan = _table_plan(table, dim, w, x.element_size(), aligned, n * c * h)
    with torch.cuda.device(x.device):
        err = lib.mrfp_row_mix(
            x.data_ptr(), table.data.data_ptr(), out.data_ptr(), n * c, h, w, on, table.terms,
            dim, _ROUTES[plan.route], plan.band, plan.stage_rows, plan.table_words, plan.smem,
            _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "row_mix")
    _build.LAUNCHES["row_mix"] += 1
    return out


def row_mix_cuda(x: torch.Tensor, p: torch.Tensor, dim: int) -> torch.Tensor:
    """The mix for a general fp32 P on CUDA tensors: P compacted on the
    card, then mixed; raises if either kernel cannot launch."""
    _build.load_library()
    _check_cuda(x, "row_mix_cuda")
    if not p.is_cuda:
        raise ValueError(f"row_mix_cuda needs CUDA tensors, got {x.device}, {p.device}")
    if p.dtype != torch.float32:
        raise TypeError(f"row_mix_cuda takes float32/bfloat16 x and float32 P, got "
                        f"{x.dtype}, {p.dtype}")
    _check(x, p.shape, dim)
    return row_mix_table_cuda(x, row_mix_compact_cuda(p), dim)
