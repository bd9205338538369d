"""Host-side plans of the redesigned kernels, on the CPU (no card here).

- ``cuda_dot_stats.tensor_core_route``: which dtype and shape the
  tensor-core ``dot_with_stats`` kernel takes (bf16 rows 16-byte aligned);
  every site of the train step must go there.
- The staged nearest backward (``csrc/resize_nearest.cu``): it stages, for
  a block of R consecutive flattened input rows, one contiguous run of
  cotangent rows, sized from ``NearestTable.max_run``. The tables' ranges
  are held against a brute-force inverse of the JAX package's forward index
  tables, at the seven OC-branch shapes and the edge cases of
  ``chip_smoke.py``; so is each block's run and its bound.
- ``nearest_bwd_rows_per_block``: the block size fits the shared-memory
  budget, or is 0 (the direct kernel) where a range is longer than two or
  not even one row fits.
- ``cuda_np_plus.np_plus_vector_width``: the NP+ apply's vector route
  (16-byte accesses) where a plane is whole vectors and both pointers are
  16-byte aligned, else the scalar route.
- ``cuda_resize.bilinear_fwd_plan``: the banded bilinear forward's route,
  bands, column tiles and shared memory, held against a brute force over
  ``bilinear_ac_weights`` at every train, eval and edge shape of
  ``chip_smoke.py``: every output's taps lie in its block's staged rows and
  columns, the blocks tile the output once, the budget holds.
- ``cuda_resize.bilinear_bwd_plan``: the backward's route (plane sum for a
  1x1 input, staged, or direct where one column's stage does not fit),
  and on the staged route the tiles, bands and stage, held against a
  brute force over ``bilinear_ac_weights`` at the same shapes and at
  hypothesis-drawn ones: every cotangent column a tile's inputs read lies
  in its staged segment, the budget holds.
- ``cuda_resize.nearest_fwd_plan``: the staged nearest forward's bands of
  output rows and their staged input rows, at the OC shapes (odd widths,
  downsamples), the edge cases and hypothesis-drawn scales.
- The wrappers' argument checks raise before any launch.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mrfp_tpu.ops.resize import _nearest_idx_from_scale, _nearest_idx_from_size
from mrfp_tpu_torch.ops import _build, cuda_dot_stats, cuda_np_plus, cuda_resize
from mrfp_tpu_torch.ops.resize import bilinear_ac_weights, bilinear_taps, nearest_table

torch.set_num_threads(2)

# (Cin, Cout, side) of the 15 bottleneck 1x1 shapes of a batch-8 768x768
# step (chip_smoke.py's DOT_STATS_SHAPES; the output's H = W)
STEP_SHAPES = [(64, 64, 192), (64, 256, 192), (256, 64, 192), (256, 128, 192),
               (128, 512, 96), (256, 512, 96), (512, 128, 96), (512, 256, 96),
               (256, 1024, 48), (512, 1024, 48), (1024, 256, 48), (1024, 512, 48),
               (512, 2048, 48), (1024, 2048, 48), (2048, 512, 48)]


@pytest.mark.parametrize("cin,cout,side", STEP_SHAPES)
def test_every_step_site_takes_the_tensor_cores(cin, cout, side):
    assert cuda_dot_stats.tensor_core_route(torch.bfloat16, cin, side * side)


@pytest.mark.parametrize("dtype,cin,hw,expected", [
    (torch.bfloat16, 24, 2000, True),      # Cin = 8 x odd, HW not a multiple of 128
    (torch.bfloat16, 72, 1000, True),
    (torch.bfloat16, 8, 8, True),
    (torch.bfloat16, 30, 256, False),      # Cin rows not 16-byte aligned
    (torch.bfloat16, 64, 63, False),       # HW rows not 16-byte aligned
    (torch.bfloat16, 0, 64, False),        # no input channels: the CUDA-core kernel zeroes y
    (torch.float32, 64, 36864, False),     # fp32 stays exact on the CUDA cores
    (torch.float16, 64, 36864, False),
])
def test_tensor_core_route(dtype, cin, hw, expected):
    assert cuda_dot_stats.tensor_core_route(dtype, cin, hw) is expected


def test_launch_counts_include_the_tensor_core_route():
    """The tensor-core launches have a count of their own, which
    ``reset_launches`` clears with the others."""
    saved = dict(_build.LAUNCHES)
    try:
        _build.LAUNCHES["dot_with_stats_tc"] = 5
        _build.reset_launches()
        assert _build.LAUNCHES["dot_with_stats_tc"] == 0
    finally:
        _build.LAUNCHES.update(saved)


# (in_size, rule, arg) per axis: the seven OC-branch resizes of a 768x768
# step, then the edge cases chip_smoke.py runs (empty ranges, widths 1, 7,
# 9, h = 1, a partial block, ranges longer than two)
AXES = [
    (192, "scale", 1.205), (231, "scale", 1.2), (277, "scale", 1.2), (332, "size", 384),
    (384, "scale", 0.838), (321, "scale", 0.798), (256, "size", 192),
    (7, "size", 3), (33, "scale", 0.798), (29, "scale", 0.798), (5, "scale", 1.5),
    (1, "scale", 1.5), (6, "scale", 1.3), (7, "scale", 1.3), (9, "size", 11),
    (9, "size", 13), (1, "size", 2), (20, "size", 30), (37, "scale", 1.2),
    (45, "scale", 1.2), (5, "scale", 3.0), (4, "size", 30000),
]


def _jax_idx(size, rule, arg):
    if rule == "scale":
        return np.asarray(_nearest_idx_from_scale(size, arg))
    return np.asarray(_nearest_idx_from_size(size, arg))


def _brute_inverse(idx, size):
    """For each input, the sorted outputs whose source it is."""
    return [np.flatnonzero(idx == i) for i in range(size)]


@pytest.mark.parametrize("size,rule,arg", AXES)
def test_nearest_table_ranges_and_max_run(size, rule, arg):
    t = nearest_table(size, rule, arg, "cpu")
    idx = _jax_idx(size, rule, arg)
    np.testing.assert_array_equal(t.idx.numpy(), idx)
    outs = _brute_inverse(idx, size)
    lo, hi = t.lo.numpy(), t.hi.numpy()
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(np.arange(lo[i], hi[i]), o)
    assert t.max_run == max(len(o) for o in outs)
    # the ranges tile [0, out): what lets a block stage one contiguous run
    assert lo[0] == 0 and hi[-1] == idx.size and np.array_equal(hi[:-1], lo[1:])


# (planes, in_hw, rule, (arg_h, arg_w)): the OC shapes at 2 planes (the
# kernel does not see the batch) and chip_smoke.py's edge cases
STAGED = [
    (2, (192, 192), "scale", (1.205, 1.205)), (2, (231, 231), "scale", (1.2, 1.2)),
    (2, (277, 277), "scale", (1.2, 1.2)), (2, (332, 332), "size", (384, 384)),
    (2, (384, 384), "scale", (0.838, 0.838)), (2, (321, 321), "scale", (0.798, 0.798)),
    (2, (256, 256), "size", (192, 192)), (6, (7, 7), "size", (3, 3)),
    (6, (33, 29), "scale", (0.798, 0.798)), (6, (5, 1), "scale", (1.5, 1.5)),
    (6, (6, 7), "scale", (1.3, 1.3)), (6, (9, 9), "size", (11, 13)),
    (6, (1, 20), "size", (2, 30)), (21, (37, 45), "scale", (1.2, 1.2)),
    (6, (5, 6), "scale", (3.0, 3.0)), (2, (3, 4), "size", (3, 30000)),
]


@pytest.mark.parametrize("planes,in_hw,rule,arg", STAGED)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_staged_backward_block_runs(planes, in_hw, rule, arg, itemsize):
    """Each block of R flattened input rows reads one contiguous run of
    flattened cotangent rows, [p0*oh + lo[h0], pl*oh + hi[hl]) as the kernel
    computes it, of at most R * max_run rows, and the staged buffer that
    bound sizes fits the budget."""
    h, w = in_hw
    ty, tx = nearest_table(h, rule, arg[0], "cpu"), nearest_table(w, rule, arg[1], "cpu")
    oh, ow = ty.idx.numel(), tx.idx.numel()
    rows = cuda_resize.nearest_bwd_rows_per_block(w, ow, ty.max_run, tx.max_run, itemsize)
    if rows == 0:
        return  # the direct kernel: test_rows_per_block_budget covers it
    assert ty.max_run <= 2 and tx.max_run <= 2
    assert cuda_resize.nearest_bwd_smem_bytes(w, rows, ty.max_run, ow, itemsize) \
        <= cuda_resize.NEAREST_BWD_SMEM_CAP
    idx = _jax_idx(h, rule, arg[0])
    outs = _brute_inverse(idx, h)
    lo, hi = ty.lo.numpy(), ty.hi.numpy()
    total = planes * h
    covered = []
    for r0 in range(0, total, rows):
        r1 = min(r0 + rows, total)
        fed = np.concatenate([p * oh + outs[hh] for p, hh in
                              (divmod(r, h) for r in range(r0, r1))] + [np.zeros(0, int)])
        p0, h0 = divmod(r0, h)
        pl, hl = divmod(r1 - 1, h)
        start, end = p0 * oh + lo[h0], pl * oh + hi[hl]
        np.testing.assert_array_equal(fed, np.arange(start, end))
        assert end - start <= rows * ty.max_run
        covered.append(fed)
    np.testing.assert_array_equal(np.concatenate(covered), np.arange(planes * oh))


@pytest.mark.parametrize("w,ow,max_run,max_run_x,itemsize,expected", [
    (332, 384, 2, 2, 2, 12), (332, 384, 2, 2, 4, 12),  # enc4: about 4096 elements a block
    (192, 231, 2, 2, 2, 21), (1, 2, 2, 2, 2, 4096),
    (4, 30000, 1, 1, 4, 0),                            # one row needs 120 KB: the direct kernel
    (4, 30000, 1, 1, 2, 1),
    (5, 15, 3, 3, 2, 0),                               # ranges of three: the direct kernel
    (100, 120, 1, 3, 4, 0), (100, 100, 3, 1, 2, 0),
])
def test_rows_per_block_budget(w, ow, max_run, max_run_x, itemsize, expected):
    rows = cuda_resize.nearest_bwd_rows_per_block(w, ow, max_run, max_run_x, itemsize)
    assert rows == expected
    cap = cuda_resize.NEAREST_BWD_SMEM_CAP
    if rows:
        assert cuda_resize.nearest_bwd_smem_bytes(w, rows, max_run, ow, itemsize) <= cap
        assert rows == max(1, cuda_resize.NEAREST_BWD_ELEMS // w) or \
            cuda_resize.nearest_bwd_smem_bytes(w, rows + 1, max_run, ow, itemsize) > cap
    elif max(max_run, max_run_x) <= 2:
        assert cuda_resize.nearest_bwd_smem_bytes(w, 1, max_run, ow, itemsize) > cap


class _NoLaunch:
    """A kernel library whose entry points must not be reached."""

    def __getattr__(self, name):
        raise AssertionError(f"{name} reached with arguments the wrapper must refuse")


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("call,error", [
    (lambda: cuda_dot_stats.dot_with_stats_cuda(torch.zeros(1, 8, 4, 4),
                                                 torch.zeros(4, 8)), ValueError),
    (lambda: cuda_dot_stats.dot_with_stats_cuda(torch.zeros(1, 8, 4, 4, dtype=torch.bfloat16),
                                                 torch.zeros(4, 8)), ValueError),
    (lambda: cuda_resize.resize_nearest_bwd_cuda(
        torch.zeros(1, 2, 7, 8), nearest_table(5, "size", 7, "cpu"),
        nearest_table(6, "size", 8, "cpu"), 5, 6), ValueError),
    (lambda: cuda_resize.resize_nearest_cuda(
        torch.zeros(1, 2, 5, 6), nearest_table(5, "size", 7, "cpu"),
        nearest_table(6, "size", 8, "cpu")), ValueError),
    (lambda: cuda_resize.resize_bilinear_cuda(
        torch.zeros(1, 2, 5, 6), bilinear_taps(5, 7, "cpu"), bilinear_taps(6, 8, "cpu")),
     ValueError),
    (lambda: cuda_np_plus.np_plus_apply_cuda(torch.zeros(1, 2, 5, 6), torch.zeros(1, 2, 1, 1),
                                             torch.zeros(1, 2, 1, 1)), ValueError),
])
def test_wrappers_refuse_cpu_tensors(monkeypatch, call, error):
    monkeypatch.setattr(_build, "load_library", lambda: _NoLaunch())
    with pytest.raises(error, match="CUDA"):
        call()


def test_dot_wrapper_refuses_dtypes_and_shapes(monkeypatch):
    """On tensors that are not on the CPU (the meta device stands in for a
    card), dtype and shape faults raise before the library is reached."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(_build, "load_library", lambda: _NoLaunch())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_dot_stats.dot_with_stats_cuda(_meta(1, 8, 4, 4, dtype=torch.float16),
                                           _meta(4, 8, dtype=torch.float16))
    with pytest.raises(TypeError, match="one dtype"):
        cuda_dot_stats.dot_with_stats_cuda(_meta(1, 8, 4, 4), _meta(4, 8, dtype=torch.float32))
    with pytest.raises(ValueError, match="NCHW x and"):
        cuda_dot_stats.dot_with_stats_cuda(_meta(1, 8, 4, 4), _meta(4, 9))
    with pytest.raises(ValueError, match="NCHW x and"):
        cuda_dot_stats.dot_with_stats_cuda(_meta(8, 4, 4), _meta(4, 8))


def test_nearest_wrapper_refuses_mismatched_cotangents(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(_build, "load_library", lambda: _NoLaunch())
    ty, tx = nearest_table(5, "size", 7, "meta"), nearest_table(6, "size", 8, "meta")
    with pytest.raises(ValueError, match="does not match the tables"):
        cuda_resize.resize_nearest_bwd_cuda(_meta(1, 2, 7, 9), ty, tx, 5, 6)
    with pytest.raises(ValueError, match="NCHW-contiguous"):
        cuda_resize.resize_nearest_bwd_cuda(_meta(2, 7, 8), ty, tx, 5, 6)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_resize.resize_nearest_bwd_cuda(_meta(1, 2, 7, 8, dtype=torch.float16), ty, tx, 5, 6)


@pytest.mark.parametrize("itemsize,hw,ptrs,expected", [
    (2, 192 * 192, (0, 4096), 8),          # the NP+ sites in bf16
    (4, 192 * 192, (256, 512), 4),         # and in fp32
    (2, 191 * 191, (0, 4096), 1),          # a ragged plane: the scalar route
    (4, 191 * 191, (0, 4096), 1),
    (2, 190 * 190, (0, 4096), 1),          # 36100 values: whole fp32 vectors, not bf16
    (4, 190 * 190, (0, 4096), 4),
    (2, 64, (8, 4096), 1),                 # x 8 bytes into a granule
    (4, 64, (0, 4100), 1),                 # out 4 bytes into a granule
    (2, 1, (0, 0), 1),
])
def test_np_plus_vector_width(itemsize, hw, ptrs, expected):
    assert cuda_np_plus.np_plus_vector_width(itemsize, hw, *ptrs) == expected


# (in_hw, out_hw) of every bilinear forward chip_smoke.py runs: the five
# train resizes, the odd-crop scalar shape, the six eval resizes, the edge
# cases (the last two need column tiles); then more shapes that need column
# tiles or shrink the band, and the BDD100k logits
BILINEAR_SHAPES = [
    ((1, 1), (48, 48)), ((48, 48), (192, 192)), ((192, 192), (384, 384)),
    ((384, 384), (768, 768)), ((192, 192), (768, 768)), ((193, 193), (769, 769)),
    ((1, 1), (64, 128)), ((64, 128), (256, 512)), ((256, 512), (1024, 2048)),
    ((1, 1), (96, 96)), ((96, 96), (384, 384)), ((384, 384), (1536, 1536)),
    ((1, 1), (6, 10)), ((7, 9), (7, 15)), ((7, 9), (1, 5)), ((7, 9), (11, 1)),
    ((13, 1), (27, 3)),
    ((3, 4), (5, 30000)), ((3, 100000), (2, 8)),
    ((3, 4), (3, 30000)), ((2, 30000), (3, 30008)), ((3, 100000), (3, 8)),
    ((1000, 4), (2, 3)), ((45, 80), (720, 1280)),
]


@pytest.mark.parametrize("in_hw,out_hw", BILINEAR_SHAPES)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_bilinear_band_plan_stages_every_tap(in_hw, out_hw, itemsize):
    """Each block (a band of output rows by a tile of output columns) stages
    rows [iy0[first], iy0[first] + stage_rows) and columns [ix0[first],
    ix0[first] + in_cols), as the kernel does: every output's two taps lie
    inside, the blocks tile the output exactly once, and the shared memory
    the launch asks for is the layout's and within the budget."""
    (h, w), (oh, ow) = in_hw, out_hw
    plan = cuda_resize.bilinear_fwd_plan(h, w, oh, ow, itemsize, True)
    iy0, iy1, _ = bilinear_ac_weights(h, oh)
    ix0, ix1, _ = bilinear_ac_weights(w, ow)
    rows_seen = np.zeros(oh, int)
    for oy0 in range(0, oh, plan.band):
        band = np.arange(oy0, min(oy0 + plan.band, oh))
        rows_seen[band] += 1
        base = iy0[oy0]
        assert base <= iy0[band].min() and iy1[band].max() < base + plan.stage_rows
    cols_seen = np.zeros(ow, int)
    for ox0 in range(0, ow, plan.cols):
        tile = np.arange(ox0, min(ox0 + plan.cols, ow))
        cols_seen[tile] += 1
        seg0 = ix0[ox0]
        assert seg0 <= ix0[tile].min() and ix1[tile].max() < seg0 + plan.in_cols
    assert (rows_seen == 1).all() and (cols_seen == 1).all()
    # a raw row keeps its segment from any byte of its first granule on
    assert 16 * plan.raw_pitch >= plan.in_cols * itemsize + 16 - itemsize
    assert plan.smem == cuda_resize.bilinear_fwd_smem_bytes(plan.stage_rows, plan.cols,
                                                            plan.raw_pitch)
    assert plan.smem <= cuda_resize.BILINEAR_FWD_SMEM_CAP
    assert plan.cols % plan.vec == 0 and plan.stage_rows <= h and plan.in_cols <= w
    tx, ty = plan.threads
    assert tx * ty <= cuda_resize.BILINEAR_FWD_THREADS and tx * plan.vec <= plan.cols


@pytest.mark.parametrize("in_hw,out_hw", BILINEAR_SHAPES[:12])
def test_bilinear_band_plan_is_as_tall_as_the_budget_allows(in_hw, out_hw):
    """At the model's shapes a band is about BILINEAR_FWD_ELEMS outputs, or
    as many rows as fit, and takes whole rows (no column tiles)."""
    (h, w), (oh, ow) = in_hw, out_hw
    for itemsize in (2, 4):
        plan = cuda_resize.bilinear_fwd_plan(h, w, oh, ow, itemsize, True)
        assert plan.cols == ow
        want = max(1, min(oh, cuda_resize.BILINEAR_FWD_ELEMS // ow))
        if plan.band < want:  # one row more would not fit
            iy0, iy1, _ = bilinear_ac_weights(h, oh)
            rows = cuda_resize.bilinear_band_span(iy0, iy1, plan.band + 1)
            assert cuda_resize.bilinear_fwd_smem_bytes(rows, ow, plan.raw_pitch) \
                > cuda_resize.BILINEAR_FWD_SMEM_CAP


@pytest.mark.parametrize("itemsize,ow,aligned,vec", [
    (2, 384, True, 8), (4, 384, True, 4), (2, 769, True, 1), (4, 769, True, 1),
    (2, 100, True, 1), (4, 100, True, 4), (2, 384, False, 1), (4, 384, False, 1),
    (2, 10, True, 1), (4, 1, True, 1),
])
def test_bilinear_vector_route(itemsize, ow, aligned, vec):
    assert cuda_resize.bilinear_fwd_plan(16, 16, 48, ow, itemsize, aligned).vec == vec


def test_bilinear_wrapper_refuses_dtypes_and_shapes(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(_build, "load_library", lambda: _NoLaunch())
    ty, tx = bilinear_taps(5, 7, "meta"), bilinear_taps(6, 8, "meta")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_resize.resize_bilinear_cuda(_meta(1, 2, 5, 6, dtype=torch.float16), ty, tx)
    with pytest.raises(ValueError, match="does not match the tables"):
        cuda_resize.resize_bilinear_cuda(_meta(1, 2, 5, 7), ty, tx)
    with pytest.raises(ValueError, match="NCHW-contiguous"):
        cuda_resize.resize_bilinear_cuda(_meta(2, 5, 6), ty, tx)


def test_np_plus_wrapper_refuses_dtypes_and_shapes(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(_build, "load_library", lambda: _NoLaunch())
    coef = _meta(2, 3, 1, 1, dtype=torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cuda_np_plus.np_plus_apply_cuda(_meta(2, 3, 4, 4, dtype=torch.float16), coef, coef)
    with pytest.raises(ValueError, match="coefficients"):
        cuda_np_plus.np_plus_apply_cuda(_meta(2, 3, 4, 4), _meta(2, 4, 1, 1), coef)
    with pytest.raises(ValueError, match="coefficients"):
        cuda_np_plus.np_plus_apply_cuda(_meta(2, 3, 4, 4), coef, _meta(1, 3, 1, 1))
    with pytest.raises(ValueError, match="coefficients"):
        cuda_np_plus.np_plus_apply_cuda(_meta(2, 3, 16), coef, coef)


# --- the staged bilinear backward and the staged nearest forward ---------------

def _bwd_taps(in_size, out_size):
    """For each input index, the outputs whose tap 0 or tap 1 reads it
    (brute force over ``bilinear_ac_weights``)."""
    i0, i1, _ = bilinear_ac_weights(in_size, out_size)
    return [np.flatnonzero((i0 == i) | (i1 == i)) for i in range(in_size)]


def _check_bilinear_bwd_plan(in_hw, out_hw, itemsize):
    """Each block of the staged backward (a band of input rows by a tile of
    input columns) stages the H-mixed cotangent columns [seg0, seg0 +
    in_cols), ``seg0`` the lower range start of its first input, as the
    kernel computes it: every cotangent column an input of the tile needs
    lies inside, the bands and tiles cover the input once, a staged row
    holds ``in_cols`` values from any lead into a granule, and the shared
    memory is the stage's and within the budget. The plane sum takes 1x1
    inputs alone; the direct kernel only shapes whose one-column tile does
    not fit."""
    (h, w), (oh, ow) = in_hw, out_hw
    plan = cuda_resize.bilinear_bwd_plan(h, w, oh, ow, itemsize)
    if (h, w) == (1, 1):
        assert plan.route == "sum"
        return plan
    txs = bilinear_taps(w, ow, "cpu")
    rx = [t.numpy() for t in (txs.lo0, txs.hi0, txs.lo1, txs.hi1)]
    cap = cuda_resize.BILINEAR_FWD_SMEM_CAP
    vec = 16 // itemsize if ow % (16 // itemsize) == 0 else 1
    if plan.route == "direct":
        assert 4 * cuda_resize.bilinear_bwd_pitch(cuda_resize.bilinear_bwd_span(*rx, 1),
                                                  itemsize) > cap
        return plan
    assert plan.route == "staged" and plan.vec == vec
    rows_seen, cols_seen = np.zeros(h, int), np.zeros(w, int)
    for y0 in range(0, h, plan.band):
        rows_seen[y0:y0 + plan.band] += 1
    need = _bwd_taps(w, ow)
    lo0, hi0, lo1, hi1 = rx
    for x0 in range(0, w, plan.cols):
        tile = np.arange(x0, min(x0 + plan.cols, w))
        cols_seen[tile] += 1
        start = min(lo0[x0], lo1[x0])
        end = max(hi0[tile[-1]], hi1[tile[-1]])
        assert 0 <= end - start <= plan.in_cols
        for i in tile:
            assert ((need[i] >= start) & (need[i] < end)).all()
    assert (rows_seen == 1).all() and (cols_seen == 1).all()
    # a thread takes 16 bytes' worth, from the granule holding the segment's
    # first value (vec > 1: up to per_word - 1 values in) or from that value
    per_word = 16 // itemsize
    lead = per_word - 1 if vec > 1 else 0
    assert plan.t_pitch >= -(-(lead + plan.in_cols) // per_word) * per_word
    assert plan.t_pitch % 4 == 0
    assert plan.smem == 4 * plan.band * plan.t_pitch <= cap
    return plan


@pytest.mark.parametrize("in_hw,out_hw", BILINEAR_SHAPES)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_bilinear_bwd_plan_stages_every_tap(in_hw, out_hw, itemsize):
    plan = _check_bilinear_bwd_plan(in_hw, out_hw, itemsize)
    # the 30,000-wide outputs of a 4-wide input need the direct kernel; the
    # model's shapes and the other edge cases take the staged one
    wide = in_hw[1] == 4 and out_hw[1] == 30000
    assert plan.route == ("sum" if in_hw == (1, 1) else "direct" if wide else "staged")


@pytest.mark.parametrize("in_hw,out_hw", BILINEAR_SHAPES[:12])
def test_bilinear_bwd_plan_takes_whole_rows(in_hw, out_hw):
    """At the model's shapes a block takes whole rows (the cotangent is read
    once, in 16-byte loads where its width allows) and about
    BILINEAR_BWD_ITEMS (row, granule) sums."""
    (h, w), (oh, ow) = in_hw, out_hw
    for itemsize in (2, 4):
        plan = cuda_resize.bilinear_bwd_plan(h, w, oh, ow, itemsize)
        if (h, w) == (1, 1):
            continue
        assert plan.cols == w and plan.in_cols == ow
        assert plan.vec == (1 if ow % (16 // itemsize) else 16 // itemsize)
        row_items = plan.t_pitch * itemsize // 16  # a thread's 16 bytes of a row
        want = max(1, min(h, cuda_resize.BILINEAR_BWD_ITEMS // row_items))
        assert plan.band == want or (plan.band < want and 4 * (plan.band + 1) * plan.t_pitch
                                     > cuda_resize.BILINEAR_FWD_SMEM_CAP)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(h=st.integers(1, 40), w=st.integers(1, 200), oh=st.integers(1, 300),
       ow=st.integers(1, 900), itemsize=st.sampled_from([2, 4]))
def test_bilinear_bwd_plan_drawn_shapes(h, w, oh, ow, itemsize):
    _check_bilinear_bwd_plan((h, w), (oh, ow), itemsize)


# (in_hw, rule, (arg_h, arg_w)) of every nearest forward chip_smoke.py runs:
# the seven OC resizes (odd widths 231, 277, 321; downsamples dec2-dec4),
# the edge cases and the long ranges
NEAREST_FWD = [(hw, rule, arg) for _p, hw, rule, arg in STAGED] + [
    ((5, 6), "scale", (3.0, 3.0))]


def _check_nearest_fwd_plan(h, w, rule, arg, itemsize):
    """Each band of output rows stages input rows [iy[first], iy[first] +
    stage_rows): every row its outputs read lies inside; the bands tile the
    output rows once, so a plane's bands are one flat run of its output;
    the shared memory holds the ix table and the stage within the budget.
    The direct kernel (band 0) only where one row does not fit."""
    ty = nearest_table(h, rule, arg[0], "cpu")
    ow = nearest_table(w, rule, arg[1], "cpu").idx.numel()
    iy = _jax_idx(h, rule, arg[0])
    plan = cuda_resize.nearest_fwd_plan(ty.spec, w, ow, itemsize)
    cap = cuda_resize.NEAREST_FWD_SMEM_CAP
    if plan.band == 0:
        assert cuda_resize.nearest_fwd_smem_bytes(ow, 1, 1, w, itemsize) > cap
        return plan
    covered = []
    for oy0 in range(0, iy.size, plan.band):
        rows = iy[oy0:oy0 + plan.band]
        assert rows.min() >= iy[oy0] and rows.max() < iy[oy0] + plan.stage_rows
        assert rows.max() - rows.min() < plan.stage_rows <= h
        covered.append(np.arange(oy0 * ow, (oy0 + rows.size) * ow))
    np.testing.assert_array_equal(np.concatenate(covered), np.arange(iy.size * ow))
    assert plan.smem == cuda_resize.nearest_fwd_smem_bytes(ow, plan.band, plan.stage_rows, w,
                                                           itemsize)
    assert plan.smem <= cap
    return plan


@pytest.mark.parametrize("in_hw,rule,arg", NEAREST_FWD)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_nearest_fwd_plan_stages_every_row(in_hw, rule, arg, itemsize):
    plan = _check_nearest_fwd_plan(*in_hw, rule, arg, itemsize)
    # only the 30,000-wide output's ix table outgrows the budget
    assert (plan.band == 0) == (arg == (3, 30000))


@pytest.mark.parametrize("in_hw,rule,arg", NEAREST_FWD[:7])
def test_nearest_fwd_plan_bands_are_as_tall_as_the_budget_allows(in_hw, rule, arg):
    """At the OC shapes a band is about NEAREST_FWD_ELEMS outputs, or as
    many rows as fit (a downsample's fp32 band reads more input rows than
    it writes)."""
    h, w = in_hw
    for itemsize in (2, 4):
        ty = nearest_table(h, rule, arg[0], "cpu")
        ow = nearest_table(w, rule, arg[1], "cpu").idx.numel()
        plan = cuda_resize.nearest_fwd_plan(ty.spec, w, ow, itemsize)
        want = max(1, min(ty.idx.numel(), cuda_resize.NEAREST_FWD_ELEMS // ow))
        assert 0 < plan.band <= want
        if plan.band < want:  # one row more would not fit
            rows = cuda_resize.bilinear_band_span(ty.idx.numpy(), ty.idx.numpy(),
                                                  plan.band + 1)
            assert cuda_resize.nearest_fwd_smem_bytes(ow, plan.band + 1, rows, w, itemsize) \
                > cuda_resize.NEAREST_FWD_SMEM_CAP


@settings(max_examples=40, deadline=None, derandomize=True)
@given(h=st.integers(1, 400), w=st.integers(1, 400), sy=st.floats(0.3, 3.0),
       sx=st.floats(0.3, 3.0), itemsize=st.sampled_from([2, 4]))
def test_nearest_fwd_plan_drawn_shapes(h, w, sy, sx, itemsize):
    if int(np.floor(h * sy)) == 0 or int(np.floor(w * sx)) == 0:
        return
    _check_nearest_fwd_plan(h, w, "scale", (sy, sx), itemsize)


def test_nearest_fwd_wrapper_refuses_mismatched_inputs(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(_build, "load_library", lambda: _NoLaunch())
    ty, tx = nearest_table(5, "size", 7, "meta"), nearest_table(6, "size", 8, "meta")
    with pytest.raises(ValueError, match="does not match the tables"):
        cuda_resize.resize_nearest_cuda(_meta(1, 2, 5, 7), ty, tx)
    with pytest.raises(ValueError, match="NCHW-contiguous"):
        cuda_resize.resize_nearest_cuda(_meta(2, 5, 6), ty, tx)


# --- the row mix's tables and launch plan, the confusion matrix's plan ---------

def _decode_table(table: np.ndarray):
    """Per output row, its (column, weight) terms as the kernel reads them."""
    terms = (table.shape[0] - 1) // 2
    wt = table[1 + terms:].view(np.float32)
    return [[(int(table[1 + t, o]), float(wt[t, o])) for t in range(table[0, o])]
            for o in range(table.shape[1])]


def _nonzeros(p: np.ndarray):
    return [[(int(c), float(p[o, c])) for c in np.flatnonzero(p[o])] for o in range(p.shape[0])]


# the seven OC index tables (AXES[:7]), a non-monotone idx, downsamples (their
# transposes have empty rows) and an upsample by three (three terms a row)
ROW_TABLE_IDX = [tuple(int(i) for i in _jax_idx(*a)) for a in AXES[:7]] + [
    (3, 0, 2, 2, 1, 0), tuple(int(i) for i in _jax_idx(7, "size", 3)),
    tuple(int(i) for i in _jax_idx(33, "scale", 0.798)),
    tuple(int(i) for i in _jax_idx(5, "scale", 3.0))]


@pytest.mark.parametrize("idx", ROW_TABLE_IDX, ids=range(len(ROW_TABLE_IDX)))
def test_row_table_holds_the_onehot_nonzeros_in_column_order(idx):
    """The host-built table of P = onehot_rows(idx, in) and of P^T: each
    row's non-zeros, in column order, and nothing else; one term a row for
    P, as many as idx repeats an input for P^T."""
    from mrfp_tpu_torch.ops import cuda_row_mix
    from mrfp_tpu_torch.ops.resize import onehot_rows
    size = max(idx) + 1 + (len(idx) % 3)  # some inputs are never read
    for transpose in (False, True):
        p = onehot_rows(idx, size, "cpu", transpose).numpy()
        table = cuda_row_mix.row_table_np(p)
        assert table.dtype == np.int32 and table.shape[1] == p.shape[0]
        assert _decode_table(table) == _nonzeros(p)
        counts = np.bincount(idx, minlength=size) if transpose else np.ones(len(idx), int)
        assert (table.shape[0] - 1) // 2 == counts.max()
        np.testing.assert_array_equal(table[0], counts)


def test_row_table_of_a_general_matrix():
    """A dense matrix with zeros, a NaN (kept, as in the product) and an
    all-zero row."""
    from mrfp_tpu_torch.ops import cuda_row_mix
    p = np.random.default_rng(0).standard_normal((5, 9)).astype(np.float32)
    p[p < 0.3] = 0
    p[1, 4] = np.nan
    p[3] = 0
    decoded = _decode_table(cuda_row_mix.row_table_np(p))
    want = [[(int(c), float(p[o, c])) for c in np.flatnonzero(p[o] != 0)] for o in range(5)]
    assert [len(r) for r in decoded] == [len(r) for r in want] and decoded[3] == []
    for got, ref in zip(decoded, want):
        np.testing.assert_array_equal(np.array(got), np.array(ref))


def _mix_from_table(x: torch.Tensor, table, dim: int) -> torch.Tensor:
    """The kernel's arithmetic from its table: per output, fmaf over its
    terms in order from 0 (in fp32; a one-hot term is exact), rounded once."""
    data = table.data.numpy()
    terms = table.terms
    wt = data[1 + terms:].view(np.float32)
    xf = x.float()
    outs = []
    for o in range(data.shape[1]):
        acc = torch.zeros_like(xf.select(dim, 0))
        for t in range(data[0, o]):
            acc = acc + float(wt[t, o]) * xf.select(dim, int(data[1 + t, o]))
        outs.append(acc)
    return torch.stack(outs, dim).to(x.dtype)


@pytest.mark.parametrize("idx", ROW_TABLE_IDX[5:], ids=range(len(ROW_TABLE_IDX[5:])))
@pytest.mark.parametrize("dim", [2, 3])
def test_table_mix_equals_the_plain_product(idx, dim):
    """The cached tables, read as the kernel reads them, give row_mix_plain
    with the one-hot P and with P^T (sums of at most two terms here, and of
    three for the x3 upsample, whose ones add exactly in any order on these
    integer-valued inputs)."""
    from mrfp_tpu_torch.ops import cuda_row_mix
    from mrfp_tpu_torch.ops.resize import onehot_rows, onehot_table
    size = max(idx) + 1
    rng = np.random.default_rng(len(idx))
    shape = [2, 3, 4, 5]
    shape[dim] = size
    x = torch.from_numpy(rng.integers(-50, 50, shape).astype(np.float32)).to(torch.bfloat16)
    y = _mix_from_table(x, onehot_table(idx, size, "cpu"), dim)
    assert torch.equal(y, cuda_row_mix.row_mix_plain(x, onehot_rows(idx, size, "cpu"), dim))
    assert torch.equal(y, x.index_select(dim, torch.tensor(idx)))
    g = torch.from_numpy(rng.integers(-50, 50, y.shape).astype(np.float32)).to(torch.bfloat16)
    gx = _mix_from_table(g, onehot_table(idx, size, "cpu", transpose=True), dim)
    assert torch.equal(gx, cuda_row_mix.row_mix_plain(
        g, onehot_rows(idx, size, "cpu", transpose=True), dim))


def test_onehot_table_is_built_once_per_key(monkeypatch):
    """take_rows' table is cached beside onehot_rows under the same key: the
    second call builds nothing."""
    from mrfp_tpu_torch.ops import cuda_row_mix, resize
    built = []
    real = cuda_row_mix.row_table
    monkeypatch.setattr(cuda_row_mix, "row_table",
                        lambda p, device: built.append(p.shape) or real(p, device))
    idx = (0, 0, 2, 3, 3, 1, 4)
    a = resize.onehot_table(idx, 6, "cpu")
    assert resize.onehot_table(idx, 6, "cpu") is a
    t = resize.onehot_table(idx, 6, "cpu", transpose=True)
    assert resize.onehot_table(idx, 6, "cpu", transpose=True) is t
    assert built == [(7, 6), (6, 7)] and t is not a
    np.testing.assert_array_equal(a.data.numpy(), cuda_row_mix.row_table_np(
        resize.onehot_rows(idx, 6, "cpu").numpy()))
    assert (a.terms, a.size_in, t.terms, t.size_in) == (1, 6, 2, 7)


ROW_MIX_WIDTHS = [1, 7, 9, 192, 231, 277, 321, 332, 384]


@pytest.mark.parametrize("width", ROW_MIX_WIDTHS)
@pytest.mark.parametrize("itemsize", [2, 4])
def test_row_mix_h_plan_without_host_rows(width, itemsize):
    """dim 2 for a table compacted on the card (no host columns): the
    vector route exactly where a row is whole 16-byte vectors and the
    pointers are aligned, else the scalar route; a band of about
    ROW_MIX_H_UNITS units; the table staged where it fits the budget."""
    from mrfp_tpu_torch.ops import cuda_row_mix as rm
    vec = 16 // itemsize
    for aligned in (True, False):
        for size_in, size_out, terms in ((192, 231, 1), (231, 192, 2), (384, 321, 1)):
            plan = rm.row_mix_plan(2, size_in, size_out, width, terms, itemsize, aligned)
            vector = aligned and width % vec == 0
            assert plan.route == ("h vector" if vector else "h scalar")
            assert plan.vec == (vec if vector else 1)
            units = width // plan.vec
            assert plan.band == max(1, min(size_out, rm.ROW_MIX_H_UNITS // units))
            assert plan.table_words == (1 + 2 * terms) * size_out
            assert plan.smem == 4 * plan.table_words <= rm.ROW_MIX_SMEM_CAP
    # a dense P's table does not fit: it stays in device memory
    plan = rm.row_mix_plan(2, 332, 384, width, 332, itemsize, True)
    assert plan.table_words == 0 and plan.smem == 0


def _check_h_staged_plan(table, width, itemsize):
    """The staged H plan of a host-built table: every band's terms read
    input rows inside [lo, lo + stage_rows) for the band's smallest column
    lo (brute force over the table), the bands tile the output rows, the
    shared memory is the kernel's layout within the budget, and the band is
    as tall as the budget allows up to ROW_MIX_H_ELEMS outputs."""
    from mrfp_tpu_torch.ops import cuda_row_mix as rm
    on = table.data.shape[1]
    plan = rm.row_mix_plan(2, table.size_in, on, width, table.terms, itemsize, False,
                           first=table.first, last=table.last)
    cap = rm.ROW_MIX_SMEM_CAP
    if plan.route == "h scalar":  # not one band row fits
        assert rm.row_mix_staged_smem_bytes(0, max(1, rm.row_band_span(
            table.first, table.last, 1)) * width, width, itemsize) > cap
        return plan
    assert plan.route == "h staged" and plan.vec == 16 // itemsize
    rows = _decode_table(table.data.numpy())
    for o0 in range(0, on, plan.band):
        cols = [c for terms in rows[o0:o0 + plan.band] for c, _ in terms]
        if cols:
            assert max(cols) - min(cols) < plan.stage_rows
    assert plan.smem == rm.row_mix_staged_smem_bytes(plan.table_words, plan.stage_rows * width,
                                                     plan.band * width, itemsize) <= cap
    assert plan.table_words in (0, (1 + 2 * table.terms) * on)
    want = max(1, min(on, rm.ROW_MIX_H_ELEMS // width))
    assert 1 <= plan.band <= want
    if plan.band < want:
        stage = max(1, rm.row_band_span(table.first, table.last, plan.band + 1))
        assert rm.row_mix_staged_smem_bytes(plan.table_words, stage * width,
                                            (plan.band + 1) * width, itemsize) > cap
    return plan


@pytest.mark.parametrize("width", ROW_MIX_WIDTHS + [30_000])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_row_mix_h_plan_stages_a_bands_rows(width, itemsize):
    """dim 2 for take_rows' host-built tables, at the OC index tables of
    the H mixes, a non-monotone idx, a downsample and an x3 upsample: rows
    that are not whole 16-byte vectors (or unaligned pointers) take the
    staged route, whose stage holds every band's input rows."""
    from mrfp_tpu_torch.ops import cuda_row_mix as rm
    from mrfp_tpu_torch.ops.resize import onehot_table
    for idx in [ROW_TABLE_IDX[i] for i in (0, 2, 4, 6, 7, 8, 10)]:
        size = max(idx) + 1
        for transpose in (False, True):
            table = onehot_table(idx, size, "cpu", transpose)
            plan = _check_h_staged_plan(table, width, itemsize)
            assert (plan.route == "h scalar") == (width == 30_000)
            # aligned whole vectors keep the vector route
            if width % (16 // itemsize) == 0:
                assert rm.row_mix_plan(2, table.size_in, table.data.shape[1], width,
                                       table.terms, itemsize, True, first=table.first,
                                       last=table.last).route == "h vector"


def test_row_band_span():
    from mrfp_tpu_torch.ops import cuda_row_mix as rm
    first = np.array([3, -1, 5, 0, -1, -1])
    last = np.array([4, -1, 9, 2, -1, -1])
    assert rm.row_band_span(first, last, 1) == 5   # row 2 reads 5..9
    assert rm.row_band_span(first, last, 2) == 10  # rows 2-3 read 0..9
    assert rm.row_band_span(first, last, 3) == 7   # rows 0-2 read 3..9
    assert rm.row_band_span(first, last, 6) == 10
    assert rm.row_band_span(np.array([-1, -1]), np.array([-1, -1]), 1) == 0


@pytest.mark.parametrize("width", ROW_MIX_WIDTHS + [100_000])
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("scale", [1.2, 0.798])
def test_row_mix_w_plan(width, itemsize, scale):
    """dim 3: the staged route with the table in shared memory and as many
    rows a band as the budget allows, up to about ROW_MIX_W_ELEMS
    values; the shared memory is the kernel's layout; the direct route only
    where not one row fits."""
    from mrfp_tpu_torch.ops import cuda_row_mix as rm
    size_out = max(1, int(np.floor(width * scale)))
    cap = rm.ROW_MIX_SMEM_CAP
    for terms in (1, 2):
        plan = rm.row_mix_plan(3, width, size_out, 1, terms, itemsize, True, rows=4096)
        words = (1 + 2 * terms) * size_out
        if plan.route == "w direct":
            assert rm.row_mix_staged_smem_bytes(0, width, size_out, itemsize) > cap
            assert (plan.band, plan.smem) == (0, 0)
            continue
        assert plan.route == "w staged" and plan.vec == 16 // itemsize
        assert plan.stage_rows == plan.band
        assert plan.smem == rm.row_mix_staged_smem_bytes(
            plan.table_words, plan.band * width, plan.band * size_out, itemsize) <= cap
        assert plan.table_words in (words, 0)
        if plan.table_words == 0:  # the table alone would not leave room for a row
            assert rm.row_mix_staged_smem_bytes(words, width, size_out, itemsize) > cap
        want = max(1, min(4096, rm.ROW_MIX_W_ELEMS // max(width, size_out)))
        assert 1 <= plan.band <= want
        if plan.band < want:
            assert rm.row_mix_staged_smem_bytes(plan.table_words, (plan.band + 1) * width,
                                                (plan.band + 1) * size_out, itemsize) > cap
    assert (rm.row_mix_plan(3, width, size_out, 1, 1, itemsize, True).route == "w direct") \
        == (width == 100_000)


def test_row_mix_w_plan_band_stops_at_the_rows():
    from mrfp_tpu_torch.ops import cuda_row_mix as rm
    assert rm.row_mix_plan(3, 9, 13, 9, 1, 2, True, rows=3).band == 3


@pytest.mark.parametrize("pred_dtype,label_dtype,ptrs,expected", [
    (torch.int64, torch.uint8, (0, 4096), (torch.int64, torch.uint8, True)),   # the eval path
    (torch.int32, torch.int32, (16, 32), (torch.int32, torch.int32, True)),
    (torch.int64, torch.int64, (0, 0), (torch.int64, torch.int64, True)),
    (torch.int64, torch.uint8, (0, 4097), (torch.int64, torch.uint8, False)),  # a sliced label
    (torch.int64, torch.uint8, (8, 0), (torch.int64, torch.uint8, False)),
    (torch.uint8, torch.uint8, (3, 0), (torch.int32, torch.uint8, True)),      # cast: aligned
    (torch.int16, torch.int8, (2, 1), (torch.int32, torch.int32, True)),
    (torch.int64, torch.int16, (8, 2), (torch.int64, torch.int32, False)),
    (torch.float32, torch.bool, (0, 0), (torch.int32, torch.int32, True)),
])
def test_hist_plan(pred_dtype, label_dtype, ptrs, expected):
    """The native dtypes are read as they are, any other is cast to int32
    (a fresh, aligned array); 16-byte loads where both arrays are
    aligned."""
    from mrfp_tpu_torch.ops import cuda_hist
    assert tuple(cuda_hist.hist_plan(pred_dtype, label_dtype, *ptrs)) == expected


def test_row_mix_wrappers_refuse_dtypes_and_shapes(monkeypatch):
    from mrfp_tpu_torch.ops import cuda_row_mix as rm
    from mrfp_tpu_torch.ops.resize import onehot_table
    monkeypatch.setattr(_build, "load_library", lambda: _NoLaunch())
    table = onehot_table((0, 1, 1, 4), 5, "meta")
    with pytest.raises(ValueError, match="CUDA"):
        rm.row_mix_table_cuda(torch.zeros(1, 2, 5, 6), table, 2)
    with pytest.raises(ValueError, match="CUDA"):
        rm.row_mix_compact_cuda(torch.zeros(4, 5))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(TypeError, match="float32/bfloat16"):
        rm.row_mix_table_cuda(_meta(1, 2, 5, 6, dtype=torch.float16), table, 2)
    with pytest.raises(ValueError, match="x.shape\\[dim\\]"):
        rm.row_mix_table_cuda(_meta(1, 2, 5, 6), table, 3)
    with pytest.raises(ValueError, match="dim must be"):
        rm.row_mix_table_cuda(_meta(1, 2, 5, 6), table, 1)
    with pytest.raises(ValueError, match="a table of"):
        rm.row_mix_table_cuda(_meta(1, 2, 5, 6),
                              rm.RowTable(table.data.to(torch.int64), 1, 5), 2)
    with pytest.raises(ValueError, match="a table of"):
        rm.row_mix_table_cuda(_meta(1, 2, 5, 6), rm.RowTable(table.data, 2, 5), 2)
    with pytest.raises(TypeError, match="2-D float32"):
        rm.row_mix_compact_cuda(_meta(4, 5, dtype=torch.float16))
    with pytest.raises(TypeError, match="float32 P"):
        rm.row_mix_cuda(_meta(1, 2, 5, 6), _meta(4, 5), 2)
    with pytest.raises(ValueError, match="x.shape\\[dim\\]"):
        rm.row_mix_cuda(_meta(1, 2, 5, 6), _meta(4, 6, dtype=torch.float32), 2)


def test_row_mix_refuses_a_stage_shorter_than_a_band(monkeypatch):
    """The staged H mix does not check its stage on the card in a release
    build: the wrapper refuses a plan whose stage misses a band's rows."""
    from mrfp_tpu_torch.ops import cuda_row_mix as rm
    from mrfp_tpu_torch.ops.resize import onehot_table
    monkeypatch.setattr(_build, "load_library", lambda: _NoLaunch())
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    table = onehot_table((0, 4, 2, 1), 5, "meta", transpose=True)
    planned = rm._plan_cached.__wrapped__(2, 4, 5, 6, table.terms, 2, True, 0, (
        table.first.astype(np.int64).tobytes(), table.last.astype(np.int64).tobytes()))
    assert planned.route == "h staged" and planned.stage_rows == 4
    short = planned._replace(stage_rows=planned.stage_rows - 1)
    monkeypatch.setattr(rm, "row_mix_plan", lambda *args: short)
    rm._plan_cached.cache_clear()
    try:
        with pytest.raises(ValueError, match="the stage holds 3"):
            rm.row_mix_table_cuda(_meta(1, 2, 4, 6), table, 2)
    finally:
        rm._plan_cached.cache_clear()


def test_hist_wrapper_refuses_arguments(monkeypatch):
    from mrfp_tpu_torch.ops import cuda_hist
    monkeypatch.setattr(_build, "load_library", lambda: _NoLaunch())
    hist = torch.zeros(19, 19, dtype=torch.int32)
    pred = torch.zeros(8, dtype=torch.long)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_hist.confusion_matrix_cuda(hist, pred, pred, 19)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    meta_hist = torch.zeros(19, 19, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="differ in size"):
        cuda_hist.confusion_matrix_cuda(meta_hist, _meta(8), _meta(9), 19)
    with pytest.raises(ValueError, match="contiguous int32"):
        cuda_hist.confusion_matrix_cuda(meta_hist.long(), _meta(8), _meta(8), 19)
    with pytest.raises(ValueError, match="num_classes"):
        cuda_hist.confusion_matrix_cuda(meta_hist, _meta(8), _meta(8), 129)
