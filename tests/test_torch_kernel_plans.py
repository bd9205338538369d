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
- The wrappers' argument checks raise before any launch.
"""

import numpy as np
import pytest
import torch

from mrfp_tpu.ops.resize import _nearest_idx_from_scale, _nearest_idx_from_size
from mrfp_tpu_torch.ops import _build, cuda_dot_stats, cuda_resize
from mrfp_tpu_torch.ops.resize import nearest_table

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
