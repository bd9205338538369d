"""Builds the package's CUDA kernels and binds them through ctypes.

``nvcc`` compiles every ``csrc/*.cu`` (one process per file, all at once)
and links them into one shared library with a plain C interface (no PyTorch
headers, so the build takes seconds). The library goes
into ``mrfp_tpu_torch/_build/`` at first use; its file name carries a hash of
the sources and flags, so a stale library is never loaded. Nothing is built
or loaded when the package is imported.

``LAUNCHES`` counts kernel launches per wrapper: each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that its main
path went through the kernels. ``dot_with_stats_tc`` counts the subset of
``dot_with_stats`` launches that took the tensor-core kernel;
``row_mix_compact`` counts the compactions of a caller's general P, which
``take_rows`` never launches. The fused OC stage counts its statistics
(``oc_stage_stats``), its apply (``oc_stage``) and its backward
(``oc_stage_bwd``, both passes), one each a stage, and its transpositions
between NCHW and channels-last (``oc_stage_layout``).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

LAUNCHES = {"resize_bilinear": 0, "resize_bilinear_bwd": 0, "resize_nearest": 0,
            "resize_nearest_bwd": 0, "confusion_matrix": 0, "dot_with_stats": 0,
            "dot_with_stats_tc": 0, "row_mix": 0, "row_mix_compact": 0, "channel_sums": 0,
            "np_plus_apply": 0, "oc_stage_stats": 0, "oc_stage": 0, "oc_stage_bwd": 0,
            "oc_stage_layout": 0}

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-DNDEBUG",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_SIGNATURES = {
    # x, out, iy0, iy1, fy, ix0, ix1, fx, nc, h, w, oh, ow, vec, band, stage_rows,
    # cols, in_cols, raw_pitch, threads_x, threads_y, smem, dtype, stream
    "mrfp_resize_bilinear": [_P] * 8 + [ctypes.c_int64] + [ctypes.c_int] * 14 + [_P],
    # g, gx, fy, ly0, hy0, ly1, hy1, fx, lx0, hx0, lx1, hx1, nc, h, w, oh, ow,
    # route, vec, band, cols, in_cols, t_pitch, smem, dtype, stream
    "mrfp_resize_bilinear_bwd": [_P] * 12 + [ctypes.c_int64] + [ctypes.c_int] * 12 + [_P],
    # x, out, iy, ix, nc, h, w, oh, ow, band, stage_rows, smem, dtype, stream
    "mrfp_resize_nearest": [_P] * 4 + [ctypes.c_int64] + [ctypes.c_int] * 6
                           + [ctypes.c_int64, ctypes.c_int, _P],
    # g, gx, ly, hy, lx, hx, nc, h, w, oh, ow, rows_per_block, max_run_y, max_run_x,
    # smem, dtype, stream
    "mrfp_resize_nearest_bwd": [_P] * 6 + [ctypes.c_int64] + [ctypes.c_int] * 7
                               + [ctypes.c_int64, ctypes.c_int, _P],
    # pred, label, n, num_classes, pred_dtype, label_dtype, vec, hist, stream
    "mrfp_confusion_matrix": [_P, _P, ctypes.c_int64] + [ctypes.c_int] * 4 + [_P] * 2,
    # n, cout, hw, tensor_cores -> the partial rows mrfp_dot_with_stats needs
    "mrfp_dot_with_stats_parts": [ctypes.c_int] * 4,
    # x, w, y, part, parts, s1, s2, n, cin, cout, hw, dtype, tensor_cores, stream
    "mrfp_dot_with_stats": [_P, _P, _P, _P, ctypes.c_int, _P, _P] + [ctypes.c_int] * 6 + [_P],
    # p, table, rows, cols, stream
    "mrfp_row_mix_compact": [_P, _P, ctypes.c_int, ctypes.c_int, _P],
    # x, table, out, planes, h, w, on, terms, dim, route, band, stage_rows,
    # table_words, smem, dtype, stream
    "mrfp_row_mix": [_P] * 3 + [ctypes.c_int64] + [ctypes.c_int] * 9
                    + [ctypes.c_int64, ctypes.c_int, _P],
    # x, part, splits, s1, s2, n, channels, hw, dtype, stream
    "mrfp_channel_sums": [_P, _P, ctypes.c_int, _P, _P, ctypes.c_int64, ctypes.c_int,
                          ctypes.c_int64, ctypes.c_int, _P],
    # x, alpha, shift, out, planes, hw, vec, dtype, stream
    "mrfp_np_plus_apply": [_P] * 4 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_int, _P],
    # y, ly, hy, lx, hx, part, parts, n, h, w, c, count, eps, stats, local, dtype, pack,
    # stream
    "mrfp_oc_stage_stats": [_P] * 6 + [ctypes.c_int] * 5
                           + [ctypes.c_double, ctypes.c_double, _P, _P, ctypes.c_int,
                              ctypes.c_int, _P],
    # y, out, stats, w, b, iy, ix, n, h, w, c, oh, ow, identity, dtype, pack, stream
    "mrfp_oc_stage_apply": [_P] * 7 + [ctypes.c_int] * 9 + [_P],
    # dy, y, stats, w, b, ly, hy, lx, hx, part, parts, sums, dx, n, h, w, c, oh, ow,
    # identity, short_ranges, passes, dtype, pack, stream
    "mrfp_oc_stage_bwd": [_P] * 10 + [ctypes.c_int, _P, _P] + [ctypes.c_int] * 11 + [_P],
    # in, add, out, images, rows, cols, in_dtype, out_dtype, stream
    "mrfp_oc_stage_layout": [_P] * 3 + [ctypes.c_int] * 5 + [_P],
}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmrfp_kernels-{digest.hexdigest()[:16]}.so"


def _run_all(cmds) -> str:
    """Run the commands at once; returns their output, or raises with the
    output of every one that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    outs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        outs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(outs)


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.
    ptxas's report (registers, spills per kernel) goes beside the library,
    in ``<library>.log``. Processes that build at once (the ranks of a
    data-parallel run) take turns on a file lock, so one builds and the
    others find its library; the lock dies with the process that holds
    it."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            _compile(so)
    return so


def _compile(so: Path) -> None:
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, p.stem + ".o") for p in sorted(CSRC.glob("*.cu"))]
        report = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                           for obj, src in zip(objs, sorted(CSRC.glob("*.cu")))])
        so.with_suffix(".log").write_text(report)
        lib = os.path.join(tmp, so.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, so)  # atomic: a concurrent loader sees all or nothing


def load_library() -> ctypes.CDLL:
    """Build (first use only) and load the kernel library; raises on failure."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
