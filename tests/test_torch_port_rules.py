"""Rules of the port that no parity test covers: it imports no JAX, it never
runs a CUDA request on the CPU, and a CUDA tensor reaches the kernel or an
error, never the plain version."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mrfp_tpu_torch.cli import eval as cli_eval
from mrfp_tpu_torch.ops import _build
from mrfp_tpu_torch.ops.hist import confusion_matrix_update
from mrfp_tpu_torch.ops.resize import resize_bilinear_align_corners

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def test_port_imports_no_jax():
    code = ("import sys, pkgutil, importlib, mrfp_tpu_torch\n"
            "for m in pkgutil.walk_packages(mrfp_tpu_torch.__path__, 'mrfp_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import mrfp_tpu_torch.cli.eval\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'mrfp_tpu', 'flax'))\n"
            "assert not bad, bad\n"
            "print('ok', len([m for m in sys.modules if m.startswith('mrfp_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_cli_device_cuda_without_cuda_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        cli_eval.main(["--device", "cuda", "--synthetic", "--synthetic-hw", "48", "64",
                       "--max-images", "1", "--domains", "cityscapes"])
    assert exc.value.code not in (0, None)


def _boom():
    raise RuntimeError("kernel library unavailable")


def test_cuda_branch_raises_instead_of_falling_back(monkeypatch):
    """Tensors off the CPU take the kernel branch; when the library cannot
    load, each wrapper raises. (The meta device stands in for a card.)"""
    monkeypatch.setattr(_build, "load_library", _boom)
    x = torch.empty(1, 4, 3, 5, device="meta")
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        resize_bilinear_align_corners(x, (6, 10))
    hist = torch.zeros(19, 19, dtype=torch.int32, device="meta")
    pred = torch.empty(2, 8, dtype=torch.long, device="meta")
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        confusion_matrix_update(hist, pred, pred, 19)
    # and the CPU path never touches the library
    assert confusion_matrix_update(torch.zeros(19, 19, dtype=torch.int32),
                                   torch.zeros(4, dtype=torch.long),
                                   torch.zeros(4, dtype=torch.long), 19)[0, 0] == 4


def test_library_name_tracks_the_sources():
    so = _build.library_path()
    assert so.parent == _build.BUILD_DIR and so.name.startswith("libmrfp_kernels-")
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {
        "resize_bilinear.cu", "confusion_matrix.cu"}


def test_cli_cpu_synthetic_prints_results():
    out = subprocess.run(
        [sys.executable, "-m", "mrfp_tpu_torch.cli.eval", "--device", "cpu",
         "--synthetic", "--synthetic-hw", "48", "64", "--max-images", "2"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    results = json.loads(out.stdout[out.stdout.index("\n{") + 1:])
    assert set(results) == {"bdd100k", "cityscapes", "synthia", "mapillary", "gtav"}
    for r in results.values():
        assert r["images"] == 2 and r["pixels"] == 2 * 48 * 64
        assert 0.0 <= r["mean_iu"] <= 1.0 and r["device"] == "cpu"
