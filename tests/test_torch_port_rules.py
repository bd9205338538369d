"""Rules of the port that no parity test covers: it imports no JAX, it never
runs a CUDA request on the CPU, and a CUDA tensor reaches the kernel or an
error, never the plain version."""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mrfp_tpu_torch.cli import eval as cli_eval
from mrfp_tpu_torch.ops import _build
from mrfp_tpu_torch.ops.hist import confusion_matrix_update
from mrfp_tpu_torch.nn.norms import norm_group
from mrfp_tpu_torch.ops import (cuda_channel_sums, cuda_dot_stats, cuda_np_plus,
                                cuda_oc_stage, cuda_resize, cuda_row_mix)
from mrfp_tpu_torch.ops.dot_stats import dot_with_stats
from mrfp_tpu_torch.ops.np_plus import np_plus_apply
from mrfp_tpu_torch.ops.oc_stage import oc_stage, to_channels_last
from mrfp_tpu_torch.ops.resize import (bilinear_taps, nearest_table, onehot_table,
                                       resize_bilinear_align_corners, resize_nearest, take_rows)
from mrfp_tpu_torch.ops.stats import channel_sums

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
            "import mrfp_tpu_torch.cli.eval, mrfp_tpu_torch.cli.train\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'mrfp_tpu', 'flax'))\n"
            "assert not bad, bad\n"
            "print('ok', len([m for m in sys.modules if m.startswith('mrfp_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


PORT_SOURCES = sorted(str(p.relative_to(REPO)) for p in (REPO / "mrfp_tpu_torch").rglob("*.py")) \
    + ["chip_smoke.py", "chip_compare.py"]


@pytest.mark.parametrize("source", PORT_SOURCES)
def test_port_source_names_no_jax(source):
    """No ``import`` or ``from`` anywhere in a port file, inside functions
    too, names jax, flax or the JAX package: imports at load time are
    checked above, and this covers the ones that load only when called."""
    tree = ast.parse((REPO / source).read_text(), source)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [(a.name, node.lineno) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append((node.module, node.lineno))
    bad = [(n, line) for n, line in names if n.split(".")[0] in ("jax", "flax", "mrfp_tpu")]
    assert not bad, bad


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
    with pytest.raises(RuntimeError, match="kernel library unavailable"):
        resize_nearest(x, scale=(1.2, 1.2))


def _meta(*shape):
    return torch.empty(*shape, device="meta")


def _wrapper_calls(wrapper):
    """The calls that must reach ``wrapper``'s kernel for a tensor off the
    CPU: the wrapper itself and, for the fused-statistics slice's four, the
    public function that routes to it."""
    meta = torch.device("meta")
    x = _meta(2, 4, 5, 6)
    coef = _meta(2, 4, 1, 1)
    return {
        "resize_nearest_cuda": [lambda: cuda_resize.resize_nearest_cuda(
            _meta(1, 4, 5, 6), nearest_table(5, "size", 7, meta),
            nearest_table(6, "size", 8, meta))],
        "resize_nearest_bwd_cuda": [lambda: cuda_resize.resize_nearest_bwd_cuda(
            _meta(1, 4, 7, 8), nearest_table(5, "size", 7, meta),
            nearest_table(6, "size", 8, meta), 5, 6)],
        "resize_bilinear_bwd_cuda": [lambda: cuda_resize.resize_bilinear_bwd_cuda(
            _meta(1, 4, 7, 8), bilinear_taps(5, 7, meta), bilinear_taps(6, 8, meta), 5, 6)],
        "dot_with_stats_cuda": [lambda: cuda_dot_stats.dot_with_stats_cuda(x, _meta(3, 4)),
                                lambda: dot_with_stats(x, _meta(3, 4))],
        "row_mix_cuda": [lambda: cuda_row_mix.row_mix_cuda(x, _meta(7, 5), 2),
                         lambda: cuda_row_mix.row_mix_compact_cuda(_meta(7, 5)),
                         lambda: cuda_row_mix.row_mix_table_cuda(
                             x, onehot_table((0, 1, 1, 4), 6, meta), 3),
                         lambda: take_rows(x, (0, 1, 1, 4), 3)],
        "channel_sums_cuda": [lambda: cuda_channel_sums.channel_sums_cuda(x),
                              lambda: channel_sums(x)],
        "np_plus_apply_cuda": [lambda: cuda_np_plus.np_plus_apply_cuda(x, coef, coef),
                               lambda: np_plus_apply(x, coef, coef)],
        "oc_stage_cuda": [lambda: cuda_oc_stage.oc_stage_stats_cuda(
                              x, nearest_table(5, "size", 7, meta),
                              nearest_table(6, "size", 8, meta), 112, 1e-5),
                          lambda: cuda_oc_stage.oc_stage_apply_cuda(
                              x, _meta(4, 4), _meta(4), _meta(4), nearest_table(5, "size", 7, meta),
                              nearest_table(6, "size", 8, meta), (cuda_oc_stage.NHWC,)),
                          lambda: cuda_oc_stage.oc_stage_bwd_cuda(
                              [_meta(2, 4, 7, 8)], (cuda_oc_stage.NCHW,), x, _meta(4, 4),
                              _meta(4), _meta(4), nearest_table(5, "size", 7, meta),
                              nearest_table(6, "size", 8, meta), norm_group()),
                          lambda: cuda_oc_stage.oc_stage_layout_cuda(x, cuda_oc_stage.NHWC),
                          lambda: oc_stage(x, _meta(4), _meta(4), scale=(1.2, 1.2)),
                          lambda: oc_stage(x, _meta(4), _meta(4), size=(5, 6)),
                          lambda: to_channels_last(x)],
    }[wrapper]


@pytest.mark.parametrize("wrapper", ["resize_nearest_cuda", "resize_nearest_bwd_cuda",
                                     "resize_bilinear_bwd_cuda", "dot_with_stats_cuda",
                                     "row_mix_cuda", "channel_sums_cuda",
                                     "np_plus_apply_cuda", "oc_stage_cuda"])
def test_train_wrappers_raise_instead_of_falling_back(monkeypatch, wrapper):
    """Each wrapper added after the eval slice, called on a tensor off the
    CPU with the library loader failing, raises; none returns the plain
    result."""
    monkeypatch.setattr(_build, "load_library", _boom)
    for call in _wrapper_calls(wrapper):
        with pytest.raises(RuntimeError, match="kernel library unavailable"):
            call()
    # and the CPU path never touches the library
    assert confusion_matrix_update(torch.zeros(19, 19, dtype=torch.int32),
                                   torch.zeros(4, dtype=torch.long),
                                   torch.zeros(4, dtype=torch.long), 19)[0, 0] == 4


def test_library_name_tracks_the_sources():
    so = _build.library_path()
    assert so.parent == _build.BUILD_DIR and so.name.startswith("libmrfp_kernels-")
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {
        "resize_bilinear.cu", "resize_nearest.cu", "confusion_matrix.cu", "dot_stats.cu",
        "row_mix.cu", "channel_sums.cu", "np_plus_apply.cu", "oc_stage.cu"}
    assert set(_build.LAUNCHES) == {"resize_bilinear", "resize_bilinear_bwd", "resize_nearest",
                                    "resize_nearest_bwd", "confusion_matrix", "dot_with_stats",
                                    "dot_with_stats_tc", "row_mix", "row_mix_compact",
                                    "channel_sums", "np_plus_apply", "oc_stage_stats",
                                    "oc_stage", "oc_stage_bwd", "oc_stage_layout"}
    # every entry point the wrappers call has a ctypes signature
    calls = set()
    for src in (_build._PKG / "ops").glob("cuda_*.py"):
        calls |= set(re.findall(r"lib\.(mrfp_\w+)\(", src.read_text()))
    assert calls == set(_build._SIGNATURES)


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


def test_fused_step_checkpoint_loads_into_an_unfused_model(tmp_path):
    """``fuse_bn_stats`` adds no parameter or buffer: the state_dict after a
    fused MRFP+ step loads with ``strict=True`` into a model that never ran
    fused, and the two give the same eval logits."""
    import dataclasses
    from mrfp_tpu_torch.cli.train import build_state
    from mrfp_tpu_torch.core.config import mrfp_plus_config
    from mrfp_tpu_torch.models import MRFP
    from mrfp_tpu_torch.train.step import train_step
    cfg = mrfp_plus_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype="float32",
                                                fuse_bn_stats=True))
    state = build_state(cfg, torch.device("cpu"))
    gen = torch.Generator().manual_seed(4)
    img = torch.randint(0, 256, (2, 32, 32, 3), generator=gen, dtype=torch.uint8)
    lbl = torch.randint(0, 19, (2, 32, 32), generator=gen, dtype=torch.uint8)
    train_step(state, img, lbl, cfg)
    torch.save(state.model.state_dict(), tmp_path / "fused.pt")
    plain = MRFP(oc_branch=True)
    plain.load_state_dict(torch.load(tmp_path / "fused.pt"), strict=True)
    state.model.eval()
    x = img.permute(0, 3, 1, 2).float()
    with torch.no_grad():
        assert torch.equal(state.model(x), plain(x))
    assert int(plain.layer1[0].bn1.num_batches_tracked) == 1
