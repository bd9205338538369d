"""What the port's trainer writes, read back on the CPU.

- ``cli.eval --ckpt`` evaluates a model that ``cli.train`` trained: given
  the run directory, its ``ckpt/`` or a ``step_<N>.pt``, it loads the
  checkpoint's model (without the train-only OC buffers) and scores the
  same histogram and mIoU as the in-process evaluator on that model.
- A checkpoint carries its run's recipe (source or synthetic data, crop,
  seed, mode, the DSN head): a run of another recipe in the same runs directory refuses
  to resume it, and leaves it as it was; a run of the same recipe with a
  larger ``--max-iter`` resumes.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mrfp_tpu_torch.cli import eval as cli_eval
from mrfp_tpu_torch.cli import train as cli_train
from mrfp_tpu_torch.core.config import mrfp_plus_config
from mrfp_tpu_torch.data import SyntheticDataset
from mrfp_tpu_torch.models import build_mrfp
from mrfp_tpu_torch.train.checkpoint import CheckpointManager, find_checkpoint
from mrfp_tpu_torch.train.evaluator import SegEvaluator
from mrfp_tpu_torch.weights import eval_state_dict

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TRAIN_ARGS = ["--device", "cpu", "--synthetic", "--crop-size", "64", "--batch-size", "2",
              "--log-every", "1", "--seed", "0"]
EVAL_ARGS = ["--device", "cpu", "--synthetic", "--synthetic-hw", "64", "64",
             "--max-images", "3", "--domains", "cityscapes", "--step-timeout", "0"]


def _train(runs_dir, *extra, args=TRAIN_ARGS):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return subprocess.run([sys.executable, "-m", "mrfp_tpu_torch.cli.train", *args,
                           "--runs-dir", str(runs_dir), *extra], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """Two synthetic steps of ``cli.train`` at 64 px; the run directory."""
    runs = tmp_path_factory.mktemp("runs")
    out = _train(runs, "--max-iter", "2")
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["step"] == 2
    return Path(result["run_dir"])


def _checkpoint_files(run_dir):
    ckpt = run_dir / "ckpt"
    return {p.name: p.read_bytes() for p in sorted(ckpt.iterdir()) if p.is_file()}


@pytest.mark.parametrize("where", ["run", "ckpt", "file"])
def test_cli_eval_reads_what_cli_train_wrote(run_dir, where):
    ckpt = {"run": run_dir, "ckpt": run_dir / "ckpt",
            "file": run_dir / "ckpt" / "step_2.pt"}[where]
    assert find_checkpoint(str(ckpt)) == str(run_dir / "ckpt" / "step_2.pt")
    argv = EVAL_ARGS + ["--ckpt", str(ckpt)]
    cpu = torch.device("cpu")

    # the trained model, loaded by hand, through the in-process evaluator
    blob = torch.load(run_dir / "ckpt" / "step_2.pt", map_location="cpu", weights_only=True)
    sd, dropped = eval_state_dict(blob["model"])
    assert dropped, "the MRFP+ checkpoint holds OC buffers"
    want_model = build_mrfp("cpu")
    want_model.load_state_dict(sd, strict=True)
    dataset = SyntheticDataset(length=4, hw=(64, 64))
    want = SegEvaluator(want_model, device=cpu).run(dataset, max_images=3,
                                                    log=lambda *a, **k: None)

    got_model = cli_eval.load_model(cli_eval.parse_args(argv), cpu)
    for k, v in got_model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    got = SegEvaluator(got_model, device=cpu).run(dataset, max_images=3,
                                                  log=lambda *a, **k: None)
    np.testing.assert_array_equal(np.asarray(got["hist"]), np.asarray(want["hist"]))

    res = cli_eval.main(argv)["cityscapes"]
    assert res["mean_iu"] == want["mean_iu"] and res["images"] == 3
    assert res["pixels"] == int(np.asarray(want["hist"]).sum())


def test_find_checkpoint_names_the_orbax_route(tmp_path):
    (tmp_path / "1000").mkdir()  # an Orbax step directory, not a port checkpoint
    with pytest.raises(FileNotFoundError, match="A13"):
        find_checkpoint(str(tmp_path))


@pytest.mark.parametrize("other", [["--crop-size", "48"], ["--seed", "1"],
                                   ["--source", "cityscapes"], ["--use-dsn"]])
def test_another_recipe_does_not_resume(run_dir, other):
    """A run of another recipe whose name (and so whose ckpt/) is the smoke
    run's refuses to resume it and writes nothing there; the real-data run
    stops before it looks for its data."""
    before = _checkpoint_files(run_dir)
    args = [a for a in TRAIN_ARGS if "--source" not in other or a != "--synthetic"]
    out = _train(run_dir.parent, *other, "--max-iter", "3", "--data-root",
                 str(run_dir / "no-data"), args=args)
    assert out.returncode != 0
    assert "refusing to resume" in out.stderr, out.stderr[-3000:]
    assert _checkpoint_files(run_dir) == before


def test_restore_checks_the_recipe(tmp_path):
    """In process: the recipe goes into the checkpoint; a manager of another
    recipe raises and leaves the state untouched, one of the same recipe
    (or one that names none) restores."""
    cfg = mrfp_plus_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, max_iter=10,
                                                compute_dtype="float32"))
    recipe = {"source": "synthetic", "crop_size": 64, "seed": 0, "mode": "mrfp+"}
    state = cli_train.build_state(cfg, torch.device("cpu"))
    state.step = 3
    mgr = CheckpointManager(str(tmp_path), recipe=recipe)
    mgr.save(state)
    mgr.close()
    assert torch.load(tmp_path / "step_3.pt", weights_only=True)["recipe"] == recipe

    fresh = cli_train.build_state(cfg, torch.device("cpu"))
    for other in ({**recipe, "source": "gtav"}, {**recipe, "crop_size": 768},
                  {**recipe, "seed": 1}, {**recipe, "mode": "baseline"}):
        with pytest.raises(ValueError, match="refusing to resume"):
            CheckpointManager(str(tmp_path), recipe=other).restore(fresh)
        assert fresh.step == 0
    for same in (recipe, None):
        fresh = cli_train.build_state(cfg, torch.device("cpu"))
        assert CheckpointManager(str(tmp_path), recipe=same).restore(fresh)
        assert fresh.step == 3


def test_max_iter_extension_still_resumes(run_dir, tmp_path):
    """The smoke run extended to 3 steps resumes at 2 (the recipe leaves
    ``max_iter`` out); in a copy, so the other tests keep step 2."""
    runs = tmp_path / "runs"
    shutil.copytree(run_dir.parent, runs)
    out = _train(runs, "--max-iter", "3")
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["step"] == 3 and sorted(result["losses"]) == ["3"]
