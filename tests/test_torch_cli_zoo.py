"""The zoo's entry points on the CPU: ``cli.train_zoo`` (two steps with the
ISW statistics phase, a resume that runs it again), ``cli.eval --trunk
--variant --wt-layer --ckpt`` against the in-process evaluator (equal
scores), ``cli.export --wt-layer --check`` (bit for bit), resume refused
across the zoo and MRFP recipes, one-step runs of the zoo's other trunks
and of iw code 5, and the flags that stay unported or cannot run (each
names its ROADMAP item)."""

import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrfp_tpu.models import deepv3_zoo as jax_zoo
from mrfp_tpu.nn import cov_settings as jax_cov
from mrfp_tpu_torch.cli import eval as cli_eval
from mrfp_tpu_torch.cli import export as cli_export
from mrfp_tpu_torch.cli import train as cli_train
from mrfp_tpu_torch.cli import train_zoo
from mrfp_tpu_torch.data import SyntheticDataset
from mrfp_tpu_torch.models.deepv3_zoo import DeepV3Plus
from mrfp_tpu_torch.nn.resnet import RESNET_TRUNKS
from mrfp_tpu_torch.train.evaluator import SegEvaluator

from torch_dist_group import REPO, env

torch.set_num_threads(2)

WT = ["0", "0", "2", "2", "2", "0", "0"]
ZOO = ["--device", "cpu", "--synthetic", "--trunk", "resnet-18", "--variant", "D32",
       "--batch-size", "2", "--crop-size", "64", "--log-every", "1"]


def _result(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def zoo_run(tmp_path_factory):
    """Two steps of the r18-D32 ISW recipe, then a resume to step 3; yields
    (run directory, the two results) and removes the run's checkpoints."""
    runs = str(tmp_path_factory.mktemp("zoo_runs"))
    results = []
    for max_iter in (2, 3):
        out = str(tmp_path_factory.getbasetemp() / f"zoo_{max_iter}.json")
        argv = ZOO + ["--wt-layer", *WT, "--use-wtloss", "--covstat-batches", "1",
                      "--clusters", "5", "--max-iter", str(max_iter), "--runs-dir", runs,
                      "--json-out", out]
        assert train_zoo.main(argv) == 0
        with open(out) as f:
            results.append(json.load(f))
    yield results[-1]["run_dir"], results
    shutil.rmtree(runs)


def test_cli_train_zoo_trains_resumes_and_logs_the_whitening_loss(zoo_run):
    run_dir, (first, second) = zoo_run
    assert first["step"] == 2 and sorted(int(s) for s in first["losses"]) == [1, 2]
    assert second["step"] == 3 and sorted(int(s) for s in second["losses"]) == [3]
    for res in (first, second):  # the statistics phase runs again on resume
        assert [m["dim"] for m in res["covstat"]["masks"]] == [64, 64, 128]
        assert all(m["nrc"] > 0 for m in res["covstat"]["masks"])
        assert all(np.isfinite(v) for v in res["losses"].values())
    rows = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    tags = {r["tag"] for r in rows}
    assert {"train/loss", "train/loss_main", "train/loss_aux", "train/loss_wt"} <= tags
    blob = torch.load(os.path.join(run_dir, "ckpt", "step_3.pt"), map_location="cpu",
                      weights_only=True)
    assert blob["recipe"] == {"source": "synthetic", "crop_size": 64, "seed": 0,
                              "mode": "zoo", "trunk": "resnet-18", "variant": "D32",
                              "wt_layer": [0, 0, 2, 2, 2, 0, 0], "use_wtloss": True,
                              "use_dsn": True}
    assert any(k.startswith("dsn.") for k in blob["model"])


def test_cli_eval_zoo_checkpoint_matches_the_in_process_evaluator(zoo_run):
    run_dir, _ = zoo_run
    argv = ["--device", "cpu", "--synthetic", "--synthetic-hw", "64", "96", "--max-images",
            "2", "--domains", "cityscapes", "--step-timeout", "0", "--trunk", "resnet-18",
            "--variant", "D32", "--wt-layer", *WT, "--ckpt", run_dir]
    got = cli_eval.main(argv)["cityscapes"]
    model = DeepV3Plus(trunk="resnet-18", variant="D32", wt_layer=tuple(map(int, WT)))
    blob = torch.load(os.path.join(run_dir, "ckpt", "step_3.pt"), map_location="cpu",
                      weights_only=True)
    model.load_state_dict(blob["model"], strict=True)
    ds = SyntheticDataset(length=4, hw=(64, 96))
    want = SegEvaluator(model.eval(), device=torch.device("cpu")).run(
        ds, max_images=2, log=lambda *a, **k: None)
    assert got["images"] == 2 and got["pixels"] == int(want["hist"].sum()) == 2 * 64 * 96
    assert (got["mean_iu"], got["acc"]) == (want["mean_iu"], want["acc"])
    # --arch names the same model: DeepR18V3PlusD is r18 at D, not D32
    arch = cli_eval.build_model(cli_eval.parse_args(["--arch", "DeepR18V3PlusD",
                                                     "--wt-layer", *WT]))
    assert (arch.trunk, arch.variant, arch.wt_layer) == ("resnet-18", "D", (0, 0, 2, 2, 2, 0, 0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cli_export_zoo_check_is_bit_exact_on_cpu(zoo_run, tmp_path, dtype):
    run_dir, _ = zoo_run
    out = str(tmp_path / "zoo.pt2x")
    try:
        res = cli_export.main(["--device", "cpu", "--height", "64", "--width", "64",
                               "--trunk", "resnet-18", "--variant", "D32", "--wt-layer", *WT,
                               "--ckpt", run_dir, "--dtype", dtype, "--check", "--out", out])
        assert "bit for bit" in res["check"]
        manifest = res["manifest"]
        assert manifest["model"] == {"zoo": "DeepV3Plus", "trunk": "resnet-18",
                                     "variant": "D32", "wt_layer": [0, 0, 2, 2, 2, 0, 0],
                                     "use_dsn": True}
        assert manifest["ops"] == ["mrfp::resize_bilinear"]
        assert manifest["output"]["shape"] == [1, 19, 64, 64]
    finally:
        if os.path.exists(out):
            os.unlink(out)


def test_resume_is_refused_across_the_zoo_and_mrfp_recipes(tmp_path, capsys):
    """A zoo run and an MRFP baseline run of one trunk, variant, plan, batch
    and rate share a run directory name; neither resumes the other's
    checkpoint."""
    plan = ["--wt-layer", "0", "0", "4", "4", "4", "0", "0"]
    mrfp = ["--device", "cpu", "--synthetic", "--trunk", "resnet-18", "--variant", "D32",
            "--mode", "baseline", "--batch-size", "2", "--crop-size", "64", "--max-iter", "1"]
    first = str(tmp_path / "zoo_first")
    assert train_zoo.main(ZOO + plan + ["--max-iter", "1", "--runs-dir", first]) == 0
    run = _result(capsys)["run_dir"]
    with pytest.raises(ValueError, match="refusing to resume"):
        cli_train.main(mrfp + ["--runs-dir", first])
    second = str(tmp_path / "mrfp_first")
    assert cli_train.main(mrfp + ["--runs-dir", second]) == 0
    assert os.path.basename(_result(capsys)["run_dir"]) == os.path.basename(run)
    with pytest.raises(ValueError, match="refusing to resume"):
        train_zoo.main(ZOO + plan + ["--max-iter", "2", "--runs-dir", second])
    shutil.rmtree(first)
    shutil.rmtree(second)


def test_irw_with_the_whitening_loss_fails_in_jax_and_is_refused_here(tmp_path):
    """ROADMAP C6: JAX's statistics pass calls ``set_variance_of_covariance``
    on an IRW layer, which has none; the port refuses the flags up front."""
    layers = jax_zoo.build_cov_layers("resnet-18", (0, 0, 1, 0, 0, 0, 0))
    assert isinstance(layers[0], jax_cov.CovMatrixIRW)
    with pytest.raises(AttributeError, match="set_variance_of_covariance"):
        jax_zoo.covstat_update(layers, [jnp.zeros((2, 4, 4, 64))])
    with pytest.raises(ValueError, match="ROADMAP C6"):
        train_zoo.main(ZOO + ["--wt-layer", "0", "0", "1", "0", "0", "0", "0", "--use-wtloss",
                              "--max-iter", "1", "--runs-dir", str(tmp_path)])


@pytest.mark.parametrize("flags,item", [
    (["--spatial-parallel", "2"], "two ranks"), (["--model-parallel", "2"], "two ranks"),
    (["--wt-layer", "0", "0", "5", "0", "0", "0", "0"], None),
    (["--trunk", "mobilenetv2"], None), (["--arch", "DeepShuffleNetV3PlusD"], None)])
def test_unported_zoo_flags_raise(tmp_path, capsys, flags, item):
    """Spatial and tensor parallelism, iw code 5, the MobileNetV2 trunk and
    a ShuffleNetV2 factory (refused until they were ported) train: one
    step each on the CPU, 48 px, a finite loss; with
    ``--spatial-parallel 2`` or ``--model-parallel 2`` on two ranks (gloo,
    a ``file://`` rendezvous), which log the same loss (and under a model
    axis end the step with the same replicated tensors)."""
    argv = ZOO + ["--crop-size", "48"] + flags + ["--max-iter", "1", "--runs-dir", str(tmp_path)]
    if item == "two ranks":
        procs = [subprocess.Popen(
            [sys.executable, "-m", "mrfp_tpu_torch.cli.train_zoo", *argv, "--num-processes",
             "2", "--process-id", str(r), "--coordinator-address", f"file://{tmp_path}/rdv"],
            cwd=REPO, env=env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        outs = [p.communicate(timeout=600) for p in procs]
        assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
        results = [json.loads(o[0].strip().splitlines()[-1]) for o in outs]
        assert results[0]["losses"] == results[1]["losses"]
        assert results[0].get("replicated_sha256") == results[1].get("replicated_sha256")
        assert ("replicated_sha256" in results[0]) == ("--model-parallel" in flags)
        assert results[0]["step"] == 1 and np.isfinite(results[0]["losses"]["1"])
        return
    assert train_zoo.main(argv) == 0
    result = _result(capsys)
    assert result["step"] == 1 and all(np.isfinite(v) for v in result["losses"].values())


def test_use_wtloss_with_unread_isw_slots_fails_in_jax_and_is_refused_here(tmp_path):
    """ROADMAP C11: MNASNet reads no wt_layer slot, so its forward collects
    no map; JAX's statistics pass then freezes a mask that saw no variance
    (``set_mask_matrix`` asserts). The port refuses the flags up front, and
    trains the same plan without ``--use-wtloss`` (the slots are ignored,
    as in JAX)."""
    layers = jax_zoo.build_cov_layers("mnasnet_05", (0, 0, 2, 0, 0, 0, 0))
    jax_zoo.covstat_update(layers, [])  # the pass over an empty w_arr
    with pytest.raises(AssertionError, match="covstat pass"):
        layers[0].set_mask_matrix()
    plan = ["--trunk", "mnasnet_05", "--variant", "D16", "--wt-layer", "0", "0", "2", "0",
            "0", "0", "0", "--crop-size", "48", "--max-iter", "1", "--runs-dir", str(tmp_path)]
    with pytest.raises(ValueError, match="ROADMAP C11"):
        train_zoo.main(ZOO + plan + ["--use-wtloss"])
    assert train_zoo.main(ZOO + plan) == 0


def test_cli_train_takes_the_nine_trunks():
    """``cli.train --trunk`` passes its checks for every ResNet trunk and
    raises the JAX package's ValueError for a zoo-only trunk; resnet-101
    with the OC branch (the MRFP+ recipe) names ROADMAP C8 when its model
    is built."""
    for trunk in RESNET_TRUNKS:
        cli_train.check_args(cli_train.parse_args(["--trunk", trunk]))
    with pytest.raises(ValueError, match="zoo trunks live in models.deepv3_zoo"):
        cli_train.check_args(cli_train.parse_args(["--trunk", "mobilenetv2"]))
    cfg = cli_train.build_config(cli_train.parse_args(["--trunk", "resnet-101"]))
    with pytest.raises(ValueError, match="ROADMAP C8"):
        cli_train.build_state(cfg, torch.device("cpu"))
