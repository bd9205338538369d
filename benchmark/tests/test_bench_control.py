"""The control at a size a CPU holds: the reference in the precision just
below the configuration's (FP8 for the bf16 training cells, TF32 for the
fp32 eval), put in the program's place, fails at least one of the cell's
limits. On the card, at the cells' own sizes, ``benchmark/calibrate.py``
reads it on three seeds (the readings in PERF.md), and
``test_bench_card.py`` checks it."""

import copy
import importlib

import pytest
import torch

from benchmark import harness
from benchmark.calibrate import CONTROL
from benchmark.tests.conftest import SMALL


@pytest.mark.parametrize("workload", [w["name"] for w in harness.manifest()["workloads"]])
def test_the_control_fails_the_cell(workload):
    cell = next(w for w in harness.manifest()["workloads"] if w["name"] == workload)
    cfg = copy.deepcopy(harness.load_json("configs", cell["config"]))
    traffic = harness.load_json("traffic", cell["traffic"])
    kind = traffic["driver"]
    for key, value in SMALL[kind].items():
        section, _, leaf = key.rpartition(".")
        (traffic if section == "traffic" else cfg[section])[leaf] = value
    if kind == "eval":  # a widest gap over pixels: enough of them for one to show
        traffic.update(height_width=[256, 512], sweep_images=4)
    else:  # at 64 px the trunk's last maps are 4x4, too few for FP8's scales to show
        cfg["train"]["crop_size"] = 128
    limits = harness.load_json("limits", workload)
    driver = importlib.import_module(f"benchmark.drivers.{kind}")
    dtype = cfg["train"]["compute_dtype"] if kind == "train" else cfg["eval"]["dtype"]
    checks = driver.control(cfg, traffic, 2 ** 32 + 3, torch.device("cpu"), CONTROL[dtype])
    failed = {k: v["value"] for k, v in checks.items() if k in limits and v["value"] > limits[k]}
    assert failed, (checks, limits)
