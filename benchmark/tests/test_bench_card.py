"""On the card, at each cell's own size: a run of the cell is correct, and
the control (the reference in the precision just below the
configuration's, put in the program's place) fails at least one of the
cell's limits. ``python -m pytest benchmark/tests -m card`` on the chip;
skipped without a card."""

import importlib
import time

import pytest

from benchmark import harness
from benchmark.calibrate import CONTROL

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_cell_passes_and_its_control_fails(workload, cuda_device):
    m = harness.measure(workload, 4_000_000_007, 2.0, False, cuda_device, time.perf_counter())
    assert harness.is_correct(m), m.checks
    cell = next(w for w in harness.manifest()["workloads"] if w["name"] == workload)
    cfg = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    dtype = cfg["train"]["compute_dtype"] if traffic["driver"] == "train" else cfg["eval"]["dtype"]
    checks = driver.control(cfg, traffic, 4_000_000_007, cuda_device, CONTROL[dtype])
    judged = {k: v["value"] for k, v in checks.items() if k in m.limits}
    assert any(v > m.limits[k] for k, v in judged.items()), (judged, m.limits)
