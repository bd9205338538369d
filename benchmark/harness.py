"""One run of one cell: the manifest, the cell's files found by name, the
driver, the metric readers and the result line.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration and a
traffic mix. The harness finds ``configs/<config>.json``,
``traffic/<traffic>.json`` (whose ``driver`` names ``drivers/<driver>.py``),
``limits/<workload>.json`` (the limit of each number that decides
``correct``) and one reader a metric, ``metrics/<metric>.py``, whose
``read(measurement)`` returns the metric's value or None where it finds
nothing to read. A new cell, mix or metric is new files and new entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mrfp_tpu")


@dataclasses.dataclass
class Measurement:
    """What a driver measures in one run, for the metric readers."""
    workload: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float
    trace_path: Optional[Path] = None
    setup_s: float = 0.0
    window_s: float = 0.0
    images: int = 0
    attempted: int = 0
    failed: int = 0
    step_ms: List[float] = dataclasses.field(default_factory=list)
    gates: List[tuple] = dataclasses.field(default_factory=list)
    losses: list = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    profile: object = None
    profile_gates: List[tuple] = dataclasses.field(default_factory=list)
    profiled_images: int = 0
    checks: Dict[str, dict] = dataclasses.field(default_factory=dict)

    def phase(self, name: str) -> None:
        """Print the seconds since the process started at the end of a
        set-up phase (on stderr)."""
        print(f"set-up: {name} done at {time.perf_counter() - self.started:.3f} s",
              file=sys.stderr)

    def reference(self):
        return importlib.import_module(f"benchmark.reference.{self.config['reference']}")

    def print_nvidia_smi(self, when: str) -> None:
        """The card's name, clocks, power and power limit, on stderr."""
        if self.device.type != "cuda":
            return
        fields = "name,power.limit,power.draw,clocks.sm,clocks.mem,temperature.gpu"
        try:
            out = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=20).stdout.strip().splitlines()
        except (OSError, subprocess.TimeoutExpired) as err:
            out = [f"nvidia-smi: {err}"]
        line = out[self.device.index or 0] if out else "nvidia-smi: no output"
        print(f"nvidia-smi {when} ({fields}): {line}", file=sys.stderr)


class Timer:
    """Step boundaries: a CUDA event at each on the current stream (host
    clock on the CPU), read after the window."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        synchronize(device)
        self.device = device
        self.t0 = time.perf_counter()
        self.marks = [self._now()]

    def _now(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def mark(self) -> None:
        self.marks.append(self._now())

    def stop(self) -> float:
        synchronize(self.device)
        return time.perf_counter() - self.t0

    def intervals_ms(self) -> List[float]:
        if not self.cuda:
            return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]
        return [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_peak_bytes(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def reader(name: str):
    """``metrics/<name>.py`` (a metric's name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics_of(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (``trace`` False) or per-layer ones."""
    if not trace:
        return [e for e in bench["end_to_end"] if workload in e.get("workloads", [workload])]
    e2e = {e["name"] for e in metrics_of(bench, workload, False)}
    return [p for p in bench["per_layer"]
            if workload in p.get("workloads", [workload] if p["moves"] in e2e else [])]


def measure(workload: str, seed: int, seconds: float, trace: bool, device: torch.device,
            started: float, overrides: Optional[dict] = None) -> Measurement:
    """Run the cell once on ``device``; ``overrides`` (the harness's own
    tests only) replace entries of the configuration and the traffic."""
    bench = manifest()
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg = load_json("configs", cell["config"])
    traffic = load_json("traffic", cell["traffic"])
    limits = load_json("limits", workload)
    for key, value in (overrides or {}).items():
        section, _, leaf = key.rpartition(".")
        (traffic if section == "traffic" else cfg[section])[leaf] = value
    m = Measurement(workload=workload, config=cfg, traffic=traffic, limits=limits, seed=seed,
                    seconds=seconds, trace=trace, device=device, started=started,
                    trace_path=HERE / "out" / f"trace_{workload}.json")
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    driver.run(m)
    return m


def result(m: Measurement) -> dict:
    """The result line: the cell's metrics as their readers find them, the
    device, the breakdown of a traced run, and last the compared numbers
    beside their limits."""
    bench = manifest()
    metrics = {}
    for spec in metrics_of(bench, m.workload, m.trace):
        value = reader(spec["name"]).read(m)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    device = {"platform": "gpu" if m.device.type == "cuda" else m.device.type,
              "kind": torch.cuda.get_device_name(m.device) if m.device.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(m.peak_bytes)}
    out = {"correct": is_correct(m), "attempted": int(m.attempted), "failed": int(m.failed),
           "metrics": metrics, "device": device}
    if m.trace and m.profile is not None:
        device["busy_s"] = float(m.profile.busy_s())
        device["window_s"] = float(m.profile.window_s)
        out["breakdown"] = m.profile.breakdown()
    out["checks"] = {k: v for k, v in m.checks.items() if v["limit"] is not None}
    return out


def is_correct(m: Measurement) -> bool:
    judged = [v for v in m.checks.values() if v["limit"] is not None]
    return (bool(judged) and m.failed == 0
            and all(v["value"] == v["value"] and v["value"] <= v["limit"] for v in judged))


def forbidden_modules() -> List[str]:
    return sorted(name for name in sys.modules if name.split(".")[0] in FORBIDDEN)
