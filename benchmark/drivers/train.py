"""The training window: the cell's train step, back to back, on batches from a
pinned pool of seed-made images and labels.

Set-up builds one train state from the seed's weights, runs the
configuration's own preparation (the ISW statistics pass), then the three
steps that the reference follows (``Trainer.checked``, batches 0-2 of the
pool, every row different) and the warm-up steps, all through the step the
window calls; the window then runs ``Trainer.window`` steps until
``seconds`` have passed, each batch copied from the pinned pool by the
port's ``utils/transfer.to_device``. A CUDA event at every step boundary
gives each step's device time; the window's rate is all its images over
its wall time, which ends with a synchronize.

After the window (and the profiled sub-window of a traced run) the peak
memory is read, the program is freed, and the reference runs its three
steps from the same seed, with the answers of the program's set-up that
its steps follow (``Trainer.readings``: the ISW masks); ``compare`` turns
the two sets of readings into the numbers held against the cell's limits.
"""

from __future__ import annotations

import gc
import importlib
import statistics
import sys
import time
from typing import Dict

import numpy as np
import torch

from benchmark import inputs, trace
from benchmark.harness import Measurement, Timer, device_peak_bytes, synchronize

CHECKED = 3


def batch(pool, k: int, n: int, device):
    """Batch ``k`` of ``n`` rows of the pool, wrapping, copied by the port."""
    from mrfp_tpu_torch.utils.transfer import to_device
    images, labels = pool
    rows = images.shape[0] // n
    i = (k % rows) * n
    return to_device(images[i:i + n], device), to_device(labels[i:i + n], device)


def reference_batches(pool, n: int, device):
    images, labels = pool
    return [(images[k * n:(k + 1) * n].to(device).permute(0, 3, 1, 2).float().contiguous(),
             labels[k * n:(k + 1) * n].to(device).long()) for k in range(CHECKED)]


def leaf_grads(model) -> Dict[str, torch.Tensor]:
    """Each trainable leaf's gradient, fp32 on the host."""
    return {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()
            if p.requires_grad}


def run(m: Measurement) -> None:
    cfg, traffic, device = m.config, m.traffic, m.device
    program = importlib.import_module(f"benchmark.programs.{cfg['program']}")
    reference = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    t = cfg["train"]
    n, side = t["batch_size"], t["crop_size"]
    template = reference.template(cfg, True)
    pool = inputs.pool(n * traffic["pool_batches"], (side, side), cfg["model"]["num_classes"],
                       traffic, m.seed, device, pinned=device.type == "cuda")
    m.phase("weights and pool")
    trainer = program.Trainer(cfg, inputs.weights(template, m.seed, device), m.seed, device,
                              pool)
    m.phase("program built, its preparation")
    model = trainer.state.model
    readings: Dict[str, object] = {"parts": []}
    for k in range(CHECKED):
        out = trainer.checked(*batch(pool, k, n, device), k)
        readings["parts"].append({key: out[key] for key in out if key.startswith("loss")})
        if k == 0:
            readings["grad"] = leaf_grads(model)
    start = inputs.weights(template, m.seed, device)
    readings["change"] = {name: (p.detach() - start[name]).float().cpu()
                          for name, p in model.named_parameters() if p.requires_grad}
    del start
    readings["parts"] = [{k: float(v) for k, v in p.items()} for p in readings["parts"]]
    readings.update(trainer.readings())
    m.phase("checked steps")
    block = trainer.block
    at = {"batch": CHECKED, "gate": 0}  # the next pool batch, the next gate of the schedule

    def steps(count: int = 0, until: float = 0.0, timer: Timer = None):
        """Window steps: ``count`` of them, or until ``until`` seconds have
        passed and the gate schedule is at the end of a block, so every
        window holds whole blocks (each gate combination equally often)."""
        t0 = time.perf_counter()
        done = 0
        while (count and done < count) or (
                until and (time.perf_counter() - t0 < until or at["gate"] % block)):
            out = trainer.window(*batch(pool, at["batch"], n, device), at["batch"],
                                 trainer.gates(at["gate"]))
            if timer is not None:
                timer.mark()
                m.gates.append((bool(out["gate_oc"]), bool(out["gate_np"]),
                                bool(out["gate_dec"])))
                m.losses.append(out["loss"])
            at["batch"] += 1
            at["gate"] += 1
            done += 1

    steps(count=traffic["warmup_steps"])
    at["gate"] = 0  # the window starts a block
    synchronize(device)
    m.phase("warm-up")
    m.setup_s = time.perf_counter() - m.started
    m.print_nvidia_smi("before the window")
    from mrfp_tpu_torch.ops import _build
    _build.reset_launches()
    timer = Timer(device)
    steps(until=m.seconds, timer=timer)
    m.window_s = timer.stop()
    m.step_ms = timer.intervals_ms()
    m.images = n * len(m.step_ms)
    m.launches = dict(_build.LAUNCHES)
    m.print_nvidia_smi("after the window")
    m.attempted = len(m.losses)
    m.failed = sum(1 for v in torch.stack(m.losses).float().cpu().tolist()
                   if v != v or abs(v) == float("inf"))
    if m.trace:
        first = len(m.gates)
        m.profile = trace.profiled(
            lambda: steps(count=traffic["profile_steps"], timer=Timer(device)),
            lambda: synchronize(device), m.trace_path)
        m.profile_gates = m.gates[first:]
        m.profiled_images = n * traffic["profile_steps"]
        del m.gates[first:]
    m.peak_bytes = device_peak_bytes(device)
    del trainer, model, m.losses[:]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = reference.train_readings(cfg, m.seed, reference_batches(pool, n, device), device,
                                   pool=pool, given=readings)
    print(f"reference: {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    m.checks = compare(readings, ref, m.limits)


def compare(prog: dict, ref: dict, limits: dict) -> Dict[str, dict]:
    """The comparison's numbers (each a gap, 0 when equal); those with a
    limit in ``limits/<cell>.json`` decide ``correct`` (PERF.md gives the
    readings each limit was set from):

    - ``loss``: the largest relative gap of a step's loss over the 3 steps;
      ``loss_first``: the first step's alone; ``loss_<part>``: the same of
      each part of the objective the reference reports (the zoo's main,
      DSN and whitening terms);
    - ``grad``: over the leaves, the gap between the program's and the
      reference's norm of the first step's gradient, over the larger of
      the reference's norm of that leaf and of the median leaf (the worst
      leaf); ``grad_median``: the median leaf's; ``grad_diff`` and
      ``grad_diff_median``: the norm of their difference over the same
      scale, worst and median leaf;
    - ``change`` (and ``_median``, ``_diff``, ``_diff_median``): the same of
      each leaf's change over the 3 steps;
    - where the configuration has a statistics pass (the ISW masks, which
      the reference's steps take from the program): ``cov_var``, over the
      whitened maps, the norm of the difference between the program's and
      the reference's variances of covariance over the reference's norm;
      ``masks``, the share of the mask entries that differ between the
      program's and the reference's k-means of the program's variances,
      over the entries either selects (0: exact).

    Leaves whose reference gradient is under a thousandth of the median
    leaf's (nought to rounding: a BatchNorm shift before an InstanceNorm)
    are left out of ``grad`` and ``change``."""
    gaps = {part: max(_relative(p[part], r[part]) for p, r in zip(prog["parts"], ref["parts"]))
            for part in ref["parts"][0]}
    gaps["loss_first"] = _relative(prog["parts"][0]["loss"], ref["parts"][0]["loss"])
    grad_norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref["grad"].items()}
    med = statistics.median(grad_norms.values())
    kept = [k for k, v in grad_norms.items() if v >= 1e-3 * med]
    for key in ("grad", "change"):
        norm = {k: float(torch.linalg.vector_norm(ref[key][k].double())) for k in kept}
        scale = {k: max(norm[k], statistics.median(norm.values())) for k in kept}
        by_norm = [abs(float(torch.linalg.vector_norm(prog[key][k].double())) - norm[k])
                   / scale[k] for k in kept]
        by_diff = [float(torch.linalg.vector_norm((prog[key][k] - ref[key][k]).double()))
                   / scale[k] for k in kept]
        gaps[key], gaps[f"{key}_median"] = max(by_norm), statistics.median(by_norm)
        gaps[f"{key}_diff"], gaps[f"{key}_diff_median"] = max(by_diff), statistics.median(by_diff)
        worst = max(range(len(kept)), key=by_norm.__getitem__)
        print(f"{key}: worst leaf {kept[worst]}", file=sys.stderr)
    if "variances" in ref:
        gaps["cov_var"] = max(
            float(np.linalg.norm(np.asarray(p, np.float64) - r) / np.linalg.norm(r))
            for p, r in zip(prog["variances"], ref["variances"]))
        gaps["masks"] = max(_mask_gap(a, b) for a, b in zip(prog["masks"], ref["masks"]))
    return {k: {"value": float(v), "limit": limits.get(k)} for k, v in gaps.items()}


def _relative(p: float, r: float) -> float:
    return abs(p - r) / abs(r) if r else (0.0 if p == r else float("inf"))


def _mask_gap(a, b) -> float:
    a, b = np.asarray(a) > 0.5, np.asarray(b) > 0.5
    union = (a | b).sum()
    return float((a ^ b).sum() / max(union, 1))


def control(cfg: dict, traffic: dict, seed: int, device, rounding=None, half: bool = False
            ) -> Dict[str, dict]:
    """The comparison's other readings, for its limits: the reference put in
    the program's place, its conv operands rounded to ``rounding``, or
    stepping on the first half of each batch (``half``), against the plain
    reference on the same seed, which takes its statistics pass's masks as
    it takes the program's."""
    reference = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    n, side = cfg["train"]["batch_size"], cfg["train"]["crop_size"]
    pool = inputs.pool(n * traffic["pool_batches"], (side, side), cfg["model"]["num_classes"],
                       traffic, seed, device, pinned=False)
    batches = reference_batches(pool, n, device)
    steps = [(x[:n // 2], y[:n // 2]) for x, y in batches] if half else batches
    other = reference.train_readings(cfg, seed, steps, device, rounding=rounding, pool=pool)
    ref = reference.train_readings(cfg, seed, batches, device, pool=pool, given=other)
    return compare(other, ref, {})
