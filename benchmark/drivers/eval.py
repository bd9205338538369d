"""The evaluation sweep: the port's ``SegEvaluator.run`` over in-memory pools
of seed-made uint8 images and labels at the traffic's shapes.

The window calls ``run`` on one sweep of ``sweep_images`` images after
another (each sweep is what ``cli.eval`` does for a domain: its images
stream to the card, the confusion matrix accumulates there, and the
histogram comes back at its end) until ``seconds`` have passed; the rate
is every image of every sweep over the window's wall time.

For the comparison the predictions of ``sampled_sweeps`` sweeps, drawn
from the seed among the first ones, are kept where the evaluator makes
them (the argument it hands ``confusion_matrix_update``), each copied as
uint8 into its slot of a pinned host buffer made in set-up, so the
card's peak is the evaluator's; after the window every kept image is
counted (``unkept``: all of the sampled sweeps' images, exactly), those
sweeps' histograms are held against a count of their predictions and
labels (exactly), and the reference's fp32 logits of each kept image
against the prediction (``logit_gap``).
"""

from __future__ import annotations

import gc
import importlib
import time
from typing import Dict

import numpy as np
import torch

from benchmark import inputs, trace
from benchmark.harness import Measurement, device_peak_bytes, synchronize


class Pool:
    """A domain for ``SegEvaluator.run``: images ``[start, start + n)`` of
    the host pool, wrapping, as numpy (HWC uint8, HW uint8)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, start: int, n: int):
        self.images, self.labels, self.start, self.n = images, labels, start, n
        self.name = "pool"

    def __len__(self) -> int:
        return self.n

    def index(self, i: int) -> int:
        return (self.start + i) % self.images.shape[0]

    def __getitem__(self, i: int):
        k = self.index(i)
        return {"image": self.images[k], "label": self.labels[k]}


def run(m: Measurement) -> None:
    cfg, traffic, device = m.config, m.traffic, m.device
    program = importlib.import_module(f"benchmark.programs.{cfg['program']}")
    reference = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    from mrfp_tpu_torch.train import evaluator as ev
    if device.type == "cuda":  # the reference protocol: fp32 with TF32 off
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    hw = tuple(traffic["height_width"])
    img_t, lbl_t = inputs.pool(traffic["pool_images"], hw, cfg["model"]["num_classes"],
                               traffic, m.seed, device, pinned=False)
    images, labels = img_t.numpy(), lbl_t.numpy()
    m.phase("pool")
    model = program.build_eval(cfg, inputs.weights(reference.template(cfg, False), m.seed,
                                                   device), device)
    m.phase("program built")
    evaluator = ev.SegEvaluator(model, num_classes=cfg["model"]["num_classes"],
                                eval_batch=cfg["eval"]["eval_batch"], device=device)
    per_sweep = traffic["sweep_images"]
    rng = np.random.default_rng(inputs.role_seed(m.seed, "sample"))
    sampled = set(rng.choice(traffic["sample_among"], traffic["sampled_sweeps"],
                             replace=False).tolist())
    base = {i: k * per_sweep for k, i in enumerate(sorted(sampled))}  # each one's first slot
    host = torch.empty((len(sampled) * per_sweep, *hw), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    kept: Dict[int, int] = {}  # predictions handed over in each sampled sweep
    results: Dict[int, np.ndarray] = {}
    update = ev.confusion_matrix_update
    sweep = {"index": 0, "keep": None}

    def keeping(hist, pred, label, num_classes, impl=None):
        i = sweep["keep"]
        if i is not None:
            for row in pred.reshape(-1, *hw):
                if kept[i] < per_sweep:
                    host[base[i] + kept[i]].copy_(row.to(torch.uint8), non_blocking=True)
                kept[i] += 1
        return update(hist, pred, label, num_classes, impl)

    ev.confusion_matrix_update = keeping

    def sweeps(count: int = 0, until: float = 0.0) -> int:
        """One sweep of ``count`` images, or sweeps of ``sweep_images``
        until ``until`` seconds have passed and the sampled ones have run."""
        t0, done = time.perf_counter(), 0
        while (count and done < count) or (until and time.perf_counter() - t0 < until) \
                or (until and sweep["index"] < traffic["sample_among"] + 1):
            i = sweep["index"]
            size = count or per_sweep
            sweep["keep"] = i if i in sampled and not count else None
            if sweep["keep"] is not None:
                kept[i] = 0
            res = evaluator.run(Pool(images, labels, i * per_sweep, size),
                                log=lambda *a, **k: None)
            if sweep["keep"] is not None:
                results[i] = np.asarray(res["hist"])
            m.attempted += size
            m.failed += int(res["dropped"])
            sweep["index"] += 1
            done += size
        return done

    try:
        sweeps(count=traffic["warmup_images"])
        m.attempted = m.failed = 0
        kept.clear()
        results.clear()
        sweep["index"] = 0
        synchronize(device)
        m.phase("warm-up")
        m.setup_s = time.perf_counter() - m.started
        m.print_nvidia_smi("before the window")
        from mrfp_tpu_torch.ops import _build
        _build.reset_launches()
        t0 = time.perf_counter()
        m.images = sweeps(until=m.seconds)
        synchronize(device)
        m.window_s = time.perf_counter() - t0
        m.launches = dict(_build.LAUNCHES)
        m.print_nvidia_smi("after the window")
        if m.trace:
            m.profile = trace.profiled(lambda: sweeps(count=traffic["profile_images"]),
                                       lambda: synchronize(device), m.trace_path)
            m.profiled_images = traffic["profile_images"]
    finally:
        ev.confusion_matrix_update = update
    m.peak_bytes = device_peak_bytes(device)
    del evaluator, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    m.checks = compare(cfg, reference, m.seed, device, images, labels, per_sweep,
                       {i: (kept.get(i, 0), host[base[i]:base[i] + per_sweep]) for i in sampled},
                       results, m.limits)


def compare(cfg, reference, seed, device, images, labels, per_sweep, kept, results, limits):
    """``kept``: each sampled sweep's count of predictions handed over and
    its slots. ``unkept``: over the sampled sweeps, how far the count of
    kept predictions lies from the sweep's images (0: every image, once).
    ``hist``: the summed absolute difference between each sampled sweep's
    histogram and the count of its kept predictions against its labels (0:
    exact). ``logit_gap``: over the kept images' pixels, the widest gap by
    which the logit of the predicted class lies below the reference's best,
    over the reference logits' standard deviation in that image."""
    classes = cfg["model"]["num_classes"]
    unkept, hist_gap, gap = 0, 0, 0.0
    order = []
    for i, (handed, slots) in sorted(kept.items()):
        unkept += abs(handed - per_sweep)
        if i not in results:
            continue
        pool = Pool(images, labels, i * per_sweep, per_sweep)
        count = np.zeros((classes, classes), np.int64)
        for j, pred in enumerate(slots[:min(handed, per_sweep)]):
            lbl = labels[pool.index(j)].astype(np.int64).ravel()
            p = pred.numpy().astype(np.int64).ravel()
            ok = lbl < classes
            count += np.bincount(classes * lbl[ok] + p[ok], minlength=classes ** 2
                                 ).reshape(classes, classes)
            order.append((pool.index(j), pred))
        hist_gap += int(np.abs(count - results[i]).sum())
    xs = (torch.from_numpy(images[k]).to(device).permute(2, 0, 1)[None].float()
          for k, _ in order)
    for (k, pred), logits in zip(order, reference.eval_logits(cfg, seed, xs, device)):
        lg = logits[0]
        best = lg.max(dim=0).values
        got = lg.gather(0, pred.long().to(device)[None].view(1, *lg.shape[1:]))[0]
        gap = max(gap, float((best - got).max() / lg.std()))
    checks = {"unkept": unkept, "hist": hist_gap, "logit_gap": gap}
    return {k: {"value": float(v), "limit": limits.get(k)} for k, v in checks.items()}


def control(cfg: dict, traffic: dict, seed: int, device, rounding=None, half: bool = False
            ) -> Dict[str, dict]:
    """The reference put in the program's place, its conv operands rounded
    to ``rounding``: the gap of its predictions on the distinct images of
    a sweep (the pool's, wrapping as a sweep does) against the plain
    reference's logits."""
    reference = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    hw = tuple(traffic["height_width"])
    img_t, _ = inputs.pool(traffic["pool_images"], hw, cfg["model"]["num_classes"], traffic,
                           seed, device, pinned=False)
    xs = [img_t[k].to(device).permute(2, 0, 1)[None].float()
          for k in range(min(traffic["sweep_images"], img_t.shape[0]))]
    gap = 0.0
    for x in xs:
        (low,) = list(reference.eval_logits(cfg, seed, [x], device, rounding))
        (lg,) = list(reference.eval_logits(cfg, seed, [x], device))
        lg = lg[0]
        got = lg.gather(0, low.argmax(dim=1))[0]
        gap = max(gap, float((lg.max(dim=0).values - got).max() / lg.std()))
    return {"logit_gap": {"value": gap, "limit": None}}
