"""Run directory, log file and JSONL metric stream (mrfp_tpu/utils/experiment.py).

A copy of the JAX package's harness without its jax imports. Every scalar
goes to two sinks: the JSONL stream ``metrics.jsonl`` and a TensorBoard
event file under ``tb/`` (``utils/tbevents.py``; ``tensorboard --logdir
<run>/tb``). One difference: the run's name leaves out ``max_iter``, so a
run extended with a larger ``--max-iter`` finds its own checkpoints and
resumes. Under data parallelism only the coordinator writes the log file
and the two metric sinks (an event file takes one writer); the other ranks
log to their own stderr and write nothing into the run directory but its
``ckpt/``.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
from typing import Any, Dict, Optional

from mrfp_tpu_torch.utils.tbevents import TBEventWriter


def make_exp_name(cfg) -> str:
    """Compact run name from the salient knobs (misc.py:24-63 spirit)."""
    m, p, t = cfg.model, cfg.perturb, cfg.train
    bits = [m.trunk.replace("-", ""), m.variant,
            "wt" + "".join(str(x) for x in m.wt_layer)]
    if p.enabled:
        bits.append(f"mrfp{'p' if m.hrfp_plus else ''}")
    bits += [f"bs{cfg.data.batch_size}", f"lr{t.lr:g}"]
    return "_".join(bits)


class NullWriter:
    """A ``MetricWriter`` that writes nothing (the non-coordinator ranks')."""

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def close(self) -> None:
        pass


class MetricWriter:
    """Scalars as JSON lines, ``{"tag", "value", "step"}``, line-buffered,
    and, with ``tb_dir``, as TensorBoard events in a file there."""

    def __init__(self, path: str, tb_dir: Optional[str] = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self._tb = TBEventWriter(tb_dir) if tb_dir is not None else None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step)}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


def prep_experiment(cfg, root: str = "./runs", coordinator: bool = True) -> Dict[str, Any]:
    """Create ``root/<name>/ckpt``, a log file beside it, and the metric
    writer; returns ``{"name", "exp_dir", "ckpt_dir", "writer",
    "log_handler"}``. Without ``coordinator``: the directories only, a
    ``NullWriter`` and a handler that writes nothing."""
    name = make_exp_name(cfg)
    exp_dir = os.path.join(root, name)
    ckpt_dir = os.path.join(exp_dir, "ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    if not coordinator:
        return {"name": name, "exp_dir": exp_dir, "ckpt_dir": ckpt_dir,
                "writer": NullWriter(), "log_handler": logging.NullHandler()}
    stamp = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    handler = logging.FileHandler(os.path.join(exp_dir, f"log_{stamp}.log"), mode="w")
    handler.setFormatter(logging.Formatter("%(asctime)s.%(msecs)03d %(message)s",
                                           datefmt="%m-%d %H:%M:%S"))
    logging.getLogger("").addHandler(handler)
    return {"name": name, "exp_dir": exp_dir, "ckpt_dir": ckpt_dir,
            "writer": MetricWriter(os.path.join(exp_dir, "metrics.jsonl"),
                                   tb_dir=os.path.join(exp_dir, "tb")),
            "log_handler": handler}
