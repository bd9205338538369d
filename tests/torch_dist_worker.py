"""One rank of a CPU process group of the data-parallel tests
(``torch_dist_group.Group``):

    python tests/torch_dist_worker.py JOB RANK WORLD RENDEZVOUS OUT [CASES]

joins the gloo group at RENDEZVOUS (a ``file://`` path), runs each case of
the JOB file (``{name: (case function of the module CASES, by default
torch_dist_cases, kwargs)}``) in order, and writes
``OUT/<name>.rank<RANK>.pt`` (whole, by a rename). Rank 0 writes the
whole result; the other ranks write their rows, and for the
steps' gradients and states a SHA-256 of every tensor instead, which must
equal rank 0's. A step's result takes ~330 MB, so rank 0 writes the next
one only once the test has read and removed the last: one is on disk at a
time.
"""

from __future__ import annotations

import importlib
import os
import sys
import time
from pathlib import Path

import torch

TESTS = Path(__file__).resolve().parent
sys.path[:0] = [str(TESTS.parent), str(TESTS)]

from mrfp_tpu_torch.parallel.dist import initialize_distributed  # noqa: E402
from torch_dist_cases import digest  # noqa: E402


def _digested(res):
    """``res`` with the tensors under ``grads`` and ``state`` hashed."""
    return {k: ({name: digest(t) for name, t in v.items()}
                if k in ("grads", "state") else v) for k, v in res.items()}


def _write(res, path: str, large: bool, wait_s: float = 900.0) -> None:
    """``res`` to ``path`` by a rename; a ``large`` one once no other is
    left in the directory (each marked by ``<path>.large``, which the test
    removes with the result)."""
    out = os.path.dirname(path)
    if large:
        deadline = time.monotonic() + wait_s
        while any(f.endswith(".large") for f in os.listdir(out)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{out}: the last large result was never read")
            time.sleep(0.2)
        open(path + ".large", "w").close()
    torch.save(res, path + ".tmp")
    os.replace(path + ".tmp", path)


def main(job: str, rank: str, world: str, rendezvous: str, out: str,
         cases: str = "torch_dist_cases") -> None:
    cases = importlib.import_module(cases)
    torch.set_num_threads(1)
    initialize_distributed(rendezvous, int(world), int(rank), "cpu", timeout_s=600)
    try:
        for name, (case, kwargs) in torch.load(job, weights_only=True).items():
            res = getattr(cases, case)(**kwargs)
            path = f"{out}/{name}.rank{rank}.pt"
            if rank == "0":
                _write(res, path, large="grads" in res or "state" in res)
            else:
                _write(_digested(res), path, large=False)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
