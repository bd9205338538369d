"""A CPU process group of the port's data-parallel tests: the ranks of
``torch_dist_worker.py`` (file rendezvous, gloo, one torch thread each)
run every case of a job once for the test module, and the tests read the
ranks' results case by case."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_dist_worker.py"


def env() -> dict:
    """The ranks' environment: one OpenMP thread, the repo importable."""
    out = dict(os.environ, OMP_NUM_THREADS="1")
    out["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([out["PYTHONPATH"]] if out.get("PYTHONPATH") else []))
    return out


class Group:
    """The module's process group: its ``world`` ranks start at once and
    write each case's result (a function of the module ``cases``) as they
    finish it; ``result`` waits for one (the whole group within
    ``timeout`` s), ``take`` reads a case and removes its files, so the
    ranks can write the next large one."""

    def __init__(self, job: dict, directory: Path, cases: str = "torch_dist_cases",
                 world: int = 2, timeout: float = 900.0):
        self.job, self.dir, self.world = job, directory, world
        torch.save(job, directory / "job.pt")
        self.logs = [directory / f"rank{r}.log" for r in range(world)]
        self.procs = []
        for r, log in enumerate(self.logs):
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(WORKER), str(directory / "job.pt"), str(r),
                     str(world), f"file://{directory / 'rendezvous'}", str(directory), cases],
                    cwd=REPO, env=env(), stdout=f, stderr=subprocess.STDOUT))
        self.deadline = time.monotonic() + timeout

    def result(self, name: str, rank: int):
        # the tests read the cases in the job's order: a large result before
        # this one that is still here was deselected, and would hold the ranks
        for earlier in list(self.job)[:list(self.job).index(name)]:
            if (self.dir / f"{earlier}.rank0.pt.large").exists() and \
                    (self.dir / f"{earlier}.rank0.pt").exists():
                self.take(earlier)
        path = self.dir / f"{name}.rank{rank}.pt"
        while not path.exists():
            failed = [p.returncode for p in self.procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > self.deadline or \
                    all(p.poll() is not None for p in self.procs):
                self.close(keep_logs=True)
                raise AssertionError(f"{name}: no result from rank {rank} (exit codes "
                                     f"{[p.poll() for p in self.procs]}):\n" + "\n".join(
                                         log.read_text()[-3000:] for log in self.logs))
            time.sleep(0.2)
        return torch.load(path, weights_only=True)

    def take(self, name: str) -> list:
        """Every rank's result of ``name``; its files removed."""
        got = [self.result(name, r) for r in range(self.world)]
        for r in range(self.world):
            for suffix in ("", ".large"):
                (self.dir / f"{name}.rank{r}.pt{suffix}").unlink(missing_ok=True)
        return got

    def close(self, keep_logs: bool = False) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if not keep_logs:
            shutil.rmtree(self.dir, ignore_errors=True)
