"""Supervisor, PyTorch port (mrfp_tpu/cli/supervise.py): relaunch a
training command when it exits restartably.

The step watchdog (``utils/watchdog.py``) turns a wedged device call into
exit 75 (EX_TEMPFAIL), and the trainer's checkpoints (and
``--snapshot-every``) make every relaunch a resume; this wrapper closes the
loop by relaunching the command until it succeeds, fails for real, or
exhausts its restart budget:

    python -m mrfp_tpu_torch.cli.supervise --max-restarts 20 -- \
        python -m mrfp_tpu_torch.cli.train --source gtav ... --step-timeout 900

Policy, as the JAX package's:
- exit 0: done, exit 0.
- exit 75 (the watchdog's, or a preempted run's) or death by SIGKILL (an
  OOM-killed or operator-killed job is worth one retry): sleep
  ``--backoff`` seconds, then relaunch, while the budget lasts.
- any other exit: a real error (bad config, NaN guard, assertion):
  propagate it at once; a restart would only repeat it.

The JAX supervisor also waits, between attempts, for the TPU to answer a
health probe (``--health-wait``, mrfp_tpu/utils/tpu_health.py). That is a
workaround for a TPU reached through a tunnel, whose wedge outlives the
process; the port has no such probe and no such flag: a CUDA context dies
with its process, and a card that stays faulted fails the relaunch's
first device call, which the watchdog or the exit code reports.
"""

from __future__ import annotations

import argparse
import logging
import signal
import subprocess
import sys
import time
from typing import Optional, Sequence

RESTARTABLE = (75, -signal.SIGKILL)  # EX_TEMPFAIL, external SIGKILL


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="relaunch a command on restartable failures (exit 75 from the step "
                    "watchdog or a preemption, SIGKILL)")
    p.add_argument("--max-restarts", type=int, default=20)
    p.add_argument("--backoff", type=float, default=60.0,
                   help="seconds to sleep before each relaunch")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="the command to supervise (prefix with --)")
    args = p.parse_args(argv)
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        p.error("no command given (pass it after --)")
    args.command = cmd
    return args


def supervise(cmd, max_restarts: int = 20, backoff: float = 60.0,
              _run=subprocess.run, _sleep=time.sleep) -> int:
    """Run ``cmd`` until success, a real failure or the restart budget's
    end; returns the final exit code. ``_run`` and ``_sleep`` are
    injectable for tests."""
    restarts = 0
    while True:
        t0 = time.monotonic()
        try:
            rc = _run(cmd).returncode
        except OSError as e:
            # an unlaunchable command (a typo, a missing interpreter) is a
            # real error, not a restartable one: a clean exit, no traceback
            logging.error("supervise: cannot launch %r: %s", cmd[0], e)
            return 127
        if rc == 0:
            if restarts:
                logging.info("supervise: succeeded after %d restart(s)", restarts)
            return 0
        if rc not in RESTARTABLE:
            logging.error("supervise: non-restartable exit %d after %.0fs: propagating", rc,
                          time.monotonic() - t0)
            return rc
        restarts += 1
        if restarts > max_restarts:
            logging.error("supervise: restart budget (%d) exhausted", max_restarts)
            return rc
        logging.warning("supervise: restartable exit %d after %.0fs: relaunch %d/%d", rc,
                        time.monotonic() - t0, restarts, max_restarts)
        if backoff > 0:
            _sleep(backoff)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return supervise(args.command, max_restarts=args.max_restarts, backoff=args.backoff)


if __name__ == "__main__":
    sys.exit(main())
