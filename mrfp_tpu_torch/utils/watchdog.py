"""Step watchdog: failure detection for wedged device execution.

A copy of mrfp_tpu/utils/watchdog.py (that package's ``__init__`` imports
jax); only ``watchdog_from_arg``'s default differs: it asks the caller
whether the run is on an accelerator instead of probing for a TPU.

A device execution can wedge so that every device call blocks forever
inside the runtime — the process then sits at ~0% CPU indefinitely, with no
exception to catch and no in-process way to cancel the blocked call. The
reference has nothing to offer here either (its NCCL jobs die on collective
timeout only because torch.distributed sets one).

This watchdog turns the forever-hang into a bounded, *restartable* failure:
a daemon thread tracks a heartbeat the loop beats at every sync point (the
evaluator beats every few synced images); if no beat arrives within the
timeout it logs the diagnosis and force-exits with EX_TEMPFAIL (75), so a
supervisor that relaunches on exit code 75 retries the sweep.

Two windows, because the first "step" includes one-time set-up (building
the kernels, loading weights, cuDNN's first calls): a generous
``first_beat_timeout_s`` until the first beat, then the steady-state
``timeout_s`` between beats. The steady-state window must exceed the time
between sync points.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional


class StepWatchdog:
    """Fire ``on_timeout`` (default: ``os._exit(75)``) when no heartbeat
    arrives within the window. ``beat()`` is cheap and thread-safe; call it
    whenever forward progress is proven (a fetched scalar, a finished
    validation). ``stop()`` disarms permanently (normal shutdown)."""

    EXIT_CODE = 75  # EX_TEMPFAIL: transient, retry me

    def __init__(self, timeout_s: float, first_beat_timeout_s: float = 0.0,
                 on_timeout: Optional[Callable[[], None]] = None,
                 poll_s: float = 5.0, name: str = "step"):
        self.timeout_s = float(timeout_s)
        self.first_beat_timeout_s = float(first_beat_timeout_s or timeout_s)
        self._on_timeout = on_timeout
        self._poll_s = poll_s
        self._name = name
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._beats = 0
        self._emergency: Optional[Callable[[], None]] = None
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "StepWatchdog":
        self._last = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"watchdog-{self._name}")
        self._thread.start()
        return self

    def beat(self) -> None:
        with self._lock:
            self._last = time.monotonic()
            self._beats += 1

    def stop(self) -> None:
        self._stopped.set()

    def set_emergency(self, fn: Optional[Callable[[], None]]) -> None:
        """Register a last-chance callback run from the watchdog thread
        right before ``on_timeout``/exit — e.g. persisting a host-side
        state snapshot the wedged device would otherwise take down with
        it. Must not touch the device (the device is exactly what stopped
        responding); exceptions are logged and never mask the exit."""
        with self._lock:
            self._emergency = fn

    # --- internals ---------------------------------------------------------

    def _window(self) -> float:
        return self.first_beat_timeout_s if self._beats == 0 \
            else self.timeout_s

    def _run(self) -> None:
        while not self._stopped.wait(self._poll_s):
            with self._lock:
                stale = time.monotonic() - self._last
                window = self._window()
                beats = self._beats
            if stale > window:
                logging.critical(
                    "watchdog: no %s heartbeat for %.0fs (window %.0fs, "
                    "%d beats so far) — device execution is presumed "
                    "wedged; exiting %d for a supervisor restart "
                    "(training auto-resumes from the last checkpoint)",
                    self._name, stale, window, beats, self.EXIT_CODE)
                with self._lock:
                    emergency = self._emergency
                if emergency is not None:
                    try:
                        emergency()
                        logging.critical("watchdog: emergency hook done")
                    except Exception:
                        logging.exception("watchdog: emergency hook failed")
                if self._on_timeout is not None:
                    self._on_timeout()
                    return
                # flush logs, then hard-exit: the main thread is blocked
                # inside an uncancellable device call, so sys.exit / raising
                # in this thread cannot unwind it
                logging.shutdown()
                os._exit(self.EXIT_CODE)


def watchdog_from_arg(step_timeout: Optional[float],
                      first_beat_timeout: Optional[float] = None,
                      accelerator: bool = False) -> Optional[StepWatchdog]:
    """CLI policy: ``None`` means auto (1800 s steady-state when
    ``accelerator`` is true, off elsewhere — CPU test runs never want one);
    ``0`` disables; anything else is the steady-state window in seconds.
    The first-beat window defaults to the larger of 2x the steady window
    and 3600 s, covering a first step that includes building kernels and
    loading weights; pass ``first_beat_timeout`` to override it. Returns a
    STARTED watchdog or None."""
    if step_timeout is None:
        step_timeout = 1800.0 if accelerator else 0.0
    if not step_timeout or step_timeout <= 0:
        return None
    if first_beat_timeout is None or first_beat_timeout <= 0:
        first_beat_timeout = max(2 * step_timeout, 3600.0)
    return StepWatchdog(
        step_timeout, first_beat_timeout_s=first_beat_timeout).start()
