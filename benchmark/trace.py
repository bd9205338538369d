"""A profiled sub-window: ``torch.profiler`` over CPU and CUDA, read back from
its Kineto events, and the breakdown the result line carries.

``Trace`` keeps the device events (kernels, copies, memsets) as
``(name, start_s, end_s)`` and the host's events on the profiled thread;
``busy_s`` is the length of the union of the device intervals, so work that
overlaps on two streams counts once. The Chrome trace is written beside the
run, so the whole timeline can be opened where the breakdown is not enough.
"""

from __future__ import annotations

import dataclasses
import re
import time
from pathlib import Path
from typing import Callable, List, Optional, Tuple

Event = Tuple[str, float, float]


@dataclasses.dataclass
class Trace:
    device: List[Event]
    host: List[Event]
    window_s: float

    def busy_s(self) -> float:
        return _union(sorted((s, e) for _, s, e in self.device))

    def device_seconds(self, pattern: str) -> float:
        """Summed device time of the events whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for name, s, e in self.device if rx.search(name))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost host event around each."""
        totals: dict = {}
        for name, s, e in self.device:
            name = short(name)
            totals[name] = totals.get(name, 0.0) + (e - s)
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
        merged = _merged(sorted((s, e) for _, s, e in self.device))
        gaps = sorted(((start - end, 0.5 * (start + end))
                       for (_, end), (start, _) in zip(merged, merged[1:])), reverse=True)
        return {"device_ops": [[n, float(t)] for n, t in ops],
                "idle_gaps": [[self._host_at(mid), float(length)]
                              for length, mid in gaps[:top]]}

    def _host_at(self, t: float) -> str:
        best: Optional[Event] = None
        for ev in self.host:
            if ev[1] <= t <= ev[2] and (best is None or ev[2] - ev[1] < best[2] - best[1]):
                best = ev
        return short(best[0]) if best is not None else "host idle"


def short(name: str, limit: int = 120) -> str:
    """A kernel's name without its parameter list, at most ``limit`` long."""
    return re.sub(r"\(.*", "", name)[:limit]


def _merged(intervals) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _union(intervals) -> float:
    return sum(e - s for s, e in _merged(intervals))


def profiled(fn: Callable[[], None], sync: Callable[[], None], out: Optional[Path]) -> Trace:
    """Run ``fn`` under the profiler, ``sync`` before and after it, and read
    the events back; with ``out``, write the Chrome trace there."""
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window = time.perf_counter() - t0
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out))
    return read_events(prof.profiler.kineto_results.events(), window)


def read_events(events, window_s: float) -> Trace:
    """Kineto events -> ``Trace``: CUDA events on the device, the others on
    the host, in seconds from the first event (nanosecond clocks read as
    integers, so a short kernel keeps its digits)."""
    import torch
    raw = []
    for ev in events:
        start, dur = _ns(ev, "start"), _ns(ev, "duration")
        if start is not None and dur is not None:
            raw.append((ev.name(), start, dur, ev.device_type() == torch.autograd.DeviceType.CUDA))
    base = min((r[1] for r in raw), default=0)
    device, host = [], []
    for name, start, dur, on_device in raw:
        item = (name, (start - base) * 1e-9, (start - base + dur) * 1e-9)
        (device if on_device else host).append(item)
    return Trace(device=device, host=host, window_s=window_s)


def _ns(ev, what: str) -> Optional[int]:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    fn = getattr(ev, f"{what}_us", None)
    return None if fn is None else int(round(float(fn()) * 1e3))
