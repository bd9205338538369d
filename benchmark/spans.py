"""The program's spans joined to a traced run's device work.

The port records spans of its own work (``mrfp_tpu_torch/utils/profiling.py``)
on the host clock that the profiler stamps its events with, the Unix epoch
in nanoseconds; a Chrome trace's ``ts`` (microseconds) plus its
``baseTimeNanoseconds`` is on the same clock, and its ``tid`` is the native
thread id a span records. ``Join`` reads the run's Chrome trace
(``benchmark/out/trace_<cell>.json``, written by ``trace.profiled``) once
and ties each device event of the profiled sub-window (kernel, copy,
memset) through its ``correlation`` to the runtime call that launched it:

- forward: the launch belongs to the innermost span open on its thread at
  the launch's time;
- backward: where the launch lies inside an
  ``autograd::engine::evaluate_function`` event, it also belongs to the span
  in which the forward op of the same sequence number ran.

A span's work is that of its own launches and of its children's. Idle
time is the gaps in the union of the device intervals from the
sub-window's first event on (``trace.Trace.busy_s``'s union); a gap is
credited to the spans open on the main thread (the thread that recorded
most of the sub-window's spans) where they overlap it.

``joined(m)`` returns None on the CPU, for a run without a trace, and where
the program records no spans.
"""

from __future__ import annotations

import bisect
import functools
import json
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from benchmark.trace import _merged

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH = ("cuda_runtime", "cuda_driver")
BACKWARD = "autograd::engine::evaluate_function"


class Join:
    """One traced sub-window's device work against the program's spans.
    ``recorded``: span records (``name``, ``id``, ``parent``, ``tid``,
    ``start_ns``, ``end_ns``, ``counts``); those that overlap the
    sub-window are kept. Times are nanoseconds on the shared clock."""

    def __init__(self, trace: dict, recorded: Iterable):
        base = int(trace.get("baseTimeNanoseconds", 0))
        events = [e for e in trace["traceEvents"] if e.get("ph") == "X" and "ts" in e]

        def start(e) -> int:
            return base + round(float(e["ts"]) * 1e3)

        def end(e) -> int:
            return start(e) + round(float(e.get("dur", 0)) * 1e3)

        self.t0 = min((start(e) for e in events), default=0)
        self.t1 = max((end(e) for e in events), default=0)
        self.spans = {s.id: s for s in recorded
                      if s.end_ns is not None and s.end_ns >= self.t0 and s.start_ns <= self.t1}
        per_thread: Dict[int, int] = {}
        for s in self.spans.values():
            per_thread[s.tid] = per_thread.get(s.tid, 0) + 1
        self.main_tid = max(per_thread, key=per_thread.get) if per_thread else None
        self._by_thread: Dict[int, Tuple[List[int], List]] = {}
        for s in sorted(self.spans.values(), key=lambda s: (s.start_ns, -s.end_ns)):
            starts, items = self._by_thread.setdefault(s.tid, ([], []))
            starts.append(s.start_ns)
            items.append(s)
        self._chain: Dict[int, Set[str]] = {}

        launches: Dict[object, Tuple[int, int]] = {}
        backward: Dict[int, List[Tuple[int, int, int]]] = {}
        forward_ops = []
        for e in events:
            cat, args = e.get("cat"), e.get("args") or {}
            if cat in LAUNCH and "correlation" in args:
                launches[args["correlation"]] = (e["tid"], start(e))
            elif cat == "cpu_op" and "Sequence number" in args:
                if e["name"].startswith(BACKWARD):
                    backward.setdefault(e["tid"], []).append(
                        (start(e), end(e), args["Sequence number"]))
                else:
                    forward_ops.append((start(e), e["tid"], args["Sequence number"]))
        self._backward = {}
        for tid, items in backward.items():
            items.sort()
            self._backward[tid] = ([s for s, _, _ in items], items)
        # a sequence number's first forward op is the outermost: its span
        seq_span: Dict[int, Optional[int]] = {}
        for t, tid, seq in sorted(forward_ops):
            if seq not in seq_span:
                seq_span[seq] = self.span_at(tid, t)

        # (start, end, launch time or None, forward span id, backward span id)
        self.work: List[Tuple[int, int, Optional[int], Optional[int], Optional[int]]] = []
        self.unlaunched = 0
        for e in events:
            if e.get("cat") not in DEVICE:
                continue
            launch = launches.get((e.get("args") or {}).get("correlation"))
            if launch is None:
                self.unlaunched += 1
                self.work.append((start(e), end(e), None, None, None))
                continue
            tid, t = launch
            seq = self._seq_at(tid, t)
            self.work.append((start(e), end(e), t, self.span_at(tid, t),
                              None if seq is None else seq_span.get(seq)))
        self.steps = self.named("train.step", main=True)
        self._step_ends = [s.end_ns for s in self.steps]

    # -- lookups --------------------------------------------------------------

    def span_at(self, tid: int, t: int) -> Optional[int]:
        """The id of the innermost span open on thread ``tid`` at ``t``."""
        starts, items = self._by_thread.get(tid, ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        s = items[i] if i >= 0 else None
        while s is not None and s.end_ns < t:
            s = self.spans.get(s.parent)
        return None if s is None else s.id

    def _seq_at(self, tid: int, t: int) -> Optional[int]:
        """The sequence number of the innermost backward function running on
        thread ``tid`` at ``t``."""
        starts, items = self._backward.get(tid, ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        for s, e, seq in reversed(items[max(0, i - 15):i + 1]):
            if s <= t <= e:
                return seq
        return None

    def chain(self, span_id: Optional[int]) -> Set[str]:
        """The names of a span and of every span around it."""
        if span_id is None:
            return set()
        names = self._chain.get(span_id)
        if names is None:
            s = self.spans[span_id]
            names = {s.name} | (self.chain(s.parent) if s.parent in self.spans else set())
            self._chain[span_id] = names
        return names

    def named(self, name: str, main: bool = False) -> List:
        """The sub-window's spans called ``name`` (on the main thread only
        with ``main``), in order of start."""
        return sorted((s for s in self.spans.values()
                       if s.name == name and (not main or s.tid == self.main_tid)),
                      key=lambda s: s.start_ns)

    def step_of(self, t: int) -> Optional[int]:
        """The index of the ``train.step`` that a time belongs to: each step
        takes what follows the previous step's end up to its own end (the
        benchmark re-draws the OC buffers and copies the batch between two
        steps, for the next one)."""
        k = bisect.bisect_left(self._step_ends, t)
        return k if k < len(self._step_ends) else None

    def steps_with(self, name: str) -> List[int]:
        """The indices of the steps that hold a span called ``name``."""
        return sorted({k for k in (self.step_of(s.start_ns) for s in self.named(name))
                       if k is not None})

    # -- measures (seconds) -----------------------------------------------------

    def device_s(self, names: Optional[Set[str]] = None, steps: Optional[Sequence[int]] = None,
                 forward: bool = True, backward: bool = True) -> float:
        """Device time of the work launched in a span called one of
        ``names`` (or in it or around it: its forward work), and of the
        backward work of forward ops that ran in one (``backward``), of
        the steps ``steps`` only where given; every launched event with
        ``names`` None."""
        keep = None if steps is None else set(steps)
        total = 0
        for s, e, t, fwd, bwd in self.work:
            if t is None or (keep is not None and self.step_of(t) not in keep):
                continue
            if names is None or (forward and names & self.chain(fwd)) or \
                    (backward and names & self.chain(bwd)):
                total += e - s
        return total * 1e-9

    def launched_in(self, name: str) -> float:
        """Device time of the work launched, on any thread, while a span
        called ``name`` was open."""
        spans = [(s.start_ns, s.end_ns) for s in self.named(name)]
        starts = [s for s, _ in spans]
        total = 0
        for s, e, t, _fwd, _bwd in self.work:
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += e - s
        return total * 1e-9

    @functools.cached_property
    def gaps(self) -> List[Tuple[int, int]]:
        """The device's idle intervals: from the sub-window's first event to
        the first device work, and between the merged device intervals."""
        merged = _merged(sorted((s, e) for s, e, *_ in self.work))
        if not merged:
            return []
        return [(self.t0, merged[0][0])] + [(a[1], b[0]) for a, b in zip(merged, merged[1:])]

    def idle_s(self, names: Optional[Set[str]] = None) -> float:
        """Idle device time while the main thread was inside a span called
        one of ``names`` (any span with None)."""
        cover = _merged(sorted((s.start_ns, s.end_ns) for s in self.spans.values()
                               if s.tid == self.main_tid and (names is None or s.name in names)))
        ends = [e for _, e in cover]
        total = 0
        for g0, g1 in self.gaps:
            for c0, c1 in cover[bisect.bisect_right(ends, g0):]:
                if c0 >= g1:
                    break
                total += min(g1, c1) - max(g0, c0)
        return total * 1e-9


def program_spans() -> Optional[list]:
    """The program's completed spans, or None where the port has no span
    recorder."""
    from mrfp_tpu_torch.utils import profiling
    spans = getattr(profiling, "spans", None)
    return None if spans is None else spans()


@functools.lru_cache(maxsize=1)
def _load(path: str, mtime_ns: int) -> Optional[Join]:
    recorded = program_spans()
    if not recorded:
        return None
    with open(path) as f:
        trace = json.load(f)
    join = Join(trace, recorded)
    return join if join.spans else None


def joined(m) -> Optional[Join]:
    """The join of a traced run on the card (``m`` a ``harness.Measurement``),
    parsed once a run; None on the CPU, without a trace or without spans."""
    if m.device.type != "cuda" or m.profile is None or m.trace_path is None \
            or not m.trace_path.exists():
        return None
    return _load(str(m.trace_path), m.trace_path.stat().st_mtime_ns)
