"""Tracing hooks (mrfp_tpu/utils/profiling.py): spans inside the program,
and the operator's trace exporter.

``span(name, **counts)`` times a piece of the program's own work on the
host clock that ``torch.profiler`` stamps its events with (``time.time_ns``,
the Unix epoch), so a span can be joined to a profiler trace by time and
thread afterwards. It reads the clock and nothing else: no
``record_function`` or NVTX range (those would land among the trace's
device events), no CUDA event, no synchronize, no read of a device tensor.
Recording is always on; the completed spans go into one bounded buffer
(``MAX_SPANS``, the oldest dropped first) and ``spans()`` returns them.

``trace_ctx`` records a ``torch.profiler`` trace of the host and the card
into a directory, with the spans of its window on their threads, for
Perfetto or chrome://tracing.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

# an MRFP+ step records about 20 spans and an eval image about 6: this holds
# the last 3,000 steps, a whole benchmark run with its set-up
MAX_SPANS = 1 << 16


class Span:
    """One span: ``name``, ``id``, the ``parent`` span's id (None at the top
    of its thread), the native ``tid``, ``start_ns`` and ``end_ns`` from
    ``time.time_ns()`` (``end_ns`` None while open) and integer ``counts``.
    Entering it opens it on the calling thread; ``add`` sets counts while
    it is open (e.g. bytes, once they are known)."""

    __slots__ = ("name", "counts", "id", "parent", "tid", "start_ns", "end_ns", "_recorder")

    def __init__(self, recorder: "Recorder", name: str, counts: Dict[str, int]):
        self.name, self.counts, self._recorder = name, counts, recorder
        self.id = self.parent = self.tid = self.start_ns = self.end_ns = None

    def add(self, **counts: int) -> None:
        self.counts.update((k, int(v)) for k, v in counts.items())

    def __enter__(self) -> "Span":
        rec = self._recorder
        local = rec._local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
            local.tid = threading.get_native_id()
        self.id = next(rec._ids)
        self.parent = stack[-1].id if stack else None
        self.tid = local.tid
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        rec = self._recorder
        rec._local.stack.pop()
        self._recorder = None
        rec._done.append(self)
        return False


class Recorder:
    """Spans per thread (each thread its own stack of open spans) into one
    buffer of the last ``capacity`` completed spans."""

    def __init__(self, capacity: int = MAX_SPANS):
        self._done: collections.deque = collections.deque(maxlen=capacity)
        self._local = threading.local()
        self._ids = itertools.count(1)

    def span(self, name: str, **counts: int) -> Span:
        """A new span, to enter: ``with span("h2d", bytes=n) as s:``."""
        return Span(self, name, counts)

    def spans(self) -> List[Span]:
        """The completed spans, oldest first."""
        return list(self._done)


# the program's own recorder, which every span site uses
RECORDER = Recorder()
span = RECORDER.span
spans = RECORDER.spans


@contextlib.contextmanager
def trace_ctx(logdir: Optional[str]):
    """torch.profiler trace scope (CPU, and CUDA where present) written to
    ``logdir/trace.json``, the spans completed inside it added as Chrome
    ``X`` events (category ``span``) on their threads; a no-op when logdir
    is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        t0 = time.time_ns()
        yield prof
        t1 = time.time_ns()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    trace["traceEvents"].extend(
        {"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": s.tid,
         "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
         "args": {"id": s.id, "parent": s.parent, **s.counts}}
        for s in spans() if s.start_ns >= t0 and s.end_ns <= t1)
    with open(path, "w") as f:
        json.dump(trace, f)
