"""The join of the program's spans with a traced run (``benchmark/spans.py``):
on a hand-written Chrome trace, a forward launch, a backward launch tied
to it by sequence number and an idle gap inside ``oc.redraw``, read
through the metric readers; on the card (``-m card``), launches issued
inside spans lie within the spans' recorded intervals."""

import json
import time
import types
from pathlib import Path

import pytest

from benchmark import harness, spans

BASE = 1_700_000_000_000_000_000  # the trace's baseTimeNanoseconds


def _span(id, name, parent, tid, t0_us, t1_us, **counts):
    return types.SimpleNamespace(id=id, name=name, parent=parent, tid=tid,
                                 start_ns=BASE + int(t0_us * 1000),
                                 end_ns=BASE + int(t1_us * 1000), counts=counts)


def _x(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


# one step on thread 1, its backward on thread 2; times in microseconds
SPANS = [
    _span(1, "train.step", None, 1, 1, 155, step=0),
    _span(2, "train.forward", 1, 1, 5, 40, microbatch=0),
    _span(3, "oc.encode", 2, 1, 9, 16),
    _span(4, "train.backward", 1, 1, 45, 90),
    _span(5, "oc.redraw", 1, 1, 92, 99, bytes=64, pinned=64),
]
TRACE = {"baseTimeNanoseconds": BASE, "traceEvents": [
    _x("cpu_op", "aten::convolution", 1, 10, 5, **{"Sequence number": 7}),
    _x("cuda_runtime", "cudaLaunchKernel", 1, 12, 1, correlation=1),
    _x("cpu_op", "aten::add", 1, 30, 2, **{"Sequence number": 8}),
    _x("cuda_runtime", "cudaLaunchKernel", 1, 31, 1, correlation=2),
    _x("kernel", "conv_fwd", 7, 20, 10, correlation=1),
    _x("kernel", "add_fwd", 7, 33, 7, correlation=2),
    _x("cpu_op", f"{spans.BACKWARD}: ConvolutionBackward0", 2, 50, 10,
       **{"Sequence number": 7, "Fwd thread id": 1}),
    _x("cuda_runtime", "cudaLaunchKernel", 2, 52, 1, correlation=3),
    _x("kernel", "conv_bwd", 7, 60, 20, correlation=3),
    # the OC re-draw's copy, after an idle gap while the host draws
    _x("cuda_runtime", "cudaMemcpyAsync", 1, 98, 1, correlation=4),
    _x("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 8, 100, 2, correlation=4),
    _x("cuda_runtime", "cudaLaunchKernel", 1, 150, 1, correlation=5),
    _x("kernel", "sgd", 7, 152, 8, correlation=5),
]}


def test_the_join_of_a_hand_written_trace():
    j = spans.Join(TRACE, SPANS)
    assert [s.id for s in j.steps] == [1] and j.main_tid == 1 and j.unlaunched == 0
    assert j.span_at(1, 12_000 + BASE) == 3 and j.span_at(1, 42_000 + BASE) == 1
    us = 1e-6
    # the forward launch in oc.encode, its backward tied by sequence number 7
    assert j.device_s({"oc.encode"}) == pytest.approx(30 * us)
    assert j.device_s({"oc.encode"}, backward=False) == pytest.approx(10 * us)
    assert j.device_s({"train.forward"}, backward=False) == pytest.approx(17 * us)
    assert j.launched_in("train.backward") == pytest.approx(20 * us)
    assert j.device_s() == pytest.approx(47 * us)
    # idle: [10, 20) before the first kernel, [30, 33), [40, 60), [80, 100), [102, 152)
    assert j.idle_s() == pytest.approx(103 * us)
    assert j.idle_s({"oc.redraw"}) == pytest.approx(7 * us)
    assert j.idle_s({"oc.encode"}) == pytest.approx(6 * us)
    assert j.steps_with("oc.redraw") == [0] and j.steps_with("np_plus") == []


def test_the_readers_on_a_hand_written_trace(tmp_path, monkeypatch):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(TRACE))
    monkeypatch.setattr(spans, "program_spans", lambda: SPANS)
    spans._load.cache_clear()
    m = types.SimpleNamespace(device=types.SimpleNamespace(type="cuda"), profile=object(),
                              trace_path=path, profiled_images=4)
    read = {name: harness.reader(name).read(m) for name in (
        "forward_ms.train", "backward_ms.train", "oc_branch_device_ms", "np_plus_ms",
        "whitening_ms", "draw_idle_ms", "input_wait_ms.eval", "pinned_mib.eval")}
    spans._load.cache_clear()
    assert read["forward_ms.train"] == pytest.approx(0.017)
    assert read["backward_ms.train"] == pytest.approx(0.020)
    assert read["oc_branch_device_ms"] == pytest.approx(0.032)  # 10 + 20 + the 2 us copy
    assert read["draw_idle_ms"] == pytest.approx(0.007)
    # no NP+, whitening or evaluator spans: nothing to read
    assert read["np_plus_ms"] is read["whitening_ms"] is read["input_wait_ms.eval"] is None
    assert read["pinned_mib.eval"] is None
    # on the CPU, or without a trace, the join reads nothing
    m.device.type = "cpu"
    assert spans.joined(m) is None and harness.reader("kmeans_s").read(m) is None


@pytest.mark.card
def test_launches_inside_spans_lie_within_them(cuda_device, tmp_path):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mrfp_tpu_torch.utils.profiling import span
    x = torch.ones(1 << 16, device=cuda_device)
    (x * 2).sum().item()
    n = 400
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            with span("card.probe", index=i):
                x.mul_(1.0)
            if i % 50 == 0:
                time.sleep(1e-3)
        torch.cuda.synchronize(cuda_device)
    path = Path(tmp_path) / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    probes = [s for s in spans.program_spans() if s.name == "card.probe"][-n:]
    j = spans.Join(trace, probes)
    kernels = {e["args"]["correlation"] for e in trace["traceEvents"] if e.get("cat") == "kernel"}
    base = trace["baseTimeNanoseconds"]
    launches = sorted(base + round(e["ts"] * 1e3) for e in trace["traceEvents"]
                      if e.get("cat") in spans.LAUNCH
                      and (e.get("args") or {}).get("correlation") in kernels)
    assert len(launches) == n and len(j.spans) == n
    inside = sum(s.start_ns <= t <= s.end_ns for s, t in zip(probes, launches))
    assert inside >= 0.99 * n, (inside, n)
    assert sum(j.span_at(s.tid, t) == s.id for s, t in zip(probes, launches)) >= 0.99 * n
