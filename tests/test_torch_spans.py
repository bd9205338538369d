"""The port's spans (``mrfp_tpu_torch/utils/profiling.py``) on the CPU: the
recorder's nesting, parents, per-thread stacks and bounded buffer; the
clock it shares with the profiler's events; and the span sites of the
MRFP+ step, the zoo step, the evaluator, the host copy and the ISW
k-means."""

import dataclasses
import threading

import numpy as np
import torch

from mrfp_tpu_torch.cli import train as cli_train
from mrfp_tpu_torch.core.config import Config, mrfp_plus_config
from mrfp_tpu_torch.models.deepv3_zoo import DeepV3Plus
from mrfp_tpu_torch.nn.cov_settings import kmeans_1d
from mrfp_tpu_torch.perturb.oc_branch import oc_init
from mrfp_tpu_torch.train.evaluator import SegEvaluator
from mrfp_tpu_torch.train.state import create_train_state
from mrfp_tpu_torch.train.step import train_step
from mrfp_tpu_torch.train.zoo_step import zoo_train_step
from mrfp_tpu_torch.utils import profiling

torch.set_num_threads(2)


def _new_spans(before):
    """The program's spans completed since ``before`` (a span id)."""
    return [s for s in profiling.spans() if s.id > before]


def _last_id():
    return max((s.id for s in profiling.spans()), default=0)


def test_nesting_parents_threads_and_the_bounded_buffer():
    rec = profiling.Recorder(capacity=5)
    with rec.span("outer", step=3) as outer:
        with rec.span("inner") as inner:
            inner.add(bytes=10)
            seen = {}

            def other():
                with rec.span("elsewhere") as s:
                    seen["span"] = s
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
        assert inner.parent == outer.id and outer.parent is None
    elsewhere = seen["span"]
    assert elsewhere.parent is None and elsewhere.tid != outer.tid
    assert outer.tid == threading.get_native_id()
    assert [s.name for s in rec.spans()] == ["elsewhere", "inner", "outer"]
    assert inner.counts == {"bytes": 10} and outer.counts == {"step": 3}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    for i in range(10):
        with rec.span("more", index=i):
            pass
    assert len(rec.spans()) == 5
    assert [s.counts["index"] for s in rec.spans()] == [5, 6, 7, 8, 9]


def test_a_cpu_op_lies_inside_the_span_around_it():
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("clock") as s:
            x.mul(3.0)
    (op,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mul"]
    assert s.start_ns <= op.start_ns() and op.start_ns() + op.duration_ns() <= s.end_ns


def _gated(cfg, p):
    return cfg.replace(perturb=dataclasses.replace(cfg.perturb, p_oc=p, p_np=p, p_dec=p))


def test_an_mrfp_plus_step_opens_its_sites_and_the_gates_theirs():
    cfg = mrfp_plus_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, trunk="resnet-18", variant="D32"),
                      train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    state = cli_train.build_state(_gated(cfg, 1.0), torch.device("cpu"))
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.integers(0, 256, (2, 48, 48, 3), dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 19, (2, 48, 48)).astype(np.uint8))
    steps = []
    for p in (1.0, 0.0):
        before = _last_id()
        out = train_step(state, images, labels, _gated(cfg, p))
        assert (out["gate_oc"], out["gate_np"], out["gate_dec"]) == (p > 0,) * 3
        steps.append({s.name: [] for s in _new_spans(before)})
        for s in _new_spans(before):
            steps[-1][s.name].append(s)
    fired, quiet = steps
    assert sorted(fired) == ["h2d", "isw.whiten", "np_plus", "np_plus.draw", "oc.decode",
                             "oc.encode", "oc.redraw", "train.backward", "train.forward",
                             "train.step"]
    assert sorted(quiet) == ["isw.whiten", "train.backward", "train.forward", "train.step"]
    (step,), (fwd,), (redraw,) = fired["train.step"], fired["train.forward"], fired["oc.redraw"]
    assert step.counts == {"step": 0} and quiet["train.step"][0].counts == {"step": 1}
    assert fwd.parent == step.id and fwd.counts == {"microbatch": 0}
    drawn = sum(v.numel() for v in oc_init(torch.Generator().manual_seed(0)).values())
    assert redraw.parent == step.id and redraw.counts == {"bytes": 4 * drawn, "pinned": 0}
    assert [s.counts["channels"] for s in fired["np_plus"]] == [64, 64]
    assert all(s.parent == fwd.id for s in fired["np_plus"] + fired["oc.encode"])
    assert {s.parent for s in fired["np_plus.draw"]} == {s.id for s in fired["np_plus"]}
    assert len(fired["h2d"]) == 4 and len(fired["isw.whiten"]) == 3  # 0044400: three IN


def test_a_zoo_step_opens_the_whitening_sites():
    cfg = Config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, use_wtloss=True, trunk="resnet-18",
                                                variant="D32", wt_layer=(0, 0, 2, 2, 2, 0, 0)),
                      train=dataclasses.replace(cfg.train, compute_dtype="float32"))
    torch.manual_seed(0)
    model = DeepV3Plus(trunk="resnet-18", variant="D32", wt_layer=cfg.model.wt_layer,
                       use_dsn=True)
    state = create_train_state(model, cfg.train)
    rng = np.random.default_rng(6)
    images = torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 19, (2, 32, 32)).astype(np.uint8))
    before = _last_id()
    zoo_train_step(state, images, labels, cfg)
    got = _new_spans(before)
    names = [s.name for s in got]
    assert names.count("isw.whiten") == 3 and names.count("isw.loss") == 1
    fwd = next(s for s in got if s.name == "train.forward")
    assert next(s for s in got if s.name == "isw.loss").parent == fwd.id


def test_an_eval_sweep_records_its_input_and_copies():
    class Zeros(torch.nn.Module):
        def forward(self, x, valid_hw=None):
            return torch.zeros((x.shape[0], 19, *x.shape[2:]))

    rng = np.random.default_rng(7)
    data = [{"image": rng.integers(0, 256, (24, 40, 3), dtype=np.uint8),
             "label": rng.integers(0, 19, (24, 40)).astype(np.uint8)} for _ in range(3)]
    before = _last_id()
    SegEvaluator(Zeros(), device="cpu").run(data, log=lambda *a, **k: None)
    got = _new_spans(before)
    inputs = [s for s in got if s.name == "eval.input"]
    copies = [s for s in got if s.name == "h2d"]
    assert [s.counts.get("images") for s in inputs] == [1, 1, 1, None]  # the last finds none
    assert [s.counts["bytes"] for s in copies] == [24 * 40 * 3, 24 * 40] * 3
    assert all(s.counts["pinned"] == 0 for s in copies)  # nothing is pinned for the CPU


def test_kmeans_records_its_span():
    before = _last_id()
    assign, centroids = kmeans_1d(np.arange(100, dtype=np.float64) % 7, 3)
    (s,) = [s for s in _new_spans(before) if s.name == "isw.kmeans"]
    assert s.counts == {"values": 100} and s.end_ns >= s.start_ns
    assert assign.shape == (100,) and centroids.shape == (3,)
