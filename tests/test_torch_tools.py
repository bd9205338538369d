"""The port's run tools against the JAX package's, on the CPU: TensorBoard
events (byte for byte), the dual-sink metric writer, ``cli.train
--snapshot-every`` and the watchdog's emergency save, the supervisor's
policy, ``decode_segmap`` and ``cli.visualize``, the shape census, the
input benchmark, the reference-named metrics and the small utilities
(meters, the profiler's trace with the program's spans)."""

import dataclasses
import json
import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from mrfp_tpu import metrics as jax_metrics
from mrfp_tpu.cli import shape_census as jax_census
from mrfp_tpu.data import label_maps as jax_label_maps
from mrfp_tpu.utils import tbevents as jax_tb
from mrfp_tpu_torch import metrics
from mrfp_tpu_torch.cli import bench_input, shape_census, supervise, visualize
from mrfp_tpu_torch.data import label_maps
from mrfp_tpu_torch.utils import profiling, tbevents
from mrfp_tpu_torch.utils.experiment import MetricWriter
from mrfp_tpu_torch.utils.meters import AverageMeter

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SCALARS = [("train/loss", 2.75, 1), ("train/lr", 0.01, 1), ("train/loss", 1.5, 50),
           ("val/mean_iu", 0.4123, 1000), ("train/loss", float("nan"), 7), ("x/neg", -3e-8, 2**40)]


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


# --- TensorBoard events -------------------------------------------------------

def _write(module, logdir):
    w = module.TBEventWriter(str(logdir), wall_time=1.7e9)
    for i, (tag, value, step) in enumerate(SCALARS):
        w.add_scalar(tag, value, step, wall_time=1.7e9 + i / 8)
    w.close()
    return w.path


def _same(a, b):
    return a == b or (np.isnan(a) and np.isnan(b))


def test_tfevents_bytes_equal_the_jax_writer(tmp_path):
    ours = _write(tbevents, tmp_path / "port")
    ref = _write(jax_tb, tmp_path / "jax")
    assert os.path.basename(ours) == os.path.basename(ref)
    assert Path(ours).read_bytes() == Path(ref).read_bytes()


def test_port_reader_reads_both_files(tmp_path):
    for path in (_write(tbevents, tmp_path / "port"), _write(jax_tb, tmp_path / "jax")):
        got = list(tbevents.read_tfevents(path))
        assert len(got) == len(SCALARS)
        for (tag, value, step, wall), (etag, evalue, estep) in zip(got, SCALARS):
            assert (tag, step) == (etag, estep)
            assert _same(value, float(np.float32(evalue)))
            assert wall >= 1.7e9


def test_reader_refuses_a_corrupt_record(tmp_path):
    path = _write(tbevents, tmp_path)
    raw = bytearray(Path(path).read_bytes())
    raw[-6] ^= 0xFF  # inside the last record's payload
    Path(path).write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="corrupt record payload"):
        list(tbevents.read_tfevents(path))


def test_metric_writer_writes_both_sinks(tmp_path):
    w = MetricWriter(str(tmp_path / "metrics.jsonl"), tb_dir=str(tmp_path / "tb"))
    w.add_scalar("train/loss", 1.25, 3)
    w.add_scalar("val/mean_iu", 0.5, 4)
    w.close()
    lines = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    assert lines == [{"tag": "train/loss", "value": 1.25, "step": 3},
                     {"tag": "val/mean_iu", "value": 0.5, "step": 4}]
    (event_file,) = os.listdir(tmp_path / "tb")
    got = [(t, v, s) for t, v, s, _ in tbevents.read_tfevents(str(tmp_path / "tb" / event_file))]
    assert got == [("train/loss", 1.25, 3), ("val/mean_iu", 0.5, 4)]


# --- cli.train --snapshot-every -----------------------------------------------

def test_cli_train_snapshots_and_writes_tensorboard_events(tmp_path):
    """Three CPU steps with a snapshot each: the snapshot's copy time and
    bytes are in the metric stream, and ``tb/`` reads back with the loss at
    every logged step, as the JSONL stream has it."""
    from mrfp_tpu_torch.cli import train as cli_train
    out = tmp_path / "result.json"
    rc = cli_train.main(["--device", "cpu", "--synthetic", "--crop-size", "32",
                         "--batch-size", "2", "--max-iter", "3", "--log-every", "1",
                         "--snapshot-every", "1", "--step-timeout", "600",
                         "--runs-dir", str(tmp_path), "--json-out", str(out)])
    assert rc == 0
    run_dir = json.loads(out.read_text())["run_dir"]
    lines = [json.loads(l) for l in open(os.path.join(run_dir, "metrics.jsonl"))]
    by_tag = {}
    for l in lines:
        by_tag.setdefault(l["tag"], {})[l["step"]] = l["value"]
    assert sorted(by_tag["train/snapshot_seconds"]) == [1, 2, 3]
    assert min(by_tag["train/snapshot_bytes"].values()) > 100e6  # R50-D16 + momentum
    (event_file,) = os.listdir(os.path.join(run_dir, "tb"))
    events = {}
    for tag, value, step, _ in tbevents.read_tfevents(os.path.join(run_dir, "tb", event_file)):
        events.setdefault(tag, {})[step] = value
    assert events.keys() == by_tag.keys()
    assert sorted(events["train/loss"]) == sorted(events["train/lr"]) == [1, 2, 3]
    for step, value in by_tag["train/loss"].items():
        assert events["train/loss"][step] == np.float32(value)


def test_snapshot_every_needs_a_watchdog(caplog):
    from mrfp_tpu_torch.core.config import Config
    from mrfp_tpu_torch.train.loop import run_training_loop

    class Ckpt:
        def save(self, state, metrics=None):
            pass

        def wait(self):
            pass

        def host_blob(self, state):
            raise AssertionError("snapshot taken without a watchdog")

    state = _tiny_state()
    cfg = Config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, max_iter=2, log_every=1))
    with caplog.at_level(logging.WARNING):
        step, preempted, _ = run_training_loop(
            state, _Loader([_BATCH] * 2), _step_fn, cfg, Ckpt(), _NoWriter(), "cpu",
            snapshot_every=1)
    assert (step, preempted) == (2, False)
    assert "snapshot_every ignored" in caplog.text


class _Loader(list):
    def set_epoch(self, epoch):
        pass


class _NoWriter:
    def add_scalar(self, *a):
        pass


_BATCH = {"image": torch.zeros((1, 4, 4, 3)), "label": torch.zeros((1, 4, 4), dtype=torch.int32)}


def _tiny_state():
    from mrfp_tpu_torch.train.state import TrainState
    model = torch.nn.Linear(4, 1, bias=False)
    with torch.no_grad():
        model.weight.copy_(torch.arange(4.0))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    return TrainState(step=0, model=model, optimizer=opt,
                      scheduler=torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0), seed=0)


def _step_fn(state, images, labels):
    with torch.no_grad():
        state.model.weight.add_(1.0)
    state.step += 1
    return {"loss": torch.tensor(float(state.step)), "gate_oc": True, "gate_np": False,
            "gate_dec": True}


_WEDGE_SCRIPT = """
import dataclasses, sys, time
import torch
from mrfp_tpu_torch.core.config import Config
from mrfp_tpu_torch.train.checkpoint import CheckpointManager
from mrfp_tpu_torch.train.loop import run_training_loop
from mrfp_tpu_torch.train.state import TrainState
from mrfp_tpu_torch.utils.watchdog import StepWatchdog

model = torch.nn.Linear(4, 1, bias=False)
with torch.no_grad():
    model.weight.copy_(torch.arange(4.0))
opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
state = TrainState(step=0, model=model, optimizer=opt,
                   scheduler=torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0), seed=0)


def step_fn(state, images, labels):
    if state.step + 1 >= 7:
        time.sleep(3600)  # a wedged device call: it never returns
    with torch.no_grad():
        state.model.weight.add_(1.0)
    state.step += 1
    return {"loss": torch.tensor(float(state.step)), "gate_oc": True, "gate_np": False,
            "gate_dec": True}


class Loader(list):
    def set_epoch(self, epoch):
        pass


class Writer:
    def add_scalar(self, *a):
        pass


cfg = Config()
cfg = cfg.replace(train=dataclasses.replace(cfg.train, max_iter=50, log_every=1,
                                            checkpoint_every=1000))
batch = {"image": torch.zeros((1, 4, 4, 3)), "label": torch.zeros((1, 4, 4), dtype=torch.int32)}
wd = StepWatchdog(1.0, first_beat_timeout_s=10.0, poll_s=0.1).start()
run_training_loop(state, Loader([batch] * 4), step_fn, cfg, CheckpointManager(sys.argv[1]),
                  Writer(), "cpu", watchdog=wd, snapshot_every=2)
"""


def test_wedged_step_exits_75_with_emergency_snapshot(tmp_path):
    """Steps 1-6 sync, step 7 wedges forever: the watchdog takes the process
    down with 75 and first persists the step-6 host snapshot through the
    checkpoint manager (no scheduled checkpoint falls before step 30), so a
    relaunch loses one step (tests/test_watchdog.py:205-242)."""
    from mrfp_tpu_torch.train.checkpoint import CheckpointManager
    from mrfp_tpu_torch.utils.watchdog import StepWatchdog

    d = str(tmp_path / "ckpt")
    p = subprocess.run([sys.executable, "-c", _WEDGE_SCRIPT, d],
                       env=_env(), timeout=180, capture_output=True, text=True)
    assert p.returncode == StepWatchdog.EXIT_CODE, (p.returncode, p.stderr[-3000:])
    assert "persisting host snapshot of step 6" in p.stderr, p.stderr[-2000:]
    mgr = CheckpointManager(d)
    assert mgr.latest_step() == 6
    state = _tiny_state()
    assert mgr.restore(state)
    assert state.step == 6
    assert torch.equal(state.model.weight.detach(), (torch.arange(4.0) + 6)[None])
    mgr.close()


# --- cli.supervise ------------------------------------------------------------

class FakeRun:
    def __init__(self, codes):
        self.codes = list(codes)
        self.calls = 0

    def __call__(self, cmd):
        self.calls += 1
        return subprocess.CompletedProcess(cmd, self.codes.pop(0))


@pytest.mark.parametrize("codes,max_restarts,rc,calls", [
    ([0], 20, 0, 1),               # success first try
    ([75, 75, 0], 20, 0, 3),       # restarts on 75 until success
    ([-9, 0], 20, 0, 2),           # SIGKILL is restartable
    ([1], 20, 1, 1),               # a real error propagates at once
    ([75] * 4, 3, 75, 4),          # the restart budget runs out
])
def test_supervise_policy(codes, max_restarts, rc, calls):
    run, slept = FakeRun(codes), []
    assert supervise.supervise(["x"], max_restarts=max_restarts, backoff=2.5, _run=run,
                               _sleep=slept.append) == rc
    assert run.calls == calls
    assert slept == [2.5] * (calls - 1)


def test_supervise_parse_args():
    a = supervise.parse_args(["--max-restarts", "5", "--", "python", "-c", "pass"])
    assert a.command == ["python", "-c", "pass"] and a.max_restarts == 5
    with pytest.raises(SystemExit):
        supervise.parse_args(["--max-restarts", "5"])
    with pytest.raises(SystemExit):  # no TPU health probe in the port
        supervise.parse_args(["--health-wait", "0", "--", "true"])


def test_supervise_unlaunchable_command_is_a_clean_error():
    assert supervise.supervise(["definitely-not-a-command-xyz"], backoff=0) == 127


def test_supervise_subprocess_round_trip(tmp_path):
    """Through ``__main__``: the child exits 75 once (leaving a marker), then 0."""
    marker = tmp_path / "tried"
    child = (f"import os,sys; p={str(marker)!r}\n"
             "sys.exit(0) if os.path.exists(p) else (open(p,'w').close(), sys.exit(75))")
    proc = subprocess.run([sys.executable, "-m", "mrfp_tpu_torch.cli.supervise", "--backoff",
                           "0", "--", sys.executable, "-c", child],
                          env=_env(), cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "relaunch 1/" in proc.stdout + proc.stderr


# --- decode_segmap and cli.visualize ------------------------------------------

def test_decode_segmap_equals_jax():
    np.testing.assert_array_equal(label_maps.CITYSCAPES_PALETTE,
                                  jax_label_maps.CITYSCAPES_PALETTE)
    lbl = np.random.default_rng(0).integers(0, 256, (37, 53)).astype(np.uint8)
    lbl[:5] = 255
    got, ref = label_maps.decode_segmap(lbl), jax_label_maps.decode_segmap(lbl)
    assert got.dtype == ref.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def test_cli_visualize_writes_triplets(tmp_path):
    n = visualize.main(["--device", "cpu", "--synthetic", "--synthetic-hw", "32", "48",
                        "--n", "2", "--out", str(tmp_path)])
    assert n == 2
    assert sorted(os.listdir(tmp_path)) == [f"{i:03d}_{k}.png" for i in range(2)
                                            for k in ("gt", "image", "pred")]
    from mrfp_tpu_torch.data import SyntheticDataset
    sample = SyntheticDataset(length=2, hw=(32, 48))[1]
    gt = np.asarray(Image.open(tmp_path / "001_gt.png"))
    np.testing.assert_array_equal(
        gt, label_maps.decode_segmap(sample["label"].astype(np.int32).astype(np.uint8)))
    pred = np.asarray(Image.open(tmp_path / "000_pred.png"))
    assert pred.shape == (32, 48, 3)
    assert {tuple(c) for c in pred.reshape(-1, 3)} <= {tuple(c) for c in
                                                         label_maps.CITYSCAPES_PALETTE}


# --- shape census and the input benchmark ---------------------------------------

def _png(path, hw, seed=0, label=False):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 34, hw).astype(np.uint8) if label else \
        rng.integers(0, 255, (*hw, 3)).astype(np.uint8)
    Image.fromarray(arr).save(path)


def test_shape_census_equals_jax(tmp_path, capsys):
    """A mixed-shape GTAV tree and a Mapillary one: the same census as the
    JAX package's, and the shapes printed."""
    for i, hw in enumerate([(52, 96), (52, 96), (40, 64)]):
        _png(str(tmp_path / f"gtav/images/test/0000{i}.png"), hw, i)
        _png(str(tmp_path / f"gtav/labels/test/0000{i}.png"), hw, i, label=True)
    for i, hw in enumerate([(40, 64), (48, 80)]):
        _png(str(tmp_path / f"mapillary/validation/images/ab{i}.jpg"), hw, 10 + i)
        _png(str(tmp_path / f"mapillary/validation/labels/ab{i}.png"), hw, 10 + i, label=True)
    for domain in ("gtav", "mapillary"):
        got = shape_census.census(domain, str(tmp_path), eval_size=96)
        assert got == jax_census.census(domain, str(tmp_path), eval_size=96)
    assert shape_census.census("gtav", str(tmp_path)) == {(52, 96): 2, (40, 64): 1}
    report = shape_census.main(["--data-root", str(tmp_path), "--domains", "mapillary",
                                "--eval-size", "96"])
    assert report["mapillary"]["census"] == {"96x96": 2}
    assert "96x96: 2" in capsys.readouterr().out


def test_bench_input_runs_on_a_tiny_tree(tmp_path, capsys):
    bench_input.build_tree(str(tmp_path), 10, hw=(40, 72))
    assert len(os.listdir(tmp_path / "images/train")) == 10
    out = bench_input.main(["--root", str(tmp_path), "--batch-size", "2",
                            "--num-workers", "1"])
    assert out["metric"] == "gtav_768_train_pipeline_img_per_sec"
    assert out["main"] > 0 and out["process"] > 0
    assert "img/s" in capsys.readouterr().out


# --- metrics and the small utilities --------------------------------------------

def test_metrics_equal_jax():
    rng = np.random.default_rng(5)
    gt = rng.integers(0, 19, (2, 40, 40))
    gt[:, :3] = 255
    pred = np.where(rng.random(gt.shape) < 0.7, np.minimum(gt, 18), rng.integers(0, 19, gt.shape))
    assert metrics.eval(gt, pred) == jax_metrics.eval(gt, pred)
    assert metrics.mean_iou is metrics.eval
    np.testing.assert_array_equal(metrics.fast_hist(pred, gt, 19),
                                  jax_metrics.fast_hist(pred, gt, 19))
    hist = metrics.fast_hist(pred, gt, 19)
    got = metrics.evaluate_eval(hist, log=lambda *a: None)
    ref = jax_metrics.evaluate_eval(hist, log=lambda *a: None)
    for k in ("acc", "acc_cls", "mean_iu", "fwavacc"):
        assert got[k] == ref[k], k
    dev = torch.zeros((19, 19), dtype=torch.int32)
    metrics.fast_hist_device(dev, torch.from_numpy(pred), torch.from_numpy(gt), 19)
    np.testing.assert_array_equal(dev.numpy(), hist)


def test_meters_probes_and_profiling(tmp_path):
    m = AverageMeter()
    for v, n in ((2.0, 1), (4.0, 3)):
        m.update(v, n)
    assert (m.val, m.sum, m.count, m.avg) == (4.0, 14.0, 4, 3.5)
    with profiling.trace_ctx(str(tmp_path / "trace")):
        with profiling.span("exported", bytes=32):
            torch.ones(8).sum()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    base = trace["baseTimeNanoseconds"]
    (got,) = [e for e in trace["traceEvents"] if e.get("cat") == "span"]
    (done,) = [s for s in profiling.spans() if s.name == "exported"]
    assert (got["name"], got["ph"], got["tid"], got["args"]["bytes"]) == \
        ("exported", "X", done.tid, 32)
    assert abs(base + got["ts"] * 1e3 - done.start_ns) < 1e3
    op = next(e for e in trace["traceEvents"] if e.get("name") == "aten::sum")
    assert got["ts"] <= op["ts"] and op["ts"] + op["dur"] <= got["ts"] + got["dur"]
    with profiling.trace_ctx(None):
        pass
