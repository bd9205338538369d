"""BENCHMARK.json against the contract's shapes, and every cell's files
found by name."""

import json
import re

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_units_and_keys():
    bench = harness.manifest()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]] \
        + [e["name"] for e in bench["end_to_end"] + bench["per_layer"]]
    assert all(NAME.match(n) for n in names), names
    for e in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for e in bench["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
    assert len(json.dumps(bench)) < 64 * 1024


def test_each_cell_finds_its_files():
    bench = harness.manifest()
    for w in bench["workloads"]:
        cfg = harness.load_json("configs", w["config"])
        traffic = harness.load_json("traffic", w["traffic"])
        harness.load_json("limits", w["name"])
        assert (harness.HERE / "drivers" / f"{traffic['driver']}.py").exists()
        assert (harness.HERE / "reference" / f"{cfg['reference']}.py").exists()
        assert (harness.HERE / "programs" / f"{cfg['program']}.py").exists()
        for spec in harness.metrics_of(bench, w["name"], False) + \
                harness.metrics_of(bench, w["name"], True):
            assert callable(harness.reader(spec["name"]).read)


def test_moves_targets_are_reported_where_the_layer_metric_is():
    bench = harness.manifest()
    e2e = {e["name"]: e for e in bench["end_to_end"]}
    for p in bench["per_layer"]:
        assert p["moves"] in e2e
        for w in p["workloads"]:
            assert p["moves"] in {e["name"] for e in harness.metrics_of(bench, w, False)}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    bench = harness.manifest()
    for w in bench["workloads"]:
        e2e = {e["name"] for e in harness.metrics_of(bench, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(bench, w["name"], True)
        assert w["chips"] == 1


def test_config_files_name_their_source_and_cuts():
    bench = harness.manifest()
    for c in bench["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
