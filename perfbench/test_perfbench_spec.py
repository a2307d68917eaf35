"""BENCHMARK.json against the benchmark's contract, and the harness finding
its configurations, traffic mixes and metric readers by name."""
import json
import re

import pytest

from perfbench.cell import HERE, ROOT, cell_parts, load_json, load_spec
from perfbench.harness import metric_reader, metrics_of

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}

SPEC = load_spec()


def line(text):
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def test_top_level():
    assert set(SPEC) == KEYS["top"]
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    for w in cmd:
        assert not w.startswith("/") and ".." not in w
        if (ROOT / w).exists():
            assert any(w.startswith(p + "/") for p in SPEC["paths"])
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the driver's day
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_keys(group):
    items = SPEC[group]
    assert 1 <= len(items) <= {"configs": 24, "workloads": 24,
                               "end_to_end": 16, "per_layer": 128}[group]
    names = [it["name"] for it in items]
    assert len(set(names)) == len(names)
    kind = {"configs": "config", "workloads": "workload"}.get(group, group)
    for it in items:
        assert NAME.match(it["name"]), it["name"]
        extra = {"workloads"} if group in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[kind] <= set(it) <= KEYS[kind] | extra, it["name"]
        if "unit" in it:
            assert UNIT.match(it["unit"]) and it["better"] in ("lower",
                                                               "higher")
        for k in ("why", "layer", "source"):
            if k in it:
                assert line(it[k]), (it["name"], k)


def test_metric_names_differ_across_groups():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(names)) == len(names)


def test_configs():
    files = set()
    for c in SPEC["configs"]:
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        conf = load_json(ROOT / c["file"])
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    assert len({c["source"] for c in SPEC["configs"]}) == len(SPEC["configs"])


def test_workloads():
    pairs = set()
    configs = {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_reports_enough(cell):
    e2e = {m["name"] for m in metrics_of(SPEC, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per = metrics_of(SPEC, cell, True)
    assert per
    assert all(m["moves"] in e2e for m in per)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_harness_finds_the_cell_by_name(cell):
    w, cfg, mix = cell_parts(SPEC, cell)
    assert w["name"] == cell
    assert cfg["name"] == w["config"]
    assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
    assert (HERE / "drivers" / f"{mix['entry']}.py").is_file()
    from perfbench.drivers import Driver, driver_class
    assert issubclass(driver_class(mix["entry"]), Driver)


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    SPEC["end_to_end"] + SPEC["per_layer"]])
def test_harness_finds_each_metric_reader(metric):
    assert callable(metric_reader(metric))


def test_files_under_paths_are_named_from_names():
    for p in SPEC["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            rel = f.relative_to(ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_spec_is_valid_json_and_stable():
    with open(ROOT / "BENCHMARK.json") as f:
        assert json.load(f) == SPEC
