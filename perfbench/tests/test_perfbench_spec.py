"""BENCHMARK.json against the benchmark's contract, and every name in it
against the file the harness finds for it."""
import json
import re

import pytest

from conftest import ROOT
from perfbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "perfbench/run.py"]
    assert spec["paths"] == ["perfbench"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(spec, kind):
    names = [e["name"] for e in spec[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs_resolve(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert (ROOT / "perfbench" / "systems" / f"{cfg['family']}.py").is_file()
        assert (ROOT / "perfbench" / "reference" / f"{cfg['family']}.py").is_file()
        assert set(cfg["limits"]) == {"widest_gap", "outside_span_changed"}
        assert any(w["config"] == c["name"] for w in spec["workloads"])


def test_workloads_resolve(spec):
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
        cell, entry, cfg, mix = core.cell_parts(spec, w["name"])
        assert mix["bucket"] in cfg["batch_buckets"]
        driver = core.load_module(core.find("drivers", mix["driver"]))
        assert all(callable(getattr(driver, f)) for f in ("traffic", "warm", "window"))
    assert len(pairs) == len(spec["workloads"])


def test_metrics_resolve(spec):
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert core.find("metrics", m["name"]).is_file(), m["name"]
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        mod = core.load_module(core.find("metrics", m["name"]))
        assert callable(mod.read)
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in spec["end_to_end"]}
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200


def test_every_cell_reports_enough(spec):
    for w in spec["workloads"]:
        e2e = {m["name"] for m in core.metrics_of(spec, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = core.metrics_of(spec, w["name"], True)
        assert per_layer and all(m["moves"] in e2e for m in per_layer)


def test_rooflines_and_mfu_are_shares(spec):
    for m in spec["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
