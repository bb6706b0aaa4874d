"""BENCHMARK.json keeps to the form its readers require, and every cell resolves to
its configuration, traffic and reader files."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
LINE = re.compile(r"[^\t\n\r]{1,200}")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head)|(_dim|_rank)$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells: 2 + 14 x 24 runs at run_seconds + 60, 2 x 90 a cell, 1200 spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.fullmatch(e["name"]), e["name"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.fullmatch(c["source"]) and LINE.fullmatch(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.fullmatch(k) for k in c["reduced"])
        assert not any(WIDTHS.search(k) for k in c["reduced"])
    for wl in BENCH["workloads"]:
        assert set(wl) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(wl["traffic"]) and wl["chips"] in (1, 4) and LINE.fullmatch(wl["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.fullmatch(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    wl = harness.find_cell(BENCH, cell)
    assert cell == f"{wl['config']}.{wl['traffic']}"
    config = next(c for c in BENCH["configs"] if c["name"] == wl["config"])
    assert (ROOT / config["file"]).is_file() and config["file"].startswith("portbench/")
    cfg = harness.load_config(wl["config"])
    assert cfg["reduced"] == config["reduced"]
    assert all(k in cfg["call"] for k in cfg["reduced"])
    assert harness.load_adapter(cfg["entry"]).Adapter
    traffic = harness.load_traffic(wl["traffic"])
    assert harness.load_generator(traffic["generator"]).make
    e2e = harness.cell_metrics(BENCH, cell, trace=False)
    layer = harness.cell_metrics(BENCH, cell, trace=True)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2 and layer
    for m in e2e + layer:
        assert hasattr(harness.load_reader(m["name"]), "read")
    for m in layer:
        assert m["moves"] in [e["name"] for e in e2e]


def test_every_config_is_used():
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
