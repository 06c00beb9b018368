"""BENCHMARK.json against the contract's rules and the files it names."""

import json
import re

import pytest

from benchmark import harness
from conftest import REPO

MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["benchmark"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", METRICS + MANIFEST["workloads"] + MANIFEST["configs"],
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
            assert "\t" not in entry[key]


def test_unique_names():
    for group in (METRICS, MANIFEST["workloads"], MANIFEST["configs"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_end_to_end_rules():
    names = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert names["setup_s"]["bound"] <= 0.25 and "workloads" not in names["setup_s"]
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("metric", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_per_layer_cells_report_what_it_moves(metric):
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    moved = e2e[metric["moves"]]
    for cell in metric["workloads"]:
        assert "workloads" not in moved or cell in moved["workloads"]
    assert metric["workloads"], "every per-layer metric lists its cells"
    assert "." in metric["name"], "named <stem>.<suffix>: its reader is metrics/<stem>.py"
    assert harness.reader_path(REPO / "benchmark", metric["name"]).is_file()
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cells_have_files(cell):
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    assert (REPO / configs[cell["config"]]["file"]).is_file()
    wl = json.loads((REPO / "benchmark" / "workloads" / f"{cell['name']}.json").read_text())
    assert (REPO / "benchmark" / "runners" / f"{wl['runner']}.py").is_file()
    assert wl["limits"] and cell["chips"] == 1
    e2e = [m for m in MANIFEST["end_to_end"]
           if "workloads" not in m or cell["name"] in m["workloads"]]
    assert len(e2e) >= 2 and any(cell["name"] in m.get("workloads", ()) for m in
                                 MANIFEST["per_layer"])


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_configs_are_published_widths(config):
    sizes = json.loads((REPO / config["file"]).read_text())
    assert config["reduced"] == []
    assert (sizes["n_blocks"], sizes["n_heads"], sizes["embed_dim"], sizes["ffn_dim"],
            sizes["in_channels"], sizes["dropout"]) == (6, 4, 64, 256, 22, 0.0)
    assert sizes["source"] == config["source"]
