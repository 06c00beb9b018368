"""The rules that ``BENCHMARK.json`` and the files it names keep, as
functions of a checkout's root.

Each rule returns its problems, one string a problem naming the entry and
the key at fault; an empty list is a pass.  Rules of one entry (a metric, a
cell, a configuration) take the entry; :func:`problems` runs every rule on
every entry.

A configuration is held to the published widths of its own architecture:
its file names an ``architecture``, and ``architectures/<architecture>.json``
gives that architecture's ``published`` sizes and ``may_cut``, the keys that
a cell may cut with the least value each may take.  A second architecture
enters by added files alone.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, List

from benchmark import harness

Entry = Dict[str, Any]

TOP_LEVEL = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
             "per_layer"}
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: Path) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def bench(root: Path) -> Path:
    return root / "benchmark"


def metrics(manifest: Dict[str, Any]) -> List[Entry]:
    return manifest["end_to_end"] + manifest["per_layer"]


def top_level_keys(root: Path) -> List[str]:
    m, out = load(root), []
    if set(m) != TOP_LEVEL:
        out.append(f"top level: keys {sorted(m)}, not {sorted(TOP_LEVEL)}")
    if m.get("paths") != ["benchmark"]:
        out.append(f"paths: {m.get('paths')!r}, not ['benchmark']")
    if not 1 <= m.get("run_seconds", 0) <= 51:
        out.append(f"run_seconds: {m.get('run_seconds')!r}, not 1 to 51")
    if len((root / "BENCHMARK.json").read_bytes()) > 64 * 1024:
        out.append("BENCHMARK.json: over 64 KiB")
    return out


def names_and_units(root: Path, entry: Entry) -> List[str]:
    """A name, a unit, ``better``, ``source``, and the one-line texts."""
    name, out = entry["name"], []
    if not NAME.match(name):
        out.append(f"{name!r}.name: not a name")
    if "unit" in entry:
        if not UNIT.match(entry["unit"]):
            out.append(f"{name}.unit: {entry['unit']!r} is not a unit")
        if entry["better"] not in ("lower", "higher"):
            out.append(f"{name}.better: {entry['better']!r}")
        if entry["source"] not in SOURCES:
            out.append(f"{name}.source: {entry['source']!r}")
    for key in ("why", "layer", "source"):
        text = entry.get(key)
        if text is not None and not (1 <= len(text) <= 200 and "\n" not in text
                                     and "\t" not in text):
            out.append(f"{name}.{key}: not one line of 1 to 200 characters without a tab")
    return out


def unique_names(root: Path) -> List[str]:
    m, out = load(root), []
    for group, entries in (("metrics", metrics(m)), ("workloads", m["workloads"]),
                           ("configs", m["configs"])):
        names = [e["name"] for e in entries]
        for name in sorted({n for n in names if names.count(n) > 1}):
            out.append(f"{group}[{name}].name: given twice")
    return out


def end_to_end_rules(root: Path) -> List[str]:
    """Every end-to-end bound from 1% to 25%, from the host's clock or the
    device's trace; ``setup_s`` in every cell."""
    e2e, out = load(root)["end_to_end"], []
    setup = [m for m in e2e if m["name"] == "setup_s"]
    if not setup:
        out.append("end_to_end[setup_s]: missing")
    elif setup[0]["bound"] > 0.25 or "workloads" in setup[0]:
        out.append("end_to_end[setup_s]: bound over 0.25, or a list of workloads")
    for m in e2e:
        if not 0.01 <= m["bound"] <= 0.25:
            out.append(f"end_to_end[{m['name']}].bound: {m['bound']!r}, not 0.01 to 0.25")
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"end_to_end[{m['name']}].source: {m['source']!r}")
    return out


def per_layer_cells(root: Path, metric: Entry) -> List[str]:
    """The metric lists its cells, each of which reports what it moves, and
    its reader ``metrics/<stem>.py`` is there."""
    m, name, out = load(root), metric["name"], []
    e2e = {x["name"]: x for x in m["end_to_end"]}
    moved = e2e.get(metric["moves"])
    if moved is None:
        return [f"per_layer[{name}].moves: {metric['moves']!r} is no end-to-end metric"]
    for cell in metric.get("workloads", ()):
        if "workloads" in moved and cell not in moved["workloads"]:
            out.append(f"per_layer[{name}].workloads: {cell} does not report {moved['name']}")
    if not metric.get("workloads"):
        out.append(f"per_layer[{name}].workloads: every per-layer metric lists its cells")
    if "." not in name:
        out.append(f"per_layer[{name}].name: not <stem>.<suffix>, so it has no reader")
    elif not harness.reader_path(bench(root), name).is_file():
        out.append(f"per_layer[{name}]: no reader {harness.reader_path(bench(root), name).name}")
    if ("roofline" in name or "mfu" in name) and metric["unit"] != "%":
        out.append(f"per_layer[{name}].unit: a share of a roofline or a peak is in %")
    return out


def cell_files(root: Path, cell: Entry) -> List[str]:
    """The cell's configuration and traffic files and its runner are there;
    it has limits, one chip, ``setup_s`` and another end-to-end metric, and a
    per-layer metric."""
    m, name, out = load(root), cell["name"], []
    configs = {c["name"]: c for c in m["configs"]}
    if cell["config"] not in configs:
        return [f"workloads[{name}].config: no configuration {cell['config']!r}"]
    if not (root / configs[cell["config"]]["file"]).is_file():
        out.append(f"workloads[{name}].config: no file {configs[cell['config']]['file']}")
    path = bench(root) / "workloads" / f"{name}.json"
    if not path.is_file():
        return out + [f"workloads[{name}]: no file workloads/{name}.json"]
    wl = json.loads(path.read_text())
    if not (bench(root) / "runners" / f"{wl.get('runner')}.py").is_file():
        out.append(f"workloads[{name}].runner: no file runners/{wl.get('runner')}.py")
    if not wl.get("limits"):
        out.append(f"workloads[{name}].limits: none")
    if cell["chips"] != 1:
        out.append(f"workloads[{name}].chips: {cell['chips']!r}, not 1")
    e2e = [x for x in m["end_to_end"] if "workloads" not in x or name in x["workloads"]]
    if len(e2e) < 2:
        out.append(f"workloads[{name}]: reports no end-to-end metric besides setup_s")
    if not any(name in x.get("workloads", ()) for x in m["per_layer"]):
        out.append(f"workloads[{name}]: no per-layer metric lists it")
    return out


def published_widths(root: Path, config: Entry) -> List[str]:
    """The configuration file names its ``architecture``; every published
    size of ``architectures/<architecture>.json`` is the file's, except a
    key in the entry's ``reduced``, which that architecture's ``may_cut``
    allows, at its floor or above and below the published value, with the
    published value stated under the file's ``published``; and the file's
    ``source`` is the entry's."""
    name, out = config["name"], []
    sizes = json.loads((root / config["file"]).read_text())
    arch_name = sizes.get("architecture")
    path = bench(root) / "architectures" / f"{arch_name}.json"
    if not isinstance(arch_name, str) or not path.is_file():
        return [f"configs[{name}].architecture: {arch_name!r}, with no file "
                f"architectures/<architecture>.json"]
    arch = json.loads(path.read_text())
    published, may_cut, reduced = arch["published"], arch["may_cut"], config["reduced"]
    for key, value in published.items():
        if key not in reduced and sizes.get(key) != value:
            out.append(f"configs[{name}].{key}: {sizes.get(key)!r}, published {value!r}, "
                       f"and not in reduced")
    for key in reduced:
        if key not in may_cut:
            out.append(f"configs[{name}].reduced: {key} may not be cut ({arch_name}'s may_cut "
                       f"is {sorted(may_cut)})")
            continue
        value, full = sizes.get(key), published.get(key)
        if full is None or not isinstance(value, (int, float)) or not (
                may_cut[key] <= value < full):
            out.append(f"configs[{name}].{key}: {value!r}, not from the floor {may_cut[key]!r} "
                       f"up to below the published {full!r}")
        if sizes.get("published", {}).get(key) != full:
            out.append(f"configs[{name}].published.{key}: the file does not state the "
                       f"published {full!r}")
    if sizes.get("source") != config["source"]:
        out.append(f"configs[{name}].source: the file's is not the entry's")
    return out


def problems(root: Path) -> List[str]:
    """Every rule on every entry of the manifest at ``root``."""
    m = load(root)
    out = top_level_keys(root) + unique_names(root) + end_to_end_rules(root)
    for entry in metrics(m) + m["workloads"] + m["configs"]:
        out += names_and_units(root, entry)
    for metric in m["per_layer"]:
        out += per_layer_cells(root, metric)
    for cell in m["workloads"]:
        out += cell_files(root, cell)
    for config in m["configs"]:
        out += published_widths(root, config)
    return out
