"""One run of one cell: set-up, the measured window, the readings, the
comparison with the plain reference, and the result line.

Everything is found by name under the benchmark's folder: the cell's
configuration in ``configs/<config>.json``, its traffic in
``workloads/<cell>.json`` (whose ``runner`` names the module of
``runners/`` that runs it), the reader of each per-layer metric
``<stem>.<suffix>`` in ``metrics/<stem>.py`` (the suffix names the
end-to-end metric's kind of cell, so one reader serves a quantity in
each).  Adding a cell, a configuration or a metric adds files;
none of these is edited.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

# Modules that must not be loaded in the process that prints the result,
# compared by whole top-level names (the port's name begins with the JAX
# package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "phyloformer_tpu")


class Refused(Exception):
    """The run cannot give a result (no card, too few cards, a forbidden
    module); the message goes to standard error and the exit code is 2."""


@dataclasses.dataclass
class Cell:
    """A workload entry of the manifest with its files read."""

    name: str
    entry: Dict[str, Any]
    workload: Dict[str, Any]
    config: Dict[str, Any]
    root: Path  # the checkout
    bench: Path  # the benchmark's folder in it
    manifest: Dict[str, Any]

    def path(self, rel: str) -> Path:
        return self.root / rel


def load_cell(name: str, root: Path, bench: Optional[Path] = None) -> Cell:
    bench = bench or root / "benchmark"
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in manifest["workloads"]}
    if name not in entries:
        raise SystemExit(f"unknown workload {name!r}; the manifest has {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    workload = json.loads((bench / "workloads" / f"{name}.json").read_text())
    return Cell(name, entry, workload, config, root, bench, manifest)


def end_to_end_names(cell: Cell) -> List[str]:
    return [m["name"] for m in cell.manifest["end_to_end"]
            if "workloads" not in m or cell.name in m["workloads"]]


def per_layer_metrics(cell: Cell) -> List[Dict[str, Any]]:
    """The per-layer metrics that list this cell under ``workloads`` (every
    per-layer metric of this benchmark lists its cells)."""
    return [m for m in cell.manifest["per_layer"] if cell.name in m["workloads"]]


def _load(path: Path, name: str):
    """A module from its file: metric and workload names hold dots."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(bench: Path, metric: str) -> Path:
    """The reader of a metric ``<stem>.<suffix>``: ``metrics/<stem>.py``."""
    return bench / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"


def load_reader(bench: Path, metric: str):
    path = reader_path(bench, metric)
    return _load(path, f"bench_metric_{path.stem.replace('.', '_')}").read


def load_runner(bench: Path, kind: str):
    return _load(bench / "runners" / f"{kind}.py", f"bench_runner_{kind}")


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's kernel library builds into its own ``ops/kernels/build/``)."""
    cache = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise Refused("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} cards; {torch.cuda.device_count()} visible")


def forbidden_loaded() -> List[str]:
    top = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


@dataclasses.dataclass
class Reading:
    """What the per-layer readers read: the trace's reduction, the
    program's counters over the window, the benchmark's own spans, and the
    work the window's inputs need (from ``rooflines/``)."""

    cell: str
    sizes: Dict[str, Any]
    window_s: float
    trace: Any  # trace.Summary, or None
    counters: Dict[str, float]
    spans: Dict[str, float]
    model_flop: float  # the published model's operations on the window's inputs
    pair_sites: float  # real pair-sites the window's forwards covered
    units: float  # engine batches or train steps in the window
    late_ms: List[float]
    active_s: float  # seconds in which the system had work: the window, or
    # for served requests the union of their times in flight
    work: Dict[str, float]  # counts of work by name over the window (a runner's
    # ``work``), for readers of other architectures than ``pair_sites`` serves

    def share(self, num: float, den: float) -> Optional[float]:
        """100 num / den, or None where there is nothing to read."""
        return None if not den or den <= 0 or not num else 100.0 * num / den


def run(name: str, seed: int, seconds: float, trace: bool, root: Path,
        t_start: float, device: Optional[str] = None,
        bench: Optional[Path] = None) -> Dict[str, Any]:
    """One run; returns the result line's object.  ``device`` "cpu" (the
    tests' rehearsal) skips the look for a card and runs the port's plain
    versions: its result carries no metric."""
    cell = load_cell(name, root, bench)
    set_cache_dirs(root)
    rehearsal = device == "cpu"
    if not rehearsal:
        require_cards(int(cell.entry["chips"]))
    import torch

    from benchmark.window import Window

    dev = torch.device("cpu" if rehearsal else "cuda")
    runner = load_runner(cell.bench, cell.workload["runner"]).Runner(cell, seed, dev)
    try:
        runner.setup()
        setup_s = time.perf_counter() - t_start
        before = runner.counters()
        with Window(trace, dev) as win:
            out = runner.window(win, seconds)
        out.update(runner.settle())  # what the window's outputs say, read after its close
        after = runner.counters()
        memory_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    finally:
        runner.release()  # stops what the runner started, also where a step failed
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = runner.check()
    for note in getattr(runner, "notes", ()):  # readings for the record, not compared
        print(f"reading {note}", file=sys.stderr)
    limits = cell.workload["limits"]
    correct = all(math.isfinite(checks[k]) and checks[k] <= limits[k] for k in limits)
    bad = forbidden_loaded()
    if bad:
        raise Refused(f"loaded in the result's process: {', '.join(bad)}")

    metrics: Dict[str, Dict[str, Any]] = {}
    breakdown = None
    if not rehearsal and not trace:
        values = dict(out["end_to_end"], setup_s=setup_s)
        units = {m["name"]: m["unit"] for m in cell.manifest["end_to_end"]}
        for m in end_to_end_names(cell):
            metrics[m] = {"value": values[m], "unit": units[m]}
    elif not rehearsal:
        counters = {k: after[k] - before.get(k, 0) for k in after}
        reading = Reading(cell.name, cell.config, win.seconds, win.summary, counters,
                          out.get("spans", {}), out["model_flop"], out["pair_sites"],
                          out["units"], out.get("late_ms", []),
                          out.get("active_s", win.seconds), out.get("work", {}))
        for m in per_layer_metrics(cell):
            value = load_reader(cell.bench, m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if win.summary is not None:
            breakdown = {"device_ops": [list(x) for x in win.summary.device_ops],
                         "idle_gaps": [list(x) for x in win.summary.idle_gaps]}

    result: Dict[str, Any] = {
        "correct": correct, "attempted": out["attempted"], "failed": out["failed"],
        "metrics": metrics,
    }
    if rehearsal:
        result["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                            "memory_peak_bytes": 0}
    else:
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                            "count": int(cell.entry["chips"]),
                            "memory_peak_bytes": int(memory_peak),
                            "power_limit": power_limit()}
        if trace and win.summary is not None:
            result["device"]["busy_s"] = win.summary.busy_s
            result["device"]["window_s"] = win.summary.window_s
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]} for k in limits}
    return result


def print_result(result: Dict[str, Any]) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error; the result as the last line of standard output."""
    print(f"correct {result['correct']}", file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
