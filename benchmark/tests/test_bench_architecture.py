"""A second architecture enters the benchmark by added files alone.

The stub architecture ``toy`` (``toy_arch/``: its architecture, its
configuration, a cell's traffic, a runner, a reference, a roofline and a
reader, none of which the benchmark has) is copied into a tiny checkout, and
entries are appended to that checkout's BENCHMARK.json.  Then the manifest's
rules pass, the cell runs correct, nothing that was there changes, and the
widths rule still refuses what it refused before, naming the key."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import manifest

TOY = Path(__file__).parent / "toy_arch"
SOURCE = "a stub architecture of the benchmark's tests"
CONFIG = {"name": "toy-fp32", "source": SOURCE, "file": "benchmark/configs/toy-fp32.json",
          "reduced": ["n_layers"], "why": "the stub at three of its four layers"}
CELL = {"name": "infer.toy.grid", "config": "toy-fp32", "traffic": "toy_grid", "chips": 1,
        "why": "a few tiny alignments, one closed-loop caller"}
METRIC = {"name": "toy.work.infer", "unit": "sites/s", "better": "higher",
          "source": "program_counter", "layer": "toy model", "moves": "aln_per_s",
          "workloads": ["infer.toy.grid"]}


def snapshot(root):
    files = sorted(p for p in (root / "benchmark").rglob("*")
                   if p.is_file() and "__pycache__" not in p.parts)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in files + [root / "BENCHMARK.json"]}


def edit_json(path, change):
    data = json.loads(path.read_text())
    change(data)
    path.write_text(json.dumps(data))


def append_entries(m):
    m["configs"].append(CONFIG)
    m["workloads"].append(CELL)
    m["per_layer"].append(METRIC)
    next(x for x in m["end_to_end"] if x["name"] == "aln_per_s")["workloads"].append(CELL["name"])


@pytest.fixture
def toy_root(tiny_root):
    """The tiny checkout with the stub added; its files before, beside it."""
    before = snapshot(tiny_root)
    for src in sorted(TOY.rglob("*")):
        if src.is_file() and "__pycache__" not in src.parts:
            dest = tiny_root / "benchmark" / src.relative_to(TOY)
            assert not dest.exists(), dest
            dest.parent.mkdir(parents=True, exist_ok=True)
            shutil.copy(src, dest)
    edit_json(tiny_root / "BENCHMARK.json", append_entries)
    return tiny_root, before


def test_rules_pass_with_a_second_architecture(toy_root):
    root, _ = toy_root
    assert manifest.problems(root) == []


def test_second_architecture_runs_correct(toy_root):
    """The cell runs in the checkout's own package, and its reader reads the
    runner's ``work``."""
    root, _ = toy_root
    code = (
        "import json, sys, time; sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "import torch\n"
        "from benchmark import harness\n"
        "from benchmark.window import Window\n"
        "root = Path(%r)\n"
        "assert Path(harness.__file__).is_relative_to(root)\n"
        "result = harness.run('infer.toy.grid', 2**31 + 11, 0.3, False, root,"
        " time.perf_counter(), device='cpu')\n"
        "cell = harness.load_cell('infer.toy.grid', root)\n"
        "runner = harness.load_runner(cell.bench, 'toy_offline').Runner(cell, 3, torch.device('cpu'))\n"
        "runner.setup()\n"
        "with Window(False, torch.device('cpu')) as win:\n"
        "    out = runner.window(win, 0.1)\n"
        "reading = harness.Reading(cell.name, cell.config, win.seconds, None, {}, {},"
        " out['model_flop'], out['pair_sites'], out['units'], [], win.seconds, out['work'])\n"
        "read = harness.load_reader(cell.bench, 'toy.work.infer')(reading)\n"
        "print(json.dumps({'result': result, 'read': read,"
        " 'expected': out['work']['sequence_sites'] / win.seconds}))\n" % (str(root), str(root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    result = got["result"]
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    assert result["checks"]["dist_gap"]["value"] <= result["checks"]["dist_gap"]["limit"]
    assert got["read"] == pytest.approx(got["expected"]) and got["read"] > 0


def test_nothing_there_before_changes(toy_root):
    root, before = toy_root
    after = snapshot(root)
    assert {k: after[k] for k in before if k != "BENCHMARK.json"} == {
        k: v for k, v in before.items() if k != "BENCHMARK.json"}
    old, new = json.loads(before["BENCHMARK.json"]), manifest.load(root)
    for key, value in old.items():
        if isinstance(value, list):
            assert len(new[key]) >= len(value)
            for was, now in zip(value, new[key]):
                if isinstance(was, dict) and "workloads" in was:  # appended to, not rewritten
                    assert now["workloads"][:len(was["workloads"])] == was["workloads"]
                    now = dict(now, workloads=was["workloads"])
                assert now == was
        else:
            assert new[key] == value


def _widths_off(root, name, entry_change=None, file_change=None):
    """The widths rule's problems after one change to a configuration."""
    if entry_change:
        edit_json(root / "BENCHMARK.json", lambda m: entry_change(
            next(c for c in m["configs"] if c["name"] == name)))
    config = next(c for c in manifest.load(root)["configs"] if c["name"] == name)
    if file_change:
        edit_json(root / config["file"], file_change)
    return manifest.published_widths(root, config)


CASES = {
    # a toy width off its published value, and not in reduced
    "toy_width_off": ("toy-fp32", "width", None, lambda s: s.update(width=8)),
    # a reduced key below its floor
    "toy_below_floor": ("toy-fp32", "n_layers", None, lambda s: s.update(n_layers=1)),
    # a reduced key that the architecture does not let be cut
    "toy_cut_not_allowed": ("toy-fp32", "width", lambda c: c["reduced"].append("width"),
                            lambda s: (s.update(width=8), s["published"].update(width=16))),
    # Phyloformer as strict as before: no width off, nothing cut
    "phyloformer_embed_dim_32": ("phyloformer-fp32", "embed_dim", None,
                                 lambda s: s.update(embed_dim=32)),
    "phyloformer_n_blocks_cut": ("phyloformer-fp32", "n_blocks",
                                 lambda c: c["reduced"].append("n_blocks"),
                                 lambda s: s.update(n_blocks=3, published={"n_blocks": 6})),
}


@pytest.mark.parametrize("case", CASES)
def test_widths_rule_names_the_key(toy_root, case):
    root, _ = toy_root
    name, key, entry_change, file_change = CASES[case]
    found = _widths_off(root, name, entry_change, file_change)
    assert found and all(p.startswith(f"configs[{name}].") for p in found)
    assert any(key in p for p in found), found
    assert manifest.problems(root) == found
