"""The port's benchmark-grid tools against the JAX package's, on the CPU.

``make_grid_data`` writes the grid's trees and alignments on both sides (its
``TIPS`` and ``LENGTHS`` set to 8 and 12 tips and 60 and 120 sites, 2
replicates); ``run_grid`` then runs PF (``pf_mre_r5.ckpt``, under the marker
``PF_r5`` so that the renaming runs), ``Hamming_FastME``, ``ML_FastME`` and
``ml_refine`` over the port's grid on both sides, as its users run it (JAX's
``tools/run_grid.py --cpu``, the port's ``python -m
phyloformer_tpu_torch.tools.run_grid --device cpu``), and ``summarize_grid``
reads the port's output on both sides.  The JAX tools are imported from
``tools/`` as modules, as ``tests/test_run_grid.py`` does.

The host methods give JAX's trees and CSVs to the byte.  PF's distances are
the plain fp32 model's on both sides (JAX: its XLA route), so they agree
within the whole-forward bar ``DIST_TOL``, and each tree's KF within
``KF_TOL`` of max(1, KF) unless the two trees differ in topology: such a
flip is named, and at most ``MAX_FLIPS`` of the 8 may flip.
"""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_model import CKPT, PORT_THREAD_ENV, REPO
from torch_side_by_side import files_of

KF_TOL = 1e-4
MAX_FLIPS = 1
DIST_TOL = 5e-5
TIPS, LENGTHS, REPS = (8, 12), (60, 120), 2
PF_MARKER = "PF_r5"
HOST_METHODS = ("Hamming_FastME", "ML_FastME", "ml_refine")
MARKERS = (PF_MARKER,) + HOST_METHODS
JAX_ENV = {**os.environ, **PORT_THREAD_ENV, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)}
PORT_ENV = {**os.environ, **PORT_THREAD_ENV}

_JAX_TOOL = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("{name}", "tools/{name}.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
"""


def _start(side, code_or_module, args, tool=None):
    """A side's process: JAX's ``tools/<tool>.py`` imported as a module and its
    ``main(args)`` called after ``code_or_module`` (setup code), or the port's
    ``python -m <module> args``."""
    if side == "jax":
        prog = (_JAX_TOOL.format(name=tool) + code_or_module
                + f"\nsys.exit(mod.main({[str(a) for a in args]!r}))\n")
        cmd, env = [sys.executable, "-c", prog], JAX_ENV
    else:
        cmd, env = [sys.executable, "-m", code_or_module] + [str(a) for a in args], PORT_ENV
    return subprocess.Popen(cmd, cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _wait(procs, timeout=600):
    """{name: (rc, stdout, stderr)} of every process."""
    out = {}
    try:
        for name, p in procs.items():
            o, e = p.communicate(timeout=timeout)
            out[name] = (p.returncode, o, e)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    root = tmp_path_factory.mktemp("grid")
    sizes = f"mod.TIPS, mod.LENGTHS = {TIPS!r}, {LENGTHS!r}\n"
    port_grid = f"""
from phyloformer_tpu_torch.tools import make_grid_data as mod
{sizes}assert mod.main([{str(root / 'port_grid')!r}, "--reps", "{REPS}"]) == 0
"""
    res = _wait({
        "jax": _start("jax", sizes, [root / "jax_grid", "--reps", REPS], "make_grid_data"),
        "port": subprocess.Popen([sys.executable, "-c", port_grid], cwd=str(REPO),
                                 env=PORT_ENV, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)})
    for side, (rc, _, err) in res.items():
        assert rc == 0, f"make_grid_data ({side}): {err[-3000:]}"
    common = ["--grid-root", root / "port_grid", "--lengths", ",".join(map(str, LENGTHS)),
              "--pf-weights", CKPT, "--pf-marker", PF_MARKER]
    methods = ["--methods", ",".join(("PF",) + HOST_METHODS)]
    fasttree = ["--methods", "FastTree", "--lengths", str(LENGTHS[0])]
    mod = "phyloformer_tpu_torch.tools.run_grid"
    runs = _wait({
        "jax": _start("jax", "", common + methods + ["--out", root / "jax_out", "--cpu"],
                      "run_grid"),
        "port": _start("port", mod, common + methods + ["--out", root / "port_out",
                                                        "--device", "cpu"]),
        "jax_fasttree": _start("jax", "", common + fasttree + ["--out", root / "jax_ft",
                                                               "--cpu"], "run_grid"),
        "port_fasttree": _start("port", mod, common + fasttree + ["--out", root / "port_ft",
                                                                  "--device", "cpu"])})
    for side in ("jax", "port"):
        rc, _, err = runs[side]
        assert rc == 0, f"run_grid ({side}): {err[-3000:]}"
    summary = _wait({
        "jax": _start("jax", "", [root / "jax_summary.csv", root / "port_out"],
                      "summarize_grid"),
        "port": _start("port", "phyloformer_tpu_torch.tools.summarize_grid",
                       [root / "port_summary.csv", root / "port_out"])})
    return root, runs, summary


def _rows(path):
    with open(path) as fh:
        return list(csv.DictReader(fh))


def test_grid_data_is_jax_bit_for_bit(grid):
    root, _, _ = grid
    jax_files, port_files = files_of(root / "jax_grid"), files_of(root / "port_grid")
    assert sorted(port_files) == sorted(jax_files)
    n = len(TIPS) * REPS
    for L in LENGTHS:
        assert len([f for f in port_files if f.startswith(f"L{L}/msas/")]) == n
    assert [f for f in port_files if port_files[f] != jax_files[f]] == []


@pytest.mark.parametrize("method", HOST_METHODS)
def test_host_methods_write_jax_trees_and_csvs(grid, method):
    root, _, _ = grid
    m = method.lower()
    for L in LENGTHS:
        jax_dir, port_dir = root / "jax_out" / f"L{L}", root / "port_out" / f"L{L}"
        trees = files_of(port_dir / f"trees_{m}")
        assert len(trees) == len(TIPS) * REPS
        assert trees == files_of(jax_dir / f"trees_{m}")
        assert files_of(port_dir / f"matrices_{m}") == files_of(jax_dir / f"matrices_{m}")
        for kind in ("topos", "brlens") + (("dists",) if method != "ml_refine" else ()):
            name = f"{kind}_{m}.csv"
            assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes(), (L, name)


def test_pf_distances_agree_with_jax(grid):
    from phyloformer_tpu.data.phylip import read_phylip

    root, _, _ = grid
    m = PF_MARKER.lower()
    worst = 0.0
    for L in LENGTHS:
        jax_dir, port_dir = root / "jax_out" / f"L{L}", root / "port_out" / f"L{L}"
        assert not (port_dir / "matrices_pf").exists()  # renamed to the marker
        names = sorted(p.name for p in (port_dir / f"matrices_{m}").glob("*.phy"))
        assert len(names) == len(TIPS) * REPS
        assert names == sorted(p.name for p in (jax_dir / f"matrices_{m}").glob("*.phy"))
        for name in names:
            got, got_ids = read_phylip(port_dir / f"matrices_{m}" / name)
            want, want_ids = read_phylip(jax_dir / f"matrices_{m}" / name)
            assert got_ids == want_ids
            worst = max(worst, float(np.abs(np.asarray(got) - np.asarray(want)).max()))
    assert worst <= DIST_TOL, worst


def test_pf_kf_within_tolerance_or_named_flip(grid):
    from phyloformer_tpu.trees.native import compare_newick

    root, _, _ = grid
    m = PF_MARKER.lower()
    flips, n = [], 0
    for L in LENGTHS:
        jax_dir, port_dir = root / "jax_out" / f"L{L}", root / "port_out" / f"L{L}"
        want = {r["id"]: r for r in _rows(jax_dir / f"topos_{m}.csv")}
        got = _rows(port_dir / f"topos_{m}.csv")
        assert sorted(r["id"] for r in got) == sorted(want)
        for r in got:
            n += 1
            assert r["marker"] == PF_MARKER
            kf, ref = float(r["kf_score"]), float(want[r["id"]]["kf_score"])
            stem = r["id"]
            if compare_newick((port_dir / f"trees_{m}" / f"{stem}.nwk").read_text(),
                              (jax_dir / f"trees_{m}" / f"{stem}.nwk").read_text()).rf:
                flips.append((L, stem, kf, ref))
                continue
            assert abs(kf - ref) <= KF_TOL * max(1.0, ref), (L, stem, kf, ref)
    assert n == len(LENGTHS) * len(TIPS) * REPS
    assert len(flips) <= MAX_FLIPS, f"topology flips (L, alignment, port KF, JAX KF): {flips}"


def test_grid_metrics_has_jax_columns_and_rows(grid):
    root, _, _ = grid
    with open(root / "jax_out" / "grid_metrics.csv") as fh:
        jax_header = fh.readline()
    with open(root / "port_out" / "grid_metrics.csv") as fh:
        assert fh.readline() == jax_header
    want, got = _rows(root / "jax_out" / "grid_metrics.csv"), _rows(
        root / "port_out" / "grid_metrics.csv")
    key = ("marker", "length", "tips", "n")
    assert [tuple(r[k] for k in key) for r in got] == [tuple(r[k] for k in key) for r in want]
    assert len(got) == len(MARKERS) * len(LENGTHS) * len(TIPS)
    for g, w in zip(got, want):
        if g["marker"] != PF_MARKER:
            assert g == w
        else:
            assert abs(float(g["dist_mae"]) - float(w["dist_mae"])) <= DIST_TOL


@pytest.mark.parametrize("marker", MARKERS)
def test_execution_rows_and_stages_are_jax(grid, marker):
    """Each method's execution CSV has JAX's columns and (timer, marker, id)
    rows in JAX's order, each time finite; its stages JSON JAX's keys."""
    root, _, _ = grid
    m = marker.lower()
    for L in LENGTHS:
        jax_dir, port_dir = root / "jax_out" / f"L{L}", root / "port_out" / f"L{L}"
        with open(port_dir / f"execution_{m}.csv") as a, open(jax_dir / f"execution_{m}.csv") as b:
            assert a.readline() == b.readline() == "timer,marker,id,elapsed_sec,MaxRSS_kb\n"
        got, want = _rows(port_dir / f"execution_{m}.csv"), _rows(jax_dir / f"execution_{m}.csv")
        assert [(r["timer"], r["marker"], r["id"]) for r in got] == [
            (r["timer"], r["marker"], r["id"]) for r in want]
        assert all(np.isfinite(float(r["elapsed_sec"])) for r in got)
        s_got = json.loads((port_dir / f"stages_{m}.json").read_text())
        s_want = json.loads((jax_dir / f"stages_{m}.json").read_text())
        assert (s_got["length"], s_got["method"]) == (s_want["length"], s_want["method"])
        assert sorted(s_got["stages"]) == sorted(s_want["stages"])
    if marker == PF_MARKER:
        assert [r["timer"] for r in got[:3]] == ["model_load", "compile_warmup", "inference"]


def test_fasttree_raises_on_both_sides(grid):
    """No FastTree binary: both tools stop with FileNotFoundError naming it."""
    _, runs, _ = grid
    for side in ("jax_fasttree", "port_fasttree"):
        rc, _, err = runs[side]
        assert rc != 0, side
        assert "FileNotFoundError: no FastTree binary found" in err, (side, err[-2000:])


def test_summarize_grid_output_is_jax(grid):
    root, _, summary = grid
    for side, (rc, _, err) in summary.items():
        assert rc == 0, f"summarize_grid ({side}): {err[-2000:]}"
    assert summary["port"][1] == summary["jax"][1]
    assert (root / "port_summary.csv").read_bytes() == (root / "jax_summary.csv").read_bytes()
    rows = _rows(root / "port_summary.csv")
    assert sorted({(r["marker"], r["length"]) for r in rows}) == sorted(
        (mk, str(L)) for mk in MARKERS for L in LENGTHS)
