"""The end-to-end commands of ``pf-bench-torch`` (``pipeline``,
``crossmatrix``, ``report``, ``figures``; ``phyloformer_tpu_torch.bench``)
against the JAX package's ``pf-bench``, on the CPU.

Each side runs in a fresh interpreter (:mod:`torch_side_by_side`).  The
inputs: 8 birth-death trees of 8, 10 and 14 tips from
``pf-simulate-trees-torch`` and LG alignments of 70 to 140 sites on them
from ``pf-simulate-alignments-torch`` (ragged sizes; one alignment given
gaps and one a duplicate row with numpy), and ``pf_mre_r5.ckpt`` at its full
width.  The port runs ``--device cpu``: the kernels' plain versions, or the
eager model with ``--eager``; JAX runs its XLA route (``use_pallas=False``,
``pf-bench``'s default).  Bars:

- ``pipeline``: every distance within ``DIST_TOL`` (5e-5) of max(1,
  max|ref|) of JAX's, the same topology on every alignment (RF 0 between
  the two sides' trees), ``mean_kf`` within ``KF_TOL`` (1e-4), and the
  same (stage, id) rows of the CSV in the same order; ``--eager`` within
  ``DIST_TOL`` too;
- ``crossmatrix`` on pf_mre_r5 and pf_mre_r4 x one dataset: the JSON within
  ``KF_TOL``, the same ``topos_*`` rows, the heatmap written;
- ``report`` on matrices and trees that JAX's ``pf-infer`` and ``pf-tree``
  wrote: its CSVs and JSON byte-equal, and with ``--figures`` the same
  figures; ``figures`` on the same CSVs: the same set of files and JSON.
"""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from phyloformer_tpu.trees.native import compare_newick
from test_torch_model import CKPT, REPO
from torch_side_by_side import ENV, files_of, run_both, run_clis_both

DIST_TOL = 5e-5  # of max(1, max|ref|), the engine's bar
KF_TOL = 1e-4
CKPT_R4 = REPO / "artifacts" / "pf_mre_r4.ckpt"


@pytest.fixture(scope="module")
def bench_inputs(tmp_path_factory):
    """``root/trees/*.nwk`` and ``root/alns/*.fa``, the 8 examples."""
    root = tmp_path_factory.mktemp("bench")
    sim = [("phyloformer_tpu_torch.sim.cli_trees",
            ["-n", str(k), "-t", str(tips), "-o", str(root / "trees"), "--seed", str(seed)])
           for k, tips, seed in ((3, 8, 21), (3, 10, 22), (2, 14, 23))]
    for tips, length in ((8, 70), (10, 100), (14, 140)):
        sim.append(("phyloformer_tpu_torch.sim.cli_msa",
                    [str(root / "trees" / f"t{tips}"), str(root / "alns"), "-l", str(length),
                     "--seed", str(tips), "--allow-duplicate-sequences"]))
    prog = ("import importlib, os, shutil, sys\n"
            f"root = {str(root)!r}\n"
            f"for m, a in {sim[:3]!r}:\n"
            "    assert importlib.import_module(m).main(a) == 0, (m, a)\n"
            "for name in sorted(os.listdir(root + '/trees')):\n"  # a directory per size
            "    d = root + '/trees/t' + name.split('_')[1]\n"
            "    os.makedirs(d, exist_ok=True)\n"
            "    shutil.copy(root + '/trees/' + name, d)\n"
            f"for m, a in {sim[3:]!r}:\n"
            "    assert importlib.import_module(m).main(a) == 0, (m, a)\n")
    r = subprocess.run([sys.executable, "-c", prog], cwd=str(REPO), env=ENV,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    stems = sorted(p.stem for p in (root / "alns").glob("*.fa"))
    assert len(stems) == 8, stems
    rng = np.random.default_rng(9)
    # gaps in one alignment, a duplicate row (a new id) in another
    for stem, edit in ((stems[0], "gaps"), (stems[4], "duplicate")):
        path = root / "alns" / f"{stem}.fa"
        lines = path.read_text().splitlines()
        if edit == "gaps":
            for k in range(1, len(lines), 2):
                row = np.array(list(lines[k]))
                row[rng.random(len(row)) < 0.2] = "-"
                lines[k] = "".join(row)
        else:
            lines[3] = lines[1]
        path.write_text("\n".join(lines) + "\n")
    return root, stems


_PIPELINE = """
import contextlib, io, json
from $PKG.bench import cli
from $PKG.infer.engine import InferenceEngine
from $PKG.trees import native
predict, build = InferenceEngine.predict, native.build_tree_from_phylip
seen = {"preds": [], "trees": []}
def recording_predict(self, alns):
    out = predict(self, alns)
    seen["preds"] += out
    return out
def recording_build(phy, *args):
    nwk = build(phy, *args)
    seen["trees"].append(nwk)
    return nwk
InferenceEngine.predict, native.build_tree_from_phylip = recording_predict, recording_build
port = "$PKG" == "phyloformer_tpu_torch"
routes = {"main": [], "eager": ["--eager"]} if port else {"main": []}
for route, flags in routes.items():
    seen["preds"], seen["trees"] = [], []
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["pipeline", str(IN["ckpt"]), str(IN["alns"]), "--true-trees",
                       str(IN["trees"]), "-o", str(IN["out"]) + f"/$PKG.{route}.csv"]
                      + flags + (["--device", "cpu"] if port else []))
    assert rc == 0
    OUT[f"{route}.summary"] = buf.getvalue()
    OUT[f"{route}.trees"] = seen["trees"]
    for k, p in enumerate(seen["preds"]):
        OUT[f"{route}.pred{k}"] = p
"""


@pytest.fixture(scope="module")
def pipeline_runs(bench_inputs, tmp_path_factory):
    root, stems = bench_inputs
    out = tmp_path_factory.mktemp("pipeline")
    res = run_both(_PIPELINE, {"ckpt": str(CKPT), "alns": str(root / "alns"),
                               "trees": str(root / "trees"), "out": str(out)}, out)
    return stems, res, out


def _rel(got, want):
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("route", ["main", "eager"])
def test_pipeline_distances_match_jax(route, pipeline_runs):
    stems, res, _ = pipeline_runs
    want, got = res["jax"], res["port"]
    for k in range(len(stems)):
        w, g = want[f"main.pred{k}"], got[f"{route}.pred{k}"]
        assert g.shape == w.shape and np.isfinite(g).all(), stems[k]
        assert _rel(g, w) <= DIST_TOL, (stems[k], _rel(g, w))


def test_pipeline_topologies_and_kf_match_jax(pipeline_runs):
    """The BME+NNI+SPR tree of every alignment has JAX's topology, and the
    mean KF to the true trees is JAX's."""
    stems, res, _ = pipeline_runs
    want_trees, got_trees = res["jax"]["main.trees"], res["port"]["main.trees"]
    assert len(want_trees) == len(got_trees) == len(stems)
    for stem, w, g in zip(stems, want_trees, got_trees):
        assert compare_newick(str(w), str(g)).rf == 0, stem
    want = json.loads(str(res["jax"]["main.summary"]))
    got = json.loads(str(res["port"]["main.summary"]))
    assert got["n_alignments"] == want["n_alignments"] == len(stems)
    assert np.isfinite(got["mean_kf"]) and abs(got["mean_kf"] - want["mean_kf"]) <= KF_TOL
    assert sorted(got["stages"]) == sorted(want["stages"])


def _rows(path):
    with open(path) as fh:
        return list(csv.DictReader(fh))


def test_pipeline_csv_rows_match_jax(pipeline_runs):
    """The execution CSV: JAX's columns, and its (stage, id) rows in its
    order: model_load, data_load, inference, a fastme row per alignment,
    a compare row per alignment with a true tree."""
    stems, _, out = pipeline_runs
    want = _rows(out / "phyloformer_tpu.main.csv")
    got = _rows(out / "phyloformer_tpu_torch.main.csv")
    assert list(got[0]) == list(want[0]) == ["timer", "marker", "id", "elapsed_sec",
                                             "MaxRSS_kb"]
    assert [(r["timer"], r["marker"], r["id"]) for r in got] == [
        (r["timer"], r["marker"], r["id"]) for r in want]
    assert [r["timer"] for r in got[:3]] == ["model_load", "data_load", "inference"]
    assert [r["id"] for r in got if r["timer"] == "fastme"] == stems
    assert [r["id"] for r in got if r["timer"] == "compare"] == stems
    assert all(float(r["elapsed_sec"]) >= 0 and int(r["MaxRSS_kb"]) > 0 for r in got)


def test_pipeline_runs_on_the_card_by_default(tmp_path):
    """Without ``--device``, ``pipeline`` and ``crossmatrix`` ask for the
    card: here, without one, they raise before any work."""
    code = f"""
import json, torch
from phyloformer_tpu_torch.bench import cli
res = {{"cuda": torch.cuda.is_available(),
       "defaults": [cli.build_parser().parse_args(a).device for a in (
           ["pipeline", "w", "d"], ["crossmatrix", "--models", "w", "--datasets", "d=a:t",
                                    "-o", "o"])]}}
if not res["cuda"]:
    for name, argv in (("pipeline", ["pipeline", {str(CKPT)!r}, {str(tmp_path)!r}]),
                       ("crossmatrix", ["crossmatrix", "--models", {str(CKPT)!r}, "--datasets",
                                        "d={tmp_path}:{tmp_path}", "-o",
                                        {str(tmp_path / "cm")!r}])):
        try:
            cli.main(argv)
            res[name] = "ran"
        except RuntimeError as e:
            res[name] = str(e)
print(json.dumps(res))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=ENV,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["defaults"] == ["cuda", "cuda"]
    if not out["cuda"]:
        assert "no CUDA device" in out["pipeline"] and "no CUDA device" in out["crossmatrix"]
        assert not (tmp_path / "cm").exists()


@pytest.fixture(scope="module")
def crossmatrix_runs(bench_inputs, tmp_path_factory):
    root, _ = bench_inputs
    out = tmp_path_factory.mktemp("crossmatrix")
    jobs = [("$PKG.bench.cli", ["crossmatrix", "--models", str(CKPT), f"r4={CKPT_R4}",
                                "--datasets", f"sim={root / 'alns'}:{root / 'trees'}", "-o",
                                "$OUT/cm"])]
    return run_clis_both(jobs, out, port_args=["--device", "cpu"]), out


def test_crossmatrix_matches_jax(crossmatrix_runs):
    res, out = crossmatrix_runs
    (want,), (got,) = res["jax"]["res"], res["port"]["res"]
    assert want["rc"] == got["rc"] == 0, got
    w = json.loads((out / "jax" / "cm" / "crossmatrix.json").read_text())
    g = json.loads((out / "port" / "cm" / "crossmatrix.json").read_text())
    assert json.loads(got["out"]) == g
    assert sorted(g) == sorted(w) == ["pf_mre_r5", "r4"]
    for model in w:
        assert sorted(g[model]) == sorted(w[model]) == ["sim"]
        assert np.isfinite(g[model]["sim"])
        assert abs(g[model]["sim"] - w[model]["sim"]) <= KF_TOL, (model, g, w)
    for model in w:
        name = f"topos_{model}_sim.csv"
        rw, rg = _rows(out / "jax" / "cm" / name), _rows(out / "port" / "cm" / name)
        assert [r["id"] for r in rg] == [r["id"] for r in rw] and len(rg) == 8
        for a, b in zip(rg, rw):
            for k in ("norm_rf", "kf_score", "weighted_rf"):
                assert abs(float(a[k]) - float(b[k])) <= KF_TOL, (model, a, b)
    assert (out / "port" / "cm" / "misspecification_kf.pdf").stat().st_size > 0


@pytest.fixture(scope="module")
def report_inputs(bench_inputs, tmp_path_factory):
    """Matrices written by JAX's ``pf-infer`` and trees by its ``pf-tree
    fastme-dir``, on the 8 examples; and a likelihoods CSV."""
    root, stems = bench_inputs
    out = tmp_path_factory.mktemp("report_inputs")
    prog = f"""
from phyloformer_tpu.infer import cli as infer
from phyloformer_tpu.trees import cli as tree
assert infer.main([{str(CKPT)!r}, {str(root / "alns")!r}, "-o", {str(out / "mats")!r}]) == 0
assert tree.main(["fastme-dir", {str(out / "mats")!r}, {str(out / "cmp")!r}, "--nni",
                  "--spr", "-j", "1"]) == 0
"""
    r = subprocess.run([sys.executable, "-c", prog], cwd=str(REPO), env=ENV,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert sorted(p.stem for p in (out / "mats").glob("*.phy")) == stems
    rng = np.random.default_rng(4)
    (out / "likelihoods_pf.csv").write_text("marker,id,ratio\n" + "".join(
        f"PF,{s},{1 + rng.random() / 10:.6f}\n" for s in stems))
    return root, out


@pytest.fixture(scope="module")
def report_runs(report_inputs, tmp_path_factory):
    root, inp = report_inputs
    out = tmp_path_factory.mktemp("report")
    trees, mats, cmp_ = str(root / "trees"), str(inp / "mats"), str(inp / "cmp")
    jobs = [
        ("$PKG.bench.cli", ["report", trees, mats, cmp_, "-o", "$OUT/rep"]),
        ("$PKG.bench.cli", ["report", trees, mats, cmp_, "-o", "$OUT/rep_fig", "--marker",
                            "PF_Base", "--figures"]),
        ("$PKG.bench.cli", ["figures", "-o", "$OUT/fig",
                            "--topos", "$OUT/rep/topos_pf.csv", "$OUT/rep_fig/topos_pf_base.csv",
                            "--dists", "$OUT/rep/dists_pf.csv",
                            "--brlens", "$OUT/rep/brlens_pf.csv",
                            "--exec", str(inp / "exec_pf.csv"),
                            "--likelihoods", str(inp / "likelihoods_pf.csv"),
                            "--datasets", "sim=$OUT/rep/topos_pf.csv,"
                                          "$OUT/rep_fig/topos_pf_base.csv"]),
    ]
    # an execution CSV of the harness's schema
    (inp / "exec_pf.csv").write_text(
        "timer,marker,id,elapsed_sec,MaxRSS_kb\nmodel_load,PF,all,0.5,1000\n"
        "inference,PF,all,1.25,2000\nfastme,PF_Base,x,0.01,1500\n")
    return run_clis_both(jobs, out), out


def test_report_matches_jax(report_runs):
    """Both reports' CSVs and summary JSON byte-equal, and the JSON each
    prints equal."""
    res, out = report_runs
    for want, got in zip(res["jax"]["res"][:2], res["port"]["res"][:2]):
        assert want["rc"] == got["rc"] == 0, got
        assert got["out"] == want["out"]
    for sub in ("rep", "rep_fig"):
        want = {k: v for k, v in files_of(out / "jax" / sub).items() if not k.endswith(".pdf")}
        got = {k: v for k, v in files_of(out / "port" / sub).items() if not k.endswith(".pdf")}
        assert len(want) == 4 and sorted(got) == sorted(want), sorted(got)
        for name in want:
            assert got[name] == want[name], (sub, name)
    summary = json.loads((out / "port" / "rep" / "summary_pf.json").read_text())
    assert summary["topo"]["n_trees"] == 8 and summary["dist"]["n_pairs"] > 0


def test_figures_match_jax(report_runs):
    """``report --figures`` and ``figures`` render the same files as JAX's,
    every one non-empty, and ``figures`` prints the same JSON."""
    res, out = report_runs
    want, got = res["jax"]["res"][2], res["port"]["res"][2]
    assert want["rc"] == got["rc"] == 0, got
    assert got["out"] == want["out"]
    for sub in ("rep_fig", "fig"):
        w = sorted(k for k in files_of(out / "jax" / sub) if k.endswith(".pdf"))
        g = files_of(out / "port" / sub)
        assert w and sorted(k for k in g if k.endswith(".pdf")) == w, sub
        assert all(len(g[k]) > 0 for k in w)
    assert len(json.loads(got["out"])["figures"]) >= 10
    assert os.path.exists(out / "port" / "rep_fig" / "dists_pf_base.pdf")
