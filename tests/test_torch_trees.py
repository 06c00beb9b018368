"""The port's tree toolkit (``phyloformer_tpu_torch.trees``: ``native``'s
metrics, ``likelihood``, ``ml_fast``, ``baselines``, and ``pf-tree-torch``)
against the JAX package's, on the CPU.

Each side runs in a fresh interpreter (:mod:`torch_side_by_side`) on the
same inputs: 8 birth-death trees of 12, 17 and 20 tips from
``pf-simulate-trees-torch``, LG alignments of 90 sites evolved on them by
``pf-simulate-alignments-torch`` (duplicate rows allowed; one alignment
given gaps with numpy), and PHYLIP matrices of the trees' patristic
distances with numpy noise.  Bars:

- ``build_tree_from_phylip`` (BME+NNI+SPR, NJ, BIONJ) the same newick;
  ``compare_newick``'s five fields on 24 tree pairs with
  ``include_external`` both ways, and ``pauplin_length`` on 32, equal;
- ``log_likelihood`` (plain, discrete gamma, CAT), ``estimate_site_categories``
  and ``log_likelihood_ratio`` within ``LL_RTOL`` (1e-12) relative: the
  copied numpy code should give the same bits;
- ``ml_refine`` on the fast engine (17 and 20 tips, with and without CAT)
  and the slow one (12 tips, NNI; a gamma mixture, which the fast engine
  does not carry; and ``PFML_SLOW=1``): the same newick, log-likelihood
  within ``ML_RTOL`` (1e-9) relative;
- every ``pf-tree-torch`` subcommand (``fastme``, ``fastme-dir`` at one
  and three workers, ``mlrefine``, ``likelihood``, ``compare``): its files,
  standard output and exit code byte-equal to ``pf-tree``'s; ``mlrefine``'s
  log-likelihood line too; no torch loaded on the way.
"""

import subprocess
import sys

import numpy as np
import pytest

from phyloformer_tpu.data.newick import patristic_matrix, read_newick
from phyloformer_tpu.data.phylip import matrix_to_phylip
from test_torch_model import REPO
from torch_side_by_side import ENV, files_of, run_both, run_clis_both

LL_RTOL = 1e-12
ML_RTOL = 1e-9
METHODS = ("bme", "nj", "bionj")


@pytest.fixture(scope="module")
def tree_inputs(tmp_path_factory):
    """``root/trees/*.nwk``, ``root/alns/*.fa`` and ``root/mats/*.phy``."""
    root = tmp_path_factory.mktemp("trees")
    sim = [("phyloformer_tpu_torch.sim.cli_trees",
            ["-n", str(k), "-t", str(tips), "-o", str(root / "trees"), "--seed", str(seed)])
           for k, tips, seed in ((3, 12, 3), (3, 17, 4), (2, 20, 5))]
    sim.append(("phyloformer_tpu_torch.sim.cli_msa",
                [str(root / "trees"), str(root / "alns"), "-l", "90", "--seed", "3",
                 "--allow-duplicate-sequences"]))
    prog = ("import importlib, sys\n"
            f"for m, a in {sim!r}:\n"
            "    assert importlib.import_module(m).main(a) == 0, (m, a)\n")
    r = subprocess.run([sys.executable, "-c", prog], cwd=str(REPO), env=ENV,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    stems = sorted(p.stem for p in (root / "trees").glob("*.nwk"))
    assert len(stems) == 8 and sorted(p.stem for p in (root / "alns").glob("*.fa")) == stems
    # gaps in one alignment (the likelihood's missing data)
    rng = np.random.default_rng(8)
    gapped = root / "alns" / f"{stems[0]}.fa"
    lines = gapped.read_text().splitlines()
    for k in range(1, len(lines), 2):
        row = np.array(list(lines[k]))
        row[rng.random(len(row)) < 0.25] = "-"
        lines[k] = "".join(row)
    gapped.write_text("\n".join(lines) + "\n")
    (root / "mats").mkdir()
    for stem in stems:
        dm, ids = patristic_matrix(read_newick(root / "trees" / f"{stem}.nwk"))
        noise = rng.normal(0.0, 0.02, dm.shape)
        dm = np.clip(dm + (noise + noise.T) / 2, 0.0, None)
        np.fill_diagonal(dm, 0.0)
        (root / "mats" / f"{stem}.phy").write_text(matrix_to_phylip(dm, ids))
    return root, stems


_FUNCS = """
import pathlib
from $PKG.data.fasta import read_fasta
from $PKG.data.newick import read_newick, parse_newick
from $PKG.sim.models import get_model
from $PKG.trees import likelihood as lk
from $PKG.trees.baselines import hamming_fastme_tree, ml_refine
from $PKG.trees.native import build_tree_from_phylip, compare_newick, pauplin_length
root = pathlib.Path(str(IN["root"]))
stems = [str(s) for s in IN["stems"]]
for stem in stems:
    phy = (root / "mats" / f"{stem}.phy").read_text()
    true = (root / "trees" / f"{stem}.nwk").read_text()
    OUT[f"{stem}.pauplin.true"] = pauplin_length(phy, true)
    for method in ("bme", "nj", "bionj"):
        nwk = build_tree_from_phylip(phy, method, method == "bme", method == "bme")
        OUT[f"{stem}.{method}.nwk"] = nwk
        OUT[f"{stem}.{method}.pauplin"] = pauplin_length(phy, nwk)
        for ext in (False, True):
            r = compare_newick(true, nwk, ext)
            OUT[f"{stem}.{method}.cmp.{ext}"] = [r.rf, r.norm_rf, r.weighted_rf, r.kf, r.n_common]
    aln = read_fasta(root / "alns" / f"{stem}.fa", strict=False)
    tree = read_newick(root / "trees" / f"{stem}.nwk")
    OUT[f"{stem}.ll"] = lk.log_likelihood(aln, tree)
    OUT[f"{stem}.ll.gamma"] = lk.log_likelihood(aln, tree, get_model("WAG"), gamma_alpha=0.7)
    rates, cats = lk.estimate_site_categories(aln, tree, n_cats=8)
    OUT[f"{stem}.cat.rates"], OUT[f"{stem}.cat.sites"] = rates, cats
    OUT[f"{stem}.ll.cat"] = lk.log_likelihood(aln, tree, site_categories=(rates, cats))
    OUT[f"{stem}.llr"] = lk.log_likelihood_ratio(
        aln, parse_newick(OUT[f"{stem}.bme.nwk"]), tree, gamma_alpha=1.3)
    OUT[f"{stem}.hamming"] = hamming_fastme_tree(aln)
"""

_ML = """
import os, pathlib
from $PKG.data.fasta import read_fasta
from $PKG.trees.baselines import hamming_fastme_tree, ml_nni_refine, ml_refine
root = pathlib.Path(str(IN["root"]))
def aln_of(stem):
    return read_fasta(root / "alns" / f"{stem}.fa", strict=False)
def put(key, result):
    OUT[key + ".nwk"], OUT[key + ".ll"] = result
for stem in [str(s) for s in IN["fast"]]:
    aln = aln_of(stem)
    start = hamming_fastme_tree(aln)
    put(f"fast.{stem}", ml_refine(aln, start))
    put(f"fast_cat.{stem}", ml_refine(aln, start, cat_categories=4, max_sweeps=2))
stem = str(IN["slow"])
aln = aln_of(stem)
start = hamming_fastme_tree(aln)
put("slow", ml_refine(aln, start, engine="slow", max_sweeps=1, spr=False))
put("slow_gamma", ml_nni_refine(aln, start, gamma_alpha=0.8, max_sweeps=1,
                                optimize_lengths=False))
os.environ["PFML_SLOW"] = "1"
put("pfml_slow", ml_refine(aln, start, max_sweeps=1, spr=False))
"""


@pytest.fixture(scope="module")
def func_runs(tree_inputs, tmp_path_factory):
    root, stems = tree_inputs
    return stems, run_both(_FUNCS, {"root": str(root), "stems": stems},
                           tmp_path_factory.mktemp("tree_funcs"))


@pytest.fixture(scope="module")
def ml_runs(tree_inputs, tmp_path_factory):
    root, stems = tree_inputs
    fast = [s for s in stems if "_17_" in s][:1] + [s for s in stems if "_20_" in s][:1]
    slow = [s for s in stems if "_12_" in s][1]
    return run_both(_ML, {"root": str(root), "fast": fast, "slow": slow},
                    tmp_path_factory.mktemp("tree_ml"))


def test_tree_builder_and_metrics_equal(func_runs):
    """24 built trees (the same newick), ``compare_newick`` against the true
    tree with and without external branches (five fields each), and
    ``pauplin_length`` on the 24 and the 8 true trees: equal."""
    stems, res = func_runs
    want, got = res["jax"], res["port"]
    pairs = 0
    for stem in stems:
        assert got[f"{stem}.pauplin.true"] == want[f"{stem}.pauplin.true"] > 0, stem
        for method in METHODS:
            key = f"{stem}.{method}"
            assert str(got[key + ".nwk"]) == str(want[key + ".nwk"]), key
            assert got[key + ".pauplin"] == want[key + ".pauplin"] > 0, key
            for ext in (False, True):
                np.testing.assert_array_equal(got[f"{key}.cmp.{ext}"], want[f"{key}.cmp.{ext}"],
                                              err_msg=f"{key} include_external={ext}")
            pairs += 1
    assert pairs >= 20
    # the pairs are not all alike: some topologies differ from the truth
    assert any(want[f"{s}.{m}.cmp.False"][0] > 0 for s in stems for m in METHODS)


@pytest.mark.parametrize("what", ["ll", "ll.gamma", "ll.cat", "llr", "cat.rates"])
def test_likelihoods_equal(what, func_runs):
    stems, res = func_runs
    for stem in stems:
        want, got = res["jax"][f"{stem}.{what}"], res["port"][f"{stem}.{what}"]
        np.testing.assert_allclose(got, want, rtol=LL_RTOL, atol=0, err_msg=stem)


def test_site_categories_and_hamming_trees_equal(func_runs):
    stems, res = func_runs
    for stem in stems:
        np.testing.assert_array_equal(res["port"][f"{stem}.cat.sites"],
                                      res["jax"][f"{stem}.cat.sites"], err_msg=stem)
        assert str(res["port"][f"{stem}.hamming"]) == str(res["jax"][f"{stem}.hamming"]), stem


@pytest.mark.parametrize("run", ["fast", "fast_cat", "slow", "slow_gamma", "pfml_slow"])
def test_ml_refine_equal(run, ml_runs):
    """The same newick, the log-likelihood within ``ML_RTOL``; ``PFML_SLOW=1``
    takes the slow engine, as in JAX."""
    want, got = ml_runs["jax"], ml_runs["port"]
    keys = sorted(k[:-4] for k in want if k.split(".")[0] == run and k.endswith(".nwk"))
    assert keys and keys == sorted(k[:-4] for k in got
                                   if k.split(".")[0] == run and k.endswith(".nwk"))
    for k in keys:
        assert str(got[k + ".nwk"]) == str(want[k + ".nwk"]), k
        np.testing.assert_allclose(got[k + ".ll"], want[k + ".ll"], rtol=ML_RTOL, atol=0,
                                   err_msg=k)
    if run == "pfml_slow":
        assert str(got["pfml_slow.nwk"]) == str(got["slow.nwk"])
        assert got["pfml_slow.ll"] == got["slow.ll"]


def _tree_jobs(root, stems):
    mats, alns, trees = root / "mats", root / "alns", root / "trees"
    jobs = []
    for stem in stems[:2] + stems[-1:]:
        for method in METHODS:
            jobs.append(("$PKG.trees.cli", ["fastme", "-i", str(mats / f"{stem}.phy"), "-o",
                                            f"$OUT/{stem}.{method}.nwk", "-m", method, "--nni",
                                            "--spr"]))
        jobs.append(("$PKG.trees.cli", ["fastme", "-i", str(mats / f"{stem}.phy"), "-m", "nj"]))
    jobs += [
        ("$PKG.trees.cli", ["fastme-dir", str(mats), "$OUT/dir1", "-j", "1"]),
        ("$PKG.trees.cli", ["fastme-dir", str(mats), "$OUT/dir3", "-j", "3", "--nni", "--spr"]),
        ("$PKG.trees.cli", ["fastme-dir", str(mats), "$OUT/dir_nj", "-j", "2", "-m", "nj"]),
        ("$PKG.trees.cli", ["compare", str(trees), "$OUT/dir3", "-o", "$OUT/cmp.csv"]),
        ("$PKG.trees.cli", ["compare", str(trees), "$OUT/dir1", "--include-external"]),
        ("$PKG.trees.cli", ["likelihood", str(alns / f"{stems[0]}.fa"),
                            str(trees / f"{stems[0]}.nwk")]),
        ("$PKG.trees.cli", ["likelihood", str(alns / f"{stems[3]}.fa"),
                            str(trees / f"{stems[3]}.nwk"), "--gamma-alpha", "0.5",
                            "--gamma-categories", "6", "--model", "JTT"]),
        ("$PKG.trees.cli", ["mlrefine", str(alns / f"{stems[4]}.fa"),
                            str(trees / f"{stems[4]}.nwk"), "-o", "$OUT/ml.nwk"]),
        ("$PKG.trees.cli", ["mlrefine", str(alns / f"{stems[5]}.fa"),
                            str(trees / f"{stems[5]}.nwk"), "--cat", "4", "--no-spr",
                            "--max-sweeps", "1"]),
    ]
    return jobs


@pytest.fixture(scope="module")
def cli_runs(tree_inputs, tmp_path_factory):
    root, stems = tree_inputs
    out = tmp_path_factory.mktemp("tree_cli")
    jobs = _tree_jobs(root, stems)
    return jobs, run_clis_both(jobs, out), out


def test_pf_tree_torch_prints_the_same(cli_runs):
    """Exit codes, standard output and standard error of every command line
    equal (``mlrefine``'s log-likelihood JSON, ``compare``'s mean KF)."""
    jobs, res, _ = cli_runs
    for job, want, got in zip(jobs, res["jax"]["res"], res["port"]["res"]):
        assert want["rc"] == 0, (job, want)
        assert got == want, job
    assert len(res["port"]["res"]) == len(jobs)


@pytest.mark.parametrize("subdir", ["", "dir1", "dir3", "dir_nj"])
def test_pf_tree_torch_files_byte_equal(subdir, cli_runs):
    _, _, out = cli_runs
    want, got = files_of(out / "jax" / subdir), files_of(out / "port" / subdir)
    if not subdir:  # the top level: the fastme, mlrefine and compare files
        want = {k: v for k, v in want.items() if "/" not in k}
        got = {k: v for k, v in got.items() if "/" not in k}
    assert want and sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def test_pf_tree_torch_imports_no_torch(cli_runs, tree_inputs, tmp_path):
    """No subcommand loads torch (``fastme-dir``'s pool starts its workers
    from a process that holds no CUDA context); ``python -m`` runs the
    module as ``pf-tree-torch`` does."""
    _, res, _ = cli_runs
    assert res["port"]["torch"] is False
    root, _ = tree_inputs
    r = subprocess.run([sys.executable, "-m", "phyloformer_tpu_torch.trees.cli", "fastme-dir",
                        str(root / "mats"), str(tmp_path / "m"), "-j", "2", "--nni", "--spr"],
                       cwd=str(REPO), env=ENV, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert files_of(tmp_path / "m") == files_of(cli_runs[2] / "jax" / "dir3")


def test_fasttree_adapter_needs_a_binary(tmp_path):
    """With an empty ``PATH`` and no ``binary`` the adapter raises
    ``FileNotFoundError`` on both sides; given a ``binary`` that exits
    non-zero it raises ``RuntimeError`` with FastTree's message."""
    fake = tmp_path / "FastTree"
    fake.write_text("#!/bin/sh\necho 'no such model' >&2\nexit 3\n")
    fake.chmod(0o755)
    code = f"""
import os
os.environ["PATH"] = {str(tmp_path / "empty")!r}
from $PKG.data.fasta import Alignment
from $PKG.trees.baselines import fasttree_adapter
aln = Alignment(np.zeros((3, 4), np.int8), ["a", "b", "c"])
for key, kw in (("none", {{}}), ("fake", {{"binary": {str(fake)!r}}})):
    try:
        fasttree_adapter(aln, **kw)
        OUT[key] = "ran"
    except (FileNotFoundError, RuntimeError) as e:
        OUT[key] = f"{{type(e).__name__}}: {{e}}"
"""
    res = run_both(code, {}, tmp_path / "runs")
    assert str(res["port"]["none"]) == "FileNotFoundError: no FastTree binary found"
    assert str(res["port"]["fake"]).startswith("RuntimeError: FastTree failed: no such model")
    for key in ("none", "fake"):
        assert str(res["port"][key]) == str(res["jax"][key]), key
