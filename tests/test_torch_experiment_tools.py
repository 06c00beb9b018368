"""The port's experiment tools and reference-API data functions against the
JAX package's, on the CPU.

Every side runs in a fresh interpreter of its own, all started together (the
JAX tools imported from ``tools/`` as modules, as ``tests/test_run_grid.py``
does; nothing there changes); small sizes are reached by setting the tools'
module constants on both sides.  Inputs come from the port's simulators at
fixed seeds.

- data: ``seq2pair_matrix``, ``load_alignment``, ``one_hot_ref_layout``,
  ``load_distance_matrix`` and ``scale_branches`` equal to JAX's;
- ``reference_path.reference_forward`` within ``REF_TOL`` of max(1, max|ref|)
  of JAX's ``reference_path_tpu.reference_forward`` and of the port's eager
  model, at 8 x 40 and 20 x 120;
- ``accuracy_at_scale.kf_check`` at 12 tips x 60 sites x 2 against the same
  loop run in JAX: the trees and alignments bit-equal; on the fp32 oracle's
  route each KF within ``KF_TOL`` of max(1, KF) or the topology flip named (at
  most ``MAX_FLIPS``); on the fast route (one TF32 pass) the distances within
  ``GATE`` of max(1, max|ref|) and each KF within ``KF_TOL`` or named.  The
  port's plain version of the fast route rounds its operands to TF32 as the
  card does, while JAX's fast route on the CPU computes in fp32, so the two
  fast routes differ by that rounding (a KF 2.6e-4 apart was seen): there the
  distances are held to the fast-path gate, the bar of one TF32 pass against
  JAX (``tests/test_torch_precision.py``), and a KF outside ``KF_TOL`` is named
  with its distances' error, not failed;
- ``make_corpus --scale 0.0002 --device cpu``: JAX's trees and counts per
  length, ``merge_packed``'s manifest equal to JAX's tool's over the same
  shards, and ``pf-train-torch --device cpu`` takes 2 steps on ``packed_all``;
- ``make_ft_corpora --indel-n 4 --cherry-n 4``: every file JAX's, bit for bit;
- ``scaling_bench`` at 1 and 2 ranks from JAX's initial parameters: JAX's
  JSON keys, mesh and batch, the loss within ``LOSS_TOL``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_model import CKPT, JAX_THREAD_FLAGS, PORT_THREAD_ENV, REPO
from torch_side_by_side import files_of

REF_TOL = 1e-5
KF_TOL = 1e-4
MAX_FLIPS = 1
LOSS_TOL = 1e-5
GATE = 6e-3  # the fast-path gate: one TF32 pass against fp32
REF_CASES = {"8x40": (8, 40), "20x120": (20, 120)}
ACC = (12, 60, 2)  # (tips, sites, replicates) of the KF check
CORPUS_SCALE = "0.0002"
SCALING = {"N": 8, "L": 32, "STEPS": 1}
JAX_ENV = {**os.environ, **PORT_THREAD_ENV, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO),
           "XLA_FLAGS": (os.environ.get("XLA_FLAGS", "") + " " + JAX_THREAD_FLAGS).strip()}
PORT_ENV = {**os.environ, **PORT_THREAD_ENV}

_PRELUDE = """
import importlib.util, json, sys
import numpy as np
IN = dict(np.load(sys.argv[1])) if sys.argv[1] != "-" else {}
OUT = {}

def jax_tool(name):
    spec = importlib.util.spec_from_file_location(name, f"tools/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
"""

_EPILOGUE = """
if "$PKG" == "phyloformer_tpu_torch":
    _bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "phyloformer_tpu")]
    assert not _bad, _bad
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in OUT.items()})
"""

PKGS = {"jax": "phyloformer_tpu", "port": "phyloformer_tpu_torch"}


def _start(side, code, root, name, inputs=None):
    """``code`` (reading ``IN``, filling ``OUT``) in a fresh interpreter of
    ``side``, ``$PKG`` its package; returns (Popen, output path)."""
    src = "-"
    if inputs is not None:
        src = str(root / f"{name}_in.npz")
        np.savez(src, **inputs)
    dst = root / f"{name}_{side}.npz"
    warm = ("from phyloformer_tpu_torch.device import warm_cpu_math\nwarm_cpu_math()\n"
            if side == "port" else "")
    prog = (_PRELUDE + warm + code + _EPILOGUE).replace("$PKG", PKGS[side])
    p = subprocess.Popen([sys.executable, "-c", prog, src, str(dst)], cwd=str(REPO),
                         env=JAX_ENV if side == "jax" else PORT_ENV, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    return p, dst


def _collect(jobs, timeout=900):
    """{name: OUT} of every started job; fails naming the first that failed."""
    out, errs = {}, {}
    try:
        for name, (p, dst) in jobs.items():
            _, errs[name] = p.communicate(timeout=timeout)
    finally:
        for p, _ in jobs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for name, (p, dst) in jobs.items():
        assert p.returncode == 0, f"{name}: {errs[name][-4000:]}"
        out[name] = dict(np.load(dst))
    return out


def _onehots(n, l, k, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        codes = rng.integers(0, 20, size=(n, l))
        oh = np.zeros((22, l, n), np.float32)
        oh[codes.T, np.arange(l)[:, None], np.arange(n)[None, :]] = 1.0
        out.append(oh)
    return np.stack(out)


_SIM = """
from phyloformer_tpu_torch.sim import cli_msa, cli_trees
root = IN["root"].item()
assert cli_trees.main(["-n", "3", "-t", "9", "-o", root + "/trees", "--seed", "11"]) == 0
assert cli_msa.main([root + "/trees", root + "/msas", "-l", "40", "--indels", "--seed", "11"]) == 0
"""

_DATA = """
from $PKG.data import __all__ as ALL, load_alignment, load_distance_matrix, seq2pair_matrix
from $PKG.data.fasta import read_fasta
from $PKG.data.newick import read_newick, scale_branches
root = IN["root"].item()
for n in (2, 5, 13):
    for dt in ("float32", "float64"):
        OUT[f"s2p.{n}.{dt}"] = seq2pair_matrix(n, np.dtype(dt))
for k in range(3):
    fa, nwk = f"{root}/msas/{k}_9_tips.fa", f"{root}/trees/{k}_9_tips.nwk"
    oh, ids = load_alignment(fa)
    OUT[f"onehot.{k}"], OUT[f"ids.{k}"] = oh, np.array(ids)
    OUT[f"onehot64.{k}"] = read_fasta(fa).one_hot_ref_layout(np.float64)
    OUT[f"dist.{k}"] = load_distance_matrix(nwk, ids)
    OUT[f"dist_rev.{k}"] = load_distance_matrix(nwk, ids[::-1])
    tree = read_newick(nwk)
    scale_branches(tree, 0.37)
    OUT[f"scaled.{k}"] = np.array(tree.to_newick())
OUT["all"] = np.array(sorted(ALL))
"""

_REF_JAX = f"""
import jax, jax.numpy as jnp
from phyloformer_tpu.io import load_pretrained
mod = jax_tool("reference_path_tpu")
params, cfg, _ = load_pretrained({str(CKPT)!r})
with jax.default_matmul_precision("float32"):
    for case in {list(REF_CASES)!r}:
        ohs = IN[case]
        s2p = jnp.asarray(mod.seq2pair_matrix(ohs.shape[3]))
        fwd = jax.jit(lambda p, x: mod.reference_forward(p, x, s2p))
        OUT[case] = np.stack([np.asarray(fwd(params, jnp.asarray(oh))) for oh in ohs])
"""

_REF_PORT = f"""
import torch
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.models.phyloformer import forward
from phyloformer_tpu_torch.tools import reference_path as mod
torch.set_num_threads(2)
params, cfg, _ = load_pretrained({str(CKPT)!r})
for case in {list(REF_CASES)!r}:
    ohs = IN[case]
    r = mod.run(params, list(ohs), torch.device("cpu"))
    OUT[case] = np.stack(r["preds"])
    codes = torch.as_tensor(ohs.argmax(1).transpose(0, 2, 1))  # (B, n, L)
    with torch.no_grad():
        OUT[case + ".eager"] = forward(params, codes, cfg).numpy()
mod.N_TIPS, mod.SEQ_LEN, mod.N_ALIGNMENTS = 8, 40, 3
import contextlib, io
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    assert mod.main([{str(CKPT)!r}, "--device", "cpu"]) == 0
OUT["json"] = np.array(buf.getvalue().strip().splitlines()[-1])
"""

_ACC_JAX = f"""
import pathlib
from phyloformer_tpu.bench.accuracy import make_engines
from phyloformer_tpu.data import read_fasta
from phyloformer_tpu.data.phylip import vec_to_phylip
from phyloformer_tpu.io import load_pretrained
from phyloformer_tpu.sim.msa import MsaSimConfig, simulate_msa
from phyloformer_tpu.sim.trees import TreeSimConfig, diameter_sampler, simulate_tree
from phyloformer_tpu.trees.native import build_tree_from_phylip, compare_newick
n, l, reps = {ACC!r}
tmp = pathlib.Path(IN["dir"].item())
tmp.mkdir(parents=True, exist_ok=True)
params, cfg, _ = load_pretrained({str(CKPT)!r})
fast, oracle, oracle_name = make_engines(params, cfg, n, l)
OUT["oracle"] = oracle_name
for rep in range(reps):  # tools/accuracy_at_scale.py's loop
    r = np.random.default_rng(100 + rep)
    tree = simulate_tree(r, TreeSimConfig(ntips=n), diameter_sampler(None))
    (tmp / f"{{rep}}.nwk").write_text(tree.to_newick())
    ok, _ = simulate_msa(tmp / f"{{rep}}.nwk", tmp / f"{{rep}}.fa", MsaSimConfig(length=l), rng=r)
    assert ok
    aln = read_fasta(tmp / f"{{rep}}.fa")
    preds = {{"fused": fast.predict([aln])[0], "oracle": oracle.predict([aln])[0]}}
    for tag, vec in preds.items():
        _, phy = vec_to_phylip(vec.astype(np.float64), aln.ids)
        nwk = build_tree_from_phylip(phy, "bme", True, True)
        OUT[f"{{tag}}.{{rep}}.nwk"] = np.array(nwk)
        OUT[f"{{tag}}.{{rep}}.pred"] = vec
        OUT[f"{{tag}}.{{rep}}.kf"] = compare_newick(tree.to_newick(), nwk).kf
"""

_ACC_PORT = f"""
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.tools.accuracy_at_scale import kf_check
n, l, reps = {ACC!r}
params, cfg, _ = load_pretrained({str(CKPT)!r})
summary, detail = kf_check(params, cfg, n, l, reps, device="cpu", workdir=IN["dir"].item())
OUT["summary"] = np.array(json.dumps(summary))
for tag, trees in detail["trees"].items():
    for rep, nwk in enumerate(trees):
        OUT[f"{{tag}}.{{rep}}.nwk"] = np.array(nwk)
        OUT[f"{{tag}}.{{rep}}.pred"] = detail["preds"][tag][rep]
"""

_FT = """
mod = jax_tool("make_ft_corpora") if "$PKG" == "phyloformer_tpu" else __import__(
    "phyloformer_tpu_torch.tools.make_ft_corpora", fromlist=["main"])
assert mod.main([IN["dir"].item(), "--indel-n", "4", "--cherry-n", "4"]) == 0
"""

_CORPUS_JAX = f"""
mod = jax_tool("make_corpus")
out = IN["dir"].item()
for L, count in mod.LENGTH_COUNTS.items():
    mod.sim_trees(__import__("pathlib").Path(out) / f"trees_L{{L}}", int(count * {CORPUS_SCALE}),
                  20250821 + L)
OUT["counts"] = np.array(json.dumps({{str(L): int(c * {CORPUS_SCALE})
                                      for L, c in mod.LENGTH_COUNTS.items()}}))
"""

_CORPUS_PORT = f"""
import contextlib, io
from phyloformer_tpu_torch.tools import make_corpus as mod
from phyloformer_tpu_torch.train import cli
out = IN["dir"].item()
assert mod.main([out, "--scale", "{CORPUS_SCALE}", "--device", "cpu"]) == 0
OUT["counts"] = np.array(json.dumps({{str(L): int(c * {CORPUS_SCALE})
                                      for L, c in mod.LENGTH_COUNTS.items()}}))
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    OUT["train_rc"] = cli.main(["--packed-data", out + "/packed_all", "--device", "cpu",
                                "--batch-size", "2", "--nb-blocks", "2", "--max-steps", "2",
                                "--warmup-steps", "1", "--log-every", "1",
                                "--hard-loss-ceiling", "1e6", "-o", out + "/train", "-n", "r"])
OUT["train_stdout"] = np.array(buf.getvalue())
"""

_MERGE_JAX = """
mod = jax_tool("merge_packed")
out = IN["dir"].item()
assert mod.main([out + "/jax_merged"] + [out + f"/packed_L{L}" for L in (250, 500, 1000)]) == 0
"""

_INIT_JAX = """
import jax
from phyloformer_tpu.io.checkpoint import save_params_npz
from phyloformer_tpu.models import PhyloformerConfig, init_params
from phyloformer_tpu.train import TrainConfig
save_params_npz(IN["path"].item(), init_params(jax.random.PRNGKey(TrainConfig().seed),
                                               PhyloformerConfig()))
"""

_SCALING_JAX = f"""
import contextlib, io
mod = jax_tool("scaling_bench")
for k, v in {SCALING!r}.items():
    setattr(mod, k, v)
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    mod.worker(int(IN["ranks"]))
OUT["json"] = np.array(buf.getvalue().strip().splitlines()[-1])
"""

_SCALING_PORT = f"""
import contextlib, io
from phyloformer_tpu_torch.tools import scaling_bench as mod
for k, v in {SCALING!r}.items():
    setattr(mod, k, v)
mod.RANKS = (1, 2)
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    res = mod.orchestrate("cpu", IN["path"].item())
OUT["json"] = np.array(json.dumps(res))
OUT["stdout"] = np.array(buf.getvalue())
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("experiment_tools")
    s = lambda x: {"dir": np.array(str(root / x))}  # noqa: E731
    ref_in = {case: _onehots(n, l, 2, 5 + i) for i, (case, (n, l)) in enumerate(
        REF_CASES.items())}
    init = {"path": np.array(str(root / "init.npz"))}
    first = {
        "sim": _start("port", _SIM, root, "sim", {"root": np.array(str(root / "sim"))}),
        "init": _start("jax", _INIT_JAX, root, "init", init),
        "ref_jax": _start("jax", _REF_JAX, root, "ref", ref_in),
        "ref_port": _start("port", _REF_PORT, root, "ref", ref_in),
        "acc_jax": _start("jax", _ACC_JAX, root, "acc_j", s("acc_jax")),
        "acc_port": _start("port", _ACC_PORT, root, "acc_p", s("acc_port")),
        "ft_jax": _start("jax", _FT, root, "ft_j", s("ft_jax")),
        "ft_port": _start("port", _FT, root, "ft_p", s("ft_port")),
        "corpus_jax": _start("jax", _CORPUS_JAX, root, "corpus_j", s("corpus_jax")),
        "corpus_port": _start("port", _CORPUS_PORT, root, "corpus_p", s("corpus_port")),
    }
    late = {"sim", "init", "corpus_port"}
    out = _collect({k: v for k, v in first.items() if k in late})
    second = {
        "data_jax": _start("jax", _DATA, root, "data_j", {"root": np.array(str(root / "sim"))}),
        "data_port": _start("port", _DATA, root, "data_p", {"root": np.array(str(root / "sim"))}),
        "merge_jax": _start("jax", _MERGE_JAX, root, "merge", s("corpus_port")),
        "scaling_port": _start("port", _SCALING_PORT, root, "scaling_p", init),
        **{f"scaling_jax{r}": _start("jax", _SCALING_JAX, root, f"scaling_j{r}",
                                     {"ranks": np.array(r)}) for r in (1, 2)},
    }
    out.update(_collect({k: v for k, v in first.items() if k not in late}))
    out.update(_collect(second))
    return root, out


def test_data_functions_equal_jax(runs):
    _, out = runs
    want, got = out["data_jax"], out["data_port"]
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "all":
            continue
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k
    assert set(want["all"]) <= set(got["all"]), set(want["all"]) - set(got["all"])
    assert want["onehot.0"].shape == (22, 40, 9)
    assert (got["onehot.0"][21] > 0).any()  # the indels' gaps reach the gap channel


@pytest.mark.parametrize("case", list(REF_CASES))
def test_reference_forward_matches_jax_and_eager(runs, case):
    _, out = runs
    want, got, eager = out["ref_jax"][case], out["ref_port"][case], out["ref_port"][case + ".eager"]
    n, _ = REF_CASES[case]
    assert got.shape == want.shape == (2, n * (n - 1) // 2)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= REF_TOL * scale
    assert float(np.abs(got - eager).max()) <= REF_TOL * scale


def test_reference_path_prints_jax_keys(runs):
    _, out = runs
    rec = json.loads(str(out["ref_port"]["json"]))
    # tools/reference_path_tpu.py's keys
    assert list(rec) == ["structure", "device", "aln_per_s", "s_per_aln", "n_alignments"]
    assert rec["n_alignments"] == 3 and rec["aln_per_s"] > 0
    assert rec["structure"] == "reference (batch=1 serial, seq2pair matmul, fp32)"


def test_accuracy_kf_check_matches_jax_loop(runs):
    from phyloformer_tpu.trees.native import compare_newick

    root, out = runs
    want, got = out["acc_jax"], out["acc_port"]
    summary = json.loads(str(got["summary"]))
    assert summary["oracle"] == str(want["oracle"])
    assert sorted(summary) == ["kf_fused_mean", "kf_oracle_mean", "kf_pairs", "oracle"]
    n, _, reps = ACC
    assert files_of(root / "acc_port") == files_of(root / "acc_jax")
    assert len(files_of(root / "acc_port")) == 2 * reps
    flips, fast_named = [], []
    for rep in range(reps):
        for j, tag in enumerate(("fused", "oracle")):
            kf, ref = summary["kf_pairs"][rep][j], float(want[f"{tag}.{rep}.kf"])
            pred, ref_pred = got[f"{tag}.{rep}.pred"], want[f"{tag}.{rep}.pred"]
            err = float(np.abs(pred - ref_pred).max()) / max(1.0, float(np.abs(ref_pred).max()))
            assert err <= (GATE if tag == "fused" else REF_TOL), (tag, rep, err)
            if compare_newick(str(got[f"{tag}.{rep}.nwk"]), str(want[f"{tag}.{rep}.nwk"])).rf:
                flips.append((tag, rep, kf, ref))
            elif abs(kf - ref) > KF_TOL * max(1.0, ref):
                assert tag == "fused", (tag, rep, kf, ref)
                fast_named.append((rep, kf, ref, err))
    assert len(flips) <= MAX_FLIPS, f"topology flips (route, replicate, port KF, JAX KF): {flips}"
    print(f"fast route KF outside KF_TOL (replicate, port KF, JAX KF, distance error): "
          f"{fast_named}")
    assert summary["kf_fused_mean"] == pytest.approx(
        np.mean([p[0] for p in summary["kf_pairs"]]), abs=1e-12)


def test_make_corpus_trees_and_counts_are_jax(runs):
    root, out = runs
    counts = json.loads(str(out["corpus_port"]["counts"]))
    assert counts == json.loads(str(out["corpus_jax"]["counts"]))
    total = 0
    for L, count in counts.items():
        trees = files_of(root / "corpus_port" / f"trees_L{L}")
        assert len(trees) == count > 0
        assert trees == files_of(root / "corpus_jax" / f"trees_L{L}")
        manifest = json.loads((root / "corpus_port" / f"packed_L{L}" / "manifest.json")
                              .read_text())
        assert manifest["n_examples"] == len(list((root / "corpus_port" / f"msas_L{L}")
                                                  .glob("*.fa")))
        total += manifest["n_examples"]
    merged = json.loads((root / "corpus_port" / "packed_all" / "manifest.json").read_text())
    assert merged["n_examples"] == total


def test_merge_packed_manifest_is_jax(runs):
    root, _ = runs
    port, jax_dir = root / "corpus_port" / "packed_all", root / "corpus_port" / "jax_merged"
    assert (port / "manifest.json").read_text() == (jax_dir / "manifest.json").read_text()
    assert files_of(port) == files_of(jax_dir)


def test_corpus_trains_two_steps_on_the_cpu(runs):
    root, out = runs
    assert int(out["corpus_port"]["train_rc"]) == 0
    rows = [json.loads(x) for x in (root / "corpus_port" / "train" / "r_metrics.jsonl")
            .read_text().splitlines()]
    losses = [r["train_loss"] for r in rows if "train_loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses)), rows
    assert json.loads(str(out["corpus_port"]["train_stdout"]).strip().splitlines()[-1])[
        "steps"] == 2


def test_make_ft_corpora_is_jax_bit_for_bit(runs):
    root, _ = runs
    got, want = files_of(root / "ft_port"), files_of(root / "ft_jax")
    assert sorted(got) == sorted(want)
    for leg in ("indel", "cherry"):
        assert json.loads(got[f"{leg}/packed/manifest.json"])["n_examples"] == 4
        assert len([f for f in got if f.startswith(f"{leg}_test/trees/")]) == 30
    assert [f for f in got if got[f] != want[f]] == []


@pytest.mark.parametrize("ranks", [1, 2])
def test_scaling_bench_matches_jax(runs, ranks):
    _, out = runs
    want = json.loads(str(out[f"scaling_jax{ranks}"]["json"]))
    got = json.loads(str(out["scaling_port"]["json"]))[ranks - 1]
    assert list(got) == list(want)
    assert (got["devices"], got["mesh"], got["global_batch"]) == (
        want["devices"], want["mesh"], want["global_batch"])
    assert abs(got["loss"] - want["loss"]) <= LOSS_TOL, (got["loss"], want["loss"])
    stdout = str(out["scaling_port"]["stdout"])
    assert "gradient all-reduce: 2.47 MB/step" in stdout
    assert "pair-axis all-reduce (B=4, L=256): 6.29 MB/step" in stdout
