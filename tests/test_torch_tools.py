"""The port's evaluation tools against the JAX package's, on the CPU.

Four alignments of 20 tips x 120 sites and their true trees are simulated
from a seed by the port's simulators (``pf-simulate-trees-torch``,
``pf-simulate-alignments-torch``).  A JAX subprocess writes a run directory
with its ``CheckpointManager`` (Orbax): step 1 holds ``pf_mre_r5.ckpt``'s
parameters, step 2 the same with noise.  On both packages the tools run as
their users run them: JAX's ``tools/eval_testdata_kf.py --cpu`` and
``tools/eval_curve.py``, the port's ``python -m
phyloformer_tpu_torch.tools.eval_testdata_kf|eval_curve --device cpu``.

Each side also computes every alignment's tree and KF at each step through
its library (the tools' own steps); its tools print those numbers.  Across
the packages each alignment's KF agrees within ``KF_TOL`` of max(1, KF) (the
two packages' distances differ in fp32 rounding, which moves the BME branch
lengths that KF reads), unless the two trees differ in topology: such a
flip is named, and at most ``MAX_FLIPS`` of the 8 trees may flip.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_model import CKPT, REPO, run_jax, run_port

KF_TOL = 1e-4
MAX_FLIPS = 1
STEPS = (1, 2)

_LIBRARY_KF = """
def trees_and_kf(engine, alns, truths):
    out = []
    for aln, vec, truth in zip(alns, engine.predict(alns), truths):
        _, phy = vec_to_phylip(np.asarray(vec, np.float64), aln.ids)
        nwk = native.build_tree_from_phylip(phy, "bme", nni=True, spr=True)
        out.append((nwk, native.compare_newick(truth, nwk).kf))
    return out
"""


def _run_tool(args, env):
    r = subprocess.run([sys.executable] + args, capture_output=True, text=True, cwd=str(REPO),
                       timeout=300, env={**os.environ, **env})
    assert r.returncode == 0, r.stderr[-4000:]
    return [json.loads(line) for line in r.stdout.strip().splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def tools_case(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    msas, trees, run = root / "alns", root / "trees", root / "run"
    run_port(f"""
from phyloformer_tpu_torch.sim import cli_msa, cli_trees
assert cli_trees.main(["-n", "4", "-t", "20", "-o", {str(trees)!r}, "--seed", "7"]) == 0
assert cli_msa.main([{str(trees)!r}, {str(msas)!r}, "-l", "120", "--seed", "7"]) == 0
""", {}, root / "sim")
    want = run_jax(f"""
import dataclasses, json, pathlib
import jax
from phyloformer_tpu.data.fasta import read_fasta
from phyloformer_tpu.data.phylip import vec_to_phylip
from phyloformer_tpu.infer.engine import InferenceConfig, InferenceEngine
from phyloformer_tpu.io.checkpoint import CheckpointManager
from phyloformer_tpu.io.ckpt_import import load_pretrained
from phyloformer_tpu.trees import native
{_LIBRARY_KF}
params, cfg, _ = load_pretrained({str(CKPT)!r})
rng = np.random.default_rng(3)
noisy = jax.tree_util.tree_map(
    lambda a: (np.asarray(a) + rng.normal(0.0, 0.01, np.shape(a))).astype(np.float32), params)
mgr = CheckpointManager({str(run)!r})
for step, p in zip({STEPS!r}, (params, noisy)):
    mgr.save(step, {{"params": jax.tree_util.tree_map(np.asarray, p)}},
             metadata={{"step": step, "config": dataclasses.asdict(cfg)}})
mgr.close()
paths = sorted(pathlib.Path({str(msas)!r}).glob("*.fa"))
alns = [read_fasta(p) for p in paths]
truths = [(pathlib.Path({str(trees)!r}) / (p.stem + ".nwk")).read_text() for p in paths]
for step, p in zip({STEPS!r}, (params, noisy)):
    for k, (nwk, kf) in enumerate(trees_and_kf(InferenceEngine(p, cfg, InferenceConfig()),
                                               alns, truths)):
        OUT[f"{{step}}.{{k}}.nwk"], OUT[f"{{step}}.{{k}}.kf"] = np.array(nwk), kf
""", {}, root / "jax")
    jax_env = {"JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)}
    data = ["--msas", str(msas), "--trees", str(trees)]
    want["tool_kf"] = _run_tool(["tools/eval_testdata_kf.py", str(CKPT), "--cpu"] + data,
                                jax_env)[-1]
    want["tool_curve"] = _run_tool(["tools/eval_curve.py", str(run)] + data, jax_env)
    got = run_port(f"""
import pathlib
from phyloformer_tpu_torch.data.fasta import read_fasta
from phyloformer_tpu_torch.data.phylip import vec_to_phylip
from phyloformer_tpu_torch.infer.engine import InferenceEngine
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.models.params import params_from_numpy
from phyloformer_tpu_torch.tools.eval_curve import run_steps
from phyloformer_tpu_torch.trees import native
{_LIBRARY_KF}
_, cfg, _ = load_pretrained({str(CKPT)!r})
steps, load = run_steps({str(run)!r})
OUT["steps"] = np.array(steps)
paths = sorted(pathlib.Path({str(msas)!r}).glob("*.fa"))
alns = [read_fasta(p) for p in paths]
truths = [(pathlib.Path({str(trees)!r}) / (p.stem + ".nwk")).read_text() for p in paths]
for step in steps:
    engine = InferenceEngine(params_from_numpy(load(step)[0]), cfg, device="cpu")
    for k, (nwk, kf) in enumerate(trees_and_kf(engine, alns, truths)):
        OUT[f"{{step}}.{{k}}.nwk"], OUT[f"{{step}}.{{k}}.kf"] = np.array(nwk), kf
OUT["stems"] = np.array([p.stem for p in paths])
""", {}, root / "port")
    mod = "phyloformer_tpu_torch.tools."
    port_env = {"OMP_NUM_THREADS": "2"}
    got["tool_kf"] = _run_tool(["-m", mod + "eval_testdata_kf", str(CKPT), "--device", "cpu"]
                               + data, port_env)[-1]
    got["tool_curve"] = _run_tool(["-m", mod + "eval_curve", str(run), "--device", "cpu",
                                   "--out", str(root / "curve.jsonl")] + data, port_env)
    got["curve_file"] = [json.loads(x) for x in (root / "curve.jsonl").read_text().splitlines()]
    return want, got


def test_tools_print_their_library_numbers(tools_case):
    """Each side's tools print the KF its library computes: eval_testdata_kf
    on the checkpoint is step 1 (the same parameters), eval_curve one row a
    step, the port's per alignment too."""
    want, got = tools_case
    for side in (want, got):
        kfs = {s: [float(side[f"{s}.{k}.kf"]) for k in range(4)] for s in STEPS}
        tool = side["tool_kf"]
        assert tool["n"] == 4 and tool["mean_kf"] == pytest.approx(np.mean(kfs[1]), abs=1e-12)
        assert tool["median_kf"] == pytest.approx(np.median(kfs[1]), abs=1e-12)
        assert [r["step"] for r in side["tool_curve"]] == list(STEPS)
        for row in side["tool_curve"]:
            assert row["n"] == 4
            assert row["mean_kf"] == pytest.approx(np.mean(kfs[row["step"]]), abs=1e-12)
    assert list(got["tool_kf"]["kf"].values()) == [float(got[f"1.{k}.kf"]) for k in range(4)]
    assert list(got["tool_kf"]["kf"]) == [str(s) for s in got["stems"]]
    assert got["curve_file"] == got["tool_curve"]
    assert list(got["steps"]) == list(STEPS)


def test_tools_give_jax_per_alignment_kf_or_name_each_flip(tools_case):
    from phyloformer_tpu.trees.native import compare_newick

    want, got = tools_case
    flips = []
    for step in STEPS:
        for k in range(4):
            kf, ref = float(got[f"{step}.{k}.kf"]), float(want[f"{step}.{k}.kf"])
            if compare_newick(str(got[f"{step}.{k}.nwk"]), str(want[f"{step}.{k}.nwk"])).rf:
                flips.append((step, str(got["stems"][k]), kf, ref))
                continue
            assert abs(kf - ref) <= KF_TOL * max(1.0, ref), (step, k, kf, ref)
    assert len(flips) <= MAX_FLIPS, f"topology flips (step, alignment, port KF, JAX KF): {flips}"
