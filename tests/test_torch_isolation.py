"""The PyTorch port stands alone: no JAX, nothing of the JAX package, and
its entry points refuse to fall back to the CPU silently.

The port runs in fresh interpreters (torch and JAX are kept in separate
processes throughout the port's tests).
"""

import ast
import json
import math
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "phyloformer_tpu_torch"


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "flax", "optax", "orbax", "phyloformer_tpu")


def _run(code: str) -> dict:
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=str(REPO), timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_importing_every_module_pulls_in_no_jax():
    out = _run("""
import importlib, json, pkgutil, sys
import phyloformer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "loaded": sorted(sys.modules)}))
""")
    assert len(out["imported"]) >= 20, out["imported"]
    bad = [m for m in out["loaded"] if _forbidden(m)]
    assert not bad, bad


@pytest.mark.parametrize("path", sorted(p.relative_to(REPO).as_posix()
                                        for p in list(PKG.rglob("*.py"))
                                        + [REPO / "chip_smoke.py"]))
def test_source_imports_no_jax(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_entry_points_default_to_cuda(tmp_path):
    """Without a card, the engine and the CLI raise unless the CPU is asked
    for; with one, they run there."""
    aln = tmp_path / "alns"
    aln.mkdir()
    (aln / "a.fa").write_text(">x\nACDEFG\n>y\nACDEFH\n>z\nAC-EFG\n")
    ckpt = REPO / "artifacts" / "pf_mre_r5.ckpt"
    out = _run(f"""
import json, torch
from phyloformer_tpu_torch.infer import cli
from phyloformer_tpu_torch.infer.engine import InferenceEngine
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
params, cfg, _ = load_pretrained({str(ckpt)!r})
res = {{"cuda": torch.cuda.is_available()}}
try:
    InferenceEngine(params, cfg)
    res["engine"] = "ran"
except RuntimeError as e:
    res["engine"] = str(e)
try:
    res["cli"] = cli.main([{str(ckpt)!r}, {str(aln)!r}, "-o", {str(tmp_path / "o1")!r}])
except RuntimeError as e:
    res["cli"] = str(e)
res["engine_cpu"] = InferenceEngine(params, cfg, device="cpu").device.type
res["cli_cpu"] = cli.main([{str(ckpt)!r}, {str(aln)!r}, "-o", {str(tmp_path / "o2")!r},
                           "--device", "cpu"])
print(json.dumps(res))
""")
    if out["cuda"]:
        assert out["engine"] == "ran" and out["cli"] == 0
    else:
        assert "no CUDA device" in out["engine"], out
        assert "no CUDA device" in out["cli"], out
        assert not (tmp_path / "o1" / "a.phy").exists()
    assert out["engine_cpu"] == "cpu"
    assert out["cli_cpu"] == 0
    assert (tmp_path / "o2" / "a.phy").read_text().startswith("3\n")


def test_unported_knobs_raise():
    """bf16 parameters on the fused forward (above the pipeline's site
    limit) are refused, naming the JAX package's own failure there; bf16
    parameters, the reduced matmul precisions,
    bf16 storage of x1 and the sharded engine (on a mesh of one rank) are
    ported and construct."""
    out = _run("""
import json
from phyloformer_tpu_torch.infer.engine import (InferenceConfig, InferenceEngine,
                                                ShardedInferenceEngine)
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
params, cfg, _ = load_pretrained("artifacts/pf_mre_r5.ckpt")
msgs = []
for kw in ({"precision": "bfloat16"}, {"matmul_precision": "default"},
           {"pipeline_act_dtype": "bfloat16"}):
    try:
        InferenceEngine(params, cfg, InferenceConfig(**kw), device="cpu")
        msgs.append("ran")
    except ValueError as e:
        msgs.append(str(e))
from phyloformer_tpu_torch.parallel.mesh import make_mesh
try:
    ShardedInferenceEngine(params, cfg, make_mesh(), device="cpu")
    msgs.append("ran")
except ValueError as e:
    msgs.append(str(e))
import numpy as np
from phyloformer_tpu_torch.data.fasta import Alignment
# a 1100-site alignment (a 1280-site bucket) runs the L-tiled path
eng = InferenceEngine(params, cfg, device="cpu")
codes = np.random.default_rng(0).integers(0, 20, (4, 1100)).astype(np.int8)
long_pred = eng.predict([Alignment(codes, list("abcd"))])[0]
try:
    InferenceEngine(params, cfg, InferenceConfig(precision="bfloat16"),
                    device="cpu").predict([Alignment(codes, list("abcd"))])
    msgs.append("ran")
except ValueError as e:
    msgs.append(str(e))
print(json.dumps({"msgs": msgs, "long": long_pred.tolist()}))
""")
    assert len(out["msgs"]) == 5, out
    assert out["msgs"][0:4] == ["ran", "ran", "ran", "ran"], out
    assert "the JAX package's own fused forward raises" in out["msgs"][4], out
    assert "axial_block.py:276" in out["msgs"][4], out
    assert len(out["long"]) == 6 and all(math.isfinite(v) for v in out["long"]), out


def test_import_walk_covers_training_modules():
    out = _run("""
import json, pkgutil
import phyloformer_tpu_torch as pkg
print(json.dumps({"names": [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                                    pkg.__name__ + ".")]}))
""")
    for name in ("train.cli", "train.data", "train.loop", "train.losses", "train.schedule",
                 "train.trainer", "train.packed", "train.cli_preprocess", "train.profiling",
                 "io.checkpoint", "ops.kernels.autodiff", "ops.kernels.axial_block_bwd"):
        assert "phyloformer_tpu_torch." + name in out["names"], name


def test_import_walk_covers_oracle_and_bench_modules():
    out = _run("""
import json, pkgutil
import phyloformer_tpu_torch as pkg
print(json.dumps({"names": [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                                    pkg.__name__ + ".")]}))
""")
    for name in ("infer.oracle", "bench", "bench.accuracy", "bench.cli"):
        assert "phyloformer_tpu_torch." + name in out["names"], name


def test_import_walk_covers_tree_toolkit_and_bench_modules():
    """The tree and MSA toolkit, the end-to-end bench modules and the span
    recorder are walked (so the guards above cover them), and the host ones
    load neither torch nor JAX: ``pf-tree-torch``'s process pool and
    ``pf-msa-torch`` start no CUDA context, and a span site needs no torch."""
    host = ("trees.native", "trees.likelihood", "trees.ml_fast", "trees.baselines",
            "trees.cli", "data.msa_tools", "data.cli_msa_tools", "bench.harness",
            "bench.report", "bench.figures", "bench.crossmatrix", "bench.cli", "spans")
    out = _run(f"""
import importlib, json, pkgutil, sys
import phyloformer_tpu_torch as pkg
for name in {host!r}:
    importlib.import_module("phyloformer_tpu_torch." + name)
print(json.dumps({{"loaded": sorted(sys.modules),
                  "names": [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                                  pkg.__name__ + ".")]}}))
""")
    for name in host:
        assert "phyloformer_tpu_torch." + name in out["names"], name
    assert not [m for m in out["loaded"] if _forbidden(m) or m.split(".")[0] == "torch"]
    assert "matplotlib" not in out["loaded"]


def test_import_walk_covers_orbax_manifest_and_tools():
    """The Orbax reader, the figure manifest and the evaluation tools are
    walked (so the guards above cover them); importing them, and the Orbax
    reader's own imports, load neither JAX nor ``orbax`` nor matplotlib."""
    mods = ("io.orbax", "bench.manifest", "tools", "tools.eval_testdata_kf",
            "tools.eval_curve")
    out = _run(f"""
import importlib, json, pkgutil, sys
import phyloformer_tpu_torch as pkg
for name in {mods!r}:
    importlib.import_module("phyloformer_tpu_torch." + name)
from phyloformer_tpu_torch.io import orbax
try:
    orbax._tensorstore()
except ImportError:
    pass
print(json.dumps({{"loaded": sorted(sys.modules),
                  "names": [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                                  pkg.__name__ + ".")]}}))
""")
    for name in mods:
        assert "phyloformer_tpu_torch." + name in out["names"], name
    assert not [m for m in out["loaded"] if _forbidden(m)]
    assert "matplotlib" not in out["loaded"]


EXPERIMENT_TOOLS = ("reference_path", "make_grid_data", "run_grid", "summarize_grid",
                    "accuracy_at_scale", "merge_packed", "make_corpus", "make_ft_corpora",
                    "scaling_bench", "first_call_check")


def test_import_walk_covers_experiment_tools_and_data_api():
    """The experiment tools are walked (so the guards above cover them);
    importing them and the reference-API data functions loads neither JAX
    nor the JAX package."""
    out = _run(f"""
import importlib, json, pkgutil, sys
import phyloformer_tpu_torch as pkg
for name in {EXPERIMENT_TOOLS!r}:
    importlib.import_module("phyloformer_tpu_torch.tools." + name)
from phyloformer_tpu_torch.data import (load_alignment, load_distance_matrix, one_hot,
                                        seq2pair_matrix)
from phyloformer_tpu_torch.data.newick import scale_branches
print(json.dumps({{"loaded": sorted(sys.modules),
                  "names": [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                                  pkg.__name__ + ".")]}}))
""")
    for name in EXPERIMENT_TOOLS:
        assert "phyloformer_tpu_torch.tools." + name in out["names"], name
    assert not [m for m in out["loaded"] if _forbidden(m)]


# the tools that run the model, and how each is started on the card by default
CARD_TOOLS = {
    "reference_path": ["W"],
    "accuracy_at_scale": ["W"],
    "run_grid": ["--methods", "PF", "--pf-weights", "W", "--grid-root", "G", "--lengths",
                 "60", "--out", "O"],
    "scaling_bench": [],
}


@pytest.mark.parametrize("tool", sorted(CARD_TOOLS))
def test_experiment_tools_default_to_cuda(tool, tmp_path):
    """Without a card each tool that runs the model raises unless --device cpu
    is given."""
    ckpt = str(REPO / "artifacts" / "pf_mre_r5.ckpt")
    grid = tmp_path / "grid" / "L60" / "msas"
    grid.mkdir(parents=True)
    (grid / "0_3_tips.fa").write_text(">x\nACDEFG\n>y\nACDEFH\n>z\nAC-EFG\n")
    (tmp_path / "grid" / "L60" / "trees").mkdir()
    argv = [{"W": ckpt, "G": str(tmp_path / "grid"), "O": str(tmp_path / "out")}.get(a, a)
            for a in CARD_TOOLS[tool]]
    out = _run(f"""
import json, torch
from phyloformer_tpu_torch.tools import {tool} as mod
res = {{"cuda": torch.cuda.is_available()}}
if not res["cuda"]:
    try:
        mod.main({argv!r})
        res["err"] = "ran"
    except RuntimeError as e:
        res["err"] = str(e)
print(json.dumps(res))
""")
    if not out["cuda"]:
        assert "no CUDA device" in out["err"], out


def test_make_corpus_evolves_on_the_card_by_default(tmp_path):
    """make_corpus's alignments are evolved on the card unless --device cpu
    is given: without a card it raises before it draws a tree."""
    r = subprocess.run([sys.executable, "-m", "phyloformer_tpu_torch.tools.make_corpus",
                        str(tmp_path / "c"), "--scale", "0.00008"], capture_output=True,
                       text=True, cwd=str(REPO), timeout=300)
    import torch

    if not torch.cuda.is_available():
        assert r.returncode != 0
        assert "no CUDA device" in r.stderr, r.stderr[-2000:]
        assert not (tmp_path / "c" / "trees_L250").exists()


def test_serve_and_ckpt_modules_import_no_jax_and_serve_defaults_to_cuda():
    """The serving package and pf-ckpt-torch pull in neither JAX nor the JAX
    package; pf-serve-torch runs on the card by default and raises without
    one, before it listens."""
    out = _run(f"""
import json, sys, torch
import phyloformer_tpu_torch.serve, phyloformer_tpu_torch.serve.server
import phyloformer_tpu_torch.serve.cli, phyloformer_tpu_torch.io.cli
from phyloformer_tpu_torch.serve import cli
res = {{"cuda": torch.cuda.is_available(), "loaded": sorted(sys.modules),
       "default": cli.build_parser().parse_args(["w.ckpt"]).device}}
if not res["cuda"]:
    try:
        cli.build_server([{str(REPO / "artifacts" / "pf_mre_r5.ckpt")!r}, "--port", "0"])
        res["serve"] = "ran"
    except RuntimeError as e:
        res["serve"] = str(e)
print(json.dumps(res))
""")
    assert not [m for m in out["loaded"] if _forbidden(m)]
    assert out["default"] == "cuda"
    if not out["cuda"]:
        assert "no CUDA device" in out["serve"], out


def test_bench_cli_defaults_to_cuda(tmp_path):
    """Without a card pf-bench-torch raises unless --device cpu is given."""
    out = _run("""
import json, torch
from phyloformer_tpu_torch.bench import cli
res = {"cuda": torch.cuda.is_available(),
       "defaults": [cli.build_parser().parse_args(a).device
                    for a in (["accuracy-grid"], ["throughput", "w.ckpt"])]}
if not res["cuda"]:
    try:
        cli.main(["accuracy-grid", "--grid", "6x30", "--reps", "1"])
        res["grid"] = "ran"
    except RuntimeError as e:
        res["grid"] = str(e)
print(json.dumps(res))
""")
    assert out["defaults"] == ["cuda", "cuda"]
    if not out["cuda"]:
        assert "no CUDA device" in out["grid"], out


def test_train_cli_defaults_to_cuda(tmp_path):
    """Without a card pf-train-torch raises before reading any data; the
    card is the default device."""
    out = _run(f"""
import json, torch
from phyloformer_tpu_torch.train import cli
res = {{"cuda": torch.cuda.is_available()}}
if not res["cuda"]:
    try:
        cli.main(["-t", {str(tmp_path)!r}, "-a", {str(tmp_path)!r}, "-o", {str(tmp_path)!r}])
        res["cli"] = "ran"
    except RuntimeError as e:
        res["cli"] = str(e)
    try:
        from phyloformer_tpu_torch.models.params import PhyloformerConfig
        from phyloformer_tpu_torch.train import TrainConfig, create_train_state
        create_train_state(PhyloformerConfig(n_blocks=1), TrainConfig())
        res["state"] = "ran"
    except RuntimeError as e:
        res["state"] = str(e)
res["default"] = cli.build_parser().parse_args([]).device
print(json.dumps(res))
""")
    assert out["default"] == "cuda"
    if not out["cuda"]:
        assert "no CUDA device" in out["cli"], out
        assert "no CUDA device" in out["state"], out


# What pf-train-torch --device cpu does with each flag in one process, on an
# empty corpus: a mesh larger than the world of one rank raises make_mesh's
# size error; --mesh-data 1, --shard-pairs and --distributed-init (given a
# world of one in torchrun's variables) run to the empty corpus (exit 1);
# with --packed-data the flags pass and the shard directory is read; dropout
# runs (to the empty corpus) on the eager route.
TRAIN_FLAG_OUTCOMES = {
    ("--mesh-data", "2"): "ValueError: mesh 2x1 != 1 devices",
    ("--mesh-data", "1"): "rc 1",
    ("--mesh-pair", "2"): "ValueError: 1 devices not divisible by pair=2",
    ("--shard-pairs",): "rc 1",
    ("--distributed-init",): "rc 1",
    ("--dropout", "0.1"): "rc 1",
    ("--packed-data", "x", "--shard-pairs"): "FileNotFoundError",
}


@pytest.mark.parametrize("flags", [list(f) for f in TRAIN_FLAG_OUTCOMES])
def test_train_cli_refuses_unported_flags(flags, tmp_path):
    """The flags that were refused before the mesh and dropout were
    ported: each now runs, or raises the mesh's size error."""
    out = _run(f"""
import json, os
from torch import distributed as dist
from phyloformer_tpu_torch.train import cli
# the rendezvous store on a port this process binds itself and holds; the
# rank joins it as a client (tests/torch_rendezvous.py)
store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
os.environ.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                  MASTER_PORT=str(store.port), TORCHELASTIC_USE_AGENT_STORE="True",
                  TORCHELASTIC_RESTART_COUNT="0")
try:
    msg = f"rc {{cli.main(['-t', {str(tmp_path)!r}, '-a', {str(tmp_path)!r}, '--device', 'cpu']
                          + {flags!r})}}"
except (ValueError, FileNotFoundError) as e:
    msg = f"{{type(e).__name__}}: {{e}}"
print(json.dumps({{"msg": msg}}))
""")
    assert out["msg"].startswith(TRAIN_FLAG_OUTCOMES[tuple(flags)]), out


def _tiny_corpus(root: pathlib.Path, n_examples: int = 6, n: int = 5, l: int = 20) -> None:
    """``root/trees`` and ``root/alns``: caterpillar trees with random
    branch lengths and random protein alignments of ``n`` tips."""
    import numpy as np

    rng = np.random.default_rng(3)
    (root / "trees").mkdir(parents=True)
    (root / "alns").mkdir()
    for k in range(n_examples):
        names = [f"t{k}_{i}" for i in range(n)]
        tree = f"{names[0]}:{rng.uniform(0.05, 0.5):.4f}"
        for name in names[1:]:
            tree = f"({tree},{name}:{rng.uniform(0.05, 0.5):.4f}):{rng.uniform(0.05, 0.5):.4f}"
        (root / "trees" / f"ex{k}.nwk").write_text(tree.rsplit(":", 1)[0] + ";\n")
        seqs = np.array(list("ARNDCQEGHILKMFPSTWYV"))[rng.integers(0, 20, (n, l))]
        (root / "alns" / f"ex{k}.fa").write_text(
            "".join(f">{name}\n{''.join(seq)}\n" for name, seq in zip(names, seqs)))


@pytest.mark.parametrize("precision", ["default", "tensorfloat32"])
def test_train_cli_runs_at_reduced_precision(precision, tmp_path):
    """``pf-train-torch --device cpu --matmul-precision {default,
    tensorfloat32} --use-pallas on``: two fused steps through the one-pass
    plain versions, their losses in the metrics file, the first within the
    6e-3 gate of (and not equal to) the float32 run's from the same seed."""
    _tiny_corpus(tmp_path / "corpus")
    common = ["-t", str(tmp_path / "corpus" / "trees"), "-a", str(tmp_path / "corpus" / "alns"),
              "--device", "cpu", "--use-pallas", "on", "--nb-blocks", "2", "--batch-size", "2",
              "--max-steps", "2", "--log-every", "1", "--num-workers", "1",
              "--hard-loss-ceiling", "1e6", "-o", str(tmp_path / "out")]
    out = _run(f"""
import contextlib, io, json
from phyloformer_tpu_torch.train import cli
res = {{}}
for name, prec in (("run", {precision!r}), ("fp32", "float32")):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main({common!r} + ["-n", name, "--matmul-precision", prec])
    res[name] = {{"rc": rc, "summary": json.loads(buf.getvalue().strip().splitlines()[-1])}}
print(json.dumps(res))
""")
    for name in ("run", "fp32"):
        assert out[name]["rc"] == 0, out
        summary = out[name]["summary"]
        assert summary["steps"] == 2 and summary["use_pallas"] is True, summary
        assert summary["device"] == "cpu", summary
    losses = {}
    for name in ("run", "fp32"):
        lines = (tmp_path / "out" / f"{name}_metrics.jsonl").read_text().splitlines()
        losses[name] = [r["train_loss"] for r in map(json.loads, lines) if "train_loss" in r]
        assert len(losses[name]) == 2 and all(map(math.isfinite, losses[name])), losses
    first, ref = losses["run"][0], losses["fp32"][0]
    assert first != ref and abs(first - ref) <= 6e-3 * abs(ref), losses


def test_training_knobs_refuse_what_is_not_ported():
    """Dropout on the fused route refuses with JAX's message; pair
    sharding and a mesh (of one rank) run, the step's loss equal to the
    step's without them; fused training above 1024 sites runs, in the block
    and in the backward host function."""
    out = _run("""
import json
import torch
from phyloformer_tpu_torch.models.params import PhyloformerConfig, init_params
from phyloformer_tpu_torch.ops.kernels.autodiff import fused_axial_block_ad
from phyloformer_tpu_torch.ops.kernels.axial_block_bwd import fused_axial_block_bwd
from phyloformer_tpu_torch.train import TrainConfig, create_train_state, make_train_step
msgs = []
def attempt(fn):
    try:
        fn()
        msgs.append("ran")
    except ValueError as e:
        msgs.append(str(e))
from phyloformer_tpu_torch.parallel.mesh import make_mesh
cfg = PhyloformerConfig(n_blocks=1, embed_dim=32)
state, tx = create_train_state(cfg, TrainConfig(), device="cpu")
attempt(lambda: make_train_step(PhyloformerConfig(n_blocks=1, embed_dim=32, dropout=0.1),
                                TrainConfig(use_pallas=True), tx))
g = torch.Generator().manual_seed(1)
batch = {"codes": torch.randint(0, 20, (2, 5, 12), generator=g),
         "dists": torch.rand(2, 10, generator=g) + 0.1}
losses = []
for tcfg, mesh in ((TrainConfig(), None), (TrainConfig(shard_pairs=True), None),
                   (TrainConfig(shard_pairs=True, use_pallas=True), make_mesh(data=1))):
    def step():
        st, tx_ = create_train_state(cfg, tcfg, device="cpu")
        losses.append(float(make_train_step(cfg, tcfg, tx_, mesh=mesh)(st, batch)[1]["train_loss"]))
    attempt(step)
layer = init_params(cfg)["layers"][0]
x = torch.randn(1, 1, 1025, 32, generator=torch.Generator().manual_seed(0))
sm, pm = torch.ones(1, 1025), torch.ones(1, 1)
out = fused_axial_block_ad(x.requires_grad_(True), layer, sm, pm, cfg)
gx, = torch.autograd.grad(out.square().sum(), [x])
from phyloformer_tpu_torch.ops.kernels.fused import fused_axial_block_res
_, x1, stats = fused_axial_block_res(x.detach(), layer, sm, pm)
gx2, dl = fused_axial_block_bwd(x.detach(), x1, stats, out.detach(), layer, sm, pm, 4)
print(json.dumps({"msgs": msgs, "losses": losses, "finite": [bool(torch.isfinite(gx).all()),
                                           bool(torch.isfinite(gx2).all())],
                  "same": bool(torch.allclose(2 * gx2, gx, rtol=1e-5, atol=1e-5))}))
""")
    assert len(out["msgs"]) == 4, out
    assert out["msgs"][0] == "use_pallas training requires dropout=0", out
    assert out["msgs"][1:] == ["ran"] * 3, out
    first = out["losses"][0]
    assert all(abs(x - first) <= 1e-5 * abs(first) for x in out["losses"]), out
    assert out["finite"] == [True, True] and out["same"], out
