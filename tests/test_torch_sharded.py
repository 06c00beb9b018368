"""The port's ('data', 'pair') mesh on ``torch.distributed`` against the JAX
package's mesh, on the CPU.

The JAX side runs in a subprocess on 8 virtual CPU devices, its mesh on the
first 4 (``make_mesh(data=2, pair=2, devices=jax.devices()[:4])``), with the
Pallas kernels in interpret mode as its own tests run them.  The port's side
runs as gloo ranks (one process each, the plain versions of the kernels),
on the same weights and inputs (``params_from_numpy``):

- ``forward_fused_sharded`` at ``test_pallas_kernels.py``'s sizes (b=2,
  n=17, L=48; 41 real sites, 15 real sequences), resident and L-tiled (the
  residency threshold lowered to 16 sites on both sides), and at one TF32
  pass: within ``FWD_TOL`` of max(1, max|ref|) of JAX's sharded output
  (the port's fused-vs-JAX bar; round 5's sharded error was 7.2e-7), and
  within ``UNSHARDED_TOL`` of the port's own unsharded ``forward_fused``;
  one pass within the 6e-3 gate (JAX computes "default" in fp32 on the
  CPU, the port's plain versions round to TF32 as the kernels do);
- ``sharded_fused_loss_and_grads`` at ``test_training.py``'s sizes (bsz 2,
  n 11, L 40: P = 55, so the last pair shard holds a padding pair that
  aliases sequence 0), ragged, for mae, mre and mse: the loss within
  ``LOSS_TOL`` relative, every gradient within ``GRAD_TOL`` of max(1,
  max|ref|) (the port's gradient bar);
- the eager route under the pair mesh (the column attention's pair-axis
  sums all-reduced, differentiably) against the unsharded eager model:
  distances and gradients;
- ``ShardedInferenceEngine`` at data 2 × pair 1 and data 1 × pair 2 on an
  odd number of alignments (``_plan`` repeats, ``_padded_bsz`` pads)
  against JAX's, within ``ENGINE_TOL``;
- the CLIs with mesh flags, each as two processes: ``pf-infer-torch``
  (the PHYLIP text of one process, within ``ENGINE_TOL``; ``--multihost``
  partitions the files), ``pf-train-torch --shard-pairs`` (both ranks the
  one process's losses within ``LOSS_TOL``; one checkpoint directory) and
  ``pf-serve-torch`` (one request answered as one process answers it).

Every rank of a run must give the same bits.  The gradient bar is shown
to catch a sharded backward that skips the A1 all-reduce.  A served
micro-batch that fails on every rank is answered and the mesh serves on;
one that fails on one rank stops both.  The trainer's routing and
``make_mesh``'s errors are checked in one process.
"""

import functools
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from test_torch_model import (
    _EPILOGUE,
    _JAX_EPILOGUE,
    _JAX_PRELUDE,
    _PRELUDE,
    CKPT,
    JAX_THREAD_FLAGS,
    PORT_THREAD_ENV,
    flatten,
    random_params,
)
from torch_rendezvous import Rendezvous

REPO = pathlib.Path(__file__).resolve().parent.parent
FWD_TOL = 1e-5  # of max(1, max|ref|): the fused forward against JAX's
UNSHARDED_TOL = 1e-6  # the sharded forward against the port's own unsharded one
GATE = 6e-3  # one TF32 pass against JAX's fp32 "default" on the CPU
ONE_PASS_TOL = 2e-3  # one TF32 pass, operands summed in another fp32 order
LOSS_TOL = 1e-5  # relative
GRAD_TOL = 5.3e-5  # of max(1, max|ref|), the gradient bar
ENGINE_TOL = 5e-5  # of max(1, max|ref|), the engine's bar
LOSSES = ("mae", "mre", "mse")
AMINO = "ARNDCQEGHILKMFPSTWYV"

# forward: test_pallas_kernels.py's sizes; training: test_training.py's
FWD = dict(b=2, n=17, l=48, real_l=41, real_n=15)
TRAIN = dict(b=2, n=11, l=40)
# the engines: 5 alignments in the (12, 40) bucket, 1 in (12, 64)
ENGINE_DIMS = [(12, 33), (11, 40), (12, 38), (10, 29), (12, 40), (7, 64)]
ENGINE_ICFG = "n_buckets=(12,), l_buckets=(40, 64), pad_batch_sizes=True"


_RANK_ENV = {**os.environ, **PORT_THREAD_ENV}  # a rank's environment, before rendezvous


def _wait_all(procs, timeout: float):
    """Wait for every process; kill the rest as soon as one fails (the others
    would wait in a collective) or the time is up.  Returns their outputs."""
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        failed = any(p.poll() not in (None, 0) for p in procs)
        if failed or time.monotonic() > deadline:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.1)
    outs = [p.communicate() for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{err[-4000:]}"
    return outs


_RANK_PRELUDE = """
from phyloformer_tpu_torch.parallel.mesh import init_distributed, make_mesh
init_distributed("gloo", "cpu")
RANK = torch.distributed.get_rank()
"""

_RANK_EPILOGUE = """
torch.distributed.destroy_process_group()
"""


def run_ranks(code, inputs, tmp_path, world, timeout=240):
    """Run ``code`` on ``world`` gloo ranks, each a fresh interpreter with
    :func:`test_torch_model.run_port`'s prelude (``IN``, ``OUT``, ``tree``,
    ``t``), ``RANK`` and the process group up; returns each rank's ``OUT``."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    src = tmp_path / "ranks_in.npz"
    np.savez(src, **inputs)
    prog = _PRELUDE + _RANK_PRELUDE + code + _RANK_EPILOGUE + _EPILOGUE
    with Rendezvous() as rdv:
        procs = [rdv.popen([sys.executable, "-c", prog, str(src),
                            str(tmp_path / f"rank{r}_out.npz")], r, world,
                           cwd=str(REPO), env=_RANK_ENV, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
                 for r in range(world)]
    _wait_all(procs, timeout)
    return [dict(np.load(tmp_path / f"rank{r}_out.npz")) for r in range(world)]


def start_jax(code, inputs, tmp_path, name):
    """:func:`test_torch_model.run_jax` without the wait: starts ``code`` and
    returns the function that waits for it and gives its ``OUT``.  The
    interpret-mode traces take ~10-25 s each, so the fixtures run them side
    by side."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    src, dst = tmp_path / f"{name}_in.npz", tmp_path / f"{name}_out.npz"
    np.savez(src, **inputs)
    flags = (os.environ.get("XLA_FLAGS", "") + " " + JAX_THREAD_FLAGS).strip()
    proc = subprocess.Popen([sys.executable, "-c", _JAX_PRELUDE + code + _JAX_EPILOGUE,
                             str(src), str(dst)], cwd=str(REPO), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": flags})

    def result():
        try:
            _, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
        assert proc.returncode == 0, err[-4000:]
        return dict(np.load(dst))

    return functools.lru_cache(maxsize=None)(result)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _same_on_every_rank(outs, keys):
    for k in keys:
        for r, o in enumerate(outs[1:], 1):
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=f"{k} on rank {r}")


# ---- the JAX fixtures and the 2 x 2 mesh ------------------------------------

def _jax_tree_code():
    return """
import jax.numpy as jnp
def tree(prefix):
    root = {}
    for key, val in IN.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(val)
    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[k]) for k in sorted(node, key=int)]
        return {k: lists(v) for k, v in node.items()}
    return lists(root)
def paths(tree, prefix):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(paths(v, f"{prefix}/{k}"))
    return out
"""


def _inputs():
    fwd_params, _ = random_params(301, 2)  # d = 64, 4 heads
    train_params, _ = random_params(302, 2)
    rng = np.random.default_rng(303)
    b, n, l = FWD["b"], FWD["n"], FWD["l"]
    inputs = {
        "fwd.codes": rng.integers(0, 20, (b, n, l)).astype(np.int32),
        "fwd.site_mask": np.repeat(np.arange(l)[None] < FWD["real_l"], b, 0),
        "fwd.seq_mask": np.repeat(np.arange(n)[None] < FWD["real_n"], b, 0),
    }
    b, n, l = TRAIN["b"], TRAIN["n"], TRAIN["l"]
    site_mask = np.ones((b, l), bool)
    site_mask[1, 37:] = False
    seq_mask = np.ones((b, n), bool)
    seq_mask[1, 10:] = False
    inputs.update({
        "train.codes": rng.integers(0, 22, (b, n, l)).astype(np.int32),
        "train.dists": rng.uniform(0.05, 2.0, (b, n * (n - 1) // 2)).astype(np.float32),
        "train.site_mask": site_mask, "train.seq_mask": seq_mask,
    })
    # kernel A alone: one block at one TF32 pass
    inputs.update({"ka.x": rng.normal(0, 1, (2, 10, 24, 64)).astype(np.float32),
                   "ka.site_mask": np.repeat(np.arange(24)[None] < 21, 2, 0),
                   "ka.pair_mask": np.repeat(np.arange(10)[None] < 9, 2, 0)})
    inputs.update(flatten(fwd_params, "fwd/params"))
    inputs.update(flatten(train_params, "train/params"))
    return inputs


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Every JAX fixture of the file, started at once, side by side: the
    sharded forward (resident, L-tiled, one pass) and kernel A at one pass,
    the sharded loss and gradients (mae, mre, mse), and the sharded engine.
    Returns, by name, the function that waits for each."""
    root = tmp_path_factory.mktemp("sharded_jax")
    head = _jax_tree_code() + """
import phyloformer_tpu.ops.pallas.axial_block as ab
from phyloformer_tpu.models.params import PhyloformerConfig
from phyloformer_tpu.ops.pallas.sharded import (forward_fused_sharded,
                                                sharded_fused_loss_and_grads)
from phyloformer_tpu.parallel import make_mesh
mesh = make_mesh(data=2, pair=2, devices=jax.devices()[:4])
cfg = PhyloformerConfig(n_blocks=2, matmul_precision="float32")
fwd = tree("fwd/params")
args = [jnp.asarray(IN["fwd." + k]) for k in ("codes", "site_mask", "seq_mask")]
def sharded(c):
    return forward_fused_sharded(fwd, args[0], c, mesh, site_mask=args[1], seq_mask=args[2],
                                 interpret=True)
train = tree("train/params")
batch = {k: jnp.asarray(IN["train." + k]) for k in ("codes", "dists", "site_mask",
                                                    "seq_mask")}
"""
    parts = {
        "fwd": """
OUT["fwd.resident"] = sharded(cfg)
""",
        "default": """
OUT["fwd.default"] = sharded(PhyloformerConfig(n_blocks=2, matmul_precision="default"))
OUT["ka.x1"], OUT["ka.stats"] = ab.fused_kernel_a(
    jnp.asarray(IN["ka.x"]), fwd["layers"][0], jnp.asarray(IN["ka.site_mask"]),
    jnp.asarray(IN["ka.pair_mask"]), 4, 1e-5, True, "default")
""",
        # the L-tiled variant: the residency thresholds lowered as JAX's own test does
        "ltiled": """
ab._RESIDENT_SITES_MAX_HI = ab._RESIDENT_SITES_MAX = 16
ab._LTILE = 32
OUT["fwd.ltiled"] = sharded(cfg)
""",
    }
    for loss_name in LOSSES:
        parts[loss_name] = f"""
loss, grads = sharded_fused_loss_and_grads(train, batch, cfg, mesh, {loss_name!r}, True)
OUT[{loss_name!r} + ".loss"] = loss
OUT.update(paths(grads, {loss_name!r} + ".grad"))
"""
    pending = {name: start_jax(head + code, _inputs(), root, name)
               for name, code in parts.items()}
    pending["engine"] = start_jax(_jax_tree_code() + f"""
from phyloformer_tpu.data.fasta import Alignment
from phyloformer_tpu.infer.engine import InferenceConfig, ShardedInferenceEngine
from phyloformer_tpu.models.params import PhyloformerConfig
from phyloformer_tpu.parallel import make_mesh
params, cfg = tree("params"), PhyloformerConfig(n_blocks=2)
alns = [Alignment(IN[f"aln{{k}}"], [str(i) for i in range(len(IN[f"aln{{k}}"]))])
        for k in range({len(ENGINE_DIMS)})]
for data, pair in ((2, 1), (1, 2)):
    mesh = make_mesh(data=data, pair=pair, devices=jax.devices()[:2])
    engine = ShardedInferenceEngine(params, cfg, mesh, InferenceConfig({ENGINE_ICFG},
                                                                       use_pallas=True))
    for k, p in enumerate(engine.predict(alns)):
        OUT[f"{{data}}x{{pair}}.{{k}}"] = p
""", _engine_inputs(), root, "engine")
    return pending


@pytest.fixture(scope="module")
def mesh_case(jax_side, tmp_path_factory):
    """The port's sharded forward, loss and gradients, kernel A at one pass
    and the eager route on four gloo ranks (data 2 x pair 2), beside JAX's."""
    root = tmp_path_factory.mktemp("sharded_mesh")
    inputs = _inputs()
    outs = run_ranks(f"""
from phyloformer_tpu_torch.models.params import PhyloformerConfig
from phyloformer_tpu_torch.models.phyloformer import forward, forward_fused
from phyloformer_tpu_torch.ops.kernels import axial_block, fused
from phyloformer_tpu_torch.ops.kernels.sharded import (
    forward_fused_sharded, pair_shard, real_pairs, sharded_fused_loss_and_grads)
from phyloformer_tpu_torch.ops.kernels import sharded
from phyloformer_tpu_torch.parallel.mesh import all_reduce_sum, batch_slice
from phyloformer_tpu_torch.train.losses import get_term
from phyloformer_tpu_torch.train.trainer import param_leaves
mesh = make_mesh(2, 2)
fwd = tree("fwd/params")
cfg = PhyloformerConfig(n_blocks=2, matmul_precision="float32")
codes, sm, qm = t("fwd.codes"), t("fwd.site_mask"), t("fwd.seq_mask")
OUT["fwd.resident"] = forward_fused_sharded(fwd, codes, cfg, mesh, sm, qm)
OUT["fwd.unsharded"] = forward_fused(fwd, codes, cfg, sm, qm)
OUT["fwd.default"] = forward_fused_sharded(
    fwd, codes, PhyloformerConfig(n_blocks=2, matmul_precision="default"), mesh, sm, qm)
OUT["fwd.default_unsharded"] = forward_fused(
    fwd, codes, PhyloformerConfig(n_blocks=2, matmul_precision="default"), sm, qm)
for prec in ("default", "highest"):
    OUT["ka.x1." + prec], OUT["ka.stats." + prec] = fused.fused_kernel_a(
        t("ka.x"), fwd["layers"][0], t("ka.site_mask"), t("ka.pair_mask"), 1e-5, prec)

# the eager route under the pair mesh: distances, and the gradients of the
# masked mae through the differentiable pair-axis sums
rows = batch_slice(mesh, codes.shape[0])
shard = pair_shard(codes.shape[1], mesh, codes.device)
local = forward(fwd, codes[rows], cfg, sm[rows], qm[rows], shard=shard)
OUT["eager.sharded"] = mesh.gather(local.detach(), codes.shape[0], shard.p_pad, True)
OUT["eager.unsharded"] = forward(fwd, codes, cfg, sm, qm)
eager = tree("train/params")
leaves = param_leaves(eager)
for leaf in leaves:
    leaf.requires_grad_(True)
tc, tsm, tqm, dists = (t("train." + k) for k in ("codes", "site_mask", "seq_mask", "dists"))
tshard = pair_shard(tc.shape[1], mesh, tc.device)
trows = batch_slice(mesh, tc.shape[0])
preds = forward(eager, tc[trows], cfg, tsm[trows], tqm[trows], shard=tshard)
pm = tshard.pair_mask(tqm[trows]).float()
share = ((preds - tshard.columns(dists[trows])).abs() * pm).sum() / real_pairs(tqm).sum()
grads = [all_reduce_sum(g, mesh.world_group) for g in torch.autograd.grad(share, leaves)]
whole = forward(eager, tc, cfg, tsm, tqm)
ref = ((whole - dists).abs() * real_pairs(tqm).float()).sum() / real_pairs(tqm).sum()
for i, (g, r) in enumerate(zip(grads, torch.autograd.grad(ref, leaves))):
    OUT[f"eager.grad{{i}}"], OUT[f"eager.ref_grad{{i}}"] = g, r

train = tree("train/params")
batch = {{k: t("train." + k) for k in ("codes", "dists", "site_mask", "seq_mask")}}
def paths(tree, prefix):
    if isinstance(tree, dict):
        return [q for k, v in tree.items() for q in paths(v, f"{{prefix}}/{{k}}")]
    if isinstance(tree, list):
        return [q for k, v in enumerate(tree) for q in paths(v, f"{{prefix}}/{{k}}")]
    return [prefix]
for loss_name in {LOSSES!r}:
    loss, grads = sharded_fused_loss_and_grads(train, batch, cfg, mesh, get_term(loss_name))
    OUT[loss_name + ".loss"] = loss
    # the gradients come in the order of the tree's leaves
    OUT.update(zip(paths(train, loss_name + ".grad"), grads))
# a planted fault: the backward without the A1 all-reduce over the pair row
bwd = sharded.fused_axial_block_bwd
sharded.fused_axial_block_bwd = lambda *a, **k: bwd(*a, **{{**k, "pair_group": None}})
_, grads = sharded_fused_loss_and_grads(train, batch, cfg, mesh, get_term("mae"))
OUT.update(zip(paths(train, "no_a1.grad"), grads))
sharded.fused_axial_block_bwd = bwd
axial_block.RESIDENT_SITES_MAX = 16
OUT["fwd.ltiled"] = forward_fused_sharded(fwd, codes, cfg, mesh, sm, qm)
""", inputs, root, world=4)
    want = {}
    for name in ("fwd", "default", "ltiled") + LOSSES:
        want.update(jax_side[name]())
    pm = np.asarray(inputs["fwd.seq_mask"])
    i, j = np.triu_indices(FWD["n"], 1)
    return want, outs, pm[:, i] & pm[:, j]


def test_every_rank_gives_the_same_bits(mesh_case):
    _, outs, _ = mesh_case
    # the sharded results (the unsharded references are each rank's own)
    _same_on_every_rank(outs, [k for k in outs[0] if "unsharded" not in k and "ref" not in k])


@pytest.mark.parametrize("case", ["resident", "ltiled"])
def test_sharded_forward_matches_jax(case, mesh_case):
    want, outs, pm = mesh_case
    got, ref = outs[0]["fwd." + case], want["fwd." + case]
    assert got.shape == ref.shape == (FWD["b"], FWD["n"] * (FWD["n"] - 1) // 2)
    assert np.isfinite(got[pm]).all()
    assert _rel(got[pm], ref[pm]) <= FWD_TOL
    assert _rel(got[pm], outs[0]["fwd.unsharded"][pm]) <= UNSHARDED_TOL


def test_sharded_forward_one_pass(mesh_case):
    """At ``matmul_precision="default"`` the sharded forward passes one TF32
    pass to kernels A and B: within the gate of JAX's, within
    ``ONE_PASS_TOL`` of the port's unsharded one-pass forward (the stats,
    summed in another order, can round to the neighbouring TF32 value),
    and not the three-pass result."""
    want, outs, pm = mesh_case
    got = outs[0]["fwd.default"][pm]
    assert _rel(got, want["fwd.default"][pm]) <= GATE
    assert _rel(got, outs[0]["fwd.default_unsharded"][pm]) <= ONE_PASS_TOL
    assert _rel(got, outs[0]["fwd.resident"][pm]) > UNSHARDED_TOL


@pytest.mark.parametrize("name", ["x1", "stats"])
def test_fused_kernel_a_one_pass_matches_jax(name, mesh_case):
    """``fused_kernel_a(..., mxu_precision="default")`` against JAX's at
    ``Precision.DEFAULT`` (fp32 on the CPU) under the one-pass gate, and
    away from the port's own three-pass result."""
    want, outs, _ = mesh_case
    got, ref = outs[0][f"ka.{name}.default"], want[f"ka.{name}"]
    assert got.shape == ref.shape
    assert _rel(got, ref) <= GATE
    assert _rel(got, outs[0][f"ka.{name}.highest"]) > 1e-6
    assert _rel(outs[0][f"ka.{name}.highest"], ref) <= FWD_TOL


@pytest.mark.parametrize("loss", LOSSES)
def test_sharded_loss_and_grads_match_jax(loss, mesh_case):
    want, outs, _ = mesh_case
    got, ref = float(outs[0][loss + ".loss"]), float(want[loss + ".loss"])
    assert abs(got - ref) <= LOSS_TOL * abs(ref), (got, ref)
    names = sorted(k for k in want if k.startswith(loss + ".grad/"))
    assert len(names) == 2 * 26 + 4
    assert names == sorted(k for k in outs[0] if k.startswith(loss + ".grad/"))
    for k in names:
        g, r = outs[0][k], want[k]
        assert g.shape == r.shape, k
        assert _rel(g, r) <= GRAD_TOL, (k, _rel(g, r))


def test_gradient_bar_catches_a_skipped_a1_all_reduce(mesh_case):
    """The sharded backward with kernel C's A1 left local (no all-reduce
    over the pair row) fails ``GRAD_TOL`` against JAX's mae gradients: the
    bar that holds the sharded step sees a wrong sharded backward.  The
    head's and the last block's FFN gradients come before A1 and stay
    right."""
    want, outs, _ = mesh_case
    names = sorted(k for k in want if k.startswith("mae.grad/"))
    errs = {k: _rel(outs[0]["no_a1" + k[3:]], want[k]) for k in names}
    assert max(errs.values()) > 10 * GRAD_TOL, errs
    assert errs["mae.grad/head/w"] <= GRAD_TOL, errs


def test_eager_route_under_pair_mesh(mesh_case):
    _, outs, pm = mesh_case
    o = outs[0]
    assert _rel(o["eager.sharded"][pm], o["eager.unsharded"][pm]) <= UNSHARDED_TOL
    n = len([k for k in o if k.startswith("eager.grad")])
    assert n == 2 * 26 + 4
    for i in range(n):
        assert _rel(o[f"eager.grad{i}"], o[f"eager.ref_grad{i}"]) <= GRAD_TOL, i


# ---- ShardedInferenceEngine --------------------------------------------------



def _engine_inputs():
    params, _ = random_params(311, 2)
    rng = np.random.default_rng(312)
    inputs = flatten(params, "params")
    for k, (n, l) in enumerate(ENGINE_DIMS):
        inputs[f"aln{k}"] = rng.integers(0, 21, (n, l)).astype(np.int8)
    return inputs


@pytest.fixture(scope="module")
def engine_case(jax_side, tmp_path_factory):
    """JAX's ShardedInferenceEngine (kernels in interpret mode) at data 2 x
    pair 1 and data 1 x pair 2 on 5 alignments of one bucket and 1 of
    another; the port's on two gloo ranks, both meshes."""
    root = tmp_path_factory.mktemp("sharded_engine")
    outs = run_ranks(f"""
from phyloformer_tpu_torch.data.fasta import Alignment
from phyloformer_tpu_torch.infer.engine import InferenceConfig, ShardedInferenceEngine
from phyloformer_tpu_torch.models.params import PhyloformerConfig
alns = [Alignment(IN[f"aln{{k}}"], [str(i) for i in range(len(IN[f"aln{{k}}"]))])
        for k in range({len(ENGINE_DIMS)})]
for data, pair in ((2, 1), (1, 2)):
    engine = ShardedInferenceEngine(tree("params"), PhyloformerConfig(n_blocks=2),
                                    make_mesh(data, pair), InferenceConfig({ENGINE_ICFG}),
                                    device="cpu")
    OUT[f"{{data}}x{{pair}}.plan"] = np.array([len(i) for _, i in engine._plan(alns)])
    OUT[f"{{data}}x{{pair}}.bsz"] = np.array([engine._padded_bsz(n) for n in (1, 3, 5)])
    for k, p in enumerate(engine.predict(alns)):
        OUT[f"{{data}}x{{pair}}.{{k}}"] = p
""", _engine_inputs(), root, world=2)
    return jax_side["engine"](), outs


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_sharded_engine_matches_jax(mesh, engine_case):
    want, outs = engine_case
    _same_on_every_rank(outs, [k for k in outs[0] if k.startswith(mesh)])
    for k, (n, _) in enumerate(ENGINE_DIMS):
        got, ref = outs[0][f"{mesh}.{k}"], want[f"{mesh}.{k}"]
        assert got.shape == ref.shape == (n * (n - 1) // 2,)
        assert np.isfinite(got).all()
        assert _rel(got, ref) <= ENGINE_TOL, (k, _rel(got, ref))


def test_sharded_engine_plan_and_padding(engine_case):
    """Five alignments of one bucket and one of another: at data 2 the plan
    repeats an index in each, and the padded batch sizes are multiples of
    the data axis."""
    _, outs = engine_case
    np.testing.assert_array_equal(outs[0]["2x1.plan"], [6, 2])
    np.testing.assert_array_equal(outs[0]["1x2.plan"], [5, 1])
    np.testing.assert_array_equal(outs[0]["2x1.bsz"], [2, 4, 8])
    np.testing.assert_array_equal(outs[0]["1x2.bsz"], [1, 4, 8])


# ---- the CLIs on two ranks ---------------------------------------------------

def _write_fasta(path, rng, n, l):
    with open(path, "w") as fh:
        for r in range(n):
            fh.write(f">s{r}\n{''.join(np.array(list(AMINO))[rng.integers(0, 20, l)])}\n")


# run_port's prelude up to its inputs: two threads, the first exp/erf/log1p/
# tanh calls made before the code under test (ROADMAP queue 3)
_WARM = _PRELUDE.split("IN = dict")[0]


def _module(name, args):
    """``python -m name args`` behind the warm-up prelude."""
    return [sys.executable, "-c", _WARM + f"import runpy\nsys.argv[0] = {name!r}\n"
            f"runpy.run_module({name!r}, run_name='__main__', alter_sys=True)\n"] + args


def _launch(args, world):
    with Rendezvous() as rdv:
        return [rdv.popen(_module(args[0], args[1:]), r, world, cwd=str(REPO), env=_RANK_ENV,
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for r in range(world)]


def _phy(path):
    lines = path.read_text().splitlines()
    return np.array([[float(v) for v in ln.split()[1:]] for ln in lines[1:]])


@pytest.fixture(scope="module")
def infer_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_cli")
    rng = np.random.default_rng(321)
    (root / "alns").mkdir()
    for k, (n, l) in enumerate([(9, 30), (12, 41), (7, 25)]):
        _write_fasta(root / "alns" / f"a{k}.fa", rng, n, l)
    one = root / "one"
    r = subprocess.run(_module("phyloformer_tpu_torch.infer.cli", [
                        str(CKPT), str(root / "alns"), "-o", str(one), "--device", "cpu"]),
                       cwd=str(REPO), env={**os.environ, **PORT_THREAD_ENV},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return root


def test_infer_cli_pair_mesh_matches_one_process(infer_dirs):
    """``pf-infer-torch --device cpu --distributed-init --mesh-pair 2`` as two
    processes: rank 0 writes the PHYLIP files of one process, within the
    engine's bar; rank 1 writes nothing."""
    out = infer_dirs / "pair"
    _wait_all(_launch(["phyloformer_tpu_torch.infer.cli", str(CKPT), str(infer_dirs / "alns"),
                       "-o", str(out), "--device", "cpu", "--distributed-init",
                       "--mesh-pair", "2", "--stats"], 2), 300)
    names = sorted(p.name for p in (infer_dirs / "one").iterdir())
    assert sorted(p.name for p in out.iterdir()) == names == ["a0.phy", "a1.phy", "a2.phy"]
    for name in names:
        got, want = _phy(out / name), _phy(infer_dirs / "one" / name)
        assert got.shape == want.shape and _rel(got, want) <= ENGINE_TOL, name


def test_infer_cli_multihost_partitions_the_files(infer_dirs):
    """``--multihost``: each rank takes its ``host_local_slice`` of the files
    and writes its own; together the two ranks write every file once, each
    as one process writes it."""
    procs = _launch(["phyloformer_tpu_torch.infer.cli", str(CKPT), str(infer_dirs / "alns"),
                     "-o", str(infer_dirs / "multi"), "--device", "cpu", "--distributed-init",
                     "--multihost", "--stats"], 2)
    outs = _wait_all(procs, 300)
    counts = [json.loads(out.strip().splitlines()[-1])["alignments"] for out, _ in outs]
    assert counts == [2, 1]
    for name in ("a0.phy", "a1.phy", "a2.phy"):
        got, want = _phy(infer_dirs / "multi" / name), _phy(infer_dirs / "one" / name)
        assert _rel(got, want) <= ENGINE_TOL, name


_TRAIN_HARNESS = """
import json, sys
from phyloformer_tpu_torch.train import cli, loop
fit = loop.fit
summaries = []
def capture(*a, **k):
    summaries.append(fit(*a, **k))
    return summaries[-1]
loop.fit = capture
rc = cli.main(sys.argv[1:])
print(json.dumps({"rc": rc, "loss": summaries[0]["last_train_loss"],
                  "steps": summaries[0]["steps"]}))
"""


def test_train_cli_sharded_matches_one_process(tmp_path):
    """``pf-train-torch --device cpu --distributed-init --mesh-pair 2
    --shard-pairs --use-pallas on`` for 2 steps on two ranks: both report
    the same loss, the one process's within ``LOSS_TOL``; rank 0 alone
    writes the metrics and exactly one checkpoint directory."""
    from test_torch_isolation import _tiny_corpus

    _tiny_corpus(tmp_path / "corpus", n=7)
    common = ["-t", str(tmp_path / "corpus" / "trees"), "-a", str(tmp_path / "corpus" / "alns"),
              "--device", "cpu", "--use-pallas", "on", "--nb-blocks", "2", "--batch-size", "2",
              "--max-steps", "2", "--log-every", "1", "--num-workers", "1", "--warmup-steps",
              "0", "--learning-rate", "1e-3", "--hard-loss-ceiling", "1e6"]
    single = subprocess.Popen([sys.executable, "-c", _WARM + _TRAIN_HARNESS] + common + [
        "-o", str(tmp_path / "one"), "-n", "run"], cwd=str(REPO),
        env={**os.environ, **PORT_THREAD_ENV}, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    with Rendezvous() as rdv:
        procs = [rdv.popen(
            [sys.executable, "-c", _WARM + _TRAIN_HARNESS] + common + [
                "-o", str(tmp_path / "sharded"), "-n", "run", "--distributed-init",
                "--mesh-pair", "2", "--shard-pairs"], r, 2, cwd=str(REPO), env=_RANK_ENV,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    ranks = [json.loads(out.strip().splitlines()[-1]) for out, _ in _wait_all(procs, 300)]
    one = json.loads(_wait_all([single], 300)[0][0].strip().splitlines()[-1])
    assert [x["rc"] for x in ranks] == [0, 0] and [x["steps"] for x in ranks] == [2, 2]
    assert ranks[0]["loss"] == ranks[1]["loss"]
    assert abs(ranks[0]["loss"] - one["loss"]) <= LOSS_TOL * abs(one["loss"]), (ranks, one)
    lines = (tmp_path / "sharded" / "run_metrics.jsonl").read_text().splitlines()
    losses = [rec["train_loss"] for rec in map(json.loads, lines) if "train_loss" in rec]
    one_losses = [rec["train_loss"] for rec in map(
        json.loads, (tmp_path / "one" / "run_metrics.jsonl").read_text().splitlines())
        if "train_loss" in rec]
    assert len(losses) == 2 and np.allclose(losses, one_losses, rtol=LOSS_TOL, atol=0)
    dirs = sorted(p.name for p in (tmp_path / "sharded").iterdir() if p.is_dir())
    assert dirs == ["checkpoints_run"], dirs
    assert sorted(p.name for p in (tmp_path / "sharded" / "checkpoints_run").iterdir()) == [
        "ckpt_2.pt"]


def test_serve_cli_on_two_ranks_answers_as_one_process(tmp_path):
    """``pf-serve-torch --device cpu --distributed-init --mesh-pair 2``:
    rank 0 listens, rank 1 follows; one POST is answered as one process
    answers it (within the engine's bar); SIGINT to rank 0 stops both."""
    fa = "".join(f">s{r}\n{''.join(np.array(list(AMINO))[row])}\n" for r, row in
                 enumerate(np.random.default_rng(331).integers(0, 20, (9, 35))))

    def ask(proc):
        line = ""
        while "listening on" not in line:
            line = proc.stderr.readline()
            assert line, "the server exited before listening"
        port = int(line.strip().rsplit(":", 1)[1])
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=fa.encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            return np.array(json.loads(r.read())["distances"])

    flags = [str(CKPT), "--device", "cpu", "--port", "0", "--host", "127.0.0.1",
             "--precision", "float32"]
    procs = _launch(["phyloformer_tpu_torch.serve.cli"] + flags
                    + ["--distributed-init", "--mesh-pair", "2"], 2)
    single = subprocess.Popen(_module("phyloformer_tpu_torch.serve.cli", flags),
                              cwd=str(REPO), env={**os.environ, **PORT_THREAD_ENV},
                              stderr=subprocess.PIPE, text=True)
    try:
        got, want = ask(procs[0]), ask(single)
        assert got.shape == want.shape == (9, 9)
        assert _rel(got, want) <= ENGINE_TOL
        for p in (procs[0], single):
            p.send_signal(signal.SIGINT)
        assert single.wait(timeout=60) == 0
        _wait_all(procs, 60)
    finally:
        for p in procs + [single]:
            if p.poll() is None:
                p.kill()
                p.wait()


_SERVE_FAILURES = """
import json, threading, urllib.error, urllib.request
from phyloformer_tpu_torch.serve.server import (
    InferenceServer, MeshLeader, MeshOutOfStep, follow)

class Planted:
    \"\"\"An engine whose k-th predict raises where fails[k].\"\"\"
    def __init__(self, fails):
        self.fails, self.calls = fails, 0
    def load_kernels(self):
        pass
    def predict(self, alns):
        k, self.calls = self.calls, self.calls + 1
        if self.fails[k]:
            raise RuntimeError(f"planted failure {k} on rank {RANK}")
        return [np.zeros(len(a.ids) * (len(a.ids) - 1) // 2) for a in alns]

mesh = make_mesh(1, 2)
# batch 0 fails on both ranks, batch 1 on neither, batch 2 on rank 1 alone
engine = Planted([[True, False, False], [True, False, True]][RANK])
res = {}
try:
    if RANK == 0:
        server = InferenceServer(MeshLeader(engine, mesh), {}, port=0)
        statuses = []
        def client():
            for _ in range(3):
                req = urllib.request.Request(f"http://127.0.0.1:{server.port}/predict",
                                             data=b">a\\nACD\\n>b\\nACE\\n>c\\nCCD\\n")
                try:
                    with urllib.request.urlopen(req, timeout=60) as r:
                        statuses.append(r.status)
                except urllib.error.HTTPError as e:
                    statuses.append(e.code)
        thread = threading.Thread(target=client)
        thread.start()
        res["statuses"] = statuses
        server.serve_forever()
    else:
        follow(engine, mesh)
    res["stopped"] = "returned"
except MeshOutOfStep as e:
    res["stopped"] = str(e)
if RANK == 0:
    thread.join()
res["calls"] = engine.calls
OUT["res"] = np.asarray(json.dumps(res))
"""


def test_serve_failure_on_one_rank_stops_every_rank(tmp_path):
    """The ranks agree on each micro-batch's failure: a batch that fails on
    both ranks is answered 500 and the mesh serves on (the next batch 200);
    one that fails on rank 1 alone is answered 500, then both ranks stop
    with ``MeshOutOfStep`` instead of leaving their collectives out of
    step."""
    outs = run_ranks(_SERVE_FAILURES, {}, tmp_path, world=2, timeout=120)
    res = [json.loads(str(o["res"])) for o in outs]
    assert res[0]["statuses"] == [500, 200, 500], res
    for r in res:
        assert r["calls"] == 3 and r["stopped"].startswith("1 of 2 ranks failed"), res


# ---- the harness's rendezvous, and the routes JAX cannot run ------------------

_ALL_REDUCE = """
import json, torch
from torch import distributed as dist
dist.init_process_group("gloo", init_method="env://")
t = torch.full((3,), float(dist.get_rank() + 1))
dist.all_reduce(t)
print(json.dumps({"rank": dist.get_rank(), "sum": t.tolist()}))
dist.destroy_process_group()
"""


def test_launch_comes_up_when_the_chosen_port_is_taken():
    """A port chosen as the old harness chose it (bound to port 0, its number
    read) is taken by another process before any rank binds it, as another
    test worker may take it.  A rank told to bind that port itself fails
    (EADDRINUSE: the race); two ranks launched through the harness's
    ``Rendezvous``, with that port already in their environment, come up
    and all-reduce, since the store binds and holds its own port."""
    with socket.socket() as squatter:
        squatter.bind(("127.0.0.1", 0))
        squatter.listen()
        taken = squatter.getsockname()[1]
        env = {**_RANK_ENV, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(taken)}
        old = subprocess.run([sys.executable, "-c", _ALL_REDUCE], cwd=str(REPO),
                             env={**env, "RANK": "0", "WORLD_SIZE": "1"},
                             capture_output=True, text=True, timeout=120)
        assert old.returncode != 0 and "EADDRINUSE" in old.stderr, old.stderr[-2000:]
        with Rendezvous() as rdv:
            assert rdv.port != taken
            procs = [rdv.popen([sys.executable, "-c", _ALL_REDUCE], r, 2, cwd=str(REPO),
                               env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                               text=True) for r in range(2)]
        outs = _wait_all(procs, 120)
    got = sorted(json.loads(out.strip().splitlines()[-1])["rank"] for out, _ in outs)
    assert got == [0, 1]
    for out, _ in outs:
        assert json.loads(out.strip().splitlines()[-1])["sum"] == [3.0, 3.0, 3.0]


# The three fused-forward routes at bf16 parameters, on 6 sequences: the
# two-kernel form at 40 sites, the L-tiled A1/A2 form at 1100 sites (both
# with the pipeline off) and the pair-sharded form (data 1 x pair 2).
_BF16_ROUTES = ("two_kernel", "l_tiled", "sharded")

_JAX_BF16 = f"""
import json
from phyloformer_tpu.data.fasta import Alignment
from phyloformer_tpu.infer.engine import (InferenceConfig, InferenceEngine,
                                          ShardedInferenceEngine)
from phyloformer_tpu.io.ckpt_import import load_pretrained
from phyloformer_tpu.parallel import make_mesh
params, cfg, _ = load_pretrained({str(CKPT)!r})
rng = np.random.default_rng(5)
def aln(l):
    return Alignment(rng.integers(0, 20, (6, l)).astype(np.int8), [f"s{{i}}" for i in range(6)])
icfg = InferenceConfig(precision="bfloat16", use_pallas=True, use_pipeline=False)
routes = {{
    "two_kernel": lambda: InferenceEngine(params, cfg, icfg).predict([aln(40)]),
    "l_tiled": lambda: InferenceEngine(params, cfg, icfg).predict([aln(1100)]),
    "sharded": lambda: ShardedInferenceEngine(
        params, cfg, make_mesh(data=1, pair=2, devices=jax.devices()[:2]),
        InferenceConfig(precision="bfloat16", use_pallas=True)).predict([aln(40)]),
}}
res = {{}}
for name, run in routes.items():
    try:
        run()
        res[name] = "ran"
    except ValueError as e:
        res[name] = str(e)
OUT["res"] = np.asarray(json.dumps(res))
"""

_PORT_BF16 = f"""
import json
from phyloformer_tpu_torch.data.fasta import Alignment
from phyloformer_tpu_torch.infer.engine import (InferenceConfig, InferenceEngine,
                                                ShardedInferenceEngine)
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
params, cfg, _ = load_pretrained({str(CKPT)!r})
rng = np.random.default_rng(5)
def aln(l):
    return Alignment(rng.integers(0, 20, (6, l)).astype(np.int8), [f"s{{i}}" for i in range(6)])
icfg = InferenceConfig(precision="bfloat16", use_pipeline=False)
routes = {{
    "two_kernel": lambda: InferenceEngine(params, cfg, icfg, device="cpu").predict([aln(40)]),
    "l_tiled": lambda: InferenceEngine(params, cfg, icfg, device="cpu").predict([aln(1100)]),
    "sharded": lambda: ShardedInferenceEngine(
        params, cfg, make_mesh(1, 2), InferenceConfig(precision="bfloat16"),
        device="cpu").predict([aln(40)]),
}}
res = {{}}
for name, run in routes.items():
    try:
        run()
        res[name] = "ran"
    except ValueError as e:
        res[name] = str(e)
OUT["res"] = np.asarray(json.dumps(res))
"""


def test_bf16_fused_forward_fails_in_jax_and_is_refused_here(tmp_path):
    """JAX's own fused forward raises on bf16 parameters on each of the three
    routes (kernel A and A2 store their fp32 x1 into a bf16 output,
    ``axial_block.py:276`` and ``:391``; Pallas checks the store when it
    traces the kernel, so a TPU raises too), and the port refuses the same
    three, naming that failure.  A JAX package that runs these routes makes
    this test fail: its bf16 forms can then be ported against it."""
    jax_res = start_jax(_JAX_BF16, {}, tmp_path, "bf16")
    port = [json.loads(str(o["res"])) for o in run_ranks(_PORT_BF16, {}, tmp_path / "port",
                                                          world=2, timeout=180)]
    want = json.loads(str(jax_res()["res"]))
    assert sorted(want) == sorted(_BF16_ROUTES), want
    for route in _BF16_ROUTES:
        assert "Invalid dtype for `swap`" in want[route], (route, want[route])
        assert "Ref dtype: bfloat16. Value dtype: float32" in want[route], (route, want[route])
        for rank in port:
            msg = rank[route]
            assert msg.startswith("precision='bfloat16' on "), (route, msg)
            assert "the JAX package's own fused forward raises" in msg, (route, msg)
            assert "axial_block.py:276" in msg, (route, msg)


# ---- one process -------------------------------------------------------------

def _run(code: str) -> dict:
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=str(REPO), timeout=300, env={**os.environ, **PORT_THREAD_ENV})
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_make_mesh_errors_and_host_slices():
    """Without a process group the world is one rank: a mesh of two raises
    JAX's size errors (with how to start the ranks), 1 x 1 runs; the host
    slices of 5 files over 2 and 3 ranks partition them."""
    out = _run("""
import json
from phyloformer_tpu_torch.parallel.mesh import host_local_slice, make_mesh
msgs = []
for kw in ({"pair": 2}, {"data": 2}, {"data": 2, "pair": 2}):
    try:
        make_mesh(**kw)
        msgs.append("ran")
    except ValueError as e:
        msgs.append(str(e))
m = make_mesh(data=1)
print(json.dumps({"msgs": msgs, "shape": m.shape, "world": m.world,
                  "slices": [[host_local_slice(5, r, n) for r in range(n)] for n in (2, 3)]}))
""")
    assert out["msgs"][0].startswith("1 devices not divisible by pair=2"), out
    assert out["msgs"][1].startswith("mesh 2x1 != 1 devices"), out
    assert out["msgs"][2].startswith("mesh 2x2 != 1 devices"), out
    assert all("--distributed-init" in m for m in out["msgs"]), out
    assert out["shape"] == {"data": 1, "pair": 1} and out["world"] == 1
    assert out["slices"] == [[[0, 3], [3, 5]], [[0, 2], [2, 4], [4, 5]]]


def test_route_follows_jax():
    """The trainer's routes, JAX's without its escape hatch: the sharded
    routes where ``shard_pairs`` meets a pair axis, else the single-card
    ones on each rank's rows (a pair axis without ``shard_pairs``
    included); ``use_pallas`` picks the fused kernels.  JAX's
    ``PF_PALLAS_MAX_SITES`` and ``PF_PALLAS_TRAIN_MAX_SITES`` are not read:
    set, they leave the routes and the fused forward as they are."""
    out = _run("""
import json, os
import torch
from phyloformer_tpu_torch.models import phyloformer as pf
from phyloformer_tpu_torch.models.params import PhyloformerConfig, init_params
from phyloformer_tpu_torch.parallel.mesh import Mesh, local_mesh
from phyloformer_tpu_torch.train.trainer import TrainConfig, route
os.environ["PF_PALLAS_MAX_SITES"] = os.environ["PF_PALLAS_TRAIN_MAX_SITES"] = "8"
cfg = PhyloformerConfig(n_blocks=1, embed_dim=32)
params = init_params(cfg, torch.Generator().manual_seed(0))
codes = torch.randint(0, 20, (1, 5, 40), generator=torch.Generator().manual_seed(1))
calls = []
fused_block = pf.fused_axial_block
pf.fused_axial_block = lambda *a, **k: (calls.append("fused"), fused_block(*a, **k))[1]
pf.forward_fused(params, codes, cfg)
meshes = {"one": local_mesh(), "pair": Mesh({"data": 1, "pair": 2}, 0),
          "data": Mesh({"data": 2, "pair": 1}, 0)}
res = {"fused_called": calls == ["fused"]}
for name, mesh in meshes.items():
    res[name] = [route(TrainConfig(use_pallas=u, shard_pairs=s), mesh)
                 for u in (True, False) for s in (True, False)]
print(json.dumps(res))
""")
    assert out["fused_called"], out
    # (use_pallas, shard_pairs) = (T, T), (T, F), (F, T), (F, F)
    single = ["fused", "fused", "eager", "eager"]
    assert out["one"] == single and out["data"] == single, out
    assert out["pair"] == ["sharded_fused", "fused", "sharded_eager", "eager"], out
