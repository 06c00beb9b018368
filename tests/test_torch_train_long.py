"""Fused training above the resident site threshold, packed corpora and the
training profiler: the port against the JAX package, on the CPU.

- Kernels: the port's ``kernel_e1_plain`` / ``kernel_e2_plain`` against the
  TPU kernels ``_kernel_e1`` / ``_kernel_e2`` (``pl.pallas_call(interpret=
  True)``, HIGHEST products) at the JAX package's own L-tiled shape: 2 × 26
  pairs (23 real) × 150 sites (119 real) in 48-site tiles.  Row sums and gx
  1e-5, weight gradients 5.3e-5, relative to max(1, max|ref|).
- Blocks: ``FusedAxialBlock`` against JAX ``fused_axial_block_ad`` under
  ``value_and_grad``, forced onto the L-tiled forward and backward by
  lowering both packages' thresholds, and unforced at 1040 sites: loss rel
  1e-5, gx 1e-4, weight gradients 2e-5 scaled (the bars of
  ``test_torch_train.test_block_gradients_match_jax``).
- Steps: three fused train steps of a 2-block d = 32 model on an L-tiled
  bucket against JAX's (loss rel 1e-5, parameters atol 2e-4).
- Packed data: shards written by each package are the same bytes and give
  the same batches in the same order from either package's loader;
  ``pf-preprocess-torch`` then ``pf-train-torch --packed-data --device cpu``.
- ``--profile`` writes a trace and exits; ``--debug-nans`` raises on a NaN.

The port runs in subprocesses (:func:`test_torch_model.run_port`).
"""

import functools
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from test_torch_model import flatten, run_port
from test_torch_train import LEAVES, _layer, _rel_err, _toy_batch, _write_corpus

EPS = 1e-5
D, H = 64, 4
# the JAX package's L-tiled backward test (test_pallas_kernels.py:192-239)
B, P, L, REAL_P, REAL_L, TILE = 2, 26, 150, 23, 119, 48


def _ltiled_thresholds(mp, sites):
    """Lower the JAX package's resident-site thresholds (forward and
    backward) and its backward site tile to ``sites``."""
    import phyloformer_tpu.ops.pallas.axial_block as ab
    import phyloformer_tpu.ops.pallas.axial_block_bwd as jb

    mp.setattr(ab, "_RESIDENT_SITES_MAX_HI", sites)
    mp.setattr(jb, "_BWD_RESIDENT_SITES_MAX", sites)
    mp.setattr(jb, "_BWD_LTILE_MAX", sites)


def _masked_inputs(seed, b, p, l, real_p, real_l):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, p, l, D)).astype(np.float32)
    site_mask = np.repeat(np.arange(l)[None] < real_l, b, 0)
    pair_mask = np.repeat(np.arange(p)[None] < real_p, b, 0)
    g = rng.normal(size=(b, p, l, D)).astype(np.float32)
    g = g * site_mask[:, None, :, None] * pair_mask[:, :, None, None]  # a masked loss
    return x, site_mask, pair_mask, g


# ---- kernels E1 and E2 ---------------------------------------------------------

E2_NAMES = ["gx", "row_norm/scale", "row_norm/bias", "row_attn/wq", "row_attn/bq",
            "row_attn/wk", "row_attn/bk", "row_attn/wv", "row_attn/bv", "row_attn/wo",
            "row_attn/bo"]


def _jax_e1_e2(layer, x, g1, site_mask):
    """_kernel_e1 then _kernel_e2 on the site axis padded to a multiple of
    TILE, as the JAX host function runs them: grid (B, 1 pair tile, site
    tiles)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from phyloformer_tpu.ops.pallas import axial_block_bwd as jb

    prec = jax.lax.Precision.HIGHEST
    f32 = jnp.float32
    lp = -(-L // TILE) * TILE
    pad = ((0, 0), (0, 0), (0, lp - L), (0, 0))
    xp, gp = jnp.pad(jnp.asarray(x), pad), jnp.pad(jnp.asarray(g1), pad)
    smp = jnp.pad(jnp.asarray(site_mask, f32), ((0, 0), (0, lp - L)))
    la, rn = layer["row_attn"], layer["row_norm"]
    full = pl.BlockSpec(memory_space=pltpu.VMEM)
    tile = pl.BlockSpec((1, P, TILE, D), lambda b, p, li: (b, p, li, 0))
    sm_s = pl.BlockSpec((1, TILE, 1), lambda b, p, li: (b, li, 0))
    rows = pl.BlockSpec((1, P, 1, 4 * D), lambda b, p, li: (b, p, 0, 0))
    grid = (B, 1, lp // TILE)

    e1_params = [rn["scale"], rn["bias"], la["wq"], la["bq"], la["wk"], la["bk"], la["wv"],
                 la["bv"], la["wo"].T]
    rowsums = pl.pallas_call(
        functools.partial(jb._kernel_e1, n_heads=H, eps=EPS, prec=prec, interpret=True),
        grid=grid, in_specs=[tile, tile, sm_s] + [full] * len(e1_params), out_specs=rows,
        out_shape=jax.ShapeDtypeStruct((B, P, 1, 4 * D), f32), interpret=True,
    )(xp, gp, smp[:, :, None], *e1_params)

    e_params = [rn["scale"], rn["bias"], la["wq"], la["bq"], la["wq"].T, la["wk"], la["bk"],
                la["wk"].T, la["wv"], la["bv"], la["wv"].T, la["wo"].T]
    shapes = [(B, P, lp, D), (1, D), (1, D), (D, H), (1, H), (D, H), (1, H), (D, D), (1, D),
              (D, D), (1, D)]
    outs = pl.pallas_call(
        functools.partial(jb._kernel_e2, n_heads=H, eps=EPS, prec=prec, interpret=True),
        grid=grid,
        in_specs=[tile, tile, rows, sm_s, pl.BlockSpec(memory_space=pltpu.SMEM)]
        + [full] * len(e_params),
        out_specs=(tile,) + tuple(pl.BlockSpec(s, lambda *_, n=len(s): (0,) * n)
                                  for s in shapes[1:]),
        out_shape=tuple(jax.ShapeDtypeStruct(s, f32) for s in shapes), interpret=True,
    )(xp, gp, rowsums, smp[:, :, None], jnp.sum(smp, axis=1)[:, None], *e_params)
    want = {"e1.rowsums": np.asarray(rowsums)[:, :, 0]}
    for name, v in zip(E2_NAMES, outs):
        v = np.asarray(v)
        want["e2." + name] = v[:, :, :L] if name == "gx" else (v[0] if v.shape[0] == 1 else v)
    return want


@pytest.fixture(scope="module")
def e12_case(tmp_path_factory):
    layer = _layer(19)
    x, site_mask, pair_mask, g1 = _masked_inputs(21, B, P, L, REAL_P, REAL_L)
    with jax.default_matmul_precision("float32"):
        want = _jax_e1_e2(layer, x, g1, site_mask)
    inputs = {"x": x, "g1": g1, "site_mask": site_mask, "rowsums": want["e1.rowsums"]}
    inputs.update(flatten(layer, "layer"))
    got = run_port("""
from phyloformer_tpu_torch.ops.kernels import axial_block_bwd as bw
w = bw.BwdWeights.of(tree("layer"))
sm = t("site_mask", torch.float32)
OUT["e1.rowsums"] = bw.kernel_e1_plain(t("x"), t("g1"), sm, w.e, 1e-5)
# E2 on the reference's row sums, so each comparison is one kernel
gx, de = bw.kernel_e2_plain(t("x"), t("g1"), t("rowsums"), sm, w.e, 1e-5)
OUT["e2.gx"] = gx
for sub, leaves in bw.unpack_grads("kernel_e", de, 64, 4, {}).items():
    for leaf, v in leaves.items():
        OUT[f"e2.{sub}/{leaf}"] = v
""", inputs, tmp_path_factory.mktemp("port_e12"))
    return got, want


@pytest.mark.parametrize("name", ["e1.rowsums"] + ["e2." + n for n in E2_NAMES])
def test_e1_e2_match_jax(name, e12_case):
    """e1.rowsums = _kernel_e1's (B, P, 4d) sums; e2.* = _kernel_e2 on
    them: gx and every row weight gradient."""
    got, want = e12_case
    g, r = got[name], want[name]
    assert g.shape == r.shape, (g.shape, r.shape)
    assert np.isfinite(g).all()
    tol = 1e-5 if name in ("e1.rowsums", "e2.gx") else 5.3e-5
    err = _rel_err(g, r)
    assert err <= tol, err


# ---- one block under autograd, L-tiled ----------------------------------------------

# name: (batch, pairs, sites, real pairs, real sites, lowered threshold or None)
BLOCK_CASES = {"forced": (2, 21, 134, 18, 111, 48), "unforced": (1, 3, 1040, 3, 1040, None)}


@pytest.fixture(scope="module")
def long_block_case(tmp_path_factory):
    from phyloformer_tpu.models.params import PhyloformerConfig
    from phyloformer_tpu.ops.pallas.autodiff import fused_axial_block_ad

    cfg = PhyloformerConfig(n_blocks=1, n_heads=H, embed_dim=D, matmul_precision="float32")
    layer = _layer(23)
    inputs, want = flatten(layer, "layer"), {}
    for case, (b, p, l, rp, rl, lowered) in BLOCK_CASES.items():
        x, site_mask, pair_mask, g = _masked_inputs(25, b, p, l, rp, rl)
        sm, pm, gj = jnp.asarray(site_mask), jnp.asarray(pair_mask), jnp.asarray(g)

        def loss(x_, layer_):
            return jnp.sum(fused_axial_block_ad(x_, layer_, sm, pm, cfg, True) * gj)

        with pytest.MonkeyPatch.context() as mp:
            if lowered:
                _ltiled_thresholds(mp, lowered)
            with jax.default_matmul_precision("float32"):
                v, (gx, gl) = jax.value_and_grad(loss, argnums=(0, 1))(jnp.asarray(x), layer)
        want[f"{case}.loss"] = np.asarray(v)
        want[f"{case}.gx"] = np.asarray(gx)
        want.update({f"{case}.{a}/{k}": np.asarray(gl[a][k]) for a, k in LEAVES})
        inputs.update({f"{case}.x": x, f"{case}.site_mask": site_mask,
                       f"{case}.pair_mask": pair_mask, f"{case}.g": g})
    got = run_port(f"""
import collections, json
from phyloformer_tpu_torch.models.params import PhyloformerConfig
from phyloformer_tpu_torch.ops.kernels import axial_block, axial_block_bwd as bw, fused
from phyloformer_tpu_torch.ops.kernels.autodiff import LAYER_LEAVES, fused_axial_block_ad
calls = collections.Counter()
def counted(mod, name):
    fn = getattr(mod, name)
    def wrapper(*a, **k):
        calls[name] += 1
        return fn(*a, **k)
    setattr(mod, name, wrapper)
for mod, name in ((fused, "kernel_a"), (fused, "kernel_a1"), (bw, "kernel_e"),
                  (bw, "kernel_e1"), (bw, "kernel_e2")):
    counted(mod, name)
cfg = PhyloformerConfig(n_blocks=1)
for case, (b, p, l, rp, rl, lowered) in {BLOCK_CASES!r}.items():
    axial_block.RESIDENT_SITES_MAX = lowered or 1024
    calls.clear()
    layer = tree("layer")
    for a, k in LAYER_LEAVES:
        layer[a][k].requires_grad_(True)
    x = t(case + ".x").requires_grad_(True)
    out = fused_axial_block_ad(x, layer, t(case + ".site_mask", torch.float32),
                               t(case + ".pair_mask", torch.float32), cfg)
    loss = (out * t(case + ".g")).sum()
    loss.backward()
    OUT[case + ".loss"] = loss
    OUT[case + ".gx"] = x.grad
    for a, k in LAYER_LEAVES:
        OUT[f"{{case}}.{{a}}/{{k}}"] = layer[a][k].grad
    OUT[case + ".calls"] = np.asarray(json.dumps(dict(calls)))
""", inputs, tmp_path_factory.mktemp("port_long_block"))
    return got, want


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_ltiled_block_gradients_match_jax(case, long_block_case):
    """The L-tiled fused block (A1, A2, B forward; C, D, E1, E2 backward)
    under autograd against JAX's: forced at 134 sites, unforced at 1040."""
    got, want = long_block_case
    calls = json.loads(str(got[case + ".calls"]))
    assert calls == {"kernel_a1": 1, "kernel_e1": 1, "kernel_e2": 1}, calls
    assert abs(float(got[f"{case}.loss"]) - float(want[f"{case}.loss"])) <= (
        1e-5 * abs(float(want[f"{case}.loss"])))
    np.testing.assert_allclose(got[f"{case}.gx"], want[f"{case}.gx"], atol=1e-4, rtol=1e-4)
    for a, b in LEAVES:
        g, r = got[f"{case}.{a}/{b}"], want[f"{case}.{a}/{b}"]
        assert g.shape == r.shape, (a, b)
        scale = max(np.abs(r).max(), 1.0)
        np.testing.assert_allclose(g / scale, r / scale, atol=2e-5, err_msg=f"{a}/{b}")


# ---- train steps on an L-tiled bucket -----------------------------------------------

STEP_SITES, STEP_THRESHOLD = 40, 16


@pytest.fixture(scope="module")
def long_step_case(tmp_path_factory):
    from phyloformer_tpu.models.params import PhyloformerConfig, init_params
    from phyloformer_tpu.train import TrainConfig, create_train_state, make_train_step

    cfg = PhyloformerConfig(n_blocks=2, n_heads=4, embed_dim=32, matmul_precision="float32")
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0.0, 0.05, a.shape)).astype(np.float32),
        init_params(jax.random.PRNGKey(6), cfg))
    # keep every head off φ's exponential branch (see test_torch_train.step_case)
    for ly in params["layers"]:
        for attn in ("row_attn", "col_attn"):
            for k in ("bq", "bk"):
                ly[attn][k] = ly[attn][k] + np.float32(2.0)
    batches = [_toy_batch(2, 7, STEP_SITES, s) for s in (11, 12, 11)]
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=50, use_pallas=True)
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        _ltiled_thresholds(mp, STEP_THRESHOLD)
        state, tx = create_train_state(cfg, tcfg, params=jax.tree_util.tree_map(
            jnp.asarray, params))
        step = make_train_step(cfg, tcfg, tx)
        for i, batch in enumerate(batches):
            state, logs = step(state, batch, jax.random.PRNGKey(0))
            for k in ("train_loss", "grad_norm"):
                want[f"{i}.{k}"] = np.asarray(logs[k])
    want.update(flatten(jax.tree_util.tree_map(np.asarray, state["params"]), "params"))
    inputs = {f"{i}.{n}": v for i, b in enumerate(batches) for n, v in b.items()}
    inputs.update(flatten(params, "params"))
    got = run_port(f"""
from phyloformer_tpu_torch.models.params import PhyloformerConfig
from phyloformer_tpu_torch.ops.kernels import axial_block
from phyloformer_tpu_torch.train.trainer import TrainConfig, create_train_state, make_train_step
axial_block.RESIDENT_SITES_MAX = {STEP_THRESHOLD}
cfg = PhyloformerConfig(n_blocks=2, n_heads=4, embed_dim=32)
tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=50, use_pallas=True)
state, tx = create_train_state(cfg, tcfg, params=tree("params"), device="cpu")
step = make_train_step(cfg, tcfg, tx)
for i in range(3):
    batch = {{n: IN[f"{{i}}.{{n}}"] for n in ("codes", "dists", "site_mask", "seq_mask")}}
    state, logs = step(state, batch)
    for k in ("train_loss", "grad_norm"):
        OUT[f"{{i}}.{{k}}"] = np.asarray(float(logs[k]))
def rec(prefix, node):
    if isinstance(node, dict):
        for k, v in node.items():
            rec(prefix + "/" + k, v)
    elif isinstance(node, list):
        for i, v in enumerate(node):
            rec(prefix + "/" + str(i), v)
    else:
        OUT[prefix] = node
rec("params", state["params"])
""", inputs, tmp_path_factory.mktemp("port_long_steps"))
    return got, want


def test_ltiled_train_steps_match_jax(long_step_case):
    got, want = long_step_case
    for i in range(3):
        for k in ("train_loss", "grad_norm"):
            v, ref = float(got[f"{i}.{k}"]), float(want[f"{i}.{k}"])
            assert np.isfinite(v) and abs(v - ref) <= 1e-5 * abs(ref), (i, k, v, ref)
    keys = [k for k in want if k.startswith("params/")]
    assert len(keys) == 2 * 26 + 4
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], atol=2e-4, err_msg=k)


# ---- packed corpora, the preprocess CLI, --profile and --debug-nans ------------------

@pytest.fixture(scope="module")
def packed_case(tmp_path_factory):
    from phyloformer_tpu.train.data import LoaderConfig, make_pairs
    from phyloformer_tpu.train.packed import PackedBucketedLoader, PackedDataset, preprocess

    root = tmp_path_factory.mktemp("packed")
    corpus = root / "corpus"
    _write_corpus(corpus, 31, [(6, 30), (5, 26), (7, 33), (6, 140), (4, 20), (6, 31), (5, 29),
                               (6, 150), (7, 27), (5, 25), (12, 40)])
    preprocess(make_pairs(corpus / "trees", corpus / "alns"), root / "jax", shard_size=4)
    got = run_port(f"""
import contextlib, io, json
from pathlib import Path
from phyloformer_tpu_torch.train import cli, cli_preprocess
from phyloformer_tpu_torch.train.data import LoaderConfig
from phyloformer_tpu_torch.train.packed import PackedBucketedLoader, PackedDataset
root = Path({str(root)!r})
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    OUT["preprocess.rc"] = cli_preprocess.main(["-t", str(root / "corpus" / "trees"), "-a",
                                                str(root / "corpus" / "alns"), "-o",
                                                str(root / "port"), "--shard-size", "4"])
OUT["preprocess.stdout"] = buf.getvalue()
for name in ("jax", "port"):
    loader = PackedBucketedLoader(PackedDataset(root / name), LoaderConfig(batch_size=2, seed=3))
    for epoch in range(2):
        for i, batch in enumerate(loader):
            for k, v in batch.items():
                OUT[f"{{name}}.{{epoch}}.{{i}}.{{k}}"] = v
common = ["--packed-data", str(root / "port"), "--device", "cpu", "--batch-size", "2",
          "--nb-blocks", "2", "--loss", "mre", "--warmup-steps", "1", "--log-every", "1",
          "--check-val-every", "2", "--hard-loss-ceiling", "1e6", "-o", str(root / "out"),
          "-n", "run"]
for name, extra in (("train", ["--max-steps", "2", "--use-pallas", "on"]),
                    ("profile", ["--profile"])):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        OUT[name + ".rc"] = cli.main(common + extra)
    OUT[name + ".stdout"] = buf.getvalue()
""", {}, root / "port_run")
    want = {}
    for name in ("jax", "port"):
        loader = PackedBucketedLoader(PackedDataset(root / name), LoaderConfig(batch_size=2,
                                                                               seed=3))
        for epoch in range(2):
            for i, batch in enumerate(loader):
                want.update({f"{name}.{epoch}.{i}.{k}": v for k, v in batch.items()})
    return root, got, want


def test_packed_shards_are_the_same_bytes(packed_case):
    root, got, _ = packed_case
    assert int(got["preprocess.rc"]) == 0
    assert json.loads(str(got["preprocess.stdout"]).strip().splitlines()[-1])["examples"] == 11
    files = sorted(p.name for p in (root / "jax").iterdir())
    assert files == sorted(p.name for p in (root / "port").iterdir())
    assert len(files) == 1 + 3 * 3, files  # the manifest and three shards of 4, 4, 3
    for name in files:
        assert (root / "jax" / name).read_bytes() == (root / "port" / name).read_bytes(), name


def test_packed_batches_match_across_packages(packed_case):
    """Each package's loader over each package's shards: the same batches
    in the same order, two epochs."""
    _, got, want = packed_case
    keys = sorted(want)
    assert keys == sorted(k for k in got if k.startswith(("jax.", "port.")))
    assert len([k for k in keys if k.startswith("jax.0.") and k.endswith(".codes")]) >= 6
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        other = ("port." if k.startswith("jax.") else "jax.") + k.split(".", 1)[1]
        np.testing.assert_array_equal(got[k], want[other], err_msg=k)


def test_train_cli_packed_data_and_profile(packed_case):
    """pf-train-torch --packed-data --device cpu for 2 fused-path steps,
    then --profile: 10 traced steps, a Chrome trace, and an exit."""
    root, got, _ = packed_case
    assert int(got["train.rc"]) == 0
    out = str(got["train.stdout"])
    assert "packed train examples: 10, val examples: 1" in out, out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["steps"] == 2 and summary["use_pallas"] is True, summary
    assert summary["best_val_loss"] is not None and np.isfinite(summary["best_val_loss"])
    assert sorted(p.name for p in (root / "out" / "checkpoints_run").iterdir()) == ["ckpt_2.pt"]
    assert int(got["profile.rc"]) == 0
    prof = json.loads(str(got["profile.stdout"]).strip().splitlines()[-1])
    assert prof == {"profile_dir": str(root / "out" / "profile"), "steps": 10}, prof
    traces = list((root / "out" / "profile").glob("*.pt.trace.json"))
    assert len(traces) == 1, traces
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("kernel_" in str(e.get("name", "")) or "aten::" in str(e.get("name", ""))
               for e in events)


def test_debug_nans_raises_on_a_nan(packed_case, tmp_path):
    """--debug-nans: a NaN weight makes the first step raise
    FloatingPointError; without the flag the run stops on the non-finite
    loss instead.  check_finite also sees a NaN in a gradient alone."""
    root, _, _ = packed_case
    got = run_port(f"""
import contextlib, io, json
import torch
from phyloformer_tpu_torch.io.checkpoint import save_params_npz
from phyloformer_tpu_torch.models.params import PhyloformerConfig, init_params
from phyloformer_tpu_torch.train import cli
from phyloformer_tpu_torch.train.profiling import check_finite, enable_nan_checks
params = init_params(PhyloformerConfig(n_blocks=2), torch.Generator().manual_seed(0))
params["layers"][1]["ffn"]["w1"][3, 5] = float("nan")
save_params_npz({str(tmp_path / "nan.npz")!r}, params)
common = ["--packed-data", {str(root / "port")!r}, "--device", "cpu", "--batch-size", "2",
          "--nb-blocks", "2", "--base-model", {str(tmp_path / "nan.npz")!r}, "--max-steps", "2",
          "-o", {str(tmp_path / "out")!r}, "-n", "nan"]
res = {{}}
for name, extra in (("flag", ["--debug-nans"]), ("no_flag", [])):
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            res[name] = cli.main(common + extra)
    except FloatingPointError as e:
        res[name] = "FloatingPointError: " + str(e)
    res[name + ".stdout"] = buf.getvalue()
    enable_nan_checks(False)
try:
    check_finite(torch.tensor(1.0), [torch.zeros(3), torch.tensor([0.0, float("nan")])])
    res["grad"] = "passed"
except FloatingPointError as e:
    res["grad"] = "FloatingPointError: " + str(e)
OUT["res"] = np.asarray(json.dumps(res))
""", {}, tmp_path / "port")
    res = json.loads(str(got["res"]))
    assert res["flag"].startswith("FloatingPointError: non-finite loss"), res
    assert res["no_flag"] == 0, res
    assert "divergence stop: train_loss=nan" in res["no_flag.stdout"], res
    assert res["grad"].startswith("FloatingPointError: non-finite gradients in 1 of 2"), res
