"""The port's fused forward (two-kernel and L-tiled) against the JAX
package's, on the CPU.

- Passes: the port's plain ``row_sums`` / ``row_finalize_col_stats`` /
  ``body_b`` against the TPU kernels ``_kernel_a1`` / ``_kernel_a2`` /
  ``_kernel_b`` (interpret mode, HIGHEST products), each on the reference's
  own inputs; and the port's ``_fused_block_ltiled_impl``,
  ``fused_axial_block_res`` and ``fused_kernel_a`` against JAX's, at the JAX
  package's own ragged shape (2 × 30 pairs × 552 sites, 21 real pairs, 495
  real sites).  Tolerance 1e-5 relative to max(1, max|ref|) on the real
  region: single kernels, fp32 sums taken in another order.
- Forward: the port's ``forward_fused`` against JAX ``forward_fused`` with
  the real ``pf_mre_r5`` weights, resident and with the site threshold
  lowered to 64 on both sides (L-tiled), 5e-5 max-abs on real pairs.
- Engine: at the real threshold (a (10, 1280) bucket) and with
  ``use_pipeline=False`` at L ≤ 1024, against the JAX engine on its fused
  path (``use_pallas=True``, interpret mode), 5e-5; and the CLI on the long
  alignments, whose 10-decimal ``.phy`` values are held to 1e-4.

The port runs in a subprocess (:func:`test_torch_model.run_port`).
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from test_torch_engine import _write_fasta
from test_torch_model import CKPT, flatten, random_batch, random_params, real_pair_mask, run_port

EPS = 1e-5
N_HEADS = 4
B, P, L, D = 2, 30, 2 * 256 + 40, 64  # three 256-site tiles on the TPU, the last ragged
REAL_P, REAL_L = 21, L - 57


def _rel_err(got, want):
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _real(name, a):
    """The real region: pairs < REAL_P and sites < REAL_L of activations,
    sites < REAL_L of column stats, all of the per-pair row sums."""
    if name.endswith("stats") and name != "rowstats":
        return a[:, :REAL_L]
    if a.ndim == 4:
        return a[:, :REAL_P, :REAL_L]
    return a


def _jax_a1_a2(x, layer, site_mask, pair_mask):
    """The TPU kernels A1 and A2 alone, one grid step per batch element."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from phyloformer_tpu.ops.pallas import axial_block as jab

    prec = jax.lax.Precision.HIGHEST
    la, ca, rn, cn = layer["row_attn"], layer["col_attn"], layer["row_norm"], layer["col_norm"]
    sm3 = jnp.asarray(site_mask, jnp.float32)[:, :, None]
    pm4 = jnp.asarray(pair_mask, jnp.float32)[:, :, None, None]
    full = pl.BlockSpec(memory_space=pltpu.VMEM)
    tile = pl.BlockSpec((1, P, L, D), lambda b, i, j: (b, 0, 0, 0))
    rows = pl.BlockSpec((1, P, 3 * D), lambda b, i, j: (b, 0, 0))
    smask = pl.BlockSpec((1, L, 1), lambda b, i, j: (b, 0, 0))
    a1 = [rn["scale"], rn["bias"], la["wq"], la["bq"], la["wk"], la["bk"], la["wv"], la["bv"]]
    rowstats = pl.pallas_call(
        functools.partial(jab._kernel_a1, n_heads=N_HEADS, eps=EPS, prec=prec, interpret=True),
        grid=(B, 1, 1), in_specs=[tile, smask] + [full] * len(a1), out_specs=rows,
        out_shape=jax.ShapeDtypeStruct((B, P, 3 * D), jnp.float32), interpret=True,
    )(x, sm3, *a1)
    a2 = [rn["scale"], rn["bias"], la["wq"], la["bq"], la["wo"], la["bo"], cn["scale"],
          cn["bias"], ca["wq"], ca["bq"], ca["wk"], ca["bk"], ca["wv"], ca["bv"]]
    x1, stats = pl.pallas_call(
        functools.partial(jab._kernel_a2, n_heads=N_HEADS, eps=EPS, prec=prec, interpret=True),
        grid=(B, 1, 1),
        in_specs=[tile, rows, smask, pl.BlockSpec((1, P, 1, 1), lambda b, i, j: (b, 0, 0, 0)),
                  pl.BlockSpec(memory_space=pltpu.SMEM)] + [full] * len(a2),
        out_specs=(tile, pl.BlockSpec((1, L, 3 * D), lambda b, i, j: (b, 0, 0))),
        out_shape=(jax.ShapeDtypeStruct((B, P, L, D), jnp.float32),
                   jax.ShapeDtypeStruct((B, L, 3 * D), jnp.float32)),
        interpret=True,
    )(x, rowstats, sm3, pm4, jnp.sum(sm3, axis=1), *a2)
    return rowstats, x1, stats


@pytest.fixture(scope="module")
def block_case(tmp_path_factory):
    from phyloformer_tpu.ops.pallas import axial_block as jab

    params, _ = random_params(81, 1)
    layer = params["layers"][0]
    rng = np.random.default_rng(82)
    x = rng.normal(0.0, 1.0, (B, P, L, D)).astype(np.float32)
    site_mask = np.repeat(np.arange(L)[None] < REAL_L, B, 0)
    pair_mask = np.repeat(np.arange(P)[None] < REAL_P, B, 0)

    want = {}
    xj, smj, pmj = jnp.asarray(x), jnp.asarray(site_mask), jnp.asarray(pair_mask)
    with jax.default_matmul_precision("float32"):
        rowstats, a2_x1, a2_stats = _jax_a1_a2(xj, layer, site_mask, pair_mask)
        lt = jab._fused_block_ltiled_impl(xj, layer, smj, pmj, N_HEADS, EPS, True,
                                          jax.lax.Precision.HIGHEST)
        res = jab.fused_axial_block_res(xj, layer, smj, pmj, N_HEADS, EPS, True)
        ka = jab.fused_kernel_a(xj, layer, smj, pmj, N_HEADS, EPS, True)
    want.update({"rowstats": rowstats, "a2.x1": a2_x1, "a2.stats": a2_stats})
    want.update(zip(("ltiled.x3", "ltiled.x1", "ltiled.stats"), lt))
    want.update(zip(("res.x3", "res.x1", "res.stats"), res))
    want.update(zip(("kernel_a.x1", "kernel_a.stats"), ka))
    want["b.x3"] = lt[0]
    want = {k: np.asarray(v) for k, v in want.items()}

    inputs = {"x": x, "site_mask": site_mask, "pair_mask": pair_mask,
              "rowstats": want["rowstats"], "x1": want["ltiled.x1"],
              "stats": want["ltiled.stats"]}
    inputs.update(flatten(layer, "layer"))
    got = run_port("""
from phyloformer_tpu_torch.ops.kernels import fused
from phyloformer_tpu_torch.ops.kernels.axial_block import body_b, row_finalize_col_stats, row_sums
layer = tree("layer")
w = fused.BlockWeights.of(layer)
x, sm, pm = t("x"), t("site_mask", torch.float32), t("pair_mask", torch.float32)
# each pass on the reference's own inputs, so every comparison is one kernel
OUT["rowstats"] = row_sums(x, sm, w.row.parts, 1e-5)
OUT["a2.x1"], OUT["a2.stats"] = row_finalize_col_stats(x, t("rowstats"), sm, pm, w.row.parts,
                                                       w.col.parts, 1e-5)
OUT["b.x3"] = body_b(t("x1"), t("stats"), pm.sum(1).clamp_min(1.0), w.b.parts, 1e-5)
OUT["ltiled.x3"], OUT["ltiled.x1"], OUT["ltiled.stats"] = fused._fused_block_ltiled_impl(
    x, w, sm, pm, 1e-5)
OUT["res.x3"], OUT["res.x1"], OUT["res.stats"] = fused.fused_axial_block_res(
    x, layer, t("site_mask"), t("pair_mask"))
OUT["kernel_a.x1"], OUT["kernel_a.stats"] = fused.fused_kernel_a(
    x, layer, t("site_mask"), t("pair_mask"))
OUT["x_after"] = x
""", inputs, tmp_path_factory.mktemp("port_fused_block"))
    return x, got, want


@pytest.mark.parametrize("name", ["rowstats", "a2.x1", "a2.stats", "b.x3",
                                  "ltiled.x3", "ltiled.x1", "ltiled.stats"])
def test_ltiled_pass_matches_jax(name, block_case):
    """rowstats = _kernel_a1, a2.* = _kernel_a2 (on JAX's row sums), b.x3 =
    _kernel_b (on JAX's x1 and stats), ltiled.* = _fused_block_ltiled_impl."""
    _, got, want = block_case
    g, r = _real(name, got[name]), _real(name, want[name])
    assert g.shape == r.shape
    assert np.isfinite(g).all()
    err = _rel_err(g, r)
    assert err <= 1e-5, err


@pytest.mark.parametrize("name", ["res.x3", "res.x1", "res.stats",
                                  "kernel_a.x1", "kernel_a.stats"])
def test_resident_block_matches_jax(name, block_case):
    """fused_axial_block_res's residuals (x3, x1, stats) and fused_kernel_a,
    at 552 sites (kernel A on whole rows), out of place."""
    x, got, want = block_case
    np.testing.assert_array_equal(got["x_after"], x)
    g, r = _real(name, got[name]), _real(name, want[name])
    assert g.shape == r.shape
    assert np.isfinite(g).all()
    err = _rel_err(g, r)
    assert err <= 1e-5, err


# ---- forward_fused -----------------------------------------------------------

def _jax_forward_fused(params, cfg, codes, site_mask, seq_mask, resident_max):
    import phyloformer_tpu.ops.pallas.axial_block as jab
    from phyloformer_tpu.models.phyloformer import forward_fused

    saved = jab._RESIDENT_SITES_MAX_HI, jab._RESIDENT_SITES_MAX
    # the threshold is read at trace time and is not part of the jit key
    jab._RESIDENT_SITES_MAX_HI = jab._RESIDENT_SITES_MAX = resident_max
    jab.fused_axial_block._clear_cache()
    try:
        return np.asarray(forward_fused(params, jnp.asarray(codes), cfg,
                                        site_mask=jnp.asarray(site_mask),
                                        seq_mask=jnp.asarray(seq_mask), interpret=True))
    finally:
        jab._RESIDENT_SITES_MAX_HI, jab._RESIDENT_SITES_MAX = saved
        jab.fused_axial_block._clear_cache()


@pytest.fixture(scope="module")
def forward_case(tmp_path_factory):
    from phyloformer_tpu.io.ckpt_import import load_pretrained

    params, cfg, _ = load_pretrained(CKPT)
    cfg = dataclasses.replace(cfg, matmul_precision="float32")
    codes, site_mask, seq_mask = random_batch(91, [(7, 131)], 8, 160)
    want = {name: _jax_forward_fused(params, cfg, codes, site_mask, seq_mask, rmax)
            for name, rmax in (("resident", 1024), ("ltiled", 64))}
    got = run_port(f"""
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.models.phyloformer import forward_fused
from phyloformer_tpu_torch.ops.kernels import axial_block, fused
params, cfg, _ = load_pretrained({str(CKPT)!r})
calls = {{"ltiled": 0}}
impl = fused._fused_block_ltiled_impl
def counted(*args):
    calls["ltiled"] += 1
    return impl(*args)
fused._fused_block_ltiled_impl = counted
for name, rmax in (("resident", 1024), ("ltiled", 64)):
    axial_block.RESIDENT_SITES_MAX = rmax
    calls["ltiled"] = 0
    OUT[name] = forward_fused(params, t("codes"), cfg, t("site_mask"), t("seq_mask"))
    OUT[name + ".ltiled_calls"] = calls["ltiled"]
""", {"codes": codes, "site_mask": site_mask, "seq_mask": seq_mask},
        tmp_path_factory.mktemp("port_forward_fused"))
    return got, want, real_pair_mask(seq_mask)


@pytest.mark.parametrize("name, ltiled_calls", [("resident", 0), ("ltiled", 6)])
def test_forward_fused_matches_jax(name, ltiled_calls, forward_case):
    got, want, pm = forward_case
    assert int(got[name + ".ltiled_calls"]) == ltiled_calls
    assert got[name].shape == want[name].shape
    assert np.isfinite(got[name][pm]).all()
    err = np.abs(got[name] - want[name])[pm].max()
    assert err <= 5e-5, err


# ---- the engine and the CLI ----------------------------------------------------

# (n, L, gap fraction): "long" lands in the (10, 1280) bucket, "short" in (10, 128)
LONG = {"long_a": (5, 1100, 0.0), "long_b": (8, 1030, 0.2)}
SHORT = {"short_a": (7, 30, 0.0), "short_b": (6, 57, 0.3)}


@pytest.fixture(scope="module")
def engine_case(tmp_path_factory):
    from phyloformer_tpu.data.fasta import read_fasta
    from phyloformer_tpu.infer.engine import InferenceConfig, InferenceEngine
    from phyloformer_tpu.io.ckpt_import import load_pretrained

    root = tmp_path_factory.mktemp("fused_engine")
    rng = np.random.default_rng(93)
    alns = {}
    for group in (LONG, SHORT):
        for stem, (n, l, gap) in group.items():
            sub = root / stem.split("_")[0]
            sub.mkdir(exist_ok=True)
            _write_fasta(sub / f"{stem}.fa", rng, n, l, gap)
            alns[stem] = read_fasta(str(sub / f"{stem}.fa"))
    params, cfg, _ = load_pretrained(CKPT)
    long_, short = sorted(LONG), sorted(SHORT)
    want = dict(zip(long_, InferenceEngine(params, cfg, InferenceConfig(use_pallas=True))
                    .predict([alns[s] for s in long_])))
    want.update(zip(short, InferenceEngine(
        params, cfg, InferenceConfig(use_pallas=True, use_pipeline=False))
        .predict([alns[s] for s in short])))

    got = run_port(f"""
from phyloformer_tpu_torch.data.fasta import read_fasta
from phyloformer_tpu_torch.infer import cli
from phyloformer_tpu_torch.infer.engine import InferenceConfig, InferenceEngine
from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
root = {str(root)!r}
params, cfg, _ = load_pretrained({str(CKPT)!r})
for stems, icfg in (({long_!r}, InferenceConfig()),
                    ({short!r}, InferenceConfig(use_pipeline=False))):
    engine = InferenceEngine(params, cfg, icfg, device="cpu")
    alns = [read_fasta(root + "/" + s.split("_")[0] + "/" + s + ".fa") for s in stems]
    OUT[stems[0] + ".plan"] = [list(shape) for shape, _ in engine._plan(alns)]
    for s, p in zip(stems, engine.predict(alns)):
        OUT[s] = p
OUT["cli.rc"] = cli.main([{str(CKPT)!r}, root + "/long", "-o", root + "/cli", "--device", "cpu"])
""", {}, root / "port")
    return root, alns, want, got


@pytest.mark.parametrize("stem", sorted(LONG) + sorted(SHORT))
def test_engine_fused_paths_match_jax(stem, engine_case):
    """Long alignments through the L-tiled path, short ones through the
    two-kernel path (use_pipeline=False)."""
    _, alns, want, got = engine_case
    first = sorted(LONG if stem in LONG else SHORT)[0]
    assert [tuple(s) for s in got[first + ".plan"]] == [(10, 1280) if stem in LONG else (10, 128)]
    aln = alns[stem]
    assert got[stem].shape == (aln.n_seqs * (aln.n_seqs - 1) // 2,)
    assert np.isfinite(got[stem]).all()
    err = np.abs(got[stem] - want[stem]).max()
    assert err <= 5e-5, (stem, err)


def test_cli_predicts_long_alignments(engine_case):
    from phyloformer_tpu.data.phylip import read_phylip

    root, alns, want, got = engine_case
    assert int(got["cli.rc"]) == 0
    for stem in sorted(LONG):
        dm, ids = read_phylip(str(root / "cli" / f"{stem}.phy"))
        assert ids == alns[stem].ids
        i, j = np.triu_indices(alns[stem].n_seqs, 1)
        err = np.abs(dm[i, j] - want[stem]).max()
        assert err <= 1e-4, (stem, err)
