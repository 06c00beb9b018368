"""The port's training path against the JAX package's, on the CPU.

- Kernels: the port's plain ``kernel_c_plain`` / ``kernel_d_plain`` /
  ``kernel_e_plain`` against the TPU kernels ``_kernel_c`` / ``_kernel_d`` /
  ``_kernel_e`` (``pl.pallas_call(interpret=True)``, HIGHEST products), each
  on the reference's own inputs, at a ragged (2, 30 pairs, 48 sites) block
  with 21 / 37 real.  Tolerance 1e-5 relative to max(1, max|ref|).
- Blocks: ``FusedAxialBlock`` and ``FusedAxialBlockRemat`` against JAX
  ``fused_axial_block_ad`` / ``fused_axial_block_ad_remat`` under
  ``value_and_grad``: loss rel 1e-5, gx 1e-4, weight gradients 2e-5 scaled.
- Steps: three train steps of a 2-block d = 32 model, the port's
  ``make_train_step(use_pallas=True)`` against JAX's from the same params
  and batches (loss rel 1e-5, params atol 2e-4), with ``grad_accum=2`` and
  with a fully padded batch row.
- Pieces: losses, the schedule, ``make_pairs`` / ``choose_data``,
  ``make_batch``, ``patristic_vector`` and the ``.npz`` files each package
  writes; and ``pf-train-torch --device cpu`` for 2 steps, then resumed.

The port runs in one subprocess per fixture (:func:`test_torch_model.run_port`).
"""

import functools
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from test_torch_model import flatten, run_port

EPS = 1e-5
B, P, L, D, H = 2, 30, 48, 64, 4
REAL_P, REAL_L = 21, 37
# JAX gradient-tree order of one layer, as the port's autodiff lists it
LEAVES = [("row_norm", "scale"), ("row_norm", "bias")] + [
    ("row_attn", k) for k in ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")] + [
    ("col_norm", "scale"), ("col_norm", "bias")] + [
    ("col_attn", k) for k in ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")] + [
    ("ffn_norm", "scale"), ("ffn_norm", "bias")] + [
    ("ffn", k) for k in ("w1", "b1", "w2", "b2")]


def _rel_err(got, want):
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _layer(seed, d=D):
    """A JAX-initialised layer with every leaf perturbed by numpy noise."""
    from phyloformer_tpu.models.params import PhyloformerConfig, init_params

    cfg = PhyloformerConfig(n_blocks=1, n_heads=H, embed_dim=d, matmul_precision="float32")
    layer = init_params(jax.random.PRNGKey(seed), cfg)["layers"][0]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0.0, 0.05, a.shape)).astype(np.float32), layer)


def _block_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, P, L, D)).astype(np.float32)
    site_mask = np.repeat(np.arange(L)[None] < REAL_L, B, 0)
    pair_mask = np.repeat(np.arange(P)[None] < REAL_P, B, 0)
    g = rng.normal(size=(B, P, L, D)).astype(np.float32)
    g = g * site_mask[:, None, :, None] * pair_mask[:, :, None, None]  # a masked loss
    return x, site_mask, pair_mask, g


# ---- the three kernels ------------------------------------------------------

def _jax_kernels(layer, x, x1, stats, g3, site_mask, pair_mask,
                 prec=jax.lax.Precision.HIGHEST):
    """_kernel_c, _kernel_d (on C's g2 and A1) and _kernel_e (on D's g1),
    one grid step per batch element, with their outputs by name; ``prec``
    the products' precision."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from phyloformer_tpu.ops.pallas import axial_block_bwd as jb

    f32, f = jnp.float32, 4 * D
    la, ca, ffn = layer["row_attn"], layer["col_attn"], layer["ffn"]
    rn, cn, fn = layer["row_norm"], layer["col_norm"], layer["ffn_norm"]
    full = pl.BlockSpec(memory_space=pltpu.VMEM)
    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    tile3 = pl.BlockSpec((1, P, L, D), lambda b, i, j: (b, 0, 0, 0))
    tile2 = pl.BlockSpec((1, P, L, D), lambda b, i: (b, 0, 0, 0))
    stats_s = pl.BlockSpec((1, L, 3 * D), lambda b, i, j: (b, 0, 0))
    a1_s = pl.BlockSpec((1, L, D), lambda b, i, j: (b, 0, 0))
    pm_s = pl.BlockSpec((1, P, 1, 1), lambda b, i, j: (b, 0, 0, 0))
    sm_s = pl.BlockSpec((1, L, 1), lambda b, i: (b, 0, 0))
    pm4 = jnp.asarray(pair_mask, f32)[:, :, None, None]
    sm3 = jnp.asarray(site_mask, f32)[:, :, None]
    count = jnp.sum(jnp.asarray(pair_mask, f32), axis=1)[:, None]

    def wspec(shape):
        return pl.BlockSpec(shape, lambda *_: (0,) * len(shape))

    def shapes(*s):
        return tuple(jax.ShapeDtypeStruct(t, f32) for t in s)

    c_params = [cn["scale"], cn["bias"], ca["wq"], ca["bq"], ca["wo"].T, ca["bo"], fn["scale"],
                fn["bias"], ffn["w1"], ffn["b1"], ffn["w1"].T, ffn["w2"].T]
    c_shapes = shapes((B, P, L, D), (B, L, D), (D, D), (1, D), (1, D), (1, D), (D, f), (1, f),
                      (f, D), (1, D))
    c_out = pl.pallas_call(
        functools.partial(jb._kernel_c, n_heads=H, eps=EPS, prec=prec, interpret=True),
        grid=(B, 1, 1), in_specs=[tile3, tile3, stats_s, pm_s, smem] + [full] * len(c_params),
        out_specs=(tile3, a1_s) + tuple(wspec(s.shape) for s in c_shapes[2:]),
        out_shape=c_shapes, interpret=True,
    )(x1, g3, stats, pm4, count, *c_params)
    g2, a1 = c_out[0], c_out[1]
    d_params = [cn["scale"], cn["bias"], ca["wq"], ca["bq"], ca["wq"].T, ca["wk"], ca["bk"],
                ca["wk"].T, ca["wv"], ca["bv"], ca["wv"].T, ca["wo"].T]
    d_shapes = shapes((B, P, L, D), (1, D), (1, D), (D, H), (1, H), (D, H), (1, H), (D, D),
                      (1, D))
    d_out = pl.pallas_call(
        functools.partial(jb._kernel_d, n_heads=H, eps=EPS, prec=prec, interpret=True),
        grid=(B, 1, 1),
        in_specs=[tile3, tile3, stats_s, a1_s, pm_s, smem] + [full] * len(d_params),
        out_specs=(tile3,) + tuple(wspec(s.shape) for s in d_shapes[1:]),
        out_shape=d_shapes, interpret=True,
    )(x1, g2, stats, a1, pm4, count, *d_params)
    g1 = d_out[0]
    e_params = [rn["scale"], rn["bias"], la["wq"], la["bq"], la["wq"].T, la["wk"], la["bk"],
                la["wk"].T, la["wv"], la["bv"], la["wv"].T, la["wo"].T]
    e_shapes = shapes((B, P, L, D), (1, D), (1, D), (D, H), (1, H), (D, H), (1, H), (D, D),
                      (1, D), (D, D), (1, D))
    e_out = pl.pallas_call(
        functools.partial(jb._kernel_e, n_heads=H, eps=EPS, prec=prec, interpret=True),
        grid=(B, 1), in_specs=[tile2, tile2, sm_s] + [full] * len(e_params),
        out_specs=(tile2,) + tuple(wspec(s.shape) for s in e_shapes[1:]),
        out_shape=e_shapes, interpret=True,
    )(x, g1, sm3, *e_params)
    names = {
        "c": ["g2", "a1", "col_attn/wo", "col_attn/bo", "ffn_norm/scale", "ffn_norm/bias",
              "ffn/w1", "ffn/b1", "ffn/w2", "ffn/b2"],
        "d": ["g1", "col_norm/scale", "col_norm/bias", "col_attn/wq", "col_attn/bq",
              "col_attn/wk", "col_attn/bk", "col_attn/wv", "col_attn/bv"],
        "e": ["gx", "row_norm/scale", "row_norm/bias", "row_attn/wq", "row_attn/bq",
              "row_attn/wk", "row_attn/bk", "row_attn/wv", "row_attn/bv", "row_attn/wo",
              "row_attn/bo"],
    }
    out = {}
    for k, outs in (("c", c_out), ("d", d_out), ("e", e_out)):
        for name, v in zip(names[k], outs):
            v = np.asarray(v)
            out[f"{k}.{name}"] = v[0] if v.ndim == 2 and v.shape[0] == 1 else v
    return out


@pytest.fixture(scope="module")
def kernel_case(tmp_path_factory):
    from phyloformer_tpu.ops.pallas.axial_block import fused_axial_block_res

    layer = _layer(7)
    x, site_mask, pair_mask, g3 = _block_inputs(13)
    with jax.default_matmul_precision("float32"):
        _, x1, stats = fused_axial_block_res(jnp.asarray(x), layer, jnp.asarray(site_mask),
                                             jnp.asarray(pair_mask), H, EPS, True)
        want = _jax_kernels(layer, jnp.asarray(x), x1, stats, jnp.asarray(g3), site_mask,
                            pair_mask)
    inputs = {"x": x, "x1": np.asarray(x1), "stats": np.asarray(stats), "g3": g3,
              "g2": want["c.g2"], "a1": want["c.a1"], "g1": want["d.g1"],
              "site_mask": site_mask, "pair_mask": pair_mask}
    inputs.update(flatten(layer, "layer"))
    got = run_port("""
from phyloformer_tpu_torch.ops.kernels import axial_block_bwd as bw
w = bw.BwdWeights.of(tree("layer"))
sm, pm = t("site_mask", torch.float32), t("pair_mask", torch.float32)
res = {}
# each kernel on the reference's own inputs, so every comparison is one kernel
g2, a1, dc = bw.kernel_c_plain(t("x1"), t("g3"), t("stats"), pm, pm.sum(1), w.c, 1e-5)
g1, dd = bw.kernel_d_plain(t("x1"), t("g2"), t("stats"), t("a1"), pm, pm.sum(1), w.d, 1e-5)
gx, de = bw.kernel_e_plain(t("x"), t("g1"), sm, w.e, 1e-5)
OUT.update({"c.g2": g2, "c.a1": a1, "d.g1": g1, "e.gx": gx})
for k, name, flat in (("c", "kernel_c", dc), ("d", "kernel_d", dd), ("e", "kernel_e", de)):
    for sub, leaves in bw.unpack_grads(name, flat, 64, 4, {}).items():
        for leaf, v in leaves.items():
            OUT[f"{k}.{sub}/{leaf}"] = v
""", inputs, tmp_path_factory.mktemp("port_bwd_kernels"))
    return got, want


KERNEL_OUTPUTS = ["c.g2", "c.a1", "c.col_attn/wo", "c.col_attn/bo", "c.ffn_norm/scale",
                  "c.ffn_norm/bias", "c.ffn/w1", "c.ffn/b1", "c.ffn/w2", "c.ffn/b2",
                  "d.g1", "d.col_norm/scale", "d.col_norm/bias", "d.col_attn/wq",
                  "d.col_attn/bq", "d.col_attn/wk", "d.col_attn/bk", "d.col_attn/wv",
                  "d.col_attn/bv", "e.gx", "e.row_norm/scale", "e.row_norm/bias",
                  "e.row_attn/wq", "e.row_attn/bq", "e.row_attn/wk", "e.row_attn/bk",
                  "e.row_attn/wv", "e.row_attn/bv", "e.row_attn/wo", "e.row_attn/bo"]


@pytest.mark.parametrize("name", KERNEL_OUTPUTS)
def test_backward_kernel_matches_jax(name, kernel_case):
    """c.* = _kernel_c, d.* = _kernel_d (on JAX's g2 and A1), e.* =
    _kernel_e (on JAX's g1): activations, A1 and every weight gradient."""
    got, want = kernel_case
    g, r = got[name], want[name]
    assert g.shape == r.shape, (g.shape, r.shape)
    assert np.isfinite(g).all()
    err = _rel_err(g, r)
    assert err <= 1e-5, err


# ---- one block under autograd ------------------------------------------------

@pytest.fixture(scope="module")
def block_grad_case(tmp_path_factory):
    from phyloformer_tpu.models.params import PhyloformerConfig
    from phyloformer_tpu.ops.pallas.autodiff import (
        fused_axial_block_ad,
        fused_axial_block_ad_remat,
    )

    cfg = PhyloformerConfig(n_blocks=1, n_heads=H, embed_dim=D, matmul_precision="float32")
    layer = _layer(8)
    x, site_mask, pair_mask, g = _block_inputs(14)
    sm, pm, gj = jnp.asarray(site_mask), jnp.asarray(pair_mask), jnp.asarray(g)
    want = {}
    for name, fn in (("fused", fused_axial_block_ad), ("remat", fused_axial_block_ad_remat)):
        def loss(x_, layer_, fn=fn):
            return jnp.sum(fn(x_, layer_, sm, pm, cfg, True) * gj)

        with jax.default_matmul_precision("float32"):
            v, (gx, gl) = jax.value_and_grad(loss, argnums=(0, 1))(jnp.asarray(x), layer)
        want[f"{name}.loss"] = np.asarray(v)
        want[f"{name}.gx"] = np.asarray(gx)
        want.update({f"{name}.{a}/{b}": np.asarray(gl[a][b]) for a, b in LEAVES})
    inputs = {"x": x, "site_mask": site_mask, "pair_mask": pair_mask, "g": g}
    inputs.update(flatten(layer, "layer"))
    got = run_port("""
from phyloformer_tpu_torch.models.params import PhyloformerConfig
from phyloformer_tpu_torch.ops.kernels.autodiff import LAYER_LEAVES, fused_axial_block_ad
cfg = PhyloformerConfig(n_blocks=1)
for name, remat in (("fused", False), ("remat", True)):
    layer = tree("layer")
    for a, b in LAYER_LEAVES:
        layer[a][b].requires_grad_(True)
    x = t("x").requires_grad_(True)
    out = fused_axial_block_ad(x, layer, t("site_mask", torch.float32),
                               t("pair_mask", torch.float32), cfg, remat=remat)
    loss = (out * t("g")).sum()
    loss.backward()
    OUT[name + ".loss"] = loss
    OUT[name + ".gx"] = x.grad
    for a, b in LAYER_LEAVES:
        OUT[f"{name}.{a}/{b}"] = layer[a][b].grad
""", inputs, tmp_path_factory.mktemp("port_block_grad"))
    return got, want


@pytest.mark.parametrize("form", ["fused", "remat"])
def test_block_gradients_match_jax(form, block_grad_case):
    got, want = block_grad_case
    assert abs(float(got[f"{form}.loss"]) - float(want[f"{form}.loss"])) <= (
        1e-5 * abs(float(want[f"{form}.loss"])))
    np.testing.assert_allclose(got[f"{form}.gx"], want[f"{form}.gx"], atol=1e-4, rtol=1e-4)
    for a, b in LEAVES:
        g, r = got[f"{form}.{a}/{b}"], want[f"{form}.{a}/{b}"]
        assert g.shape == r.shape, (a, b)
        scale = max(np.abs(r).max(), 1.0)
        np.testing.assert_allclose(g / scale, r / scale, atol=2e-5, err_msg=f"{a}/{b}")


# ---- train steps ---------------------------------------------------------------

def _toy_batch(bsz, n, l, seed):
    from phyloformer_tpu.data.pairs import n_pairs

    rng = np.random.default_rng(seed)
    batch = {"codes": rng.integers(0, 22, (bsz, n, l)).astype(np.int32),
             "dists": rng.uniform(0.05, 2.0, (bsz, n_pairs(n))).astype(np.float32),
             "site_mask": np.ones((bsz, l), bool), "seq_mask": np.ones((bsz, n), bool)}
    batch["site_mask"][-1, l - 4:] = False
    batch["seq_mask"][-1, n - 2:] = False
    return batch


# name: (grad_accum, batch sequence)
STEP_CASES = {"accum1": (1, ["b0", "b1", "b0"]), "accum2": (2, ["b0", "b1", "b0", "b1"]),
              "padded": (1, ["pad", "pad"])}


@pytest.fixture(scope="module")
def step_case(tmp_path_factory):
    from phyloformer_tpu.models.params import PhyloformerConfig, init_params
    from phyloformer_tpu.train import TrainConfig, create_train_state, make_train_step
    from phyloformer_tpu.train.trainer import pad_batch_to_multiple

    cfg = PhyloformerConfig(n_blocks=2, n_heads=4, embed_dim=32, matmul_precision="float32")
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0.0, 0.05, a.shape)).astype(np.float32),
        init_params(jax.random.PRNGKey(5), cfg))
    # Where a head's q or k sits in φ's exponential branch for every
    # position, q/Σq and k/Σk do not depend on its bias, whose gradient is
    # then exactly 0 and computed as fp32 rounding residue (~1e-8, either
    # sign) that Adam's first updates scale to ±lr.  Raising the q/k biases
    # by 2 keeps every head off that branch here, so the step comparison
    # tests the kernels and not the residue (checked in float64).
    for ly in params["layers"]:
        for attn in ("row_attn", "col_attn"):
            for k in ("bq", "bk"):
                ly[attn][k] = ly[attn][k] + np.float32(2.0)
    batches = {"b0": _toy_batch(2, 7, 24, 1), "b1": _toy_batch(2, 7, 24, 2),
               "pad": pad_batch_to_multiple(_toy_batch(3, 7, 24, 3), 4)}
    assert not batches["pad"]["seq_mask"][3].any()
    inputs = {f"{k}.{n}": v for k, b in batches.items() for n, v in b.items()}
    inputs.update(flatten(params, "params"))
    want = {}
    for case, (accum, seq) in STEP_CASES.items():
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=50, use_pallas=True,
                           grad_accum=accum)
        state, tx = create_train_state(cfg, tcfg, params=jax.tree_util.tree_map(
            jnp.asarray, params))
        step = make_train_step(cfg, tcfg, tx)
        for i, name in enumerate(seq):
            state, logs = step(state, batches[name], jax.random.PRNGKey(0))
            for k in ("train_loss", "grad_norm", "learning_rate"):
                want[f"{case}.{i}.{k}"] = np.asarray(logs[k])
        want.update(flatten(jax.tree_util.tree_map(np.asarray, state["params"]),
                            f"{case}.params"))
    got = run_port(f"""
from phyloformer_tpu_torch.models.params import PhyloformerConfig
from phyloformer_tpu_torch.train.trainer import TrainConfig, create_train_state, make_train_step
from phyloformer_tpu_torch.ops.kernels import pipeline
cfg = PhyloformerConfig(n_blocks=2, n_heads=4, embed_dim=32)
batches = {{k: {{n: IN[f"{{k}}.{{n}}"] for n in ("codes", "dists", "site_mask", "seq_mask")}}
           for k in ("b0", "b1", "pad")}}
for case, (accum, seq) in {STEP_CASES!r}.items():
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=50, use_pallas=True,
                       grad_accum=accum)
    state, tx = create_train_state(cfg, tcfg, params=tree("params"), device="cpu")
    step = make_train_step(cfg, tcfg, tx)
    for i, name in enumerate(seq):
        state, logs = step(state, batches[name])
        for k in ("train_loss", "grad_norm", "learning_rate"):
            OUT[f"{{case}}.{{i}}.{{k}}"] = np.asarray(float(logs[k]))
    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(prefix + "/" + k, v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                rec(prefix + "/" + str(i), v)
        else:
            OUT[prefix] = node
    rec(case + ".params", state["params"])
OUT["cpu_launches"] = sum(pipeline.LAUNCHES.values())
""", inputs, tmp_path_factory.mktemp("port_steps"))
    return got, want


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_steps_match_jax(case, step_case):
    got, want = step_case
    assert int(got["cpu_launches"]) == 0  # the CPU runs the plain versions
    for i in range(len(STEP_CASES[case][1])):
        loss, ref = float(got[f"{case}.{i}.train_loss"]), float(want[f"{case}.{i}.train_loss"])
        assert np.isfinite(loss) and abs(loss - ref) <= 1e-5 * abs(ref), (i, loss, ref)
        gn, gref = float(got[f"{case}.{i}.grad_norm"]), float(want[f"{case}.{i}.grad_norm"])
        assert np.isfinite(gn) and abs(gn - gref) <= 1e-5 * abs(gref), (i, gn, gref)
        assert float(got[f"{case}.{i}.learning_rate"]) == pytest.approx(
            float(want[f"{case}.{i}.learning_rate"]), rel=1e-6, abs=1e-12)
    keys = [k for k in want if k.startswith(case + ".params/")]
    assert len(keys) == 2 * 26 + 4
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], atol=2e-4, err_msg=k)


# ---- losses, schedule, data, npz, CLI ------------------------------------------

def _random_tree(rng, names):
    """A random binary tree in Newick with exponential branch lengths."""
    nodes = [f"{n}:{rng.exponential(0.1):.6f}" for n in names]
    while len(nodes) > 2:
        i, j = sorted(rng.choice(len(nodes), 2, replace=False))
        b = nodes.pop(j)
        a = nodes.pop(i)
        nodes.append(f"({a},{b}):{rng.exponential(0.1):.6f}")
    return f"({nodes[0]},{nodes[1]});"


def _write_corpus(root, seed, specs):
    """Trees in ``root/trees`` and FASTA in ``root/alns``, one per (n, L)."""
    rng = np.random.default_rng(seed)
    (root / "trees").mkdir(parents=True)
    (root / "alns").mkdir()
    amino = np.array(list("ARNDCQEGHILKMFPSTWYV"))
    for k, (n, l) in enumerate(specs):
        names = [f"t{k}_{i}" for i in range(n)]
        (root / "trees" / f"ex{k:02d}.nwk").write_text(_random_tree(rng, names) + "\n")
        seqs = amino[rng.integers(0, 20, (n, l))]
        seqs[rng.random((n, l)) < 0.02] = "-"
        order = rng.permutation(n)  # alignment order differs from the tree's
        (root / "alns" / f"ex{k:02d}.fa").write_text(
            "".join(f">{names[i]}\n{''.join(seqs[i])}\n" for i in order))


@pytest.fixture(scope="module")
def pieces_case(tmp_path_factory):
    from phyloformer_tpu.data.fasta import read_fasta
    from phyloformer_tpu.data.newick import patristic_vector, read_newick
    from phyloformer_tpu.io.checkpoint import save_params_npz
    from phyloformer_tpu.train import losses as jl
    from phyloformer_tpu.train.data import choose_data, make_pairs
    from phyloformer_tpu.train.schedule import linear_warmup_decay
    from phyloformer_tpu.train.trainer import make_batch

    root = tmp_path_factory.mktemp("train_pieces")
    _write_corpus(root / "corpus", 21, [(6, 30), (5, 26), (7, 33), (6, 28), (4, 20),
                                        (6, 31), (5, 29), (6, 30), (7, 27), (5, 25)])
    (root / "corpus" / "alns" / "extra.fa").write_text(">a\nAC\n>b\nAD\n")  # no tree
    rng = np.random.default_rng(22)
    preds = rng.uniform(0.05, 2.0, (3, 15)).astype(np.float32)
    targets = rng.uniform(0.05, 2.0, (3, 15)).astype(np.float32)
    mask = rng.random((3, 15)) < 0.7
    want = {}
    for name in ("mae", "mre", "mse"):
        want[f"loss.{name}"] = np.asarray(jl.get_loss(name)(preds, targets, mask))
        want[f"loss.{name}.nomask"] = np.asarray(jl.get_loss(name)(preds, targets))
    want.update({f"metric.{k}": np.asarray(v) for k, v in jl.metrics(preds, targets, mask).items()})
    steps = np.arange(0, 130)
    for base, warm, total in ((1e-4, 10, 100), (3e-3, 0, 50), (1e-3, 64, 64)):
        sched = linear_warmup_decay(base, warm, total)
        want[f"sched.{warm}.{total}"] = np.asarray([float(sched(s)) for s in steps])
    corpus = root / "corpus"
    pairs = make_pairs(corpus / "trees", corpus / "alns")
    want["pairs"] = np.asarray(pairs)
    want["pairs.regex"] = np.asarray(make_pairs(corpus / "trees", corpus / "alns", r"ex0[13]"))
    tr, va = choose_data(corpus / "trees", corpus / "alns", seed=7)
    want["split.train"], want["split.val"] = np.asarray(tr), np.asarray(va)
    alns = [read_fasta(a) for _, a in pairs[:3]]
    vecs = [patristic_vector(read_newick(t), a.ids) for (t, _), a in zip(pairs[:3], alns)]
    for i, v in enumerate(vecs):
        want[f"patristic.{i}"] = v
    want.update({f"batch.{k}": v for k, v in make_batch(alns, vecs, 10, 40).items()})
    layer_params = {"embed": {"w": rng.normal(size=(22, 8)).astype(np.float32)},
                    "layers": [{"ffn": {"w1": rng.normal(size=(8, 32)).astype(np.float32)}}
                               for _ in range(2)]}
    save_params_npz(root / "from_jax.npz", layer_params)
    want.update(flatten(layer_params, "npz"))
    import optax

    from phyloformer_tpu.models.params import PhyloformerConfig, init_params

    grads = [rng.normal(size=(5, 3)).astype(np.float32), rng.normal(size=7).astype(np.float32)]
    for max_norm in (0.5, 100.0):
        clipped, _ = optax.clip_by_global_norm(max_norm).update(grads, None)
        want.update({f"clip.{max_norm}.{i}": np.asarray(c) for i, c in enumerate(clipped)})
    jax_init = init_params(jax.random.PRNGKey(0), PhyloformerConfig())
    want.update({"init." + k[len("p/"):]: np.asarray(v.shape)
                 for k, v in flatten(jax_init, "p").items()})
    inputs = {"preds": preds, "targets": targets, "mask": mask, "steps": steps,
              "grad0": grads[0], "grad1": grads[1]}
    got = run_port(f"""
from pathlib import Path
from phyloformer_tpu_torch.data.fasta import read_fasta
from phyloformer_tpu_torch.data.newick import patristic_vector, read_newick
from phyloformer_tpu_torch.io.checkpoint import load_params_npz, save_params_npz
from phyloformer_tpu_torch.train import losses as tl
from phyloformer_tpu_torch.train.data import choose_data, make_pairs
from phyloformer_tpu_torch.train.schedule import linear_warmup_decay
from phyloformer_tpu_torch.train.trainer import make_batch
root = Path({str(root)!r})
p, tg, m = t("preds"), t("targets"), t("mask")
for name in ("mae", "mre", "mse"):
    OUT["loss." + name] = tl.get_loss(name)(p, tg, m)
    OUT["loss." + name + ".nomask"] = tl.get_loss(name)(p, tg)
OUT.update({{"metric." + k: v for k, v in tl.metrics(p, tg, m).items()}})
for base, warm, total in ((1e-4, 10, 100), (3e-3, 0, 50), (1e-3, 64, 64)):
    sched = linear_warmup_decay(base, warm, total)
    OUT[f"sched.{{warm}}.{{total}}"] = np.asarray([sched(int(s)) for s in IN["steps"]])
corpus = root / "corpus"
pairs = make_pairs(corpus / "trees", corpus / "alns")
OUT["pairs"] = np.asarray(pairs)
OUT["pairs.regex"] = np.asarray(make_pairs(corpus / "trees", corpus / "alns", r"ex0[13]"))
tr, va = choose_data(corpus / "trees", corpus / "alns", seed=7)
OUT["split.train"], OUT["split.val"] = np.asarray(tr), np.asarray(va)
alns = [read_fasta(a) for _, a in pairs[:3]]
vecs = [patristic_vector(read_newick(tp), a.ids) for (tp, _), a in zip(pairs[:3], alns)]
for i, v in enumerate(vecs):
    OUT[f"patristic.{{i}}"] = v
OUT.update({{"batch." + k: v for k, v in make_batch(alns, vecs, 10, 40).items()}})
npz = load_params_npz(root / "from_jax.npz")
OUT["npz/embed/w"] = npz["embed"]["w"]
OUT["npz/layers/0/ffn/w1"] = npz["layers"][0]["ffn"]["w1"]
OUT["npz/layers/1/ffn/w1"] = npz["layers"][1]["ffn"]["w1"]
from phyloformer_tpu_torch.io.checkpoint import CheckpointManager
from phyloformer_tpu_torch.models.params import PhyloformerConfig, count_params, init_params
from phyloformer_tpu_torch.models.phyloformer import forward
from phyloformer_tpu_torch.train.schedule import clip_by_global_norm
from phyloformer_tpu_torch.train.trainer import TrainConfig, create_train_state
for max_norm in (0.5, 100.0):
    g = [t("grad0").clone(), t("grad1").clone()]
    clip_by_global_norm(g, max_norm)
    for i, c in enumerate(g):
        OUT[f"clip.{{max_norm}}.{{i}}"] = c
init = init_params(PhyloformerConfig(), torch.Generator().manual_seed(0))
OUT["init.count"] = np.asarray(count_params(init))
def leaves(prefix, node):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from leaves(prefix + "/" + k, v)
    elif isinstance(node, list):
        for i, v in enumerate(node):
            yield from leaves(prefix + "/" + str(i), v)
    else:
        yield prefix, node
for name, v in leaves("", init):
    OUT["init" + name.replace("/", ".", 1)] = np.asarray(v.shape)
    OUT["init.max" + name] = v.abs().max()
    OUT["init.std" + name] = v.std() if v.numel() > 1 else torch.tensor(0.0)
# remat recomputes each block in the backward: the same gradients
cfg = PhyloformerConfig(n_blocks=2, embed_dim=32)
codes = torch.from_numpy(np.random.default_rng(3).integers(0, 22, (2, 6, 20)))
gr = []
for remat in (False, True):
    p = init_params(cfg, torch.Generator().manual_seed(1))
    for _, v in leaves("", p):
        v.requires_grad_(True)
    gr.append(torch.autograd.grad(forward(p, codes, cfg, remat=remat).sum(),
                                  [v for _, v in leaves("", p)]))
OUT["remat.max_diff"] = max((a - b).abs().max() for a, b in zip(*gr))
# the checkpoint manager keeps the newest max_to_keep
state, _ = create_train_state(cfg, TrainConfig(), device="cpu")
mgr = CheckpointManager(root / "ckpts", max_to_keep=2)
for step in (3, 6, 9):
    state["step"] = step
    mgr.save(step, state, metadata={{"step": step}})
payload, latest = mgr.restore()
OUT["ckpt.steps"] = np.asarray(mgr.all_steps())
OUT["ckpt.latest"] = np.asarray([latest, payload["step"], payload["metadata"]["step"]])
save_params_npz(root / "from_port.npz", {{"embed": {{"w": torch.from_numpy(npz["embed"]["w"])}},
                                        "layers": [{{"ffn": {{"w1": torch.from_numpy(l["ffn"]["w1"])}}}}
                                                   for l in npz["layers"]]}})
""", inputs, root / "port")
    return root, got, want


def test_losses_and_metrics_match_jax(pieces_case):
    _, got, want = pieces_case
    for k in [k for k in want if k.startswith(("loss.", "metric."))]:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6), k


def test_schedule_matches_jax(pieces_case):
    _, got, want = pieces_case
    for k in [k for k in want if k.startswith("sched.")]:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-12, err_msg=k)


def test_pairs_split_and_targets_match_jax(pieces_case):
    _, got, want = pieces_case
    assert len(want["pairs"]) == 10 and len(want["pairs.regex"]) == 2
    for k in ("pairs", "pairs.regex", "split.train", "split.val"):
        assert got[k].tolist() == want[k].tolist(), k
    for i in range(3):
        np.testing.assert_allclose(got[f"patristic.{i}"], want[f"patristic.{i}"], rtol=1e-6)
    for k in ("codes", "dists", "site_mask", "seq_mask"):
        np.testing.assert_array_equal(got[f"batch.{k}"], want[f"batch.{k}"])


def test_npz_params_read_by_both_packages(pieces_case):
    from phyloformer_tpu.io.checkpoint import load_params_npz

    root, got, want = pieces_case
    for k in ("npz/embed/w", "npz/layers/0/ffn/w1", "npz/layers/1/ffn/w1"):
        np.testing.assert_array_equal(got[k], want[k])
    back = load_params_npz(root / "from_port.npz")
    np.testing.assert_array_equal(back["embed"]["w"], want["npz/embed/w"])
    assert len(back["layers"]) == 2
    np.testing.assert_array_equal(back["layers"][1]["ffn"]["w1"], want["npz/layers/1/ffn/w1"])


def test_clip_init_remat_and_checkpoints(pieces_case):
    """optax's global-norm clipping; init_params against the JAX tree's
    shapes, the parameter count and the kaiming-uniform / uniform bounds;
    remat's gradients; the checkpoint manager's retention."""
    _, got, want = pieces_case
    for k in [k for k in want if k.startswith("clip.")]:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert int(got["init.count"]) == 308449
    shapes = [k for k in want if k.startswith("init.")]
    assert len(shapes) == 160
    for k in shapes:
        assert got[k].tolist() == want[k].tolist(), k
        leaf = k[len("init."):].replace(".", "/")
        fan_in = 22 if leaf.startswith("embed/") else (
            256 if leaf.endswith(("ffn/w2", "ffn/b2")) else 64)
        top = float(got["init.max/" + leaf])
        if "norm" in leaf:
            assert top == (1.0 if leaf.endswith("scale") else 0.0), leaf
        elif leaf.split("/")[-1].startswith("w"):
            assert 0.5 / np.sqrt(fan_in) < top <= np.sqrt(3.0 / fan_in), (leaf, top)
        elif float(got["init.std/" + leaf]) > 0:
            assert top <= 1.0 / np.sqrt(fan_in), (leaf, top)
    assert float(got["remat.max_diff"]) == 0.0
    assert got["ckpt.steps"].tolist() == [6, 9]
    assert got["ckpt.latest"].tolist() == [9, 9, 9]


def test_train_cli_runs_and_resumes_on_cpu(pieces_case):
    """pf-train-torch --device cpu: 2 fused-path steps with a validation
    and checkpoint at step 2, then 2 more eager steps resumed from it."""
    root, _, _ = pieces_case
    corpus, out = root / "corpus", root / "cli"
    common = ["-t", str(corpus / "trees"), "-a", str(corpus / "alns"), "--device", "cpu",
              "--batch-size", "2", "--nb-blocks", "2", "--loss", "mre", "--warmup-steps", "1",
              "--learning-rate", "1e-3", "--check-val-every", "2", "--log-every", "1",
              "--num-workers", "1", "-o", str(out), "-n", "run"]
    got = run_port(f"""
import contextlib, io, json
from phyloformer_tpu_torch.train import cli
res = []
for extra in (["--max-steps", "2", "--use-pallas", "on"],
              ["--max-steps", "4", "--load-checkpoint", {str(out / "checkpoints_run")!r}]):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main({common!r} + extra)
    res.append({{"rc": rc, "stdout": buf.getvalue()}})
OUT["runs"] = np.asarray(json.dumps(res))
""", {}, root / "port_cli")
    first, second = json.loads(str(got["runs"]))
    assert first["rc"] == 0 and second["rc"] == 0, (first, second)
    s1 = json.loads(first["stdout"].strip().splitlines()[-1])
    s2 = json.loads(second["stdout"].strip().splitlines()[-1])
    assert s1["steps"] == 2 and s1["use_pallas"] is True and s1["device"] == "cpu", s1
    assert "resumed from step 2" in second["stdout"], second["stdout"]
    assert s2["steps"] == 4 and s2["use_pallas"] is False, s2
    assert s2["best_val_loss"] is not None and np.isfinite(s2["best_val_loss"])
    ckpts = sorted(p.name for p in (out / "checkpoints_run").iterdir())
    assert ckpts == ["ckpt_2.pt", "ckpt_4.pt"], ckpts
    records = [json.loads(line) for line in (out / "run_metrics.jsonl").read_text().splitlines()]
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    assert len(losses) == 4 and all(np.isfinite(losses)), records
    assert [r["step"] for r in records if "val_loss" in r] == [2, 2, 4, 4], records
