"""The port's reduced-precision training against the JAX package's, on the CPU.

``mxu_precision="default"`` (the trainer's ``--matmul-precision default`` or
``tensorfloat32``) runs every product of the backward kernels C, D, E and E2
in one TF32 pass; the port's plain versions round both operands of each
product to TF32 as the kernels do (``axial_block.mm``, ``axial_block_bwd.
_mm_at``).  JAX on the CPU computes ``"default"`` in fp32, so the two differ
by the rounding one pass brings, and the bars are the JAX fast path's gate,
6e-3 (``bench.py``), relative to max(1, max|ref|) (loss and grad norm:
relative).

- Kernels: ``kernel_{c,d,e}_plain(passes=1)`` against ``_kernel_c/_d/_e``
  (``interpret=True``, ``Precision.DEFAULT``) on the reference's own inputs
  at the ragged (2, 30 pairs, 48 sites) block of ``test_torch_train``; every
  output and weight gradient within 6e-3 (measured at most 1.3e-3, on D's
  column bk), and somewhere at least 1e-6 from the port's three-pass
  outputs (one pass really ran; measured at least 5.6e-4).  E1 (exact fp32
  at both pass counts: its row sums equal the three-pass ones) then E2 at
  one pass against ``_kernel_e1`` / ``_kernel_e2`` at 1100 sites (measured
  at most 5.8e-4, on E2's wq; the row sums 1.8e-7).
- Blocks: ``fused_axial_block_ad(..., mxu_precision="default")`` against
  JAX's under ``value_and_grad`` at 48 sites and at 1100 (the L-tiled
  backward on the port's side): the output, gx and every weight gradient
  within 6e-3 (measured at most 4.3e-4, 5.2e-4 and 2.2e-3), the loss
  Σ out·g within 6e-3 of Σ|out·g| (measured 3.4e-6).
- Steps: three fused train steps of a 2-block d = 32 model at
  ``matmul_precision`` "default" and "tensorfloat32" against JAX's
  ``make_train_step`` with the same ``PhyloformerConfig``: loss and grad
  norm within 6e-3 relative (measured at most 9.4e-5 and 3.1e-4),
  parameters within the fp32 test's 2e-4 max-abs (measured 1.25e-4: Adam
  moves every parameter by about the learning rate whatever its gradient's
  size, so a gradient near 0 whose value the rounding moves moves its
  update by a share of the learning rate, 1e-3 here).
- Product: the one-pass weight-gradient product ``_mm_at(a, b, 1)`` against
  a float64 transcription with an independent numpy TF32 rounding, within
  2e-6 (fp32's own error), and at least 1e-5 from the unrounded product.

The port runs in subprocesses (:func:`test_torch_model.run_port`).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from test_torch_model import flatten, run_port
from test_torch_precision import _tf32_rna_np
from test_torch_train import (
    KERNEL_OUTPUTS,
    LEAVES,
    _block_inputs,
    _jax_kernels,
    _layer,
    _rel_err,
    _toy_batch,
)

EPS = 1e-5
D, H = 64, 4
GATE = 6e-3  # the JAX package's fast-path gate (bench.py), of max(1, max|ref|)
DEFAULT = jax.lax.Precision.DEFAULT


# ---- kernels C, D, E at one pass ----------------------------------------------

@pytest.fixture(scope="module")
def kernel_case(tmp_path_factory):
    from phyloformer_tpu.ops.pallas.axial_block import fused_axial_block_res

    layer = _layer(27)
    x, site_mask, pair_mask, g3 = _block_inputs(33)
    _, x1, stats = fused_axial_block_res(jnp.asarray(x), layer, jnp.asarray(site_mask),
                                         jnp.asarray(pair_mask), H, EPS, True, "default")
    want = _jax_kernels(layer, jnp.asarray(x), x1, stats, jnp.asarray(g3), site_mask,
                        pair_mask, prec=DEFAULT)
    inputs = {"x": x, "x1": np.asarray(x1), "stats": np.asarray(stats), "g3": g3,
              "g2": want["c.g2"], "a1": want["c.a1"], "g1": want["d.g1"],
              "site_mask": site_mask, "pair_mask": pair_mask}
    inputs.update(flatten(layer, "layer"))
    got = run_port("""
from phyloformer_tpu_torch.ops.kernels import axial_block_bwd as bw
w = bw.BwdWeights.of(tree("layer"))
sm, pm = t("site_mask", torch.float32), t("pair_mask", torch.float32)
for n in (1, 3):
    # each kernel on the reference's own inputs, so every comparison is one kernel
    g2, a1, dc = bw.kernel_c(t("x1"), t("g3"), t("stats"), pm, pm.sum(1), w.c, 1e-5, n)
    g1, dd = bw.kernel_d(t("x1"), t("g2"), t("stats"), t("a1"), pm, pm.sum(1), w.d, 1e-5, n)
    gx, de = bw.kernel_e(t("x"), t("g1"), sm, w.e, 1e-5, n)
    OUT.update({f"{n}.c.g2": g2, f"{n}.c.a1": a1, f"{n}.d.g1": g1, f"{n}.e.gx": gx})
    for k, name, flat in (("c", "kernel_c", dc), ("d", "kernel_d", dd), ("e", "kernel_e", de)):
        for sub, leaves in bw.unpack_grads(name, flat, 64, 4, {}).items():
            for leaf, v in leaves.items():
                OUT[f"{n}.{k}.{sub}/{leaf}"] = v
""", inputs, tmp_path_factory.mktemp("port_bwd_one_pass"))
    return got, want


@pytest.mark.parametrize("name", KERNEL_OUTPUTS)
def test_one_pass_backward_kernel_matches_jax(name, kernel_case):
    """c.* = _kernel_c, d.* = _kernel_d (on JAX's g2 and A1), e.* =
    _kernel_e (on JAX's g1), at ``Precision.DEFAULT``: activations, A1 and
    every weight gradient of the port's one-pass plain versions."""
    got, want = kernel_case
    g, r = got["1." + name], want[name]
    assert g.shape == r.shape, (g.shape, r.shape)
    assert np.isfinite(g).all()
    err = _rel_err(g, r)
    assert err <= GATE, err


def test_one_pass_differs_from_three(kernel_case):
    """One pass really ran: every kernel's outputs lie somewhere at least
    1e-6 (relative to max(1, max|ref|)) from its three-pass outputs."""
    got, _ = kernel_case
    for kernel in ("c", "d", "e"):
        names = [n for n in KERNEL_OUTPUTS if n.startswith(kernel + ".")]
        assert max(_rel_err(got["1." + n], got["3." + n]) for n in names) >= 1e-6, kernel


# ---- E1 + E2 above 1024 sites ------------------------------------------------------

E12_B, E12_P, E12_L, E12_REAL_L, E12_TILE = 1, 6, 1100, 1077, 220
E2_NAMES = ["gx", "row_norm/scale", "row_norm/bias", "row_attn/wq", "row_attn/bq",
            "row_attn/wk", "row_attn/bk", "row_attn/wv", "row_attn/bv", "row_attn/wo",
            "row_attn/bo"]


def _jax_e1_e2(layer, x, g1, site_mask, prec):
    """_kernel_e1 then _kernel_e2 in E12_TILE-site tiles (a divisor of the
    site axis), grid (B, 1 pair tile, site tiles), as the JAX host function
    runs them above 1024 sites."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from phyloformer_tpu.ops.pallas import axial_block_bwd as jb

    b, p, l, _ = x.shape
    f32 = jnp.float32
    sm = jnp.asarray(site_mask, f32)
    la, rn = layer["row_attn"], layer["row_norm"]
    full = pl.BlockSpec(memory_space=pltpu.VMEM)
    tile = pl.BlockSpec((1, p, E12_TILE, D), lambda i, j, li: (i, j, li, 0))
    sm_s = pl.BlockSpec((1, E12_TILE, 1), lambda i, j, li: (i, li, 0))
    rows = pl.BlockSpec((1, p, 1, 4 * D), lambda i, j, li: (i, j, 0, 0))
    grid = (b, 1, l // E12_TILE)
    e1_params = [rn["scale"], rn["bias"], la["wq"], la["bq"], la["wk"], la["bk"], la["wv"],
                 la["bv"], la["wo"].T]
    rowsums = pl.pallas_call(
        functools.partial(jb._kernel_e1, n_heads=H, eps=EPS, prec=prec, interpret=True),
        grid=grid, in_specs=[tile, tile, sm_s] + [full] * len(e1_params), out_specs=rows,
        out_shape=jax.ShapeDtypeStruct((b, p, 1, 4 * D), f32), interpret=True,
    )(jnp.asarray(x), jnp.asarray(g1), sm[:, :, None], *e1_params)
    e_params = [rn["scale"], rn["bias"], la["wq"], la["bq"], la["wq"].T, la["wk"], la["bk"],
                la["wk"].T, la["wv"], la["bv"], la["wv"].T, la["wo"].T]
    shapes = [(b, p, l, D), (1, D), (1, D), (D, H), (1, H), (D, H), (1, H), (D, D), (1, D),
              (D, D), (1, D)]
    outs = pl.pallas_call(
        functools.partial(jb._kernel_e2, n_heads=H, eps=EPS, prec=prec, interpret=True),
        grid=grid,
        in_specs=[tile, tile, rows, sm_s, pl.BlockSpec(memory_space=pltpu.SMEM)]
        + [full] * len(e_params),
        out_specs=(tile,) + tuple(pl.BlockSpec(s, lambda *_, n=len(s): (0,) * n)
                                  for s in shapes[1:]),
        out_shape=tuple(jax.ShapeDtypeStruct(s, f32) for s in shapes), interpret=True,
    )(jnp.asarray(x), jnp.asarray(g1), rowsums, sm[:, :, None], jnp.sum(sm, axis=1)[:, None],
      *e_params)
    want = {"e1.rowsums": np.asarray(rowsums)[:, :, 0]}
    for name, v in zip(E2_NAMES, outs):
        v = np.asarray(v)
        want["e2." + name] = v if name == "gx" else (v[0] if v.shape[0] == 1 else v)
    return want


@pytest.fixture(scope="module")
def e12_case(tmp_path_factory):
    layer = _layer(29)
    rng = np.random.default_rng(35)
    x = rng.normal(size=(E12_B, E12_P, E12_L, D)).astype(np.float32)
    site_mask = np.repeat(np.arange(E12_L)[None] < E12_REAL_L, E12_B, 0)
    g1 = (rng.normal(size=x.shape) * site_mask[:, None, :, None]).astype(np.float32)
    want = _jax_e1_e2(layer, x, g1, site_mask, DEFAULT)
    inputs = {"x": x, "g1": g1, "site_mask": site_mask, "rowsums": want["e1.rowsums"]}
    inputs.update(flatten(layer, "layer"))
    got = run_port("""
from phyloformer_tpu_torch.ops.kernels import axial_block_bwd as bw
w = bw.BwdWeights.of(tree("layer"))
sm = t("site_mask", torch.float32)
OUT["e1.rowsums"] = bw.kernel_e1(t("x"), t("g1"), sm, w.e, 1e-5, 1)
OUT["e1.rowsums.3"] = bw.kernel_e1(t("x"), t("g1"), sm, w.e, 1e-5, 3)
# E2 on the reference's row sums, so each comparison is one kernel
gx, de = bw.kernel_e2(t("x"), t("g1"), t("rowsums"), sm, w.e, 1e-5, 1)
OUT["e2.gx"] = gx
for sub, leaves in bw.unpack_grads("kernel_e", de, 64, 4, {}).items():
    for leaf, v in leaves.items():
        OUT[f"e2.{sub}/{leaf}"] = v
""", inputs, tmp_path_factory.mktemp("port_e12_one_pass"))
    return got, want


@pytest.mark.parametrize("name", ["e1.rowsums"] + ["e2." + n for n in E2_NAMES])
def test_one_pass_e1_e2_match_jax(name, e12_case):
    """e1.rowsums = _kernel_e1's (B, P, 4d) sums (the port's E1 sums in fp32
    at one pass too: the same as at three); e2.* = _kernel_e2 on them at
    ``Precision.DEFAULT``: gx and every row weight gradient, 1100 sites."""
    got, want = e12_case
    g, r = got[name], want[name]
    assert g.shape == r.shape, (g.shape, r.shape)
    assert np.isfinite(g).all()
    assert _rel_err(g, r) <= GATE, _rel_err(g, r)
    if name == "e1.rowsums":
        np.testing.assert_array_equal(g, got["e1.rowsums.3"])


# ---- one block under autograd --------------------------------------------------

# name: (batch, pairs, sites, real pairs, real sites)
BLOCK_CASES = {"resident": (2, 30, 48, 21, 37), "ltiled": (1, 6, 1100, 6, 1061)}


@pytest.fixture(scope="module")
def block_case(tmp_path_factory):
    from phyloformer_tpu.models.params import PhyloformerConfig
    from phyloformer_tpu.ops.pallas.autodiff import fused_axial_block_ad

    cfg = PhyloformerConfig(n_blocks=1, n_heads=H, embed_dim=D, matmul_precision="default")
    layer = _layer(31)
    inputs, want = flatten(layer, "layer"), {}
    for k, (case, (b, p, l, real_p, real_l)) in enumerate(BLOCK_CASES.items()):
        rng = np.random.default_rng(40 + k)
        x = rng.normal(size=(b, p, l, D)).astype(np.float32)
        sm = np.repeat(np.arange(l)[None] < real_l, b, 0)
        pm = np.repeat(np.arange(p)[None] < real_p, b, 0)
        g = (rng.normal(size=x.shape) * sm[:, None, :, None] * pm[:, :, None, None]).astype(
            np.float32)
        smj, pmj, gj = jnp.asarray(sm), jnp.asarray(pm), jnp.asarray(g)

        def loss(x_, layer_):
            return jnp.sum(fused_axial_block_ad(x_, layer_, smj, pmj, cfg, True, "default") * gj)

        v, (gx, gl) = jax.value_and_grad(loss, argnums=(0, 1))(jnp.asarray(x), layer)
        out = np.asarray(fused_axial_block_ad(jnp.asarray(x), layer, smj, pmj, cfg, True,
                                              "default"))
        want[f"{case}.out"] = out
        want[f"{case}.loss_scale"] = np.abs(out * g).sum()
        want[f"{case}.loss"] = np.asarray(v)
        want[f"{case}.gx"] = np.asarray(gx)
        want.update({f"{case}.{a}/{n}": np.asarray(gl[a][n]) for a, n in LEAVES})
        inputs.update({f"{case}.x": x, f"{case}.sm": sm, f"{case}.pm": pm, f"{case}.g": g})
    got = run_port(f"""
from phyloformer_tpu_torch.models.params import PhyloformerConfig
from phyloformer_tpu_torch.ops.kernels import pipeline
from phyloformer_tpu_torch.ops.kernels.autodiff import LAYER_LEAVES, fused_axial_block_ad
cfg = PhyloformerConfig(n_blocks=1, matmul_precision="default")
for case in {list(BLOCK_CASES)!r}:
    layer = tree("layer")
    for a, b in LAYER_LEAVES:
        layer[a][b].requires_grad_(True)
    x = t(case + ".x").requires_grad_(True)
    out = fused_axial_block_ad(x, layer, t(case + ".sm", torch.float32),
                               t(case + ".pm", torch.float32), cfg, mxu_precision="default")
    loss = (out * t(case + ".g")).sum()
    loss.backward()
    OUT[case + ".out"] = out
    OUT[case + ".loss"] = loss
    OUT[case + ".gx"] = x.grad
    for a, b in LAYER_LEAVES:
        OUT[f"{{case}}.{{a}}/{{b}}"] = layer[a][b].grad
OUT["cpu_launches"] = sum(pipeline.LAUNCHES.values())
""", inputs, tmp_path_factory.mktemp("port_block_one_pass"))
    return got, want


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_one_pass_block_gradients_match_jax(case, block_case):
    """The block's output, gx and every weight gradient at "default", up to
    1024 sites (kernels A, B; C, D, E) and at 1100 (A1, A2, B; C, D, E1, E2
    on the port's side), and the loss Σ out·g: a sum of terms of both signs,
    so its error is held to the gate of Σ|out·g|."""
    got, want = block_case
    assert int(got["cpu_launches"]) == 0  # the CPU runs the plain versions
    assert _rel_err(got[f"{case}.out"], want[f"{case}.out"]) <= GATE
    loss, ref = float(got[f"{case}.loss"]), float(want[f"{case}.loss"])
    assert abs(loss - ref) <= GATE * float(want[f"{case}.loss_scale"]), (loss, ref)
    assert _rel_err(got[f"{case}.gx"], want[f"{case}.gx"]) <= GATE
    for a, n in LEAVES:
        g, r = got[f"{case}.{a}/{n}"], want[f"{case}.{a}/{n}"]
        assert g.shape == r.shape and np.isfinite(g).all(), (a, n)
        assert _rel_err(g, r) <= GATE, (a, n, _rel_err(g, r))


# ---- train steps -----------------------------------------------------------------

STEP_SEQ = ["b0", "b1", "b0"]
PRECISIONS = ("default", "tensorfloat32")


@pytest.fixture(scope="module")
def step_case(tmp_path_factory):
    from phyloformer_tpu.models.params import PhyloformerConfig, init_params
    from phyloformer_tpu.train import TrainConfig, create_train_state, make_train_step

    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0.0, 0.05, a.shape)).astype(np.float32),
        init_params(jax.random.PRNGKey(6), PhyloformerConfig(
            n_blocks=2, n_heads=4, embed_dim=32)))
    # off φ's exponential branch for every head, as in test_torch_train's
    # step fixture: a q/k bias whose gradient is exactly 0 in real numbers
    # would take its sign from rounding residue, which Adam scales to ±lr
    for ly in params["layers"]:
        for attn in ("row_attn", "col_attn"):
            for k in ("bq", "bk"):
                ly[attn][k] = ly[attn][k] + np.float32(2.0)
    batches = {"b0": _toy_batch(2, 7, 24, 11), "b1": _toy_batch(2, 7, 24, 12)}
    inputs = {f"{k}.{n}": v for k, b in batches.items() for n, v in b.items()}
    inputs.update(flatten(params, "params"))
    want = {}
    for prec in PRECISIONS:
        cfg = PhyloformerConfig(n_blocks=2, n_heads=4, embed_dim=32, matmul_precision=prec)
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=50, use_pallas=True)
        state, tx = create_train_state(cfg, tcfg, params=jax.tree_util.tree_map(
            jnp.asarray, params))
        step = make_train_step(cfg, tcfg, tx)
        for i, name in enumerate(STEP_SEQ):
            state, logs = step(state, batches[name], jax.random.PRNGKey(0))
            for k in ("train_loss", "grad_norm"):
                want[f"{prec}.{i}.{k}"] = np.asarray(logs[k])
        want.update(flatten(jax.tree_util.tree_map(np.asarray, state["params"]),
                            f"{prec}.params"))
    got = run_port(f"""
from phyloformer_tpu_torch.models.params import PhyloformerConfig
from phyloformer_tpu_torch.train.trainer import TrainConfig, create_train_state, make_train_step
from phyloformer_tpu_torch.ops.kernels import pipeline
batches = {{k: {{n: IN[f"{{k}}.{{n}}"] for n in ("codes", "dists", "site_mask", "seq_mask")}}
           for k in ("b0", "b1")}}
for prec in {PRECISIONS!r}:
    cfg = PhyloformerConfig(n_blocks=2, n_heads=4, embed_dim=32, matmul_precision=prec)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=50, use_pallas=True)
    state, tx = create_train_state(cfg, tcfg, params=tree("params"), device="cpu")
    step = make_train_step(cfg, tcfg, tx)
    for i, name in enumerate({STEP_SEQ!r}):
        state, logs = step(state, batches[name])
        for k in ("train_loss", "grad_norm"):
            OUT[f"{{prec}}.{{i}}.{{k}}"] = np.asarray(float(logs[k]))
    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(prefix + "/" + k, v)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                rec(prefix + "/" + str(i), v)
        else:
            OUT[prefix] = node
    rec(prec + ".params", state["params"])
OUT["cpu_launches"] = sum(pipeline.LAUNCHES.values())
""", inputs, tmp_path_factory.mktemp("port_steps_one_pass"))
    return got, want


@pytest.mark.parametrize("prec", PRECISIONS)
def test_one_pass_train_steps_match_jax(prec, step_case):
    got, want = step_case
    assert int(got["cpu_launches"]) == 0  # the CPU runs the plain versions
    for i in range(len(STEP_SEQ)):
        for k in ("train_loss", "grad_norm"):
            v, ref = float(got[f"{prec}.{i}.{k}"]), float(want[f"{prec}.{i}.{k}"])
            assert np.isfinite(v) and abs(v - ref) <= GATE * abs(ref), (i, k, v, ref)
    keys = [k for k in want if k.startswith(prec + ".params/")]
    assert len(keys) == 2 * 26 + 4
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], atol=2e-4, err_msg=k)


# ---- the one-pass weight-gradient product --------------------------------------------

@pytest.fixture(scope="module")
def product_case(tmp_path_factory):
    rng = np.random.default_rng(92)
    a = rng.normal(0.0, 1.0, (512, 64)).astype(np.float32)  # sites x channels
    b = rng.normal(0.0, 1.0, (512, 64)).astype(np.float32)
    got = run_port("""
from phyloformer_tpu_torch.ops.kernels.axial_block_bwd import _mm_at
OUT["one"] = _mm_at(t("a"), t("b"), 1)
OUT["three"] = _mm_at(t("a"), t("b"), 3)
""", {"a": a, "b": b}, tmp_path_factory.mktemp("product_at"))
    return a, b, got


def test_one_pass_weight_gradient_is_the_rounded_operands_product(product_case):
    a, b, got = product_case
    ref = _tf32_rna_np(a).astype(np.float64).T @ _tf32_rna_np(b).astype(np.float64)
    exact = a.astype(np.float64).T @ b.astype(np.float64)
    scale = max(1.0, np.abs(ref).max())
    assert np.abs(got["one"] - ref).max() / scale <= 2e-6
    # one pass is TF32's rounding away from the fp32 product; three are not
    assert np.abs(got["one"] - exact).max() / scale >= 1e-5
    assert np.abs(got["three"] - exact).max() / scale <= 2e-6
