"""The port's plain kernel versions against the JAX package's Pallas code, on
the CPU.

- Bodies: row attention, column stats, kernel B and the softplus head of
  ``phyloformer_tpu_torch.ops.kernels.axial_block`` against the JAX bodies
  ``_body_row_attn`` / ``_body_col_stats`` / ``_body_b`` (interpret layout,
  HIGHEST products).  Tolerance 1e-5 relative to the reference's magnitude:
  single operators, fp32 sums taken in another order.
- Pipeline: the port's ``forward_fused_pipeline`` (plain versions on the
  CPU) against JAX ``forward_fused_pipeline(interpret=True)``, with block 0
  as P0 and as A-only, GELU exact and tanh, 1 and 3 blocks.  Tolerance 5e-5
  max-abs on real pairs, the JAX package's own bar for its pipeline.

The port runs in a subprocess (:func:`test_torch_model.run_port`).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from test_torch_model import flatten, random_batch, random_params, real_pair_mask, run_port

EPS = 1e-5
N_HEADS = 4

# name: (seed, n_blocks, real dims, pad_n, pad_l, gap fraction, block 0, gelu)
PIPELINE_CASES = {
    "p0_exact_3blocks_ragged": (41, 3, [(9, 16), (6, 11)], 9, 16, 0.0, "p0", "exact"),
    "p0_tanh_1block": (42, 1, [(8, 12)] * 2, 8, 12, 0.0, "p0", "tanh"),
    "a_only_exact_1block_ragged": (43, 1, [(7, 14), (9, 16)], 9, 16, 0.0, "a_only", "exact"),
    "a_only_tanh_3blocks_gapped": (44, 3, [(9, 16), (5, 10)], 9, 16, 0.4, "a_only", "tanh"),
}


def _rel_err(got, want):
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


# ---- bodies -----------------------------------------------------------------

def _jax_groups(layer):
    from phyloformer_tpu.ops.pallas.pipeline import _b_params, _col_params, _row_params

    return _row_params(layer), _col_params(layer), _b_params(layer)


@pytest.fixture(scope="module")
def bodies_case(tmp_path_factory):
    from phyloformer_tpu.ops.pallas import axial_block as jab
    from phyloformer_tpu.ops.pallas.pipeline import _mm_b, _softplus

    params, _ = random_params(51, 1)
    layer = jab.expand_qk_weights(params["layers"][0])
    rp, cp, bp = (tuple(np.asarray(a) for a in g) for g in _jax_groups(layer))
    hw, hb = np.asarray(params["head"]["w"]), np.asarray(params["head"]["b"])

    rng = np.random.default_rng(52)
    b, p, l, d = 3, 10, 16, 64
    x = rng.normal(0.0, 1.0, (b, p, l, d)).astype(np.float32)
    smask = np.zeros((b, l), np.float32)
    smask[0, :] = 1.0
    smask[1, :11] = 1.0  # ragged sites; element 2 fully masked (zero-sum guards)
    pmask = np.zeros((b, p), np.float32)
    pmask[0, :] = 1.0
    pmask[1, :6] = 1.0
    n_pairs = np.maximum(pmask.sum(1), 1.0)

    prec, hd = jax.lax.Precision.HIGHEST, d // N_HEADS
    want = {"x1": [], "stats": [], "x3": [], "head": []}
    for i in range(b):
        sm = jnp.asarray(smask[i][:, None])
        x1 = jab._body_row_attn(jnp.asarray(x[i]), sm, rp, hd, EPS, prec, True)
        stats = jab._body_col_stats(x1, jnp.asarray(pmask[i][:, None, None]), cp, hd, EPS,
                                    prec, True)
        x3 = jab._body_b(x1, stats, jnp.float32(n_pairs[i]), bp, hd, EPS, prec, True)
        sp = _softplus(_mm_b(x3, jnp.asarray(hw), jnp.asarray(hb), prec))  # (P, L, 1)
        dist = jnp.sum(sp * sm[None], axis=1)[:, 0] / jnp.maximum(jnp.sum(sm), 1.0)
        for k, v in (("x1", x1), ("stats", stats), ("x3", x3), ("head", dist)):
            want[k].append(np.asarray(v))
    want = {k: np.stack(v) for k, v in want.items()}
    want["expanded"] = flatten(layer, "expanded")

    inputs = {"x": x, "smask": smask, "pmask": pmask, "n_pairs": n_pairs.astype(np.float32),
              "hw": hw, "hb": hb, "x1": want["x1"], "stats": want["stats"], "x3": want["x3"]}
    inputs.update(flatten(params["layers"][0], "layer"))
    got = run_port("""
from phyloformer_tpu_torch.ops.kernels.axial_block import (
    body_b, body_col_stats, body_row_attn, expand_qk_weights, head)
from phyloformer_tpu_torch.ops.kernels.pipeline import b_group, col_group, row_group
layer = expand_qk_weights(tree("layer"))
def flat(node, prefix):
    if isinstance(node, dict):
        for k, v in node.items():
            flat(v, prefix + "/" + k)
    else:
        OUT[prefix] = node
flat(layer, "expanded")
# each body on the reference's own inputs, so every comparison is one stage
OUT["x1"] = body_row_attn(t("x"), t("smask"), row_group(layer).parts, 1e-5)
OUT["stats"] = body_col_stats(t("x1"), t("pmask"), col_group(layer).parts, 1e-5)
OUT["x3"] = body_b(t("x1"), t("stats"), t("n_pairs"), b_group(layer).parts, 1e-5)
OUT["head"] = head(t("x3"), t("hw"), t("hb"), t("smask"))
""", inputs, tmp_path_factory.mktemp("port_bodies"))
    return got, want


def test_expand_qk_weights_matches_jax(bodies_case):
    got, want = bodies_case
    assert sorted(k for k in got if k.startswith("expanded/")) == sorted(want["expanded"])
    for k, v in want["expanded"].items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("body", ["x1", "stats", "x3", "head"])
def test_body_matches_jax(body, bodies_case):
    """x1 = _body_row_attn, stats = _body_col_stats, x3 = _body_b, head =
    _kernel_z's head and masked site mean."""
    got, want = bodies_case
    assert got[body].shape == want[body].shape
    assert np.isfinite(got[body]).all()
    err = _rel_err(got[body], want[body])
    assert err <= 1e-5, err


# ---- the pipelined forward ---------------------------------------------------

def _jax_pipeline(params, codes, site_mask, seq_mask, block0, gelu):
    import phyloformer_tpu.ops.pallas.pipeline as jpipe

    budget = jpipe._P0_EMB_BUDGET_BYTES
    if block0 == "a_only":
        # the budget is read at trace time and is not part of the jit key
        jpipe._P0_EMB_BUDGET_BYTES = 0
        jpipe._forward_pipeline_jit._clear_cache()
    try:
        out = jpipe.forward_fused_pipeline(
            params, jnp.asarray(codes), codes.shape[1], jnp.asarray(site_mask),
            jnp.asarray(seq_mask), n_heads=N_HEADS, eps=EPS, interpret=True,
            mxu_precision="highest", act_dtype_name="float32", gelu_mode=gelu)
        return np.asarray(out)
    finally:
        if block0 == "a_only":
            jpipe._P0_EMB_BUDGET_BYTES = budget
            jpipe._forward_pipeline_jit._clear_cache()


@pytest.fixture(scope="module")
def pipeline_case(tmp_path_factory):
    inputs, want = {}, {}
    for name, (seed, nb, dims, pad_n, pad_l, gap, block0, gelu) in PIPELINE_CASES.items():
        params, _ = random_params(seed, nb)
        codes, site_mask, seq_mask = random_batch(seed, dims, pad_n, pad_l, gap)
        inputs.update(flatten(params, f"{name}/params"))
        inputs.update({f"{name}.codes": codes, f"{name}.site_mask": site_mask,
                       f"{name}.seq_mask": seq_mask})
        want[name] = (_jax_pipeline(params, codes, site_mask, seq_mask, block0, gelu),
                      real_pair_mask(seq_mask))

    got = run_port(f"""
from phyloformer_tpu_torch.ops.kernels import pipeline as pipe
for name, (block0, gelu) in {
    {k: (v[6], v[7]) for k, v in PIPELINE_CASES.items()}!r}.items():
    # an embedding budget of 0 sends block 0 down the A-only route
    pipe.P0_EMB_BUDGET_BYTES = 4 * 1024 * 1024 if block0 == "p0" else 0
    codes = t(name + ".codes")
    b, n, l = codes.shape
    OUT[name + ".gather"] = pipe.uses_gather(n, l, 64)
    weights = pipe.PipelineWeights.from_params(tree(name + "/params"))
    OUT[name] = pipe.forward_fused_pipeline(weights, codes, t(name + ".site_mask"),
                                            t(name + ".seq_mask"), eps=1e-5, gelu_mode=gelu)
""", inputs, tmp_path_factory.mktemp("port_pipeline"))
    return got, want


@pytest.mark.parametrize("case", list(PIPELINE_CASES))
def test_pipeline_matches_jax(case, pipeline_case):
    got, want = pipeline_case
    ref, pm = want[case]
    assert bool(got[case + ".gather"]) == (PIPELINE_CASES[case][6] == "p0")
    assert got[case].shape == ref.shape
    assert np.isfinite(got[case][pm]).all()
    err = np.abs(got[case] - ref)[pm].max()
    assert err <= 5e-5, err
