"""Kernel E1's association against the TPU kernel's, on the CPU.

The CUDA kernel E1 (``csrc/axial_bwd.cu``) sums each pair's row in another
association than the TPU kernel ``_kernel_e1``: it accumulates
``M = Σ_l g1ᵀ qH`` and ``N = Σ_l hᵀ kH`` (d x H a pair) over the sites and
contracts them with ``Wo^T`` and ``Wv`` once a pair, where the TPU kernel
forms ``v`` and ``d_attn`` at every site.  Its eager twin
``kernel_e1_factored`` is that association; the kernel itself runs only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Here, on seeded
inputs:

- the twin against ``kernel_e1_plain`` (the TPU kernel's association) and
  against ``_kernel_e1`` in interpret mode (HIGHEST products, 48-site
  tiles), at 134, 1100 and 1536 sites, with a ragged site mask, a batch
  element whose every site is masked, and a gapped MSA (x from a random
  embedding of alignments with 30% gaps): 1e-5 relative to
  max(1, max|ref|), the bar of ``chip_smoke.E12_TOL`` (row sums over up to
  1536 sites, taken in another order);
- the same two forms in float64: within 1e-12, so the association is exact
  algebra and the fp32 differences are rounding.

The port runs in a subprocess (:func:`test_torch_model.run_port`).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from test_torch_model import flatten, random_params, run_port
from test_torch_train import _layer, _rel_err

EPS = 1e-5
D, H = 64, 4
TILE = 48  # the JAX package's L-tiled backward tile (test_pallas_kernels.py)
TOL = 1e-5
TOL_F64 = 1e-12

# name: (seed, B, P, L, real sites per batch element, gap fraction or None)
CASES = {
    "l134_ragged": (31, 2, 5, 134, (134, 101), None),
    "l1100_masked_row": (32, 2, 4, 1100, (1077, 0), None),
    "l1536": (33, 1, 3, 1536, (1536,), None),
    "l1536_gapped_msa": (34, 2, 6, 1536, (1536, 1290), 0.3),
}


def _inputs(seed, b, p, l, real_l, gap):
    """x (normal, or the pair sums of a random embedding of gapped
    alignments of 4 tips), a cotangent g1 masked as a masked loss makes it,
    and the site mask."""
    rng = np.random.default_rng(seed)
    site_mask = np.arange(l)[None] < np.asarray(real_l)[:, None]
    if gap is None:
        x = rng.normal(size=(b, p, l, D)).astype(np.float32)
    else:
        embed = random_params(seed, 1)[0]["embed"]
        codes = rng.integers(0, 20, (b, 4, l))
        codes[rng.random(codes.shape) < gap] = 21  # '-'
        emb = np.maximum(embed["w"][codes] + embed["b"], 0.0)
        i, j = np.triu_indices(4, 1)
        x = (emb[:, i] + emb[:, j]).astype(np.float32)
    g1 = rng.normal(size=(b, p, l, D)).astype(np.float32) * site_mask[:, None, :, None]
    return x, g1, site_mask


def _jax_e1(layer, x, g1, site_mask):
    """_kernel_e1 on the site axis padded to a multiple of TILE, as the JAX
    host function runs it: grid (B, 1 pair tile, site tiles)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from phyloformer_tpu.ops.pallas import axial_block_bwd as jb

    b, p, l, _ = x.shape
    f32 = jnp.float32
    lp = -(-l // TILE) * TILE
    pad = ((0, 0), (0, 0), (0, lp - l), (0, 0))
    xp, gp = jnp.pad(jnp.asarray(x), pad), jnp.pad(jnp.asarray(g1), pad)
    smp = jnp.pad(jnp.asarray(site_mask, f32), ((0, 0), (0, lp - l)))
    la, rn = layer["row_attn"], layer["row_norm"]
    full = pl.BlockSpec(memory_space=pltpu.VMEM)
    tile = pl.BlockSpec((1, p, TILE, D), lambda bi, pi, li: (bi, pi, li, 0))
    sm_s = pl.BlockSpec((1, TILE, 1), lambda bi, pi, li: (bi, li, 0))
    rows = pl.BlockSpec((1, p, 1, 4 * D), lambda bi, pi, li: (bi, pi, 0, 0))
    params = [rn["scale"], rn["bias"], la["wq"], la["bq"], la["wk"], la["bk"], la["wv"],
              la["bv"], la["wo"].T]
    out = pl.pallas_call(
        functools.partial(jb._kernel_e1, n_heads=H, eps=EPS, prec=jax.lax.Precision.HIGHEST,
                          interpret=True),
        grid=(b, 1, lp // TILE), in_specs=[tile, tile, sm_s] + [full] * len(params),
        out_specs=rows, out_shape=jax.ShapeDtypeStruct((b, p, 1, 4 * D), f32), interpret=True,
    )(xp, gp, smp[:, :, None], *params)
    return np.asarray(out)[:, :, 0]


@pytest.fixture(scope="module")
def e1_forms(tmp_path_factory):
    layer = _layer(29)
    want, inputs = {}, flatten(layer, "layer")
    for name, case in CASES.items():
        x, g1, site_mask = _inputs(*case)
        with jax.default_matmul_precision("float32"):
            want[name] = _jax_e1(layer, x, g1, site_mask)
        inputs.update({f"{name}.x": x, f"{name}.g1": g1, f"{name}.site_mask": site_mask})
    got = run_port(f"""
from phyloformer_tpu_torch.ops.kernels import axial_block_bwd as bw
lay = tree("layer")
for name in {list(CASES)!r}:
    x, g1 = t(name + ".x"), t(name + ".g1")
    sm = t(name + ".site_mask", torch.float32)
    for suffix, dt in (("", torch.float32), (".f64", torch.float64)):
        cast = lambda d: {{k: v.to(dt) for k, v in d.items()}}
        we = bw.att_group(cast(lay["row_norm"]), cast(lay["row_attn"]))
        args = (x.to(dt), g1.to(dt), sm.to(dt), we, 1e-5)
        OUT[name + ".plain" + suffix] = bw.kernel_e1_plain(*args)
        OUT[name + ".factored" + suffix] = bw.kernel_e1_factored(*args)
""", inputs, tmp_path_factory.mktemp("port_e1"))
    return got, want


@pytest.mark.parametrize("ref", ["plain", "jax"])
@pytest.mark.parametrize("case", list(CASES))
def test_e1_factored_matches_the_tpu_kernel(case, ref, e1_forms):
    """kernel_e1_factored's (B, P, 4d) row sums against kernel_e1_plain and
    against _kernel_e1 (interpret mode) within 1e-5 relative to
    max(1, max|ref|); the plain version against _kernel_e1 too."""
    got, want = e1_forms
    factored = got[f"{case}.factored"]
    reference = got[f"{case}.plain"] if ref == "plain" else want[case]
    assert factored.shape == reference.shape == (CASES[case][1], CASES[case][2], 4 * D)
    assert np.isfinite(factored).all()
    err = _rel_err(factored, reference)
    assert err <= TOL, err
    if ref == "jax":
        err = _rel_err(got[f"{case}.plain"], reference)
        assert err <= TOL, err
    if case == "l1100_masked_row":  # every site of element 1 masked: all sums 0
        assert not factored[1].any()


@pytest.mark.parametrize("case", list(CASES))
def test_e1_association_is_exact_in_float64(case, e1_forms):
    """In float64 the factored and the plain association agree within 1e-12
    relative to max(1, max|ref|): the two differ only by rounding."""
    got, _ = e1_forms
    a, b = got[f"{case}.factored.f64"], got[f"{case}.plain.f64"]
    assert a.dtype == b.dtype == np.float64
    err = _rel_err(a, b)
    assert err <= TOL_F64, err
