"""The split-TF32 products of backward kernels C, D, E and E2, on the CPU.

Kernels C, D, E and E2 (``csrc/axial_bwd_tc.cu``) run every product on the
tensor cores as ``mma.m16n8k8`` TF32 in three passes, as the forward kernels
do (``tests/test_torch_tf32.py``).  Their weights arrive packed once per
layer (``axial_block_bwd.c_group`` / ``e_group``, ``pipeline.pack_mma``; D
reads the column attention's ``e_group``, E and E2 the row attention's);
their weight gradients are products with the sites as K, both operands split
in the kernel.  The kernels run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); here:

- every packed matrix of C's, D's and E's groups, for all six layers of
  ``artifacts/pf_mre_r5.ckpt``, unpacks to the split of its weight bit for
  bit, and the flat groups are unchanged by the packing;
- a numpy transcription of the weight-gradient product (both operands split,
  32-site tiles as the mma K-steps, fp32 sums per k-step and pass) on seeded
  operands of the kernels' shapes is within 2e-6 of float64, relative to
  max(1, max|ref|); one TF32 pass is not;
- the constants of ``axial_bwd.cuh`` (layouts, tile, the shared memory of
  a C, a D and an E or E2 block, and kernel E1's layout and ring, which
  ``axial_bwd.cu`` reports) agree with the wrapper, the blocks fit an
  H100 SM as ``BLOCKS_PER_SM`` promises, and the tile swizzle makes the
  kernels' fragment reads (straight, ldmatrix and transposed)
  conflict-free.
"""

import math
import pathlib
import re

import numpy as np
import pytest
import torch

from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.ops.kernels import axial_block_bwd as bw
from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

REPO = pathlib.Path(__file__).resolve().parent.parent
CSRC = REPO / "phyloformer_tpu_torch" / "ops" / "kernels" / "csrc"
CKPT = REPO / "artifacts" / "pf_mre_r5.ckpt"
D, H = pipe.D_KERNEL, bw.N_HEADS_KERNEL
PRODUCT_TOL = 2e-6
SM_BYTES = 228 * 1024      # shared memory of an H100 SM
BLOCK_MAX = 232448         # the most one block may take
RESERVED = 1024            # the card's reserve per resident block


@pytest.fixture(scope="module")
def layers():
    params, cfg, _ = load_pretrained(str(CKPT))
    assert cfg.n_blocks == 6
    return params["layers"]


def _split(x: np.ndarray):
    big = pipe.tf32_rna(torch.from_numpy(x)).numpy()
    return big, pipe.tf32_rna(torch.from_numpy(x - big)).numpy()


def _mats(kind, group):
    if kind == "c":
        parts = dict(zip(bw.C_PARTS, group.parts))
        return [parts[n] for n in bw.C_MMA_MATS]
    return list(bw.e_mma_mats(dict(zip(bw.ATT_PARTS, group.parts))))


@pytest.mark.parametrize("layer", range(6))
@pytest.mark.parametrize("kind", ["c", "e", "d"])
def test_backward_groups_pack_round_trip(kind, layer, layers):
    """C's six and D's and E's four packed matrices (the column and the row
    attention's, in one layout) unpack to the split of the weight bit for
    bit, in the order the kernels read them; the group's flat buffer is its
    parts' concatenation (what E1 reads)."""
    w = bw.BwdWeights.of(layers[layer])
    group = {"c": w.c, "d": w.d, "e": w.e}[kind]
    packed = group.mma.numpy()
    assert packed.size == bw.mma_size("kernel_" + kind, D, H)
    off = 0
    for m in _mats(kind, group):
        K, N = m.shape
        big, small = _split(m.numpy())
        got = pipe.unpack_mma(torch.from_numpy(packed[off:off + 2 * K * N]), K, N)
        np.testing.assert_array_equal(got[0].numpy().view(np.uint32), big.view(np.uint32))
        np.testing.assert_array_equal(got[1].numpy().view(np.uint32), small.view(np.uint32))
        off += 2 * K * N
    assert off == packed.size
    flat = torch.cat([p.reshape(-1) for p in group.parts])
    assert torch.equal(group.flat, flat)
    if kind != "c":  # the flat layout of the attention groups, unchanged by the packing
        norm, attn = ("col_norm", "col_attn") if kind == "d" else ("row_norm", "row_attn")
        assert torch.equal(group.flat, bw.att_group(layers[layer][norm],
                                                    layers[layer][attn]).flat)


def test_packing_only_at_the_kernels_shape():
    """Narrower test models (other d or head counts) get no packed copy."""
    rng = np.random.default_rng(0)
    d, h = 16, 2

    def t(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    att = {"wq": t(d, h), "bq": t(h), "wk": t(d, h), "bk": t(h), "wv": t(d, d), "bv": t(d),
           "wo": t(d, d), "bo": t(d)}
    norm = {"scale": t(d), "bias": t(d)}
    layer = {"row_norm": norm, "row_attn": att, "col_norm": norm, "col_attn": att,
             "ffn_norm": norm, "ffn": {"w1": t(d, 4 * d), "b1": t(4 * d), "w2": t(4 * d, d),
                                       "b2": t(d)}}
    w = bw.BwdWeights.of(layer)
    assert w.c.mma.numel() == 0 and w.d.mma.numel() == 0 and w.e.mma.numel() == 0


def _grad_3pass(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The kernels' weight gradient x^T y, transcribed: both operands split
    per element, the sites in tiles of BT and each tile in k-steps of 8; per
    k-step the passes small·big, big·small, big·big each added to the tile's
    fp32 accumulator, which starts at zero (grad_tile); the tiles' sums are
    added to a running fp32 sum.  (The tensor cores' own accumulation does
    not round to nearest, which numpy cannot mimic: the card tests hold the
    kernels themselves.)"""
    xb, xs = _split(x)
    yb, ys = _split(y)
    total = np.zeros((x.shape[1], y.shape[1]), np.float32)
    for t0 in range(0, x.shape[0], bw.TC_TILE_SITES):
        acc = np.zeros_like(total)
        for k0 in range(t0, t0 + bw.TC_TILE_SITES, 8):
            ks = slice(k0, k0 + 8)
            for a, b in ((xs, yb), (xb, ys), (xb, yb)):
                acc = (acc + (a[ks].T @ b[ks]).astype(np.float32)).astype(np.float32)
        total = (total + acc).astype(np.float32)
    return total


def _gelu(a):
    return (0.5 * a * (1 + np.vectorize(math.erf)(a / np.sqrt(2)))).astype(np.float32)


# (name, x columns, y columns): C's dW1 = hf^T du, dW2 = a^T g3, dWo_c =
# attn^T g2; E's and E2's dWv = h^T dv, dWo = attn^T g1, [dWq | dWk] =
# h^T [dzq | dzk]; D's dWv = hc^T dv and [dWq | dWk] = hc^T [dzq | dzk].
PRODUCTS = [("c_dw1", "ln", "small"), ("c_dw2", "gelu", "grad"), ("c_dwo", "attn", "grad"),
            ("e_dwv", "ln", "small"), ("e_dwo", "attn", "grad"), ("e_dwqk", "ln", "dz"),
            ("d_dwv", "ln", "small"), ("d_dwqk", "ln", "dz"), ("e2_dwv", "ln", "small"),
            ("e2_dwo", "attn", "grad"), ("e2_dwqk", "ln", "dz")]


@pytest.mark.parametrize("name,xk,yk", PRODUCTS)
def test_three_pass_weight_gradient_keeps_fp32(name, xk, yk):
    """Over 8 tiles of 32 sites of seeded operands shaped like the kernels'
    (a LayerNorm output, a GELU output or an attention output against
    gradients of about unit or 1e-2 scale; 8 columns for [dzq | dzk]): the
    3-pass product within PRODUCT_TOL of float64, like the fp32 product; the
    1-pass product far outside it."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n = 8 * bw.TC_TILE_SITES
    xs = {"ln": lambda: rng.standard_normal((n, D)),
          "gelu": lambda: _gelu(rng.standard_normal((n, D)).astype(np.float32)),
          "attn": lambda: rng.standard_normal((n, D)) * rng.uniform(0.2, 3.0, (1, D))}
    ys = {"small": lambda: rng.standard_normal((n, D)) * 1e-2,
          "grad": lambda: rng.standard_normal((n, D)),
          "dz": lambda: rng.standard_normal((n, 2 * H)) * 0.3}
    x = np.asarray(xs[xk](), np.float32)
    y = np.asarray(ys[yk](), np.float32)
    ref = x.astype(np.float64).T @ y.astype(np.float64)
    scale = max(1.0, np.abs(ref).max())
    err3 = np.abs(_grad_3pass(x, y) - ref).max() / scale
    err32 = np.abs((x.T @ y).astype(np.float32) - ref).max() / scale
    xb, _ = _split(x)
    yb, _ = _split(y)
    err1 = np.abs((xb.T @ yb).astype(np.float32) - ref).max() / scale
    assert err3 <= PRODUCT_TOL and err32 <= PRODUCT_TOL, (err3, err32)
    assert err1 > 10 * PRODUCT_TOL, err1


def _constants() -> dict:
    """The ``constexpr int`` constants of axial_pipeline.cuh, then those of
    axial_bwd.cuh, evaluated in order."""
    consts = {}
    for name in ("axial_pipeline.cuh", "axial_bwd.cuh"):
        for k, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", (CSRC / name).read_text()):
            consts[k] = int(eval(expr, {}, dict(consts)))
    return consts


def _struct_bytes(name: str, c: dict) -> int:
    """sizeof of a shared-memory struct of axial_bwd.cuh, from its fields."""
    text = (CSRC / "axial_bwd.cuh").read_text()
    body = text[text.index(f"struct {name} {{"):]
    body = body[:body.index("};")]
    size = 0
    for typ, dims in re.findall(r"^\s*(float4|float) \w+((?:\[[^\]]+\])*);", body, re.M):
        n = 1
        for dim in re.findall(r"\[([^\]]+)\]", dims):
            n *= int(eval(dim, {}, dict(c)))
        size += n * (16 if typ == "float4" else 4)
    return size


def test_backward_header_matches_the_wrapper(layers):
    """Sizes and offsets of the flat and packed layouts, the gradient
    vectors and the tile, as the wrapper has them (TC_LAYOUT is what it
    checks the built library against, in pf_bwd_tc_sizes' order), then the
    shared memory of a C, a D and an E or E2 block, which the library
    reports after them and each launch requests; the same for kernel E1
    (E1_LAYOUT, pf_bwd_sizes in axial_bwd.cu, and its block's SmemE1)."""
    c = _constants()
    src = (CSRC / "axial_bwd.cu").read_text()
    body = src[src.index("int pf_bwd_sizes"):]
    body = body[:body.index("return 0;")]
    order = dict((int(k), v) for k, v in re.findall(r"out\[(\d+)\] = ([\w *]+?);", body))
    assert tuple(int(eval(order[k], {}, dict(c))) for k in range(len(bw.E1_LAYOUT))) == \
        bw.E1_LAYOUT
    assert re.search(rf"out\[{len(bw.E1_LAYOUT)}\] = \(int\)sizeof\(SmemE1\);", body)
    assert "cudaFuncSetAttribute(kernel_e1, cudaFuncAttributeMaxDynamicSharedMemorySize" in src
    assert re.search(r"kernel_e1<<<[^>]*sizeof\(SmemE1\)", src)
    assert c["TS"] == pipe.TILE_SITES and c["E1_PART"] == bw.E1_PART
    src = (CSRC / "axial_bwd_tc.cu").read_text()
    body = src[src.index("int pf_bwd_tc_sizes"):]
    body = body[:body.index("return 0;")]
    order = dict((int(k), v) for k, v in re.findall(r"out\[(\d+)\] = (\w+);", body))
    assert tuple(c[order[k]] for k in range(len(bw.TC_LAYOUT))) == bw.TC_LAYOUT
    smem = dict((int(k), v) for k, v in re.findall(r"out\[(\d+)\] = \(int\)sizeof\((\w+)\);",
                                                   body))
    n = len(bw.TC_LAYOUT)
    assert [smem[k] for k in range(n, n + 3)] == ["SmemC", "SmemD", "SmemE"]
    for kernel, struct in (("kernel_c", "SmemC"), ("kernel_d", "SmemD"), ("kernel_e", "SmemE"),
                           ("kernel_e2", "SmemE")):
        assert f"allow_smem_of<{struct}>({kernel});" in src, kernel
        assert re.search(rf"{kernel}<<<[^>]*sizeof\({struct}\)", src), kernel
    assert c["BT"] == bw.TC_TILE_SITES and c["H"] == H
    w = bw.BwdWeights.of(layers[0])
    offsets = np.cumsum([0] + [p.numel() for p in w.c.parts])
    cb = ["CB_CNS", "CB_CNB", "CB_CWQE", "CB_CBQE", "CB_CWO", "CB_CWOT", "CB_CBO", "CB_FNS",
          "CB_FNB", "CB_W1", "CB_B1", "CB_W1T", "CB_W2T", "CB_CWQ", "CB_CBQ", "CB_SIZE"]
    assert [c[n] for n in cb] == list(offsets)
    offsets = np.cumsum([0] + [p.numel() for p in w.e.parts])
    ag = ["AG_LNS", "AG_LNB", "AG_WQE", "AG_BQE", "AG_WKE", "AG_BKE", "AG_WV", "AG_BV",
          "AG_WOT", "AG_WQ", "AG_BQ", "AG_WK", "AG_BK", "AG_WVT", "AG_SIZE"]
    assert [c[n] for n in ag] == list(offsets)
    ctm = ["CTM_CWQ", "CTM_CWO", "CTM_CWOT", "CTM_W1", "CTM_W1T", "CTM_W2T", "CTM_SIZE"]
    assert [c[n] for n in ctm] == list(np.cumsum([0] + [2 * m.numel() for m in _mats("c", w.c)]))
    em = ["EM_WQK", "EM_WV", "EM_WOT", "EM_WDH", "EM_SIZE"]
    assert [c[n] for n in em] == list(np.cumsum([0] + [2 * m.numel() for m in _mats("e", w.e)]))
    for kernel, names in (("kernel_c", ["WC_CWO", "WC_CBO", "WC_FNS", "WC_FNB", "WC_W1",
                                        "WC_B1", "WC_W2", "WC_B2", "NWC"]),
                          ("kernel_d", ["WA_LNS", "WA_LNB", "WA_WQ", "WA_BQ", "WA_WK", "WA_BK",
                                        "WA_WV", "WA_BV", "NWD"]),
                          ("kernel_e", ["WA_LNS", "WA_LNB", "WA_WQ", "WA_BQ", "WA_WK", "WA_BK",
                                        "WA_WV", "WA_BV", "WA_WO", "WA_BO", "NWE"])):
        sizes = [math.prod(s) for _, _, s in bw.grad_spec(kernel, D, H)]
        assert [c[n] for n in names] == list(np.cumsum([0] + sizes)), kernel


def test_backward_blocks_fit_as_promised():
    """C's block (tiles, split planes and its 128 KB of FFN gradients) fits
    an H100 SM once and not twice; D's block (its tiles, split planes and
    the tile's per-site terms), E's, which E2 runs, and E1's (its warps'
    rings of x and g1 tiles) fit twice and not three times: the blocks per
    SM of BLOCKS_PER_SM, whose grid is one wave.  E1's two blocks a SM
    leave each thread up to 255 registers."""
    c = _constants()
    smem_c, smem_d = _struct_bytes("SmemC", c), _struct_bytes("SmemD", c)
    smem_e, smem_e1 = _struct_bytes("SmemE", c), _struct_bytes("SmemE1", c)
    assert c["CGRAD"] * 4 == 128 * 1024
    assert smem_c <= BLOCK_MAX and smem_c + RESERVED <= SM_BYTES < 2 * (smem_c + RESERVED)
    for smem in (smem_d, smem_e, smem_e1):
        assert smem <= BLOCK_MAX and 2 * (smem + RESERVED) <= SM_BYTES < 3 * (smem + RESERVED)
    assert smem_e1 == c["E1_WARPS"] * c["E1_RING"] * 2 * c["TS"] * D * 4 == 96 * 1024
    assert bw.BLOCKS_PER_SM["kernel_c"] == 1 and bw.BLOCKS_PER_SM["kernel_e"] == 2
    assert bw.BLOCKS_PER_SM["kernel_d"] == 2 and bw.BLOCKS_PER_SM["kernel_e2"] == 2
    assert bw.BLOCKS_PER_SM["kernel_e1"] == 2 and c["E1_WARPS"] == bw.E1_WARPS
    assert 2 * bw.E1_WARPS * 32 * 255 <= 65536


def test_tile_swizzle_is_conflict_free():
    """Element (r, c) at r BXS + (c ^ (r & 4)), BXS = 72 (and 8 for E's dz
    planes): an mma A fragment read straight (rows g, columns t), an
    ldmatrix phase (8 rows of 4 floats) and a weight-gradient fragment read
    transposed (rows t, columns g) each hit 32 distinct banks from every
    aligned base; float2 pairs and float4 chunks stay together."""
    c = _constants()
    for stride, width in ((c["BXS"], D), (c["DZS"], 2 * H)):
        def at(r, col):
            return r * stride + (col ^ (r & 4))
        for r0 in range(0, c["BT"], 8):
            for c0 in range(0, width, 8):
                for half in (0, 4):
                    banks = {at(r0 + g, c0 + half + t) % 32 for g in range(8) for t in range(4)}
                    assert len(banks) == 32
        for r0 in range(0, c["BT"], 4):
            for c0 in range(0, width, 8):
                banks = {at(r0 + t, c0 + g) % 32 for g in range(8) for t in range(4)}
                assert len(banks) == 32
        for r0 in range(0, c["BT"], 8):
            for c0 in range(0, width, 4):
                rows = [at(r0 + g, c0) for g in range(8)]
                assert all(a % 4 == 0 for a in rows)  # 16-byte aligned rows
                assert len({(a + q) % 32 for a in rows for q in range(4)}) == 32
        assert all(at(r, c0 + q) == at(r, c0) + q for r in range(8)
                   for c0 in range(0, width, 4) for q in range(4))
