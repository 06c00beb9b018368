"""The split-TF32 products of the forward kernels, on the CPU.

The forward kernels (``csrc/axial_bodies.cuh``: kernels A, B and every
kernel built from their bodies) run each product on the tensor cores as
``mma.m16n8k8`` TF32 in three passes: each operand is split into
``big = cvt.rna.tf32(x)`` and ``small = cvt.rna.tf32(x - big)`` and the
product is ``a_small·b_big + a_big·b_small + a_big·b_big``, accumulated in
fp32.  The weights arrive split and in fragment order
(``pipeline.pack_mma``, once per weight group); the activations are split in
the kernel.  The kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here:

- ``tf32_rna`` rounds as ``cvt.rna`` does (nearest, ties away from zero,
  the low 13 mantissa bits zero), against a transcription that picks the
  nearer of the two neighbouring TF32 values in float64;
- the packing of every weight group of ``artifacts/pf_mre_r5.ckpt``
  round-trips bit for bit, and each lane's float4 holds the fragment
  elements the kernel's index arithmetic expects;
- a numpy transcription of the kernel's product (A split per element, B
  from the packed weights, fp32 sums per k-step and pass) on the real
  weights and a seeded tile is within 2e-6 of a float64 product, relative to
  max(1, max|ref|): about fp32's own error.  One TF32 pass is not (about
  3e-4), which is why the kernels take three;
- the constants of ``axial_pipeline.cuh`` (tile sizes, weight offsets and
  sizes, the shared memory of a block) agree with the wrapper's, so a tile
  or layout changed on one side only fails here and not first on the card;
- kernel M's weight planes (``pipeline.pack_wg``: 64 x 64 blocks in the
  shared-memory image of its warpgroup MMA, w2's rows permuted so that an
  accumulator can be the A operand) unpack to every matrix of the B, row
  and column groups bit for bit, in the plane order the header declares.
"""

import math
import pathlib
import re

import numpy as np
import pytest
import torch

from phyloformer_tpu_torch.io.ckpt_import import load_pretrained
from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

REPO = pathlib.Path(__file__).resolve().parent.parent
CSRC = REPO / "phyloformer_tpu_torch" / "ops" / "kernels" / "csrc"
CKPT = REPO / "artifacts" / "pf_mre_r5.ckpt"
D = pipe.D_KERNEL
# The product bar: about the plain fp32 product's own error at these widths.
PRODUCT_TOL = 2e-6

# The matrices of each forward group, as (index in parts, K, N), in packing order.
GROUP_MATS = {
    "row": ((2, D, D), (4, D, D), (6, D, D), (8, D, D)),
    "col": ((2, D, D), (4, D, D), (6, D, D)),
    "b": ((2, D, D), (4, D, D), (8, D, 4 * D), (10, 4 * D, D)),
}


@pytest.fixture(scope="module")
def weights():
    params, cfg, _ = load_pretrained(str(CKPT))
    return pipe.PipelineWeights.from_params(params), cfg


def _rna_reference(x: np.ndarray) -> np.ndarray:
    """Nearest TF32 value of each float32, ties away from zero: the nearer
    of the truncation and the next TF32 value away from zero, in float64."""
    bits = x.astype(np.float32).view(np.uint32)
    lo = (bits & np.uint32(0xFFFFE000)).view(np.float32).astype(np.float64)
    hi = ((bits & np.uint32(0xFFFFE000)) + np.uint32(0x2000)).view(np.float32).astype(np.float64)
    xd = x.astype(np.float64)
    pick_hi = np.abs(hi - xd) <= np.abs(xd - lo)  # a tie goes to hi: away from zero
    return np.where(pick_hi, hi, lo).astype(np.float32)


def _split(x: np.ndarray):
    big = pipe.tf32_rna(torch.from_numpy(x)).numpy()
    return big, pipe.tf32_rna(torch.from_numpy(x - big)).numpy()


def test_tf32_rna_rounds_as_cvt_rna():
    """Random values over many binades, exact ties, the values beside them,
    both signs, zero: bit for bit the reference, low 13 bits zero."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(20000) * np.exp2(rng.integers(-30, 30, 20000))).astype(np.float32)
    base = rng.integers(0, 1 << 30, 4000, dtype=np.uint32) & np.uint32(0x7FFFE000)
    ties = (base | np.uint32(0x1000)).view(np.float32)
    near = np.concatenate([(base | np.uint32(0x0FFF)).view(np.float32),
                           (base | np.uint32(0x1001)).view(np.float32)])
    x = np.concatenate([x, ties, -ties, near, -near, np.float32([0.0, -0.0, 1.0, -1.0])])
    got = pipe.tf32_rna(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), _rna_reference(x).view(np.uint32))
    assert not (got.view(np.uint32) & np.uint32(0x1FFF)).any()
    # a tie rounds away from zero in magnitude
    assert (np.abs(pipe.tf32_rna(torch.from_numpy(ties)).numpy()) > np.abs(ties)).all()


def test_split_of_the_checkpoint_weights(weights):
    """big + small is each weight to 2^-22 of its magnitude; big is the
    reference rounding of the weight, small that of the remainder."""
    w, _ = weights
    mats = [g.parts[i] for kind, groups in (("row", w.row), ("col", w.col), ("b", w.b))
            for g in groups for i, _, _ in GROUP_MATS[kind]]
    x = torch.cat([m.reshape(-1) for m in mats]).numpy()
    big, small = _split(x)
    np.testing.assert_array_equal(big.view(np.uint32), _rna_reference(x).view(np.uint32))
    np.testing.assert_array_equal(small.view(np.uint32), _rna_reference(x - big).view(np.uint32))
    err = np.abs(big.astype(np.float64) + small - x) - np.exp2(-22) * np.abs(x)
    assert (err <= 0).all()


@pytest.mark.parametrize("layer", range(6))
@pytest.mark.parametrize("kind", list(GROUP_MATS))
def test_pack_mma_round_trips(kind, layer, weights):
    """Every matrix of every forward group of the checkpoint: unpacked from
    the group's mma buffer, its two planes equal the split of the weight bit
    for bit; each lane's float4 is (big b0, big b1, small b0, small b1) with
    b0 = W[8j + t, 8n + g], b1 = W[8j + t + 4, 8n + g], at float index
    4 ((j (N/8) + n) 32 + 4g + t), as the kernels read it."""
    w, cfg = weights
    assert cfg.n_blocks == 6
    group = {"row": w.row, "col": w.col, "b": w.b}[kind][layer]
    packed = group.mma.numpy()
    assert packed.shape == ({"row": (pipe.ROW_MMA_SIZE,), "col": (pipe.COL_MMA_SIZE,),
                             "b": (pipe.B_MMA_SIZE,)}[kind])
    off = 0
    rng = np.random.default_rng(layer)
    for i, K, N in GROUP_MATS[kind]:
        W = group.parts[i].numpy()
        assert W.shape == (K, N)
        big, small = _split(W)
        part = packed[off:off + 2 * K * N]
        got_big, got_small = pipe.unpack_mma(torch.from_numpy(part), K, N)
        np.testing.assert_array_equal(got_big.numpy().view(np.uint32), big.view(np.uint32))
        np.testing.assert_array_equal(got_small.numpy().view(np.uint32), small.view(np.uint32))
        for _ in range(64):
            j, n, g, t = (int(rng.integers(0, m)) for m in (K // 8, N // 8, 8, 4))
            f = part[4 * ((j * (N // 8) + n) * 32 + 4 * g + t):][:4]
            want = [big[8 * j + t, 8 * n + g], big[8 * j + t + 4, 8 * n + g],
                    small[8 * j + t, 8 * n + g], small[8 * j + t + 4, 8 * n + g]]
            np.testing.assert_array_equal(f.view(np.uint32), np.float32(want).view(np.uint32))
        off += 2 * K * N
    assert off == packed.size


def _product_3pass(a: np.ndarray, packed: np.ndarray, K: int, N: int) -> np.ndarray:
    """The kernel's product, transcribed: A split per element, B's planes
    from the packed weights; per k-step of 8, the passes small·big,
    big·small, big·big each added to the fp32 accumulator (TF32 products
    are exact in fp32)."""
    a_big, a_small = _split(a)
    b_big, b_small = (p.numpy() for p in pipe.unpack_mma(torch.from_numpy(packed), K, N))
    acc = np.zeros((a.shape[0], N), np.float32)
    for j in range(K // 8):
        ks = slice(8 * j, 8 * j + 8)
        for x, y in ((a_small, b_big), (a_big, b_small), (a_big, b_big)):
            acc = (acc + (x[:, ks] @ y[ks]).astype(np.float32)).astype(np.float32)
    return acc


def _product_1pass(a: np.ndarray, w: np.ndarray) -> np.ndarray:
    a_big, _ = _split(a)
    w_big, _ = _split(w)
    return (a_big @ w_big).astype(np.float32)


@pytest.mark.parametrize("kind,index", [("row", 0), ("col", 2), ("b", 2), ("b", 3)])
def test_three_pass_product_keeps_fp32(kind, index, weights):
    """row wq and col wv (k = 64), the FFN's w1 (64 -> 256) and w2 (k = 256)
    of every layer, on a seeded 64-site tile (LayerNorm-like values; the
    GELU output for w2): the 3-pass product within PRODUCT_TOL of float64,
    like the fp32 product; the 1-pass product far outside it."""
    w, _ = weights
    i, K, N = GROUP_MATS[kind][index]
    mat_off = sum(2 * k * n for _, k, n in GROUP_MATS[kind][:index])
    rng = np.random.default_rng(100 + index)
    worst = {"3pass": 0.0, "fp32": 0.0, "1pass": np.inf}
    for group in {"row": w.row, "col": w.col, "b": w.b}[kind]:
        W = group.parts[i].numpy()
        a = rng.standard_normal((pipe.FWD_TILE_SITES, K)).astype(np.float32)
        if K == 4 * D:  # the FFN hidden after an exact GELU
            a = (0.5 * a * (1 + np.vectorize(math.erf)(a / np.sqrt(2)))).astype(np.float32)
        ref = a.astype(np.float64) @ W.astype(np.float64)
        scale = max(1.0, np.abs(ref).max())
        packed = group.mma.numpy()[mat_off:mat_off + 2 * K * N]
        worst["3pass"] = max(worst["3pass"],
                             np.abs(_product_3pass(a, packed, K, N) - ref).max() / scale)
        worst["fp32"] = max(worst["fp32"], np.abs((a @ W).astype(np.float32) - ref).max() / scale)
        worst["1pass"] = min(worst["1pass"], np.abs(_product_1pass(a, W) - ref).max() / scale)
    assert worst["3pass"] <= PRODUCT_TOL, worst
    assert worst["fp32"] <= PRODUCT_TOL, worst
    assert worst["1pass"] > 10 * PRODUCT_TOL, worst


def _header_constants() -> dict:
    """The ``constexpr int`` constants of axial_pipeline.cuh, evaluated in order."""
    consts = {}
    text = (CSRC / "axial_pipeline.cuh").read_text()
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", text):
        consts[name] = int(eval(expr, {}, dict(consts)))
    return consts


def test_header_constants_match_the_wrapper():
    """Tile sizes, group sizes and the pf_weight_sizes order, as the wrapper
    has them (pipeline.LAYOUT is what it checks the built library against)."""
    c = _header_constants()
    assert c["D"] == D
    assert (c["TS"], c["FT"]) == (pipe.TILE_SITES, pipe.FWD_TILE_SITES)
    assert (c["R_SIZE"], c["C_SIZE"], c["B_SIZE"], c["H_SIZE"]) == (
        pipe.ROW_SIZE, pipe.COL_SIZE, pipe.B_SIZE, pipe.HEAD_SIZE)
    assert (c["RM_SIZE"], c["CM_SIZE"], c["BM_SIZE"]) == (
        pipe.ROW_MMA_SIZE, pipe.COL_MMA_SIZE, pipe.B_MMA_SIZE)
    src = (CSRC / "axial_pipeline.cu").read_text()
    body = src[src.index("int pf_weight_sizes"):]
    body = body[:body.index("return 0;")]
    order = dict((int(k), v) for k, v in re.findall(r"out\[(\d+)\] = (\w+);", body))
    assert tuple(c[order[k]] for k in range(len(order))) == pipe.LAYOUT


def test_header_offsets_match_the_groups(weights):
    """Each constant offset of the flat and mma layouts is where the
    wrapper's group puts that tensor."""
    c = _header_constants()
    w, _ = weights
    names = {
        "row": ["R_LNS", "R_LNB", "R_WQ", "R_BQ", "R_WK", "R_BK", "R_WV", "R_BV", "R_WO", "R_BO"],
        "col": ["C_LNS", "C_LNB", "C_WQ", "C_BQ", "C_WK", "C_BK", "C_WV", "C_BV"],
        "b": ["B_CNS", "B_CNB", "B_CWQ", "B_CBQ", "B_CWO", "B_CBO", "B_FNS", "B_FNB", "B_W1",
              "B_B1", "B_W2", "B_B2"],
    }
    mma_names = {"row": ["RM_WQ", "RM_WK", "RM_WV", "RM_WO"],
                 "col": ["CM_WQ", "CM_WK", "CM_WV"], "b": ["BM_CWQ", "BM_CWO", "BM_W1", "BM_W2"]}
    for kind, group in (("row", w.row[0]), ("col", w.col[0]), ("b", w.b[0])):
        offsets = np.cumsum([0] + [p.numel() for p in group.parts])
        assert [c[n] for n in names[kind]] == list(offsets[:-1]), kind
        mats = GROUP_MATS[kind]
        assert [i for i, _, _ in mats] == [names[kind].index(n.replace("M_", "_"))
                                            for n in mma_names[kind]], kind
        mma_off = np.cumsum([0] + [2 * k * n for _, k, n in mats])
        assert [c[n] for n in mma_names[kind]] == list(mma_off[:-1]), kind


def test_forward_block_fits_twice_an_sm():
    """The forward's shared memory (the Smem struct: six tiles of FT x XS,
    the row-sum buffer, the warp sums and the count) fits two blocks on an
    H100 SM and not three, as the grid rule (pipeline.RESIDENT_BLOCKS)
    assumes; the tile's row stride makes fragment loads conflict-free."""
    c = _header_constants()
    floats = 6 * c["FT"] * c["XS"] + 3 * c["MG"] * c["D"] + c["NWARP"] + 1
    per_block = 4 * floats + 1024  # + the 1 KB the card reserves per block
    sm_bytes = 228 * 1024
    assert 2 * per_block <= sm_bytes < 3 * per_block
    assert pipe.RESIDENT_BLOCKS == 2
    assert len({(4 * g + t) % 32 for g in range(8) for t in range(4)}) == 32
    assert all((g * c["XS"] + t) % 32 == (4 * g + t) % 32 for g in range(8) for t in range(4))


# Kernel M's planes of each group, as (index in parts, first row, first column,
# the header's plane constant), in pack_wg's order; w2's planes are permuted.
WG_PLANES = {
    "row": ((2, 0, 0, "RG_WQ"), (4, 0, 0, "RG_WK"), (6, 0, 0, "RG_WV"), (8, 0, 0, "RG_WO")),
    "col": ((2, 0, 0, "CG_WQ"), (4, 0, 0, "CG_WK"), (6, 0, 0, "CG_WV")),
    "b": ((2, 0, 0, "BG_CWQ"), (4, 0, 0, "BG_CWO"))
    + tuple((8, 0, D * c, "BG_W1") for c in range(4))
    + tuple((10, D * c, 0, "BG_W2") for c in range(4)),
}


@pytest.mark.parametrize("layer", range(6))
@pytest.mark.parametrize("kind", list(WG_PLANES))
def test_pack_wg_round_trips(kind, layer, weights):
    """Every 64 x 64 block of every matrix of the B, row and column groups of
    the checkpoint: the plane at the header's offset (chunk c of w1 and w2
    at BG_W1 + c, BG_W2 + c) unpacks to the split of that block bit for bit,
    and image element (n, k) sits at float (k / 4) 256 + (n / 8) 32 +
    (n % 8) 4 + k % 4 of each half, physical k of a w2 plane holding logical
    row 8j + 2 (s % 4) + s / 4, as the kernel's bulk copies and descriptors
    read it."""
    w, _ = weights
    c = _header_constants()
    group = {"row": w.row, "col": w.col, "b": w.b}[kind][layer]
    sizes = {"row": pipe.ROW_WG_SIZE, "col": pipe.COL_WG_SIZE, "b": pipe.B_WG_SIZE}
    assert group.wg.shape == (sizes[kind],)
    rng = np.random.default_rng(layer)
    chunk = {}
    for i, k0, n0, name in WG_PLANES[kind]:
        index = c[name] + chunk.get(name, 0)
        chunk[name] = chunk.get(name, 0) + 1
        permute = name == "BG_W2"
        block = group.parts[i][k0:k0 + D, n0:n0 + D].numpy()
        big, small = _split(np.ascontiguousarray(block))
        plane = group.wg[index * c["WG_PLANE"]:(index + 1) * c["WG_PLANE"]]
        got_big, got_small = pipe.unpack_wg(plane, permute)
        np.testing.assert_array_equal(got_big.numpy().view(np.uint32), big.view(np.uint32))
        np.testing.assert_array_equal(got_small.numpy().view(np.uint32), small.view(np.uint32))
        img = plane.numpy()
        for _ in range(64):
            n, k = (int(v) for v in rng.integers(0, D, 2))
            j, s_ = divmod(k, 8)
            logical = 8 * j + 2 * (s_ % 4) + s_ // 4 if permute else k
            at = (k // 4) * 256 + (n // 8) * 32 + (n % 8) * 4 + k % 4
            assert img[at].view(np.uint32) == big[logical, n].view(np.uint32)
            assert img[D * D + at].view(np.uint32) == small[logical, n].view(np.uint32)
    assert sum(chunk.values()) * c["WG_PLANE"] == group.wg.numel()


def test_wg_header_constants_match_the_wrapper():
    """Kernel M's plane constants: one plane is two 64 x 64 images, the
    groups' plane counts and sizes are the wrapper's, w2's planes follow
    w1's, and the consumers per block are the wrapper's slot count."""
    c = _header_constants()
    assert c["WG_PLANE"] == pipe.WG_PLANE == 2 * D * D
    assert (c["RG_SIZE"], c["CG_SIZE"], c["BG_SIZE"]) == (
        pipe.ROW_WG_SIZE, pipe.COL_WG_SIZE, pipe.B_WG_SIZE)
    assert (c["RG_PLANES"], c["CG_PLANES"], c["BG_PLANES"]) == (
        len(WG_PLANES["row"]), len(WG_PLANES["col"]), len(WG_PLANES["b"]))
    assert (c["BG_W1"], c["BG_W2"]) == (2, 6)
    assert c["M_CONSUMERS"] == pipe.M_CONSUMERS == 2


def test_w2_permutation_is_the_accumulator_to_a_fragment_map():
    """The A fragment of wgmma.m64nNk8 TF32 holds (row, k slot t) and (row,
    k slot t + 4) of each k-step; the accumulator holds columns 8j + 2t and
    8j + 2t + 1.  Kernel M puts accumulator element 2h + e in A register
    2e + h, so k slot t + 4e of k-step j holds logical column 8j + 2t + e:
    exactly _k_slots().  A product over the permuted rows then equals the
    product over the logical ones."""
    slots = pipe._k_slots().numpy()
    for j in range(D // 8):
        for t in range(4):
            for e in range(2):
                reg = 2 * e  # element 2h + e with h = 0 lands in register 2e + h
                assert 8 * j + t + 4 * (reg >> 1) == 8 * j + t + 4 * e
                assert slots[8 * j + t + 4 * e] == 8 * j + 2 * t + e
    assert sorted(slots) == list(range(D))
    rng = np.random.default_rng(3)
    a = rng.standard_normal((pipe.FWD_TILE_SITES, D))
    wt = rng.standard_normal((D, D))
    np.testing.assert_allclose(a[:, slots] @ wt[slots], a @ wt, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("B,P,want", [(1, 4950, 132), (9, 1770, 14), (1, 45, 45),
                                      (3, 1225, 44), (200, 45, 1), (4, 1, 1)])
def test_kernel_m_grid_fits_one_wave(B, P, want, monkeypatch):
    """One block of kernel M an SM: at most the SM count over the grid where
    the batch allows, never more blocks than pairs, at least one."""
    monkeypatch.setattr(pipe, "_sms", lambda device: 132)
    assert pipe.m_blocks(P, B, torch.device("cpu")) == want
    assert want * B <= max(132, B)


def test_forward_variants_apply_to_the_sources():
    """Every substitution of ``forward_variants.json`` (the variants tool's
    diagnostics, kernel M's among them) finds its text in ``csrc/``: a
    source edited under a diagnostic fails here, not in a chip run."""
    import json

    variants = json.loads((CSRC.parent / "forward_variants.json").read_text())
    assert variants["final"] == []
    for name, subs in variants.items():
        for f, old, _ in subs:
            assert old in (CSRC / f).read_text(), (name, f)
