"""Kernel E1's work split and its walk, on the CPU.

The CUDA kernel E1 (``csrc/axial_bwd.cu``) splits the flattened (pair row,
16-site tile) list into contiguous ranges of ``tpw`` tiles, one a warp
(``axial_block_bwd.e1_plan``); each warp leaves one partial
``[M | N | ΣqH | ΣkH]`` per row segment it walks, at partial index
``warp - first warp of the row``, and the finalize adds a row's partials in
warp order before the contractions with ``Wv`` and ``Wo^T``.  The kernel runs
only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).  Here:

- the plan, at the paths' shapes and at the edges (one pair, a ragged last
  tile, rows longer than a warp's range, another SM count): every tile goes
  to exactly one warp, the warps fit one wave of ``BLOCKS_PER_SM`` blocks of
  ``E1_WARPS`` an SM, no warp has more than one tile above the mean where
  there are more tiles than warps, and no row spans more warps than the
  ``K`` partials the wrapper allocates;
- a numpy float32 transcription of the kernel's walk (its lanes' channels,
  the reduce-scatter that leaves output g in lane g, the segments and their
  partial indices, the finalize) on seeded inputs with a ragged and a fully
  masked batch element: every partial the finalize reads was written once,
  and the row sums are within 1e-5 of ``kernel_e1_plain`` relative to
  max(1, max|ref|).
"""

import numpy as np
import pytest
import torch

from phyloformer_tpu_torch.ops.kernels import axial_block_bwd as bw
from phyloformer_tpu_torch.ops.kernels import pipeline as pipe

D, H = pipe.D_KERNEL, bw.N_HEADS_KERNEL
TS = pipe.TILE_SITES
H100_SMS = 132
TOL = 1e-5

# (B, P, L, SMs): the long training bucket, the one-step check's 1 x 20 x
# 1100 (190 pairs), one pair, a ragged last tile, 1024 sites (E1 + E2 against
# E), a row longer than a warp's range, and another card's SM count
PLAN_SHAPES = [(2, 1225, 1536, H100_SMS), (1, 190, 1280, H100_SMS), (1, 1, 1100, H100_SMS),
               (2, 3, 1077, H100_SMS), (2, 1225, 1024, H100_SMS), (1, 2, 200_000, H100_SMS),
               (4, 1225, 1040, 114)]


@pytest.mark.parametrize("b,p,l,sms", PLAN_SHAPES)
def test_e1_plan_covers_every_tile_once(b, p, l, sms):
    tpw, warps, k, fin = bw.e1_plan(b, p, l, sms)
    tr = -(-l // TS)
    n = b * p * tr
    owner = np.arange(n) // tpw  # the kernel's warp of each tile: t0 = warp * tpw
    assert owner.max() == warps - 1 and (warps - 1) * tpw < n <= warps * tpw
    assert warps <= bw.BLOCKS_PER_SM["kernel_e1"] * bw.E1_WARPS * sms
    if n >= bw.BLOCKS_PER_SM["kernel_e1"] * bw.E1_WARPS * sms:
        assert tpw <= n / (bw.BLOCKS_PER_SM["kernel_e1"] * bw.E1_WARPS * sms) + 1
    per_row = owner.reshape(b * p, tr)
    first, last = per_row[:, 0], per_row[:, -1]
    assert (first == np.arange(b * p) * tr // tpw).all()  # the kernel's first warp of a row
    assert (last - first + 1).max() <= k
    assert 1 <= fin <= b * p


def _transcription(x, g1, smask, parts, eps, sms):
    """The kernel's walk in numpy float32: per warp its tiles, per tile four
    passes of four sites (lane 8s + g: site s, channels 4g..4g+3 and
    32+4g..32+4g+3), the partial of each row segment at index
    warp - first warp of the row, then the finalize.  Returns the row sums
    and how often each partial was written."""
    f32 = np.float32
    b, p, l, _ = x.shape
    tpw, warps, k, _ = bw.e1_plan(b, p, l, sms)
    tr = -(-l // TS)
    n = b * p * tr
    ch = np.array([[(0 if i < 4 else 28) + 4 * g + i for i in range(8)] for g in range(8)])
    wz = np.concatenate([parts["wq"], parts["wk"]], axis=1).astype(f32)  # (D, 2H)
    bz = np.concatenate([parts["bq"], parts["bk"]]).astype(f32)
    sc, bi = parts["ln_s"].astype(f32), parts["ln_b"].astype(f32)
    xr, gr = x.reshape(b * p, l, D), g1.reshape(b * p, l, D)
    part = np.full((b * p, k, bw.E1_PART), np.nan, f32)
    written = np.zeros((b * p, k), int)
    for gw in range(warps):
        t0, t1 = gw * tpw, min(gw * tpw + tpw, n)
        am = np.zeros((4, 8, 8, H), f32)  # [slot, g, i, h]
        an = np.zeros((4, 8, 8, H), f32)
        csum = np.zeros((4, 8), f32)  # [slot, output g]
        for t in range(t0, t1):
            row, l0 = t // tr, (t % tr) * TS
            for s0 in range(0, TS, 4):
                sites = l0 + s0 + np.arange(4)
                ok = sites < l
                a = np.where(ok[:, None], xr[row, np.minimum(sites, l - 1)], 0).astype(f32)
                gv = np.where(ok[:, None], gr[row, np.minimum(sites, l - 1)], 0).astype(f32)
                m = np.where(ok, smask[row // p, np.minimum(sites, l - 1)], 0).astype(f32)
                a, gv = a[:, ch], gv[:, ch]  # (4 slots, 8 lanes g, 8 values i)
                mu = a.sum(axis=(1, 2), dtype=f32) / f32(D)
                a = a - mu[:, None, None]
                var = (a * a).sum(axis=(1, 2), dtype=f32) / f32(D)
                r = f32(1) / np.sqrt(var + f32(eps))
                h = a * r[:, None, None] * sc[ch] + bi[ch]
                z = np.einsum("sgi,gio->sgo", h, wz[ch]).astype(f32)  # the lanes' shares
                zg = z.sum(axis=1, dtype=f32)  # reduce-scatter: output o in lane o
                zg = zg + bz
                qk = np.where(zg > 0, zg + 1, np.exp(np.minimum(zg, 0))).astype(f32) * m[:, None]
                csum += qk
                am += gv[..., None] * qk[:, None, None, :H]
                an += h[..., None] * qk[:, None, None, H:]
            if t < t1 - 1 and l0 + TS < l:
                continue
            seg = gw - row * tr // tpw
            assert 0 <= seg < k
            written[row, seg] += 1
            dst = part[row, seg]
            dst[:D * H].reshape(D, H)[ch.reshape(-1)] = am.sum(0).reshape(64, H)
            dst[D * H:2 * D * H].reshape(D, H)[ch.reshape(-1)] = an.sum(0).reshape(64, H)
            dst[2 * D * H:] = csum.sum(0)
            am[:], an[:], csum[:] = 0, 0, 0
    out = np.zeros((b * p, 4 * D), f32)
    hc = np.arange(D) // (D // H)
    for row in range(b * p):
        first = row * tr // tpw
        nseg = ((row + 1) * tr - 1) // tpw - first + 1
        ps = part[row, :nseg].sum(0, dtype=f32)
        mq, nk = ps[:D * H].reshape(D, H), ps[D * H:2 * D * H].reshape(D, H)
        sq, sk = ps[2 * D * H:2 * D * H + H], ps[2 * D * H + H:]
        out[row, :D], out[row, D:2 * D] = sq[hc], sk[hc]
        out[row, 2 * D:3 * D] = (parts["wv"] * nk[:, hc]).sum(0) + parts["bv"] * sk[hc]
        out[row, 3 * D:] = (parts["wo_t"] * mq[:, hc]).sum(0)
    return out.reshape(b, p, 4 * D), written, (tpw, k)


# (B, P, L, real sites per element, SMs): rows inside one warp's range and
# across two; rows longer than a warp's range (one tile a warp); and a fully
# masked element
WALK_CASES = {"two_rows_a_warp": (2, 3, 70, (70, 53), 1),
              "rows_span_warps": (1, 4, 150, (150,), 1),
              "one_tile_a_warp": (2, 2, 77, (77, 0), 132)}


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_e1_walk_transcription_matches_plain(case):
    b, p, l, real_l, sms = WALK_CASES[case]
    rng = np.random.default_rng(41)
    parts = {"ln_s": 1 + 0.2 * rng.normal(size=D), "ln_b": 0.2 * rng.normal(size=D),
             "wq": 0.3 * rng.normal(size=(D, H)), "bq": 0.2 * rng.normal(size=H),
             "wk": 0.3 * rng.normal(size=(D, H)), "bk": 0.2 * rng.normal(size=H),
             "wv": 0.2 * rng.normal(size=(D, D)), "bv": 0.2 * rng.normal(size=D),
             "wo": 0.2 * rng.normal(size=(D, D))}
    parts = {k: v.astype(np.float32) for k, v in parts.items()}
    parts["wo_t"] = np.ascontiguousarray(parts["wo"].T)
    x = rng.normal(size=(b, p, l, D)).astype(np.float32)
    smask = (np.arange(l)[None] < np.asarray(real_l)[:, None]).astype(np.float32)
    g1 = (rng.normal(size=(b, p, l, D)) * smask[:, None, :, None]).astype(np.float32)
    got, written, (tpw, k) = _transcription(x, g1, smask, parts, 1e-5, sms)
    tr = -(-l // TS)
    nseg = (np.arange(1, b * p + 1) * tr - 1) // tpw - np.arange(b * p) * tr // tpw + 1
    for row in range(b * p):  # each partial the finalize reads was written once, no other
        assert (written[row, :nseg[row]] == 1).all() and not written[row, nseg[row]:].any()
    if case == "rows_span_warps":
        assert tpw < tr and k > 2
    tt = {k_: torch.from_numpy(v) for k_, v in parts.items()}
    we = bw.att_group({"scale": tt["ln_s"], "bias": tt["ln_b"]},
                      {"wq": tt["wq"], "bq": tt["bq"], "wk": tt["wk"], "bk": tt["bk"],
                       "wv": tt["wv"], "bv": tt["bv"], "wo": tt["wo"]})
    want = bw.kernel_e1_plain(torch.from_numpy(x), torch.from_numpy(g1),
                              torch.from_numpy(smask), we, 1e-5).numpy()
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= TOL, err
