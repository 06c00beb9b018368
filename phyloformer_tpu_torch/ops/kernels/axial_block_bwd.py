"""The fused backward of one axial block: kernels C, D and E (or E1, E2).

The PyTorch side of ``pf_kernel_c`` / ``pf_kernel_d`` / ``pf_kernel_e`` /
``pf_kernel_e2`` (``csrc/axial_bwd_tc.cu``, split-TF32 products on the tensor
cores), ``pf_kernel_e1`` (``csrc/axial_bwd.cu``, a streaming pass bound by
its bytes) and of
``pf_reduce_slots`` for the partials (``csrc/slot_reduce.cu``), and the
counterpart of ``phyloformer_tpu/ops/pallas/axial_block_bwd.py``:

- :func:`kernel_c` (``_kernel_c``): x2 and the FFN recomputed from x1 and the
  column stats, the FFN backward → g2, ``d_attn = g2·Wo_cᵀ`` and the
  cross-pair sum ``A1 = Σ_p d_attn ⊙ qn`` ``(B, L, d)``, with the FFN and
  column out-projection weight gradients;
- :func:`kernel_d` (``_kernel_d``): the column-attention backward from A1
  and the stats → g1, with the column LN and q/k/v weight gradients;
- :func:`kernel_e` (``_kernel_e``): the row-attention backward on whole rows
  → gx, with the row LN and q/k/v/o weight gradients, up to
  ``axial_block.RESIDENT_SITES_MAX`` sites;
- :func:`kernel_e1` (``_kernel_e1``) and :func:`kernel_e2` (``_kernel_e2``):
  the same function above that length in two passes, each pair's raw row
  sums ``(B, P, 4d)`` first, then gx and the gradients from them (E1's
  kernel sums in another association, :func:`kernel_e1_factored`);
- :func:`fused_axial_block_bwd`: C, D, then E or E1 and E2, ``(gx, dlayer)``.

The plain versions (``*_plain``) follow the op order of the JAX kernels,
with real ``erf`` in the GELU derivative and the head expand / contract as a
repeat and a reshape-sum (the JAX interpret path's form).  They run for CPU
tensors and are general in ``d`` and the head count; the CUDA kernels take
``d = 64`` and 4 heads.  Each wrapper takes its plain version only for
tensors on the CPU and launches its kernel (adding one to its entry in
``pipeline.LAUNCHES``) or raises for CUDA tensors.

``passes``: the TF32 passes of the products of C, D, E and E2, JAX's
``prec`` (:func:`.axial_block.passes_of` of its ``mxu_precision``).  3 (split
TF32, within ~2^-22 of fp32) is computed as the plain fp32 product; 1 (one
TF32 pass, the reduced-precision backward) rounds both operands of every
product JAX routes through ``_mm`` and ``_mm_at`` as the kernels do
(:func:`.axial_block.mm`, :func:`_mm_at`), with fp32 accumulation.  JAX's
``_contract_heads`` / ``_expand_heads`` are 0/1 matmuls written for Mosaic;
here they stay exact sums and repeats at every pass count.  E1 sums in exact
fp32 at both counts: its bytes, not its products, bind it, and it takes
``passes`` only to ignore it.

Weight gradients come back as one flat fp32 vector per kernel, laid out as
:func:`grad_spec` says, and :func:`fused_axial_block_bwd` unpacks them into
the JAX tree layout (q/k gradients ``(d, H)``, biases ``(H,)`` / ``(d,)``).
The TPU's tile picker (``_pick_tile_bwd``) and its ``PF_PALLAS_BWD_PT_*``
overrides have no counterpart: the kernels take any ``P`` and ``L``.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import torch

from ...parallel.mesh import all_reduce_sum
from . import _build
from . import axial_block
from .axial_block import mm, passes_of, phi, tf32_rna
from .pipeline import (
    D_KERNEL,
    LAUNCHES,
    TILE_SITES,
    WeightGroup,
    _check_passes,
    _check_width,
    _lib,
    _on_cpu,
    _require,
    _stream,
    pack_mma,
    reduce_slots,
)

N_HEADS_KERNEL = 4  # the only head count the CUDA kernels are built for
_INV_SQRT2PI = 0.3989422804014327
# The per-block weight-gradient and A1 partials of one launch stay under this.
PARTIAL_BUDGET_BYTES = 256 * 1024 * 1024
# Blocks per SM that each kernel's grid aims at (pair slots = this x SMs /
# B).  C holds its FFN weight gradients and tiles in 220 KB of shared
# memory, so one block fits an SM; D, E and E2 (108 KB, at most 128
# registers a thread) fit two, and their grids are one wave of two.  E1's
# blocks of E1_WARPS warps hold their rings in 96 KB: two fit an SM.
BLOCKS_PER_SM = {"kernel_c": 1, "kernel_d": 2, "kernel_e": 2, "kernel_e1": 2, "kernel_e2": 2}
# Sites per tile of kernels C, D, E and E2 (BT in csrc/axial_bwd.cuh).
TC_TILE_SITES = 32
# Kernel E1 (E1_WARPS and E1_PART in csrc/axial_bwd.cuh): warps a block,
# each streaming its own tiles, and the floats of a row segment's partial
# [M (d x H) | N (d x H) | ΣqH | ΣkH].
E1_WARPS = 4
E1_PART = 2 * D_KERNEL * N_HEADS_KERNEL + 2 * N_HEADS_KERNEL
# Blocks an SM of E1's finalize (one row at a time, Wv and Wo^T in shared
# memory).
E1_FIN_BLOCKS_PER_SM = 2


# ---- weight groups --------------------------------------------------------
# The order of each group's parts is the packed layout of csrc/axial_bwd.cuh.

C_PARTS = ("cn_s", "cn_b", "cwq_e", "cbq_e", "cwo", "cwo_t", "cbo", "fn_s", "fn_b",
           "w1", "b1", "w1_t", "w2_t", "cwq", "cbq")
# Column (kernel D) and row (kernel E) attention share one layout.
ATT_PARTS = ("ln_s", "ln_b", "wq_e", "bq_e", "wk_e", "bk_e", "wv", "bv", "wo_t",
             "wq", "bq", "wk", "bk", "wv_t")


def _rep(t: torch.Tensor, hd: int) -> torch.Tensor:
    return t.repeat_interleave(hd, dim=-1)


# The matrices of C_PARTS that kernel C reads packed for the tensor cores
# (pipeline.pack_mma, concatenated in this order: CTM_* in axial_bwd.cuh).
C_MMA_MATS = ("cwq_e", "cwo", "cwo_t", "w1", "w1_t", "w2_t")


def _kernel_shaped(wq: torch.Tensor) -> bool:
    """Whether a ``(d, H)`` q weight has the CUDA kernels' width and heads:
    only then are a group's matrices packed for them."""
    return tuple(wq.shape) == (D_KERNEL, N_HEADS_KERNEL)


def c_group(layer) -> WeightGroup:
    ca, ffn = layer["col_attn"], layer["ffn"]
    hd = ca["wo"].shape[0] // ca["wq"].shape[1]
    mats = tuple(C_PARTS.index(n) for n in C_MMA_MATS) if _kernel_shaped(ca["wq"]) else ()
    return WeightGroup.of((
        layer["col_norm"]["scale"], layer["col_norm"]["bias"], _rep(ca["wq"], hd),
        _rep(ca["bq"], hd), ca["wo"], ca["wo"].t(), ca["bo"], layer["ffn_norm"]["scale"],
        layer["ffn_norm"]["bias"], ffn["w1"], ffn["b1"], ffn["w1"].t(), ffn["w2"].t(),
        ca["wq"], ca["bq"]), mats=mats)


def att_group(norm, attn) -> WeightGroup:
    hd = attn["wo"].shape[0] // attn["wq"].shape[1]
    return WeightGroup.of((
        norm["scale"], norm["bias"], _rep(attn["wq"], hd), _rep(attn["bq"], hd),
        _rep(attn["wk"], hd), _rep(attn["bk"], hd), attn["wv"], attn["bv"], attn["wo"].t(),
        attn["wq"], attn["bq"], attn["wk"], attn["bk"], attn["wv"].t()))


def e_mma_mats(parts: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The matrices of kernels D, E and E2, in the order they read them
    packed (EM_* in axial_bwd.cuh): ``[wq | wk]`` (d x 2H, the q/k
    projections on the d x H weights), ``wv``, ``wo_t`` and
    ``[wv_t ; wqᵀ ; wkᵀ]`` ((d + 2H) x d, the gradient of the LN output from
    ``[d_v | dzq | dzk]``)."""
    return (torch.cat([parts["wq"], parts["wk"]], dim=1), parts["wv"], parts["wo_t"],
            torch.cat([parts["wv_t"], parts["wq"].t(), parts["wk"].t()], dim=0))


def e_group(norm, attn) -> WeightGroup:
    """:func:`att_group` (the flat layout, which E1 reads alone) with the
    matrices of kernels D, E and E2 packed for the tensor cores
    (:func:`e_mma_mats`; none for other widths than the kernels')."""
    g = att_group(norm, attn)
    if not _kernel_shaped(attn["wq"]):
        return g
    mma = torch.cat([pack_mma(m.contiguous()) for m in e_mma_mats(_parts(g, ATT_PARTS))])
    return WeightGroup(g.parts, g.flat, mma, g.wg)


@dataclass(frozen=True)
class BwdWeights:
    """One layer's weight groups for kernels C, D (column attention) and E
    (row attention; E1 and E2 read it too), packed once per call of
    :meth:`of`."""

    c: WeightGroup
    d: WeightGroup
    e: WeightGroup
    n_heads: int

    @classmethod
    def of(cls, layer: Dict[str, Any]) -> "BwdWeights":
        return cls(c_group(layer), e_group(layer["col_norm"], layer["col_attn"]),
                   e_group(layer["row_norm"], layer["row_attn"]),
                   layer["row_attn"]["wq"].shape[1])


def _parts(wg: WeightGroup, names: Sequence[str]) -> Dict[str, torch.Tensor]:
    return dict(zip(names, wg.parts))


def group_size(names: Sequence[str], d: int, h: int) -> int:
    """Floats in a packed group of ``C_PARTS`` or ``ATT_PARTS``."""
    f = 4 * d
    sizes = {"w1": d * f, "b1": f, "w1_t": f * d, "w2_t": d * f, "cwq": d * h, "cbq": h,
             "wq": d * h, "bq": h, "wk": d * h, "bk": h}
    square = {"cwq_e", "cwo", "cwo_t", "wq_e", "wk_e", "wv", "wo_t", "wv_t"}
    return sum(sizes.get(n, d * d if n in square else d) for n in names)


# ---- weight-gradient layouts ----------------------------------------------

def grad_spec(kernel: str, d: int, h: int) -> List[Tuple[str, str, Tuple[int, ...]]]:
    """``(sub-tree, leaf, shape)`` of each weight gradient in the flat vector
    that a kernel returns, in order."""
    f = 4 * d
    if kernel == "kernel_c":
        return [("col_attn", "wo", (d, d)), ("col_attn", "bo", (d,)),
                ("ffn_norm", "scale", (d,)), ("ffn_norm", "bias", (d,)),
                ("ffn", "w1", (d, f)), ("ffn", "b1", (f,)), ("ffn", "w2", (f, d)),
                ("ffn", "b2", (d,))]
    norm, attn = ("col_norm", "col_attn") if kernel == "kernel_d" else ("row_norm", "row_attn")
    spec = [(norm, "scale", (d,)), (norm, "bias", (d,)), (attn, "wq", (d, h)),
            (attn, "bq", (h,)), (attn, "wk", (d, h)), (attn, "bk", (h,)),
            (attn, "wv", (d, d)), (attn, "bv", (d,))]
    if kernel == "kernel_e":
        spec += [(attn, "wo", (d, d)), (attn, "bo", (d,))]
    return spec


def mma_size(kernel: str, d: int, h: int) -> int:
    """Floats of kernel C's packed matrices, or those D, E and E2 read
    (two per element)."""
    f = 4 * d
    if kernel == "kernel_c":
        return 2 * (3 * d * d + 3 * d * f)
    return 2 * (d * 2 * h + 2 * d * d + (d + 2 * h) * d)


def grad_size(kernel: str, d: int, h: int) -> int:
    return sum(math.prod(s) for _, _, s in grad_spec(kernel, d, h))


def unpack_grads(kernel: str, flat: torch.Tensor, d: int, h: int,
                 into: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Split a kernel's flat weight-gradient vector into ``into[sub][leaf]``."""
    off = 0
    for sub, leaf, shape in grad_spec(kernel, d, h):
        n = math.prod(shape)
        into.setdefault(sub, {})[leaf] = flat[off:off + n].view(shape)
        off += n
    return into


# What pf_bwd_tc_sizes reports first (the layouts of kernels C, D, E and
# E2; then the shared memory of a C, a D and an E or E2 block, in bytes).
TC_LAYOUT = (group_size(C_PARTS, D_KERNEL, N_HEADS_KERNEL),
             mma_size("kernel_c", D_KERNEL, N_HEADS_KERNEL),
             group_size(ATT_PARTS, D_KERNEL, N_HEADS_KERNEL),
             mma_size("kernel_e", D_KERNEL, N_HEADS_KERNEL),
             grad_size("kernel_c", D_KERNEL, N_HEADS_KERNEL),
             grad_size("kernel_d", D_KERNEL, N_HEADS_KERNEL),
             grad_size("kernel_e", D_KERNEL, N_HEADS_KERNEL), TC_TILE_SITES)


def _flat(*grads: torch.Tensor) -> torch.Tensor:
    return torch.cat([g.reshape(-1) for g in grads])


# ---- helpers (axial_block_bwd.py:66-162) ----------------------------------

def gelu_grad(u: torch.Tensor) -> torch.Tensor:
    """d/du [u Φ(u)] = Φ(u) + u φ(u), with the real erf."""
    cdf = 0.5 * (1.0 + torch.erf(u * 0.7071067811865476))
    pdf = torch.exp(-0.5 * u * u) * _INV_SQRT2PI
    return cdf + u * pdf


def phi_grad(z: torch.Tensor) -> torch.Tensor:
    """φ(z) = elu(z) + 1 ⇒ φ'(z) = 1 for z > 0, exp(z) otherwise."""
    return torch.where(z > 0, torch.ones_like(z), torch.exp(z.clamp_max(0.0)))


def ln_fwd(x, scale, bias, eps):
    """LayerNorm returning ``(h, xhat, r)`` for the backward."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    xhat = (x - mu) * r
    return xhat * scale + bias, xhat, r


def ln_bwd(dh, xhat, r, scale):
    """LayerNorm backward: ``dx`` and the ``(dscale, dbias)`` sums over every
    leading axis."""
    gxh = dh * scale
    dx = r * (gxh - gxh.mean(dim=-1, keepdim=True)
              - xhat * (gxh * xhat).mean(dim=-1, keepdim=True))
    d = dh.shape[-1]
    return dx, (dh * xhat).reshape(-1, d).sum(0), dh.reshape(-1, d).sum(0)


def expand_heads(t: torch.Tensor, hd: int) -> torch.Tensor:
    """``(..., H)`` → ``(..., H·hd)``: each head's value over its lanes."""
    return t.repeat_interleave(hd, dim=-1)


def contract_heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """``(..., d)`` → ``(..., H)``: the sum over each head's lanes."""
    return t.reshape(t.shape[:-1] + (n_heads, t.shape[-1] // n_heads)).sum(-1)


def _guard(s: torch.Tensor) -> torch.Tensor:
    return torch.where(s > 0, s, torch.ones_like(s))


def _mm_at(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """aᵀ·b over every leading axis: ``(..., K)``, ``(..., M)`` → ``(K, M)``,
    a weight gradient with the sites as its depth: the fp32 product at three
    passes, ``tf32_rna(a)ᵀ·tf32_rna(b)`` accumulated in fp32 at one (JAX's
    ``_mm_at`` at ``prec``)."""
    if _check_passes(passes) == 1:
        a, b = tf32_rna(a), tf32_rna(b)
    return a.reshape(-1, a.shape[-1]).t() @ b.reshape(-1, b.shape[-1])


def derive_col_site_grads(stats, a1, n_pairs, n_heads):
    """The per-site pieces of the column-attention backward from the column
    stats ``(B, L, 3d)``, ``A1`` ``(B, L, d)`` and ``n_pairs`` ``(B, 1, 1)``
    (already ``max(count, 1)``): head-expanded ``qm_e``, ``ctx_e``,
    ``d_skv_e`` and the ``(B, L, H)`` ``d_sk_H``, ``d_sq_H``.  Gradient passes
    only where the raw sums are positive."""
    d = stats.shape[-1] // 3
    hd = d // n_heads
    sk_raw, sq_raw, kv = stats[..., :d], stats[..., d:2 * d], stats[..., 2 * d:]
    qm_raw = sq_raw / n_pairs
    qm_e = _guard(qm_raw)
    sk_e = _guard(sk_raw)
    ctx_e = kv / sk_e
    d_skv_e = a1 / sk_e
    sk_h = contract_heads(sk_e, n_heads) / hd
    d_sk_h = -contract_heads(a1 * ctx_e, n_heads) / sk_h
    d_sk_h = d_sk_h * (contract_heads(sk_raw, n_heads) > 0)
    qm_h = contract_heads(qm_e, n_heads) / hd
    d_qm_h = -contract_heads(ctx_e * qm_e * a1, n_heads) / (qm_h * qm_h)
    d_qm_h = d_qm_h * (contract_heads(qm_raw, n_heads) > 0)
    return qm_e, ctx_e, d_skv_e, d_sk_h, d_qm_h / n_pairs


# ---- plain versions -------------------------------------------------------

def kernel_c_plain(x1, g3, stats, pmask, pair_count, wc: WeightGroup, eps, passes=3):
    """``_kernel_c``: ``(g2, A1 (B, L, d), flat weight gradients)``."""
    p = _parts(wc, C_PARTS)
    d = x1.shape[-1]
    n_heads = p["cwq"].shape[1]
    hd = d // n_heads
    pm = pmask[:, :, None, None]
    n_pairs = pair_count.clamp_min(1.0)[:, None, None]
    sk_raw, sq_raw, kv = stats[..., :d], stats[..., d:2 * d], stats[..., 2 * d:]
    qm_e = _guard(sq_raw / n_pairs)
    ctx_e = kv / _guard(sk_raw)

    hc = ln_fwd(x1, p["cn_s"], p["cn_b"], eps)[0]
    qn = expand_heads(phi(mm(hc, p["cwq"], passes) + p["cbq"]), hd) * pm / qm_e[:, None]
    attn = qn * ctx_e[:, None]
    x2 = x1 + mm(attn, p["cwo"], passes) + p["cbo"]

    hf, xhat_f, r_f = ln_fwd(x2, p["fn_s"], p["fn_b"], eps)
    u = mm(hf, p["w1"], passes) + p["b1"]
    a = 0.5 * u * (1.0 + torch.erf(u * 0.7071067811865476))
    dfw2 = _mm_at(a, g3, passes)
    dfb2 = g3.reshape(-1, d).sum(0)
    du = mm(g3, p["w2_t"], passes) * gelu_grad(u)
    d_hf = mm(du, p["w1_t"], passes)
    dfw1 = _mm_at(hf, du, passes)
    dfb1 = du.reshape(-1, du.shape[-1]).sum(0)
    d_x2_ln, dfs, dfb = ln_bwd(d_hf, xhat_f, r_f, p["fn_s"])
    g2 = g3 + d_x2_ln

    dcwo = _mm_at(attn, g2, passes)
    dcbo = g2.reshape(-1, d).sum(0)
    d_attn = mm(g2, p["cwo_t"], passes)
    a1 = (d_attn * qn).sum(dim=1)
    return g2, a1, _flat(dcwo, dcbo, dfs, dfb, dfw1, dfb1, dfw2, dfb2)


def kernel_d_plain(x1, g2, stats, a1, pmask, pair_count, wd: WeightGroup, eps, passes=3):
    """``_kernel_d``: ``(g1, flat weight gradients)``."""
    p = _parts(wd, ATT_PARTS)
    d = x1.shape[-1]
    n_heads = p["wq"].shape[1]
    hd = d // n_heads
    pm = pmask[:, :, None, None]
    n_pairs = pair_count.clamp_min(1.0)[:, None, None]
    qm_e, ctx_e, d_skv_e, d_sk_h, d_sq_h = derive_col_site_grads(stats, a1, n_pairs, n_heads)

    hc, xhat_c, r_c = ln_fwd(x1, p["ln_s"], p["ln_b"], eps)
    zq = mm(hc, p["wq"], passes) + p["bq"]
    zk = mm(hc, p["wk"], passes) + p["bk"]
    kc_e = expand_heads(phi(zk), hd) * pm
    vc = mm(hc, p["wv"], passes) + p["bv"]

    d_attn = mm(g2, p["wo_t"], passes)
    qm_h = contract_heads(qm_e, n_heads) / hd
    d_q = contract_heads(d_attn * ctx_e[:, None], n_heads) / qm_h[:, None] + d_sq_h[:, None]
    d_zq = d_q * phi_grad(zq) * pm
    d_k = d_sk_h[:, None] + contract_heads(d_skv_e[:, None] * vc, n_heads)
    d_zk = d_k * phi_grad(zk) * pm
    d_v = d_skv_e[:, None] * kc_e

    dwq, dbq = _mm_at(hc, d_zq, passes), d_zq.reshape(-1, n_heads).sum(0)
    dwk, dbk = _mm_at(hc, d_zk, passes), d_zk.reshape(-1, n_heads).sum(0)
    dwv, dbv = _mm_at(hc, d_v, passes), d_v.reshape(-1, d).sum(0)
    d_hc = (mm(d_zq, p["wq"].t(), passes) + mm(d_zk, p["wk"].t(), passes)
            + mm(d_v, p["wv_t"], passes))
    d_x1_ln, ds, db = ln_bwd(d_hc, xhat_c, r_c, p["ln_s"])
    return g2 + d_x1_ln, _flat(ds, db, dwq, dbq, dwk, dbk, dwv, dbv)


def kernel_e_plain(x, g1, smask, we: WeightGroup, eps, passes=3):
    """``_kernel_e``: ``(gx, flat weight gradients)``."""
    p = _parts(we, ATT_PARTS)
    d = x.shape[-1]
    n_heads = p["wq"].shape[1]
    hd = d // n_heads
    m = smask[:, None, :, None]
    h, xhat_r, r_r = ln_fwd(x, p["ln_s"], p["ln_b"], eps)
    zq = mm(h, p["wq"], passes) + p["bq"]
    zk = mm(h, p["wk"], passes) + p["bk"]
    q_e = expand_heads(phi(zq), hd) * m
    k_e = expand_heads(phi(zk), hd) * m
    v = mm(h, p["wv"], passes) + p["bv"]

    count = smask.sum(dim=-1).clamp_min(1.0)[:, None, None, None]
    sq_raw = q_e.sum(dim=2, keepdim=True) / count  # (B, P, 1, d): q-mean
    sk_raw = k_e.sum(dim=2, keepdim=True)
    qm_r = _guard(sq_raw)
    sk_r = _guard(sk_raw)
    ctx_r = (k_e * v).sum(dim=2, keepdim=True) / sk_r
    qn_r = q_e / qm_r
    attn_r = qn_r * ctx_r

    d_attn = mm(g1, p["wo_t"], passes)
    d_ctx = (d_attn * qn_r).sum(dim=2, keepdim=True)
    d_skv_r = d_ctx / sk_r
    sk_rh = contract_heads(sk_r, n_heads) / hd
    d_sk_rh = -contract_heads(d_ctx * ctx_r, n_heads) / sk_rh
    d_sk_rh = d_sk_rh * (contract_heads(sk_raw, n_heads) > 0)
    qm_rh = contract_heads(qm_r, n_heads) / hd
    d_qn_e = d_attn * ctx_r
    d_qm_rh = -contract_heads((d_qn_e * q_e).sum(dim=2, keepdim=True), n_heads) / (qm_rh * qm_rh)
    d_qm_rh = d_qm_rh * (contract_heads(sq_raw, n_heads) > 0)
    d_sq_rh = d_qm_rh / count

    d_zq = (contract_heads(d_qn_e, n_heads) / qm_rh + d_sq_rh) * phi_grad(zq) * m
    d_zk = (d_sk_rh + contract_heads(d_skv_r * v, n_heads)) * phi_grad(zk) * m
    d_v = d_skv_r * k_e
    d_h = (mm(d_zq, p["wq"].t(), passes) + mm(d_zk, p["wk"].t(), passes)
           + mm(d_v, p["wv_t"], passes))
    d_x_ln, ds, db = ln_bwd(d_h, xhat_r, r_r, p["ln_s"])

    dwq, dbq = _mm_at(h, d_zq, passes), d_zq.reshape(-1, n_heads).sum(0)
    dwk, dbk = _mm_at(h, d_zk, passes), d_zk.reshape(-1, n_heads).sum(0)
    dwv, dbv = _mm_at(h, d_v, passes), d_v.reshape(-1, d).sum(0)
    dwo, dbo = _mm_at(attn_r, g1, passes), g1.reshape(-1, d).sum(0)
    return g1 + d_x_ln, _flat(ds, db, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo)


def kernel_e1_plain(x, g1, smask, we: WeightGroup, eps, passes=3):
    """``_kernel_e1``: each pair's raw row sums ``(B, P, 4d)``
    ``[Σq_e | Σk_e | Σk_e·v | Σ d_attn⊙q_e]`` over the masked site axis, in
    fp32 at every ``passes`` (taken, and ignored, as the kernel takes it)."""
    p = _parts(we, ATT_PARTS)
    hd = x.shape[-1] // p["wq"].shape[1]
    m = smask[:, None, :, None]
    h = ln_fwd(x, p["ln_s"], p["ln_b"], eps)[0]
    q_e = expand_heads(phi(h @ p["wq"] + p["bq"]), hd) * m
    k_e = expand_heads(phi(h @ p["wk"] + p["bk"]), hd) * m
    v = h @ p["wv"] + p["bv"]
    d_attn = g1 @ p["wo_t"]
    return torch.cat([q_e.sum(dim=2), k_e.sum(dim=2), (k_e * v).sum(dim=2),
                      (d_attn * q_e).sum(dim=2)], dim=-1)


def kernel_e1_factored(x, g1, smask, we: WeightGroup, eps, passes=3):
    """:func:`kernel_e1_plain`'s function in the association of the CUDA
    kernel: ``q_e`` and ``k_e`` are per-head values over each head's lanes,
    so the sums over the sites go through ``M = Σ_l g1ᵀ qH`` and
    ``N = Σ_l hᵀ kH`` (``(B, P, d, H)``) first, and the d x d products with
    ``Wo^T`` and ``Wv`` come once a pair: ``Σ d_attn⊙q_e = Σ_j Wo^T[j, c]
    M[j, head(c)]`` and ``Σ k_e⊙v = Σ_j Wv[j, c] N[j, head(c)] + bv ΣkH``.
    Exact algebra, other rounding, fp32 at every ``passes``; for the tests
    (nothing on the path calls it)."""
    p = _parts(we, ATT_PARTS)
    hd = x.shape[-1] // p["wq"].shape[1]
    m = smask[:, None, :, None]
    h = ln_fwd(x, p["ln_s"], p["ln_b"], eps)[0]
    q_h = phi(h @ p["wq"] + p["bq"]) * m  # (B, P, L, H)
    k_h = phi(h @ p["wk"] + p["bk"]) * m
    mq = g1.transpose(-1, -2) @ q_h  # (B, P, d, H)
    nk = h.transpose(-1, -2) @ k_h
    sq, sk = expand_heads(q_h.sum(dim=2), hd), expand_heads(k_h.sum(dim=2), hd)
    kv = (p["wv"] * expand_heads(nk, hd)).sum(dim=-2) + p["bv"] * sk
    dq = (p["wo_t"] * expand_heads(mq, hd)).sum(dim=-2)
    return torch.cat([sq, sk, kv, dq], dim=-1)


def kernel_e2_plain(x, g1, rowsums, smask, we: WeightGroup, eps, passes=3):
    """``_kernel_e2``: the row backward finalized from the raw row sums of
    :func:`kernel_e1_plain` and the site count: ``(gx, flat weight
    gradients)``, the function of :func:`kernel_e_plain`."""
    p = _parts(we, ATT_PARTS)
    d = x.shape[-1]
    n_heads = p["wq"].shape[1]
    hd = d // n_heads
    m = smask[:, None, :, None]
    h, xhat_r, r_r = ln_fwd(x, p["ln_s"], p["ln_b"], eps)
    zq = mm(h, p["wq"], passes) + p["bq"]
    zk = mm(h, p["wk"], passes) + p["bk"]
    q_e = expand_heads(phi(zq), hd) * m
    k_e = expand_heads(phi(zk), hd) * m
    v = mm(h, p["wv"], passes) + p["bv"]
    d_attn = mm(g1, p["wo_t"], passes)

    count = smask.sum(dim=-1).clamp_min(1.0)[:, None, None, None]
    rs = rowsums[:, :, None, :]  # (B, P, 1, 4d)
    sq_raw = rs[..., :d] / count  # q-mean, raw
    sk_raw = rs[..., d:2 * d]
    skv = rs[..., 2 * d:3 * d]
    sdq = rs[..., 3 * d:]  # Σ_L d_attn ⊙ q_e
    qm_r = _guard(sq_raw)
    sk_r = _guard(sk_raw)
    ctx_r = skv / sk_r

    d_ctx = sdq / qm_r  # = Σ_L d_attn ⊙ qn
    d_skv_r = d_ctx / sk_r
    sk_rh = contract_heads(sk_r, n_heads) / hd
    d_sk_rh = -contract_heads(d_ctx * ctx_r, n_heads) / sk_rh
    d_sk_rh = d_sk_rh * (contract_heads(sk_raw, n_heads) > 0)
    qm_rh = contract_heads(qm_r, n_heads) / hd
    d_qm_rh = -contract_heads(ctx_r * sdq, n_heads) / (qm_rh * qm_rh)
    d_qm_rh = d_qm_rh * (contract_heads(sq_raw, n_heads) > 0)
    d_sq_rh = d_qm_rh / count

    d_qn_e = d_attn * ctx_r
    d_zq = (contract_heads(d_qn_e, n_heads) / qm_rh + d_sq_rh) * phi_grad(zq) * m
    d_zk = (d_sk_rh + contract_heads(d_skv_r * v, n_heads)) * phi_grad(zk) * m
    d_v = d_skv_r * k_e
    d_h = (mm(d_zq, p["wq"].t(), passes) + mm(d_zk, p["wk"].t(), passes)
           + mm(d_v, p["wv_t"], passes))
    d_x_ln, ds, db = ln_bwd(d_h, xhat_r, r_r, p["ln_s"])

    attn_r = (q_e / qm_r) * ctx_r
    dwq, dbq = _mm_at(h, d_zq, passes), d_zq.reshape(-1, n_heads).sum(0)
    dwk, dbk = _mm_at(h, d_zk, passes), d_zk.reshape(-1, n_heads).sum(0)
    dwv, dbv = _mm_at(h, d_v, passes), d_v.reshape(-1, d).sum(0)
    dwo, dbo = _mm_at(attn_r, g1, passes), g1.reshape(-1, d).sum(0)
    return g1 + d_x_ln, _flat(ds, db, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo)


def reduce_partials_plain(partial):
    return partial.sum(dim=1)


# ---- CUDA wrappers --------------------------------------------------------

def _bwd_blocks(name: str, B: int, device) -> int:
    """Blocks per batch element that fill the card with ``name``'s grid."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return math.ceil(BLOCKS_PER_SM[name] * sms / B)


def _bwd_slots(name: str, B: int, P: int, per_slot_bytes: int, device) -> int:
    """Pair slots (blocks) per batch element: one wave of the card, never
    more than the pairs, and partials under ``PARTIAL_BUDGET_BYTES``."""
    budget = max(1, PARTIAL_BUDGET_BYTES // max(1, B * per_slot_bytes))
    return max(1, min(P, _bwd_blocks(name, B, device), budget))


def e1_plan(B: int, P: int, L: int, sms: int) -> Tuple[int, int, int, int]:
    """Kernel E1's work split: ``(tiles a warp, warps, partials a row,
    finalize blocks)``.  The ``B·P`` rows of ``⌈L / TILE_SITES⌉`` tiles each,
    flattened row by row, go in contiguous ranges of ``tpw`` tiles to the
    warps of ``BLOCKS_PER_SM["kernel_e1"]`` blocks an SM (the last warp may
    have fewer); a row spans at most ``K`` warps, each of which leaves one
    partial of it."""
    tr = -(-L // TILE_SITES)
    rows = B * P
    n = rows * tr
    tpw = -(-n // (BLOCKS_PER_SM["kernel_e1"] * E1_WARPS * sms))
    return tpw, -(-n // tpw), (tpw + tr - 2) // tpw + 1, min(rows, E1_FIN_BLOCKS_PER_SM * sms)


# What pf_bwd_sizes reports first (kernel E1's layout; then the shared
# memory of an E1 block, in bytes).
E1_LAYOUT = (group_size(ATT_PARTS, D_KERNEL, N_HEADS_KERNEL), 4 * D_KERNEL, TILE_SITES, E1_WARPS,
             E1_PART)

_sizes_checked = False


def _bwd_lib():
    """The kernel library, the backward's packed layouts checked on first use."""
    global _sizes_checked
    lib = _lib()
    if not _sizes_checked:
        sizes = (ctypes.c_int * (len(E1_LAYOUT) + 1))()
        lib.pf_bwd_sizes(ctypes.addressof(sizes))
        if tuple(sizes)[:len(E1_LAYOUT)] != E1_LAYOUT:
            raise RuntimeError(f"kernel E1's layout mismatch: library "
                               f"{tuple(sizes)[:len(E1_LAYOUT)]}, wrapper {E1_LAYOUT}")
        tc = (ctypes.c_int * (len(TC_LAYOUT) + 3))()
        lib.pf_bwd_tc_sizes(ctypes.addressof(tc))
        if tuple(tc)[:len(TC_LAYOUT)] != TC_LAYOUT:
            raise RuntimeError(f"tensor-core backward layout mismatch: library "
                               f"{tuple(tc)[:len(TC_LAYOUT)]}, wrapper {TC_LAYOUT}")
        _sizes_checked = True
    return lib


def reduce_partials(partial: torch.Tensor) -> torch.Tensor:
    """``(G, S, N)`` per-block partials → ``(G, N)``, summed over the slots
    in the order of :func:`.reduce.reduce_plan`."""
    if _on_cpu(partial):
        return reduce_partials_plain(partial)
    G, S, N = partial.shape
    _require(partial, "partial", (G, S, N))
    out = reduce_slots(partial)
    LAUNCHES["reduce_partials"] += 1
    return out


def _require_group(wg: WeightGroup, name: str, parts: Sequence[str], mma: str = "") -> None:
    _require(wg.flat, name, (group_size(parts, D_KERNEL, N_HEADS_KERNEL),))
    if mma:
        _require(wg.mma, f"{name}.mma", (mma_size(mma, D_KERNEL, N_HEADS_KERNEL),))


def kernel_c(x1, g3, stats, pmask, pair_count, wc: WeightGroup, eps, passes=3):
    """``_kernel_c``: ``(g2, A1 (B, L, d), flat weight gradients)``, its
    products at ``passes`` TF32 passes."""
    _check_passes(passes)
    if _on_cpu(x1, g3, stats, pmask, pair_count, wc.flat):
        return kernel_c_plain(x1, g3, stats, pmask, pair_count, wc, eps, passes)
    B, P, L, d = x1.shape
    _check_width(d)
    _require(x1, "x1", (B, P, L, d))
    _require(g3, "g3", (B, P, L, d))
    _require(stats, "stats", (B, L, 3 * d))
    _require(pmask, "pmask", (B, P))
    _require(pair_count, "pair_count", (B,))
    _require_group(wc, "c", C_PARTS, mma="kernel_c")
    if P < 1:
        raise ValueError("kernel C needs at least one pair (two sequences)")
    nw = grad_size("kernel_c", d, N_HEADS_KERNEL)
    S = _bwd_slots("kernel_c", B, P, 4 * (L * d + nw), x1.device)
    g2 = torch.empty_like(x1)
    a1_part = torch.empty((B, S, L * d), device=x1.device, dtype=torch.float32)
    w_part = torch.empty((1, B * S, nw), device=x1.device, dtype=torch.float32)
    lib = _bwd_lib()
    _build.check(lib, lib.pf_kernel_c(
        x1.data_ptr(), g3.data_ptr(), stats.data_ptr(), pmask.data_ptr(),
        pair_count.data_ptr(), wc.flat.data_ptr(), wc.mma.data_ptr(), g2.data_ptr(),
        a1_part.data_ptr(), w_part.data_ptr(), B, P, L, S, float(eps), passes, _stream()),
        "kernel_c")
    LAUNCHES["kernel_c"] += 1
    a1 = reduce_partials(a1_part).view(B, L, d)
    return g2, a1, reduce_partials(w_part)[0]


def kernel_d(x1, g2, stats, a1, pmask, pair_count, wd: WeightGroup, eps, passes=3):
    """``_kernel_d``: ``(g1, flat weight gradients)``.  ``wd`` is
    :func:`e_group`'s of the column attention (the kernel reads its packed
    matrices)."""
    _check_passes(passes)
    if _on_cpu(x1, g2, stats, a1, pmask, pair_count, wd.flat):
        return kernel_d_plain(x1, g2, stats, a1, pmask, pair_count, wd, eps, passes)
    B, P, L, d = x1.shape
    _check_width(d)
    _require(x1, "x1", (B, P, L, d))
    _require(g2, "g2", (B, P, L, d))
    _require(stats, "stats", (B, L, 3 * d))
    _require(a1, "a1", (B, L, d))
    _require(pmask, "pmask", (B, P))
    _require(pair_count, "pair_count", (B,))
    _require_group(wd, "d", ATT_PARTS, mma="kernel_d")
    if P < 1:
        raise ValueError("kernel D needs at least one pair (two sequences)")
    nw = grad_size("kernel_d", d, N_HEADS_KERNEL)
    S = _bwd_slots("kernel_d", B, P, 4 * nw, x1.device)
    g1 = torch.empty_like(x1)
    w_part = torch.empty((1, B * S, nw), device=x1.device, dtype=torch.float32)
    lib = _bwd_lib()
    _build.check(lib, lib.pf_kernel_d(
        x1.data_ptr(), g2.data_ptr(), stats.data_ptr(), a1.data_ptr(), pmask.data_ptr(),
        pair_count.data_ptr(), wd.flat.data_ptr(), wd.mma.data_ptr(), g1.data_ptr(),
        w_part.data_ptr(), B, P, L, S, float(eps), passes, _stream()), "kernel_d")
    LAUNCHES["kernel_d"] += 1
    return g1, reduce_partials(w_part)[0]


def kernel_e(x, g1, smask, we: WeightGroup, eps, passes=3):
    """``_kernel_e``: ``(gx, flat weight gradients)``.  ``we`` is
    :func:`e_group`'s (the kernel reads its packed matrices)."""
    _check_passes(passes)
    if _on_cpu(x, g1, smask, we.flat):
        return kernel_e_plain(x, g1, smask, we, eps, passes)
    B, P, L, d = x.shape
    _check_width(d)
    _require(x, "x", (B, P, L, d))
    _require(g1, "g1", (B, P, L, d))
    _require(smask, "smask", (B, L))
    _require_group(we, "e", ATT_PARTS, mma="kernel_e")
    if P < 1:
        raise ValueError("kernel E needs at least one pair (two sequences)")
    if L > axial_block.RESIDENT_SITES_MAX:
        raise ValueError(f"kernel E takes up to {axial_block.RESIDENT_SITES_MAX} sites, got "
                         f"{L}: longer rows go through kernel_e1 and kernel_e2")
    nw = grad_size("kernel_e", d, N_HEADS_KERNEL)
    S = _bwd_slots("kernel_e", B, P, 4 * nw, x.device)
    gx = torch.empty_like(x)
    w_part = torch.empty((1, B * S, nw), device=x.device, dtype=torch.float32)
    lib = _bwd_lib()
    _build.check(lib, lib.pf_kernel_e(
        x.data_ptr(), g1.data_ptr(), smask.data_ptr(), we.flat.data_ptr(), we.mma.data_ptr(),
        gx.data_ptr(), w_part.data_ptr(), B, P, L, S, float(eps), passes, _stream()),
        "kernel_e")
    LAUNCHES["kernel_e"] += 1
    return gx, reduce_partials(w_part)[0]


def kernel_e1(x, g1, smask, we: WeightGroup, eps, passes=3):
    """``_kernel_e1``: each pair's raw row sums ``(B, P, 4d)``.  The kernel
    sums in :func:`kernel_e1_factored`'s association, its rows split over
    the card's warps by :func:`e1_plan`, in exact fp32 at every ``passes``:
    its bytes bind it, so ``passes`` is taken and ignored (at one pass it is
    more exact than JAX's single-pass ``_kernel_e1``)."""
    _check_passes(passes)
    if _on_cpu(x, g1, smask, we.flat):
        return kernel_e1_plain(x, g1, smask, we, eps, passes)
    B, P, L, d = x.shape
    _check_width(d)
    _require(x, "x", (B, P, L, d))
    _require(g1, "g1", (B, P, L, d))
    _require(smask, "smask", (B, L))
    _require_group(we, "e", ATT_PARTS)
    if P < 1:
        raise ValueError("kernel E1 needs at least one pair (two sequences)")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tpw, _, segs, fin_blocks = e1_plan(B, P, L, sms)
    part = torch.empty((B * P, segs, E1_PART), device=x.device, dtype=torch.float32)
    rowsums = torch.empty((B, P, 4 * d), device=x.device, dtype=torch.float32)
    lib = _bwd_lib()
    _build.check(lib, lib.pf_kernel_e1(
        x.data_ptr(), g1.data_ptr(), smask.data_ptr(), we.flat.data_ptr(), part.data_ptr(),
        rowsums.data_ptr(), B, P, L, tpw, segs, fin_blocks, float(eps), _stream()), "kernel_e1")
    LAUNCHES["kernel_e1"] += 1
    return rowsums


def e2_grid(B: int, P: int, L: int, device) -> Tuple[int, int]:
    """Kernel E2's grid per batch element, ``(pair slots, site chunks)``:
    the pairs split into slots as the other kernels' and, where they alone
    leave the card idle, the site tiles into chunks; partials under
    ``PARTIAL_BUDGET_BYTES``."""
    nw = grad_size("kernel_e", D_KERNEL, N_HEADS_KERNEL)
    sp = _bwd_slots("kernel_e2", B, P, 4 * nw, device)
    sc = max(1, min(-(-L // TC_TILE_SITES), -(-_bwd_blocks("kernel_e2", B, device) // sp),
                    PARTIAL_BUDGET_BYTES // (B * sp * 4 * nw)))
    return sp, sc


def kernel_e2(x, g1, rowsums, smask, we: WeightGroup, eps, passes=3):
    """``_kernel_e2``: ``(gx, flat weight gradients)`` from the row sums of
    :func:`kernel_e1`.  ``we`` is :func:`e_group`'s (the kernel reads its
    packed matrices).  The grid splits pairs into slots and, where the pairs
    alone leave the card idle, the site tiles into chunks (as kernel A2)."""
    _check_passes(passes)
    if _on_cpu(x, g1, rowsums, smask, we.flat):
        return kernel_e2_plain(x, g1, rowsums, smask, we, eps, passes)
    B, P, L, d = x.shape
    _check_width(d)
    _require(x, "x", (B, P, L, d))
    _require(g1, "g1", (B, P, L, d))
    _require(rowsums, "rowsums", (B, P, 4 * d))
    _require(smask, "smask", (B, L))
    _require_group(we, "e", ATT_PARTS, mma="kernel_e")
    if P < 1:
        raise ValueError("kernel E2 needs at least one pair (two sequences)")
    nw = grad_size("kernel_e", d, N_HEADS_KERNEL)
    sp, sc = e2_grid(B, P, L, x.device)
    gx = torch.empty_like(x)
    w_part = torch.empty((1, B * sp * sc, nw), device=x.device, dtype=torch.float32)
    lib = _bwd_lib()
    _build.check(lib, lib.pf_kernel_e2(
        x.data_ptr(), g1.data_ptr(), rowsums.data_ptr(), smask.data_ptr(), we.flat.data_ptr(),
        we.mma.data_ptr(), gx.data_ptr(), w_part.data_ptr(), B, P, L, sp, sc, float(eps),
        passes, _stream()), "kernel_e2")
    LAUNCHES["kernel_e2"] += 1
    return gx, reduce_partials(w_part)[0]


# ---- host function (axial_block_bwd.py:677-1039) ---------------------------

def fused_axial_block_bwd(x, x1, stats, g3, layer, site_mask, pair_mask, n_heads: int,
                          eps: float = 1e-5, pair_count=None, mxu_precision: str = "highest",
                          pair_group=None):
    """Backward of one fused axial block.

    ``x`` ``(B, P, L, d)`` the block input, ``x1`` the post-row-attention
    activations and ``stats`` ``(B, L, 3d)`` the raw column sums (the
    residuals of :func:`.fused.fused_axial_block_res`); ``g3`` the cotangent
    of the block output; ``layer`` one element of ``params["layers"]`` (or
    its :class:`BwdWeights`); masks bool or 0/1 float; ``pair_count``
    ``(B,)`` an optional override of the real pair counts;
    ``mxu_precision`` "highest" (three TF32 passes) or "default" (one, as
    JAX maps every other name).  On a pair shard (the sharded training of
    :mod:`.sharded`), ``pair_count`` is the global count and ``pair_group``
    the process group of the pair axis: A1, a sum over all pairs and the
    block backward's only coupling across shards, is all-reduced over it
    between kernels C and D (JAX's ``psum_axis``); the weight gradients stay
    this shard's.  Returns ``(gx, dlayer)``, ``dlayer`` in the layout of
    ``layer``.  Any length: the row backward is kernel E up to
    ``axial_block.RESIDENT_SITES_MAX`` sites (read at call time) and the
    L-tiled E1 then E2 above it."""
    b, p, l, d = x.shape
    w = layer if isinstance(layer, BwdWeights) else BwdWeights.of(layer)
    if w.n_heads != n_heads or d % n_heads:
        raise ValueError(f"n_heads={n_heads} does not match the layer "
                         f"({w.n_heads} heads, d={d})")
    if x.is_cuda and n_heads != N_HEADS_KERNEL:
        raise ValueError(f"the CUDA kernels are built for {N_HEADS_KERNEL} heads, "
                         f"got {n_heads}")
    smask = site_mask.to(torch.float32).contiguous()
    pmask = pair_mask.to(torch.float32).contiguous()
    if pair_count is None:
        pair_count = pmask.sum(dim=1)
    pair_count = pair_count.to(torch.float32).reshape(b).contiguous()
    x, x1, stats, g3 = (t.contiguous() for t in (x, x1, stats, g3))

    n = passes_of(mxu_precision)
    g2, a1, dc = kernel_c(x1, g3, stats, pmask, pair_count, w.c, eps, n)
    a1 = all_reduce_sum(a1, pair_group)
    g1, dd = kernel_d(x1, g2, stats, a1, pmask, pair_count, w.d, eps, n)
    if l > axial_block.RESIDENT_SITES_MAX:
        gx, de = kernel_e2(x, g1, kernel_e1(x, g1, smask, w.e, eps, n), smask, w.e, eps, n)
    else:
        gx, de = kernel_e(x, g1, smask, w.e, eps, n)
    dlayer: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, flat in (("kernel_e", de), ("kernel_d", dd), ("kernel_c", dc)):
        unpack_grads(name, flat, d, n_heads, dlayer)
    order = ("row_norm", "row_attn", "col_norm", "col_attn", "ffn_norm", "ffn")
    return gx, {k: dlayer[k] for k in order}
