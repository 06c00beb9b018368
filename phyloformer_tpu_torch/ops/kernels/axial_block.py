"""Plain PyTorch versions of the axial-block kernel bodies.

These are the functions the CUDA kernels of ``csrc/axial_pipeline.cu``
compute, written as eager tensor code in the op order of the JAX bodies
(``phyloformer_tpu/ops/pallas/axial_block.py:172-249``).  The CPU path runs
them, the tests hold them against JAX, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card.  They are general in ``d`` and the head
count; the q/k weights come pre-expanded to ``(d, d)``
(:func:`expand_qk_weights`).

The two passes of the L-tiled kernel A (``_kernel_a1`` / ``_kernel_a2``,
``axial_block.py:314-411``) are :func:`row_sums` and
:func:`row_finalize_col_stats`; kernel A itself is :func:`body_row_attn`
then :func:`body_col_stats`, kernel B is :func:`body_b`.

Shapes: activations ``(B, P, L, d)``; ``smask`` ``(B, L)`` and ``pmask``
``(B, P)`` fp32 0/1; column stats ``(B, L, 3d)`` laid out
``[Σk | Σq | Σk·v]``; per-pair row sums ``(B, P, 3d)`` laid out
``[Σq | Σk | Σk·v]`` (q first, as ``_kernel_a1`` writes them).

``passes``: the TF32 passes of the kernels' products.  3 (split TF32, within
~2^-22 of fp32) is computed as the plain fp32 product; 1 (one TF32 pass, the
reduced-precision forward) as ``tf32_rna(a) @ tf32_rna(w)`` in fp32, the
operands rounded as the kernel rounds them (:func:`mm`).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch

from ..attention import layer_norm

# Longest site axis that the fused forward runs with kernel A on whole rows
# (the counterpart of the JAX package's fp32 ``_RESIDENT_SITES_MAX_HI``);
# longer site axes take the L-tiled A1/A2 passes, and at fp32-grade products
# the pipeline serves only buckets up to it.  Read at call time, so tests
# may lower it.
RESIDENT_SITES_MAX = 1024
# The pipeline's longest site axis at reduced-precision products (JAX's
# ``_RESIDENT_SITES_MAX``, which it keeps for the one-pass kernels).
RESIDENT_SITES_MAX_REDUCED = 2048


def expand_qk_weights(layer: Dict[str, Any]) -> Dict[str, Any]:
    """Repeat each head's q/k projection column over its ``d / H`` value
    lanes, in the row and column attention of one layer.  φ commutes with
    repetition, so this is exact."""

    def ex(attn):
        d, h = attn["wq"].shape
        hd = d // h
        out = dict(attn)
        for k in ("wq", "wk"):
            out[k] = attn[k].repeat_interleave(hd, dim=1)
        for k in ("bq", "bk"):
            out[k] = attn[k].repeat_interleave(hd)
        return out

    new = dict(layer)
    new["row_attn"] = ex(layer["row_attn"])
    new["col_attn"] = ex(layer["col_attn"])
    return new


# The FFN's activations, in the order of their kernel codes (GELU_EXACT ..
# GELU_RELU in csrc/axial_pipeline.cuh); JAX's ``_GELU_FNS``.
GELU_MODES = ("exact", "tanh", "sigmoid", "relu")
# TF32 passes of the kernels' products: split TF32, or one pass.
PASSES = (3, 1)


def gelu(x: torch.Tensor, mode: str = "exact") -> torch.Tensor:
    if mode == "exact":
        return 0.5 * x * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))
    if mode == "tanh":
        inner = math.sqrt(2.0 / math.pi) * (x + 0.044715 * x * x * x)
        return 0.5 * x * (1.0 + torch.tanh(inner))
    if mode == "sigmoid":
        return x * torch.sigmoid(1.702 * x)
    if mode == "relu":
        return torch.clamp_min(x, 0.0)
    raise ValueError(f"gelu mode {mode!r}: expected one of {GELU_MODES}")


def passes_of(mxu_precision: str) -> int:
    """The products' TF32 passes for a JAX matmul-precision name: 3 for
    "highest" / "float32" (IEEE fp32 grade), 1 for anything else ("default",
    "tensorfloat32"), as JAX reads it."""
    return 3 if mxu_precision.lower() in ("highest", "float32") else 1


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 → the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: half of the low 13 bits' weight
    is added to the magnitude, then the 13 bits are cleared."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def mm(a: torch.Tensor, w: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """A kernel's product ``a @ w``: fp32 at three passes, the one-pass
    TF32 product (both operands rounded by :func:`tf32_rna`, fp32
    accumulation) at one."""
    if passes == 3:
        return a @ w
    if passes == 1:
        return tf32_rna(a) @ tf32_rna(w)
    raise ValueError(f"passes={passes}: expected one of {PASSES}")


def phi(x: torch.Tensor) -> torch.Tensor:
    """elu(x) + 1: x + 1 for x > 0, exp(x) otherwise."""
    return torch.where(x > 0, x + 1.0, torch.exp(x.clamp_max(0.0)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    return x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))


def _guard(s: torch.Tensor) -> torch.Tensor:
    """where(s > 0, s, 1): fully masked axes give zero sums."""
    return torch.where(s > 0, s, torch.ones_like(s))


def body_row_attn(x: torch.Tensor, smask: torch.Tensor, rp: Sequence[torch.Tensor],
                  eps: float, passes: int = 3) -> torch.Tensor:
    """Row sub-block on the whole site axis: ``x1 = x + rowattn(LN x)``.

    ``rp = (ln_s, ln_b, wq, bq, wk, bk, wv, bv, wo, bo)``."""
    ln_s, ln_b, wq, bq, wk, bk, wv, bv, wo, bo = rp
    m = smask[:, None, :, None]
    h = layer_norm(x, ln_s, ln_b, eps)
    q = phi(mm(h, wq, passes) + bq) * m
    k = phi(mm(h, wk, passes) + bk) * m
    v = mm(h, wv, passes) + bv

    count = smask.sum(dim=-1).clamp_min(1.0)[:, None, None, None]
    q_mean = _guard(q.sum(dim=2, keepdim=True) / count)
    k_sum = _guard(k.sum(dim=2, keepdim=True))
    ctx = (k / k_sum * v).sum(dim=2, keepdim=True)  # (B, P, 1, d)
    return x + (mm(q / q_mean * ctx, wo, passes) + bo)


def row_sums(x: torch.Tensor, smask: torch.Tensor, rp: Sequence[torch.Tensor],
             eps: float, passes: int = 3) -> torch.Tensor:
    """L-tiled pass 1 (``_kernel_a1``): per-pair masked row sums
    ``(B, P, 3d)`` = ``[Σq | Σk | Σk·v]`` over the site axis.

    ``rp``: the row group ``(ln_s, ln_b, wq, bq, wk, bk, wv, bv, wo, bo)``."""
    ln_s, ln_b, wq, bq, wk, bk, wv, bv = rp[:8]
    m = smask[:, None, :, None]
    h = layer_norm(x, ln_s, ln_b, eps)
    q = phi(mm(h, wq, passes) + bq) * m
    k = phi(mm(h, wk, passes) + bk) * m
    v = mm(h, wv, passes) + bv
    return torch.cat([q.sum(dim=2), k.sum(dim=2), (k * v).sum(dim=2)], dim=-1)


def row_finalize_col_stats(x: torch.Tensor, rowstats: torch.Tensor, smask: torch.Tensor,
                           pmask: torch.Tensor, rp: Sequence[torch.Tensor],
                           cp: Sequence[torch.Tensor], eps: float, passes: int = 3):
    """L-tiled pass 2 (``_kernel_a2``): row attention finalized from the
    row sums of :func:`row_sums` (q-mean over the real site count, the
    one-pass ``ctx = Σk·v / Σk``), then the column stats of the result.
    Returns ``(x1, stats)``."""
    ln_s, ln_b, wq, bq, _, _, _, _, wo, bo = rp
    d = x.shape[-1]
    h = layer_norm(x, ln_s, ln_b, eps)
    q = phi(mm(h, wq, passes) + bq) * smask[:, None, :, None]
    count = smask.sum(dim=-1).clamp_min(1.0)[:, None, None]
    q_mean = _guard(rowstats[..., :d] / count)  # (B, P, d)
    k_sum = _guard(rowstats[..., d:2 * d])
    ctx = rowstats[..., 2 * d:] / k_sum
    x1 = x + (mm((q / q_mean[:, :, None]) * ctx[:, :, None], wo, passes) + bo)
    return x1, body_col_stats(x1, pmask, cp, eps, passes)


def body_col_stats(x1: torch.Tensor, pmask: torch.Tensor, cp: Sequence[torch.Tensor],
                   eps: float, passes: int = 3) -> torch.Tensor:
    """Column-attention sums over the pair axis: ``(B, L, 3d)``.

    ``cp = (ln_s, ln_b, wq, bq, wk, bk, wv, bv)``."""
    ln_s, ln_b, wq, bq, wk, bk, wv, bv = cp
    m = pmask[:, :, None, None]
    hc = layer_norm(x1, ln_s, ln_b, eps)
    qc = phi(mm(hc, wq, passes) + bq) * m
    kc = phi(mm(hc, wk, passes) + bk) * m
    vc = mm(hc, wv, passes) + bv
    return torch.cat([kc.sum(dim=1), qc.sum(dim=1), (kc * vc).sum(dim=1)], dim=-1)


def body_b(x1: torch.Tensor, stats: torch.Tensor, n_pairs: torch.Tensor,
           bp: Sequence[torch.Tensor], eps: float, gelu_mode: str = "exact",
           passes: int = 3) -> torch.Tensor:
    """Column attention finalised from the global stats, then the FFN: x3.

    ``n_pairs``: ``(B,)`` real pair counts, already ``max(count, 1)``.
    ``bp = (cn_s, cn_b, cwq, cbq, cwo, cbo, fn_s, fn_b, w1, b1, w2, b2)``."""
    cn_s, cn_b, cwq, cbq, cwo, cbo, fn_s, fn_b, w1, b1, w2, b2 = bp
    d = x1.shape[-1]
    qc = phi(mm(layer_norm(x1, cn_s, cn_b, eps), cwq, passes) + cbq)
    k_sum = _guard(stats[..., :d])
    q_mean = _guard(stats[..., d:2 * d] / n_pairs[:, None, None])
    ctx = stats[..., 2 * d:] / k_sum  # (B, L, d)
    x2 = x1 + (mm((qc / q_mean[:, None]) * ctx[:, None], cwo, passes) + cbo)
    f = gelu(mm(layer_norm(x2, fn_s, fn_b, eps), w1, passes) + b1, gelu_mode)
    return x2 + (mm(f, w2, passes) + b2)


def head(x3: torch.Tensor, hw: torch.Tensor, hb: torch.Tensor,
         smask: torch.Tensor) -> torch.Tensor:
    """Head d→1, softplus, mean over real sites: ``(B, P, L, d)`` → ``(B, P)``;
    fp32 at every pass count (JAX pins the pipeline's head HIGHEST)."""
    sp = softplus(x3 @ hw + hb)[..., 0]  # (B, P, L)
    count = smask.sum(dim=-1).clamp_min(1.0)[:, None]
    return (sp * smask[:, None, :]).sum(dim=-1) / count
