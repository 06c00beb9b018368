"""Scaled linear attention — the core Phyloformer operator — in PyTorch.

- Q and K are projected to one scalar per head (``wq``/``wk`` are ``(d, H)``);
- feature map ``φ(x) = elu(x) + 1`` (positive);
- Q is rescaled by its mean over the attended axis, K normalised to sum 1;
- output ``φQ · (φKᵀ V)`` per head, then the output projection.

A boolean mask over the attended axis enters every reduction, so padded
positions are exact no-ops.  Fully masked axes give zero sums; they are
replaced by 1 (``where(s > 0, s, 1)``) so no NaN appears.

:func:`multi_head_attention` (softmax) and :func:`linear_kernel_attention`
are the JAX package's ablation ops, plain PyTorch; no path of the model
calls them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F


def phi(x: torch.Tensor) -> torch.Tensor:
    """The linear-attention feature map φ(x) = elu(x) + 1 (> 0)."""
    return F.elu(x) + 1.0


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5, x_sum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LayerNorm over the channel (last) axis, written out as the JAX
    package writes it (biased variance).  On bf16 ``x`` every op rounds to
    bf16 except where XLA does not round JAX's bf16 LayerNorm: the mean is
    taken from ``x_sum`` (fp32, the residual sum that ``x`` is the rounding
    of) when given, and the squares are summed in fp32 unrounded."""
    mu = (x if x_sum is None else x_sum).float().mean(dim=-1, keepdim=True).to(x.dtype)
    var = (x - mu).float().square().mean(dim=-1, keepdim=True).to(x.dtype)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def scaled_linear_attention(
    x: torch.Tensor,
    params: Dict[str, torch.Tensor],
    n_heads: int,
    mask: Optional[torch.Tensor] = None,
    axis_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Scaled linear attention over axis ``-2`` of ``x`` ``(..., A, d)``.

    ``params``: ``wq/bq``, ``wk/bk`` ``(d, H)``; ``wv/bv``, ``wo/bo`` ``(d, d)``.
    ``mask``: optional bool ``(..., A)`` (broadcastable); False = padded.
    ``axis_sum``: where ``x`` holds one shard of the attended axis, the
    function that sums a partial over the shards (a differentiable
    all-reduce); it is applied to the attended-axis sums (the count, Σq, Σk
    and Σk·v), which takes ``mask``.
    """
    d = x.shape[-1]
    head_dim = d // n_heads

    q = phi(x @ params["wq"] + params["bq"])  # (..., A, H)
    k = phi(x @ params["wk"] + params["bk"])  # (..., A, H)
    v = x @ params["wv"] + params["bv"]  # (..., A, d)

    if axis_sum is not None and mask is None:
        raise ValueError("a sharded attended axis needs its mask")
    total = axis_sum or (lambda t: t)
    if mask is not None:
        m = mask[..., None].to(q.dtype)  # (..., A, 1)
        q = q * m
        k = k * m
        count = total(m.sum(dim=-2, keepdim=True))
        q_mean = total(q.sum(dim=-2, keepdim=True)) / count.clamp_min(1.0)
        k_sum = total(k.sum(dim=-2, keepdim=True))
        q_mean = torch.where(q_mean > 0, q_mean, torch.ones_like(q_mean))
        k_sum = torch.where(k_sum > 0, k_sum, torch.ones_like(k_sum))
    else:
        q_mean = q.mean(dim=-2, keepdim=True)
        k_sum = k.sum(dim=-2, keepdim=True)

    q = q / q_mean
    k = k / k_sum

    # per head h: ctx[h] = Σ_A k[A, h] · v[A, h*hd:(h+1)*hd]
    v_heads = v.reshape(v.shape[:-1] + (n_heads, head_dim))
    ctx = total(torch.einsum("...ah,...ahd->...hd", k, v_heads))
    out = torch.einsum("...ah,...hd->...ahd", q, ctx)
    out = out.reshape(out.shape[:-2] + (d,))
    return out @ params["wo"] + params["bo"]


def multi_head_attention(
    x: torch.Tensor,
    params: Dict[str, torch.Tensor],
    n_heads: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Softmax attention over axis ``-2``, the JAX package's ablation op
    (``multi_head_attention``, the reference's unused ``MultiHeadAttention``
    variant).  Params as in :func:`scaled_linear_attention` but with
    ``wq``/``wk`` ``(d, d)``; masked keys take a -1e30 logit bias."""
    d = x.shape[-1]
    hd = d // n_heads

    def split(t):
        return t.reshape(t.shape[:-1] + (n_heads, hd))

    q = split(x @ params["wq"] + params["bq"])  # (..., A, H, hd)
    k = split(x @ params["wk"] + params["bk"])
    v = split(x @ params["wv"] + params["bv"])
    logits = torch.einsum("...ahe,...bhe->...hab", q, k) / float(hd) ** 0.5
    if mask is not None:
        logits = logits + torch.where(mask[..., None, None, :], 0.0, -1e30).to(logits.dtype)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("...hab,...bhe->...ahe", probs, v)
    return out.reshape(out.shape[:-2] + (d,)) @ params["wo"] + params["bo"]


def linear_kernel_attention(
    x: torch.Tensor,
    params: Dict[str, torch.Tensor],
    n_heads: int,
    mask: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Linear-kernel attention with the ``Z`` denominator and full head
    dims, the JAX package's ablation op (``linear_kernel_attention``, the
    reference's unused ``LinearKernelAttention`` variant); params as in
    :func:`multi_head_attention`."""
    d = x.shape[-1]
    hd = d // n_heads

    def split(t):
        return t.reshape(t.shape[:-1] + (n_heads, hd))

    q = phi(split(x @ params["wq"] + params["bq"]))  # (..., A, H, hd)
    k = phi(split(x @ params["wk"] + params["bk"]))
    v = split(x @ params["wv"] + params["bv"])
    if mask is not None:
        m = mask[..., None, None].to(q.dtype)
        q, k, v = q * m, k * m, v * m
    ktv = torch.einsum("...ahe,...ahf->...hef", k, v)
    ksum = k.sum(dim=-3)  # (..., H, hd)
    z = 1.0 / (torch.einsum("...ahe,...he->...ah", q, ksum) + eps)
    out = torch.einsum("...ahe,...hef->...ahf", q, ktv) * z[..., None]
    return out.reshape(out.shape[:-2] + (d,)) @ params["wo"] + params["bo"]
