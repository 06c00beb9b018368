"""The Phyloformer network as eager fp32 PyTorch — the plain model.

Embedding (one-hot ⊗ Conv1x1 as a table lookup) + ReLU → pair gather-add
``pair[k] = emb[i_k] + emb[j_k]`` → n_blocks axial blocks (row attention over
sites, column attention over pairs, 4× GELU FFN, pre-LN residuals) → softplus
head → mean over real sites.  Channel-last ``(B, P, L, d)``.  Optional masks
make padded sites and sequences exact no-ops.  Deterministic: dropout is not
yet ported (the published checkpoints use 0).

:func:`forward` is the plain eager model, differentiable by autograd (with
``remat=True`` each block is recomputed in the backward); :func:`forward_fused`
runs the same network through the fused axial-block kernels
(:mod:`..ops.kernels.fused`), and :func:`forward_fused_ad` does so for
training, with the fused backward kernels (:mod:`..ops.kernels.autodiff`).

On bf16 parameters (the engine's ``precision="bfloat16"``) :func:`forward`
runs in bf16 and rounds where XLA rounds the JAX package's bf16 model on
the CPU: after every op, except the squares and the residual sums that a
LayerNorm's mean reads (:func:`..ops.attention.layer_norm`), the argument
of the GELU's ``erfc`` (:func:`gelu`), and the quotient of the site mean,
which is fp32.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..data.pairs import pair_indices
from ..ops.attention import layer_norm, scaled_linear_attention
from ..ops.kernels.autodiff import fused_axial_block_ad
from ..ops.kernels.axial_block import head
from ..ops.kernels.fused import BlockWeights, fused_axial_block
from ..ops.kernels.pipeline import PipelineWeights
from ..parallel.mesh import all_reduce_sum_ad
from .params import Params, PhyloformerConfig


def gelu(h: torch.Tensor) -> torch.Tensor:
    """Exact GELU.  On bf16 ``h``, JAX's form ``0.5·h·erfc(-h·√½)`` as XLA
    compiles it: ``0.5·h``, the ``erfc`` and the product each rounded to
    bf16, the ``erfc``'s argument (with √½ rounded to bf16) not."""
    if h.dtype != torch.bfloat16:
        return F.gelu(h, approximate="none")
    sqrt_half = float(torch.tensor(0.5 ** 0.5, dtype=torch.bfloat16))
    return 0.5 * h * torch.erfc(-h.float() * sqrt_half).to(h.dtype)


def softplus(h: torch.Tensor) -> torch.Tensor:
    """log(1 + eˣ).  On bf16 ``h``, JAX's ``logaddexp(h, 0)`` op by op,
    each op rounded to bf16, as XLA compiles it."""
    if h.dtype != torch.bfloat16:
        return F.softplus(h)
    return h.clamp_min(0) + torch.log1p(torch.exp(-h.abs()))


def embed_alignment(params: Params, codes: torch.Tensor) -> torch.Tensor:
    """``(B, n, L)`` integer codes → ``(B, n, L, d)``: table lookup + ReLU."""
    w, b = params["embed"]["w"], params["embed"]["b"]
    return torch.relu(w[codes.long()] + b)


def _pair_index_tensors(n_seqs: int, device) -> "tuple[torch.Tensor, torch.Tensor]":
    i_idx, j_idx = pair_indices(n_seqs)
    return (torch.as_tensor(i_idx, dtype=torch.long, device=device),
            torch.as_tensor(j_idx, dtype=torch.long, device=device))


def build_pairs(emb: torch.Tensor, n_seqs: int) -> torch.Tensor:
    """``(B, n, L, d)`` → ``(B, P, L, d)``, ``pair[k] = emb[i_k] + emb[j_k]``."""
    i_idx, j_idx = _pair_index_tensors(n_seqs, emb.device)
    return emb.index_select(1, i_idx) + emb.index_select(1, j_idx)


def pair_mask_from_seq_mask(seq_mask: torch.Tensor, n_seqs: int) -> torch.Tensor:
    """``(B, n)`` sequence mask → ``(B, P)`` pair mask."""
    i_idx, j_idx = _pair_index_tensors(n_seqs, seq_mask.device)
    return seq_mask.index_select(1, i_idx) & seq_mask.index_select(1, j_idx)


def _residual(x: torch.Tensor, h: torch.Tensor):
    """``x + h`` in ``x``'s type, and, where that rounds (bf16), the fp32
    sum it rounds, for the next LayerNorm's mean; else None."""
    s = x.float() + h.float()
    return s.to(x.dtype), (s if x.dtype != s.dtype else None)


def _block(x, x_sum, layer, cfg, site_mask, pair_mask, pair_sum=None):
    """:func:`axial_block` on ``x`` and the fp32 sum it rounds (or None);
    returns the same pair for the block's output.  ``pair_sum``: on a pair
    shard, the sum of a column-attention partial over the shards."""
    row_mask = site_mask[:, None, :] if site_mask is not None else None  # (B,1,L)
    col_mask = pair_mask[:, None, :] if pair_mask is not None else None  # (B,1,P)

    h = layer_norm(x, layer["row_norm"]["scale"], layer["row_norm"]["bias"], cfg.ln_eps, x_sum)
    x, x_sum = _residual(x, scaled_linear_attention(h, layer["row_attn"], cfg.n_heads,
                                                    mask=row_mask))

    h = layer_norm(x, layer["col_norm"]["scale"], layer["col_norm"]["bias"], cfg.ln_eps, x_sum)
    h = scaled_linear_attention(h.transpose(1, 2), layer["col_attn"], cfg.n_heads,
                                mask=col_mask, axis_sum=pair_sum)
    x, x_sum = _residual(x, h.transpose(1, 2))

    h = layer_norm(x, layer["ffn_norm"]["scale"], layer["ffn_norm"]["bias"], cfg.ln_eps, x_sum)
    h = gelu(h @ layer["ffn"]["w1"] + layer["ffn"]["b1"])
    return _residual(x, h @ layer["ffn"]["w2"] + layer["ffn"]["b2"])


def axial_block(
    x: torch.Tensor,
    layer: Dict[str, Any],
    cfg: PhyloformerConfig,
    site_mask: Optional[torch.Tensor],
    pair_mask: Optional[torch.Tensor],
) -> torch.Tensor:
    """One Phyloformer layer on ``(B, P, L, d)``."""
    return _block(x, None, layer, cfg, site_mask, pair_mask)[0]


def forward(
    params: Params,
    codes: torch.Tensor,
    cfg: PhyloformerConfig,
    site_mask: Optional[torch.Tensor] = None,
    seq_mask: Optional[torch.Tensor] = None,
    remat: bool = False,
    shard=None,
) -> torch.Tensor:
    """Predict pairwise distances: ``(B, n, L)`` codes → ``(B, P)`` fp32,
    ``P = n(n-1)/2`` in upper-triangle order.  Padded pairs hold garbage;
    mask them with :func:`pair_mask_from_seq_mask`.  ``remat``: keep only
    each block's input for the backward and recompute the block there
    (``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint``).

    ``shard``: a :class:`..ops.kernels.sharded.PairShard`, the pair-axis
    sharding of JAX's ``act_sharding``: only this rank's block of pairs is
    built and returned, ``(B, per)``, under its pair mask (padding pairs
    masked), and the column attention's pair-axis sums are all-reduced over
    the shard's pair group, differentiably."""
    n_seqs = codes.shape[1]
    emb = embed_alignment(params, codes)
    if shard is None:
        i_idx, j_idx = _pair_index_tensors(n_seqs, emb.device)
        pair_mask = pair_mask_from_seq_mask(seq_mask, n_seqs) if seq_mask is not None else None
        pair_sum = None
    else:
        i_idx, j_idx = shard.i, shard.j
        if seq_mask is None:
            seq_mask = torch.ones(codes.shape[:2], dtype=torch.bool, device=codes.device)
        pair_mask = shard.pair_mask(seq_mask)
        group = shard.group
        pair_sum = lambda t: all_reduce_sum_ad(t, group)  # noqa: E731
    x, x_sum = _residual(emb.index_select(1, i_idx), emb.index_select(1, j_idx))
    for layer in params["layers"]:
        if remat:
            x, x_sum = checkpoint(_block, x, x_sum, layer, cfg, site_mask, pair_mask, pair_sum,
                                  use_reentrant=False)
        else:
            x, x_sum = _block(x, x_sum, layer, cfg, site_mask, pair_mask, pair_sum)

    h = softplus(x @ params["head"]["w"] + params["head"]["b"])[..., 0]  # (B, P, L)
    if site_mask is not None:
        m = site_mask[:, None, :].to(h.dtype)
        return (h * m).sum(dim=-1).float() / m.sum(dim=-1).clamp_min(1.0).float()
    return h.float().mean(dim=-1)


def forward_fused(
    params,
    codes: torch.Tensor,
    cfg: PhyloformerConfig,
    site_mask: Optional[torch.Tensor] = None,
    seq_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The forward of :func:`forward` through the fused kernels: per block
    kernel A then kernel B, or above ``RESIDENT_SITES_MAX`` sites the
    L-tiled A1, A2 then B.  No site cap.  The head runs as tensor code, as
    in the JAX package, in fp32 at every precision.  ``cfg.matmul_precision``
    "float32" runs the kernels' products in three TF32 passes, the others
    ("tensorfloat32", "default") in one, as JAX's ``mxu_precision``
    "highest" / "default"; storage stays fp32 and the GELU exact.

    ``params``: a parameter tree, or the :class:`PipelineWeights` made from
    one (as the engine holds them).  CUDA tensors run the kernels, CPU
    tensors their plain versions.  Returns ``(B, P)`` distances."""
    w = params if isinstance(params, PipelineWeights) else PipelineWeights.from_params(params)
    b, n_seqs, seq_len = codes.shape
    if site_mask is None:
        site_mask = torch.ones((b, seq_len), dtype=torch.bool, device=codes.device)
    if seq_mask is None:
        seq_mask = torch.ones((b, n_seqs), dtype=torch.bool, device=codes.device)
    smask = site_mask.to(torch.float32).contiguous()
    pmask = pair_mask_from_seq_mask(seq_mask, n_seqs).to(torch.float32).contiguous()

    mxu_precision = "highest" if cfg.matmul_precision == "float32" else "default"
    x = build_pairs(torch.relu(w.embed_w[codes.long()] + w.embed_b), n_seqs)
    for row, col, bw in zip(w.row, w.col, w.b):
        x = fused_axial_block(x, BlockWeights(row, col, bw), smask, pmask, cfg.ln_eps,
                              mxu_precision)
    return head(x, w.head.parts[0], w.head.parts[1], smask)


def forward_fused_ad(
    params: Params,
    codes: torch.Tensor,
    cfg: PhyloformerConfig,
    site_mask: Optional[torch.Tensor] = None,
    seq_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The training forward through the fused kernels, differentiable: per
    block kernels A and B forward and C, D and E backward, or above
    ``RESIDENT_SITES_MAX`` sites A1, A2, B and C, D, E1, E2
    (:class:`..ops.kernels.autodiff.FusedAxialBlock`);
    ``PF_PALLAS_BWD=remat`` backpropagates through the eager block instead.
    The embedding, pair build and head are tensor code, as in the JAX
    package's ``_forward_pallas_ad``; the head in fp32 at every precision.
    ``cfg.matmul_precision`` "float32" runs the kernels' products in three
    TF32 passes, the others in one, forward and backward (JAX's rule, its
    ``mxu``).  CUDA tensors run the kernels, CPU tensors their plain
    versions.  No site cap, and no counterpart of the JAX trainer's
    ``PF_PALLAS_TRAIN_MAX_SITES`` fallback.  Returns ``(B, P)`` distances."""
    mode = os.environ.get("PF_PALLAS_BWD", "fused")
    if mode not in ("fused", "remat"):
        raise ValueError(f"PF_PALLAS_BWD={mode!r}: expected 'fused' or 'remat'")
    b, n_seqs, seq_len = codes.shape
    if site_mask is None:
        site_mask = torch.ones((b, seq_len), dtype=torch.bool, device=codes.device)
    if seq_mask is None:
        seq_mask = torch.ones((b, n_seqs), dtype=torch.bool, device=codes.device)
    smask = site_mask.to(torch.float32).contiguous()
    pmask = pair_mask_from_seq_mask(seq_mask, n_seqs).to(torch.float32).contiguous()
    mxu = "highest" if cfg.matmul_precision == "float32" else "default"
    x = build_pairs(embed_alignment(params, codes), n_seqs)
    for layer in params["layers"]:
        x = fused_axial_block_ad(x, layer, smask, pmask, cfg, remat=mode == "remat",
                                 mxu_precision=mxu)
    h = F.softplus(x @ params["head"]["w"] + params["head"]["b"])[..., 0]
    return (h * smask[:, None, :]).sum(dim=-1) / smask.sum(dim=-1).clamp_min(1.0)[:, None]
