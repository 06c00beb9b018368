"""Differentiable fused axial block: ``torch.autograd.Function``s.

The counterpart of ``phyloformer_tpu/ops/pallas/autodiff.py``:

- :class:`FusedAxialBlock`: the forward runs the fused kernels
  (:func:`.fused.fused_axial_block_res`) and keeps the residuals they
  produce, the block input ``x``, the post-row-attention ``x1`` and the
  column sums ``stats``; the backward runs kernels C, D and E, or E1 and E2
  on long rows (:func:`.axial_block_bwd.fused_axial_block_bwd`).  No forward
  recompute, and no site cap.
- :class:`FusedAxialBlockRemat`: the forward fused, the backward through
  autograd of the eager block (:func:`..models.phyloformer.axial_block`),
  one extra forward; ``PF_PALLAS_BWD=remat`` selects it.

Both take ``mxu_precision`` as a non-differentiable argument (JAX's
``nondiff_argnums``): "highest" runs the kernels' products in three TF32
passes, "default" in one, forward and backward; the remat backward then
recomputes the eager block with PyTorch's products in one TF32 pass on the
card, as JAX's ``_bwd_remat`` runs under ``default_matmul_precision``.

The layer's leaves enter as flat tensor inputs, in :data:`LAYER_LEAVES`
order, so that autograd returns their gradients; :func:`fused_axial_block_ad`
takes and returns the layer as its usual tree.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ...device import tf32_products
from .axial_block import passes_of
from .axial_block_bwd import fused_axial_block_bwd
from .fused import fused_axial_block, fused_axial_block_res

LAYER_LEAVES: Tuple[Tuple[str, str], ...] = (
    ("row_norm", "scale"), ("row_norm", "bias"),
    ("row_attn", "wq"), ("row_attn", "bq"), ("row_attn", "wk"), ("row_attn", "bk"),
    ("row_attn", "wv"), ("row_attn", "bv"), ("row_attn", "wo"), ("row_attn", "bo"),
    ("col_norm", "scale"), ("col_norm", "bias"),
    ("col_attn", "wq"), ("col_attn", "bq"), ("col_attn", "wk"), ("col_attn", "bk"),
    ("col_attn", "wv"), ("col_attn", "bv"), ("col_attn", "wo"), ("col_attn", "bo"),
    ("ffn_norm", "scale"), ("ffn_norm", "bias"),
    ("ffn", "w1"), ("ffn", "b1"), ("ffn", "w2"), ("ffn", "b2"),
)


def layer_leaves(layer: Dict[str, Any]) -> List[torch.Tensor]:
    return [layer[a][b] for a, b in LAYER_LEAVES]


def layer_tree(leaves) -> Dict[str, Dict[str, torch.Tensor]]:
    tree: Dict[str, Dict[str, torch.Tensor]] = {}
    for (a, b), t in zip(LAYER_LEAVES, leaves):
        tree.setdefault(a, {})[b] = t
    return tree


class FusedAxialBlock(torch.autograd.Function):
    """Fused forward (kernels A, B; A1, A2, B above ``RESIDENT_SITES_MAX``
    sites) and fused backward (kernels C, D, E; C, D, E1, E2 above it)."""

    @staticmethod
    def forward(ctx, x, site_mask, pair_mask, cfg, mxu_precision, *leaves):
        x3, x1, stats = fused_axial_block_res(x, layer_tree(leaves), site_mask, pair_mask,
                                              cfg.ln_eps, mxu_precision)
        ctx.cfg, ctx.mxu_precision = cfg, mxu_precision
        ctx.save_for_backward(x, x1, stats, site_mask, pair_mask, *leaves)
        return x3

    @staticmethod
    def backward(ctx, g3):
        x, x1, stats, site_mask, pair_mask, *leaves = ctx.saved_tensors
        gx, dlayer = fused_axial_block_bwd(x, x1, stats, g3, layer_tree(leaves), site_mask,
                                           pair_mask, ctx.cfg.n_heads, ctx.cfg.ln_eps,
                                           mxu_precision=ctx.mxu_precision)
        return (gx, None, None, None, None, *layer_leaves(dlayer))


class FusedAxialBlockRemat(torch.autograd.Function):
    """Fused forward; the backward recomputes the eager block and
    differentiates through it."""

    @staticmethod
    def forward(ctx, x, site_mask, pair_mask, cfg, mxu_precision, *leaves):
        ctx.cfg, ctx.mxu_precision = cfg, mxu_precision
        ctx.save_for_backward(x, site_mask, pair_mask, *leaves)
        return fused_axial_block(x, layer_tree(leaves), site_mask, pair_mask, cfg.ln_eps,
                                 mxu_precision)

    @staticmethod
    def backward(ctx, g3):
        from ...models.phyloformer import axial_block as eager_block

        x, site_mask, pair_mask, *leaves = ctx.saved_tensors
        one_pass = x.is_cuda and passes_of(ctx.mxu_precision) == 1
        with tf32_products(one_pass), torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in (x, *leaves)]
            out = eager_block(inputs[0], layer_tree(inputs[1:]), ctx.cfg, site_mask.bool(),
                              pair_mask.bool())
            grads = torch.autograd.grad(out, inputs, g3)
        return (grads[0], None, None, None, None, *grads[1:])


def fused_axial_block_ad(x, layer, site_mask, pair_mask, cfg, remat: bool = False,
                         mxu_precision: str = "highest"):
    """One differentiable fused block: ``x`` ``(B, P, L, d)``, ``layer`` a
    tree of leaves that may require grad, bool masks ``(B, L)`` / ``(B, P)``;
    ``mxu_precision`` "highest" (three TF32 passes) or "default" (one)."""
    fn = FusedAxialBlockRemat if remat else FusedAxialBlock
    return fn.apply(x, site_mask, pair_mask, cfg, mxu_precision, *layer_leaves(layer))
