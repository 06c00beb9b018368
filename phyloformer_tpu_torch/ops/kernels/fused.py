"""The fused axial block: kernel A then kernel B, or A1, A2 then B.

The PyTorch side of ``pf_kernel_a`` (``csrc/axial_pipeline.cu``) and of
``pf_kernel_a1`` / ``pf_kernel_a2`` / ``pf_kernel_b``
(``csrc/axial_fused.cu``), and the counterpart of the host functions of
``phyloformer_tpu/ops/pallas/axial_block.py``:

- :func:`fused_axial_block` / :func:`fused_axial_block_res`: one block,
  ``x → x3`` (and the residuals ``(x3, x1, stats)``);
- :func:`fused_kernel_a`: kernel A alone, ``(x1, stats)``;
- :func:`kernel_b_host`: kernel B on a pair shard, from the global stats and
  pair count (the sharded forward's, :mod:`.sharded`);
- up to :data:`axial_block.RESIDENT_SITES_MAX` sites, kernel A walks whole
  rows (:func:`kernel_a`); above it the two L-tiled passes run
  (:func:`kernel_a1`, :func:`kernel_a2`); kernel B (:func:`kernel_b`) is
  local to each pair-site and serves both.

Every kernel takes the TF32 passes of its products (``passes``: 3, split
TF32, or 1 for the reduced-precision forward; the host functions take JAX's
``mxu_precision`` name instead); storage stays fp32 and the activation
exact GELU, as in JAX's ``forward_fused``.

Each wrapper takes its plain PyTorch version only for tensors on the CPU and
launches its kernel (adding one to its entry in ``pipeline.LAUNCHES``) or
raises for CUDA tensors.  Every output is a new tensor: x1 survives kernel
B, as the residual contract of the fused backward needs.  The TPU's tile
pickers (``_pick_tile``, ``_ltiled_tiles``) have no counterpart: the CUDA
kernels take any ``P`` and ``L`` and choose their own grids.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Union

import torch

from . import _build
from . import axial_block
from .axial_block import (
    body_b,
    expand_qk_weights,
    passes_of,
    row_finalize_col_stats,
    row_sums,
)
from .pipeline import (
    B_MMA_SIZE,
    B_SIZE,
    COL_MMA_SIZE,
    COL_SIZE,
    D_KERNEL,
    FWD_TILE_SITES,
    LAUNCHES,
    ROW_MMA_SIZE,
    ROW_SIZE,
    WeightGroup,
    _check_passes,
    _check_width,
    _grid_blocks,
    _lib,
    _on_cpu,
    _require,
    _require_groups,
    _scratch,
    _slots,
    _stream,
    b_group,
    col_group,
    kernel_a_only_plain,
    reduce_stats,
    row_group,
)

# Column-stat partials of one kernel A or A2 launch stay under this size:
# the reduction reads all of them, and the pipeline's rule of ~8 blocks per
# SM would need 1.2 GB at (1770 pairs, 1536 sites) and more at longer L.
PARTIAL_BUDGET_BYTES = 256 * 1024 * 1024
# At most this many pair slots (partials) per batch element in A2; site
# chunks fill the rest of the grid.
A2_MAX_PAIR_SLOTS = 64


@dataclass(frozen=True)
class BlockWeights:
    """One layer's weight groups for kernels A/A1/A2 (row, col) and B."""

    row: WeightGroup
    col: WeightGroup
    b: WeightGroup

    @classmethod
    def of(cls, layer: Union["BlockWeights", Dict[str, Any]]) -> "BlockWeights":
        """From one element of ``params["layers"]`` (q/k expanded here), or
        as it is."""
        if isinstance(layer, cls):
            return layer
        ex = expand_qk_weights(layer)
        return cls(row_group(ex), col_group(ex), b_group(ex))


def _budget_slots(B: int, L: int) -> int:
    return max(1, PARTIAL_BUDGET_BYTES // (B * L * 3 * D_KERNEL * 4))


# ---- plain versions -------------------------------------------------------
# kernel A computes kernel_a_only_plain's function (pipeline.py).

def kernel_b_plain(x1, stats, pair_count, bw: WeightGroup, eps, passes=3):
    return body_b(x1, stats, pair_count.clamp_min(1.0), bw.parts, eps, passes=passes)


def kernel_a1_plain(x, smask, rw: WeightGroup, eps, passes=3):
    return row_sums(x, smask, rw.parts, eps, passes)


def kernel_a2_plain(x, rowstats, smask, pmask, rw: WeightGroup, cw: WeightGroup, eps,
                    passes=3):
    return row_finalize_col_stats(x, rowstats, smask, pmask, rw.parts, cw.parts, eps, passes)


# ---- CUDA wrappers --------------------------------------------------------

def kernel_a(x, smask, pmask, rw: WeightGroup, cw: WeightGroup, eps, passes=3):
    """``_kernel_a``: ``x`` ``(B, P, L, d)`` → x1 (a new tensor), stats
    ``(B, L, 3d)``."""
    _check_passes(passes)
    if _on_cpu(x, smask, pmask, rw.flat, cw.flat):
        return kernel_a_only_plain(x, smask, pmask, rw, cw, eps, passes)
    B, P, L, d = x.shape
    _check_width(d)
    _require(x, "x", (B, P, L, d))
    _require(smask, "smask", (B, L))
    _require(pmask, "pmask", (B, P))
    _require_groups(row=(rw, ROW_SIZE, ROW_MMA_SIZE), col=(cw, COL_SIZE, COL_MMA_SIZE))
    S, rowsum, partial = _scratch(B, P, L, x.device, _budget_slots(B, L))
    x1 = torch.empty_like(x)
    lib = _lib()
    _build.check(lib, lib.pf_kernel_a(
        x.data_ptr(), x1.data_ptr(), smask.data_ptr(), pmask.data_ptr(), rw.flat.data_ptr(),
        rw.mma.data_ptr(), cw.flat.data_ptr(), cw.mma.data_ptr(), rowsum.data_ptr(),
        partial.data_ptr(), B, P, L, S, float(eps), passes, _stream()), "kernel_a")
    LAUNCHES["kernel_a"] += 1
    return x1, reduce_stats(partial)


def kernel_b(x1, stats, pair_count, bw: WeightGroup, eps, passes=3):
    """``_kernel_b``: column attention from the global stats + FFN (exact
    GELU), ``x1`` → x3 (a new tensor).  ``pair_count`` ``(B,)`` real pairs."""
    _check_passes(passes)
    if _on_cpu(x1, stats, pair_count, bw.flat):
        return kernel_b_plain(x1, stats, pair_count, bw, eps, passes)
    B, P, L, d = x1.shape
    _check_width(d)
    _require(x1, "x1", (B, P, L, d))
    _require(stats, "stats", (B, L, 3 * d))
    _require(pair_count, "pair_count", (B,))
    _require_groups(b=(bw, B_SIZE, B_MMA_SIZE))
    if P < 1:
        raise ValueError("kernel B needs at least one pair (two sequences)")
    S = _slots(P * -(-L // FWD_TILE_SITES), B, x1.device)
    x3 = torch.empty_like(x1)
    lib = _lib()
    _build.check(lib, lib.pf_kernel_b(
        x1.data_ptr(), stats.data_ptr(), pair_count.data_ptr(), bw.flat.data_ptr(),
        bw.mma.data_ptr(), x3.data_ptr(), B, P, L, S, float(eps), passes, _stream()),
        "kernel_b")
    LAUNCHES["kernel_b"] += 1
    return x3


def kernel_a1(x, smask, rw: WeightGroup, eps, passes=3):
    """``_kernel_a1``: per-pair row sums ``(B, P, 3d)`` ``[Σq | Σk | Σk·v]``."""
    _check_passes(passes)
    if _on_cpu(x, smask, rw.flat):
        return kernel_a1_plain(x, smask, rw, eps, passes)
    B, P, L, d = x.shape
    _check_width(d)
    _require(x, "x", (B, P, L, d))
    _require(smask, "smask", (B, L))
    _require_groups(row=(rw, ROW_SIZE, ROW_MMA_SIZE))
    if P < 1:
        raise ValueError("kernel A1 needs at least one pair (two sequences)")
    S = _slots(P, B, x.device)
    rowstats = torch.empty((B, P, 3 * d), device=x.device, dtype=torch.float32)
    lib = _lib()
    _build.check(lib, lib.pf_kernel_a1(
        x.data_ptr(), smask.data_ptr(), rw.flat.data_ptr(), rw.mma.data_ptr(),
        rowstats.data_ptr(), B, P, L, S, float(eps), passes, _stream()), "kernel_a1")
    LAUNCHES["kernel_a1"] += 1
    return rowstats


def kernel_a2(x, rowstats, smask, pmask, rw: WeightGroup, cw: WeightGroup, eps, passes=3):
    """``_kernel_a2``: row attention finalized from ``rowstats``, then the
    column stats: x1 (a new tensor), stats ``(B, L, 3d)``."""
    _check_passes(passes)
    if _on_cpu(x, rowstats, smask, pmask, rw.flat, cw.flat):
        return kernel_a2_plain(x, rowstats, smask, pmask, rw, cw, eps, passes)
    B, P, L, d = x.shape
    _check_width(d)
    _require(x, "x", (B, P, L, d))
    _require(rowstats, "rowstats", (B, P, 3 * d))
    _require(smask, "smask", (B, L))
    _require(pmask, "pmask", (B, P))
    _require_groups(row=(rw, ROW_SIZE, ROW_MMA_SIZE), col=(cw, COL_SIZE, COL_MMA_SIZE))
    if P < 1:
        raise ValueError("kernel A2 needs at least one pair (two sequences)")
    sp = min(P, A2_MAX_PAIR_SLOTS, _budget_slots(B, L))
    sc = min(-(-L // FWD_TILE_SITES), -(-_grid_blocks(B, x.device) // sp))
    x1 = torch.empty_like(x)
    partial = torch.empty((B, sp, L, 3 * d), device=x.device, dtype=torch.float32)
    lib = _lib()
    _build.check(lib, lib.pf_kernel_a2(
        x.data_ptr(), rowstats.data_ptr(), smask.data_ptr(), pmask.data_ptr(),
        rw.flat.data_ptr(), rw.mma.data_ptr(), cw.flat.data_ptr(), cw.mma.data_ptr(),
        x1.data_ptr(), partial.data_ptr(), B, P, L, sp, sc, float(eps), passes, _stream()),
        "kernel_a2")
    LAUNCHES["kernel_a2"] += 1
    return x1, reduce_stats(partial)


# ---- host functions (axial_block.py:451-862) -------------------------------

def _masks(site_mask, pair_mask):
    return (site_mask.to(torch.float32).contiguous(),
            pair_mask.to(torch.float32).contiguous())


def _ltiled_kernel_a(x, w: BlockWeights, smask, pmask, eps, passes=3):
    """L-tiled kernel A: A1 (row sums over the whole site axis), then A2
    (rows finalized, x1, column stats).  Returns ``(x1, stats)``."""
    rowstats = kernel_a1(x, smask, w.row, eps, passes)
    return kernel_a2(x, rowstats, smask, pmask, w.row, w.col, eps, passes)


def _fused_block_ltiled_impl(x, w: BlockWeights, smask, pmask, eps, passes=3):
    """The L-tiled block: A1, A2, then kernel B.  Returns ``(x3, x1, stats)``."""
    x1, stats = _ltiled_kernel_a(x, w, smask, pmask, eps, passes)
    return kernel_b(x1, stats, pmask.sum(dim=1), w.b, eps, passes), x1, stats


def _fused_block_impl(x, w: BlockWeights, smask, pmask, eps, passes=3):
    """One block on float masks: kernel A and B up to ``RESIDENT_SITES_MAX``
    sites, the L-tiled form above.  Returns ``(x3, x1, stats)``."""
    if x.shape[2] > axial_block.RESIDENT_SITES_MAX:
        return _fused_block_ltiled_impl(x, w, smask, pmask, eps, passes)
    x1, stats = kernel_a(x, smask, pmask, w.row, w.col, eps, passes)
    return kernel_b(x1, stats, pmask.sum(dim=1), w.b, eps, passes), x1, stats


def fused_axial_block(x: torch.Tensor, layer, site_mask: torch.Tensor,
                      pair_mask: torch.Tensor, eps: float = 1e-5,
                      mxu_precision: str = "highest") -> torch.Tensor:
    """One Phyloformer block through the fused kernels.

    ``x`` ``(B, P, L, d)`` fp32; ``layer`` one element of
    ``params["layers"]`` (or its :class:`BlockWeights`); ``site_mask``
    ``(B, L)`` and ``pair_mask`` ``(B, P)``, bool or 0/1 float;
    ``mxu_precision`` "highest" (three TF32 passes) or "default" (one)."""
    return fused_axial_block_res(x, layer, site_mask, pair_mask, eps, mxu_precision)[0]


def fused_axial_block_res(x: torch.Tensor, layer, site_mask: torch.Tensor,
                          pair_mask: torch.Tensor, eps: float = 1e-5,
                          mxu_precision: str = "highest"):
    """Like :func:`fused_axial_block`, but also returns the residuals of the
    fused backward: ``(x3, x1, stats)``, x1 the post-row-attention
    activations and stats the raw column sums ``(B, L, 3d)``."""
    smask, pmask = _masks(site_mask, pair_mask)
    return _fused_block_impl(x.contiguous(), BlockWeights.of(layer), smask, pmask, eps,
                             passes_of(mxu_precision))


def fused_kernel_a(x: torch.Tensor, layer, site_mask: torch.Tensor, pair_mask: torch.Tensor,
                   eps: float = 1e-5, mxu_precision: str = "highest"):
    """Kernel A alone (L-tiled above ``RESIDENT_SITES_MAX`` sites):
    ``(x1, stats)`` with the raw column stats of the pairs of ``x`` (on a
    pair shard, this shard's partials).  ``mxu_precision`` as in
    :func:`fused_axial_block`."""
    smask, pmask = _masks(site_mask, pair_mask)
    w = BlockWeights.of(layer)
    x = x.contiguous()
    passes = passes_of(mxu_precision)
    if x.shape[2] > axial_block.RESIDENT_SITES_MAX:
        return _ltiled_kernel_a(x, w, smask, pmask, eps, passes)
    return kernel_a(x, smask, pmask, w.row, w.col, eps, passes)


def kernel_b_host(x1: torch.Tensor, stats: torch.Tensor, pair_count: torch.Tensor, layer,
                  eps: float = 1e-5, mxu_precision: str = "highest") -> torch.Tensor:
    """``sharded.py:_kernel_b_host``: kernel B on a local pair shard ``x1``
    ``(B, P_shard, L, d)`` given the **global** column stats (the shards'
    partials all-reduced over the pair axis) and the **global** real pair
    count ``(B,)``; returns x3.  Kernel B is local to each pair-site, so one
    launch serves every length: above ``RESIDENT_SITES_MAX`` sites it is the
    L-tiled block's kernel B (:func:`_fused_block_ltiled_impl`) as well."""
    w = BlockWeights.of(layer)
    return kernel_b(x1.contiguous(), stats.contiguous(),
                    pair_count.to(torch.float32).reshape(-1).contiguous(), w.b, eps,
                    passes_of(mxu_precision))
