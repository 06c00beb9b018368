"""Sharded fused inference and training: the fused kernels on pair shards.

The counterpart of ``phyloformer_tpu/ops/pallas/sharded.py``.  At 200 tips ×
1000 sites one pair activation is 19,900 × 1000 × 64 × 4 B = 5.1 GB, and the
fused forward holds about three of them.  Linear attention makes a split of
the pair axis exact and cheap: the column (pair-axis) attention reads the
other pairs only through the column sums Σq, Σk, Σk·v that kernel A already
accumulates.  So on a :class:`..parallel.mesh.Mesh` each rank

1. takes its rows of the batch (the ``data`` axis) and gathers its block of
   pairs ``x = emb[i_k] + emb[j_k]`` from its (small) embedding;
2. runs kernel A on its pair shard;
3. all-reduces the ``(B, L, 3d)`` stats over its pair row — the forward's
   only communication, ``B·L·3d·4`` bytes a block;
4. runs kernel B locally (:func:`.fused.kernel_b_host`, with the global pair
   count), then the softplus head and the site mean.

No kernel is new: A, B, A1, A2, C, D, E, E1, E2 and the slot reductions run
on the shard's ``P / pair`` pairs (padding pairs included) with the global
pair count.  The pair axis is padded to a multiple of the pair axis with
pairs of sequence 0 with itself, masked out by their global position.

Training (:func:`sharded_fused_loss_and_grads`) writes the backward out by
hand as the JAX package does: the residuals stay on their shard, kernels C,
D and E (E1 and E2 above ``RESIDENT_SITES_MAX`` sites) run locally with A1
all-reduced over the pair row between C and D, then the head, the
embedding's scatter and one all-reduce of the loss and every gradient over
the whole mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...data.pairs import pair_indices
from ...parallel.mesh import Mesh, all_reduce_sum, batch_slice
from .axial_block import head
from .axial_block_bwd import fused_axial_block_bwd
from .fused import BlockWeights, fused_kernel_a, kernel_b_host
from .pipeline import PipelineWeights


@dataclass(frozen=True)
class PairShard:
    """One rank's block of the pair axis of ``n_seqs`` sequences: the pairs
    ``(i, j)`` at global positions ``[start, start + per)`` of the padded
    axis of ``p_pad`` (``real``: position < ``p``), and the process group
    of the pair row."""

    i: torch.Tensor
    j: torch.Tensor
    real: torch.Tensor
    p: int
    p_pad: int
    start: int
    group: Any = None

    def pair_mask(self, seq_mask: torch.Tensor) -> torch.Tensor:
        """``(B, n)`` sequence mask → this shard's ``(B, per)`` pair mask,
        padding pairs False (they alias sequence 0)."""
        return seq_mask.index_select(1, self.i) & seq_mask.index_select(1, self.j) & self.real

    def build(self, emb: torch.Tensor) -> torch.Tensor:
        """``(B, n, L, d)`` → this shard's pairs ``(B, per, L, d)``."""
        return emb.index_select(1, self.i) + emb.index_select(1, self.j)

    def columns(self, t: torch.Tensor) -> torch.Tensor:
        """This shard's columns of a ``(B, p)`` tensor (zeros where padded)."""
        t = F.pad(t, (0, self.p_pad - t.shape[1]))
        return t[:, self.start:self.start + self.i.numel()]


def pair_shard(n_seqs: int, mesh: Mesh, device) -> PairShard:
    """This rank's :class:`PairShard` of ``n_seqs`` sequences on ``mesh``."""
    i_idx, j_idx = pair_indices(n_seqs)
    p = len(i_idx)
    p_pad = -(-p // mesh.pair) * mesh.pair
    per = p_pad // mesh.pair
    i_pad = np.zeros(p_pad, np.int64)
    j_pad = np.zeros(p_pad, np.int64)
    i_pad[:p], j_pad[:p] = i_idx, j_idx
    start = mesh.pair_index * per
    pos = torch.arange(start, start + per, device=device)
    return PairShard(torch.as_tensor(i_pad[start:start + per], device=device),
                     torch.as_tensor(j_pad[start:start + per], device=device), pos < p, p,
                     p_pad, start, mesh.pair_group)


def _mxu(cfg) -> str:
    return "highest" if cfg.matmul_precision == "float32" else "default"


def _defaults(codes, site_mask, seq_mask):
    b, n, l = codes.shape
    if site_mask is None:
        site_mask = torch.ones((b, l), dtype=torch.bool, device=codes.device)
    if seq_mask is None:
        seq_mask = torch.ones((b, n), dtype=torch.bool, device=codes.device)
    return site_mask, seq_mask


def _local_forward(w: PipelineWeights, codes, smask, pmask, count, shard: PairShard, cfg):
    """This rank's distances ``(B_local, per)`` through A (A1, A2), the
    stats all-reduce and B, from float masks and the global pair count."""
    mxu = _mxu(cfg)
    x = shard.build(torch.relu(w.embed_w[codes.long()] + w.embed_b))
    for row, col, bw in zip(w.row, w.col, w.b):
        blk = BlockWeights(row, col, bw)
        x1, stats = fused_kernel_a(x, blk, smask, pmask, cfg.ln_eps, mxu)
        del x  # kernel B reads x1 only
        x = kernel_b_host(x1, all_reduce_sum(stats, shard.group), count, blk, cfg.ln_eps, mxu)
        del x1
    return head(x, w.head.parts[0], w.head.parts[1], smask)


def real_pairs(seq_mask: torch.Tensor) -> torch.Tensor:
    """``(B, n)`` sequence mask → the ``(B, P)`` mask of all real pairs."""
    i, j = (torch.as_tensor(a, device=seq_mask.device) for a in pair_indices(seq_mask.shape[1]))
    return seq_mask.index_select(1, i) & seq_mask.index_select(1, j)


def _local_inputs(codes, site_mask, seq_mask, mesh: Mesh):
    """This rank's rows, its pair shard, float masks and the global pair
    count ``(B_local,)`` (exact from the sequence mask, which every rank
    holds whole: no all-reduce)."""
    rows = batch_slice(mesh, codes.shape[0])
    codes, site_mask, seq_mask = codes[rows], site_mask[rows], seq_mask[rows]
    shard = pair_shard(codes.shape[1], mesh, codes.device)
    count = real_pairs(seq_mask).sum(dim=1).to(torch.float32)
    smask = site_mask.to(torch.float32).contiguous()
    pmask = shard.pair_mask(seq_mask).to(torch.float32).contiguous()
    return codes, smask, pmask, count, shard, rows


def forward_fused_sharded(params, codes: torch.Tensor, cfg, mesh: Mesh,
                          site_mask: Optional[torch.Tensor] = None,
                          seq_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused forward with the batch over ``data`` and the activation pair
    axis over ``pair``.  Every rank passes the whole batch ``(B, n, L)``
    (B a multiple of the data axis) and gets the whole ``(B, P_pad)`` back,
    ``P_pad`` = P rounded up to the pair axis: slice to P.  ``params``: a
    parameter tree or its :class:`.pipeline.PipelineWeights` (fp32).
    ``cfg.matmul_precision`` as in :func:`..models.phyloformer.forward_fused`.
    CUDA tensors run the kernels, CPU tensors their plain versions."""
    w = params if isinstance(params, PipelineWeights) else PipelineWeights.from_params(params)
    site_mask, seq_mask = _defaults(codes, site_mask, seq_mask)
    codes_l, smask, pmask, count, shard, _ = _local_inputs(codes, site_mask, seq_mask, mesh)
    local = _local_forward(w, codes_l, smask, pmask, count, shard, cfg)
    return mesh.gather(local, codes.shape[0], shard.p_pad, pair_sharded=True)


def sharded_fused_predict(params, batch: Dict[str, torch.Tensor], cfg, mesh: Mesh):
    """This rank's ``(preds, pair mask, targets)``, each ``(B_local, per)``,
    through the sharded fused forward (the sharded eval step's)."""
    site_mask, seq_mask = _defaults(batch["codes"], batch.get("site_mask"),
                                    batch.get("seq_mask"))
    codes, smask, pmask, count, shard, rows = _local_inputs(batch["codes"], site_mask,
                                                            seq_mask, mesh)
    w = PipelineWeights.from_params(params)
    preds = _local_forward(w, codes, smask, pmask, count, shard, cfg)
    return preds, pmask, shard.columns(batch["dists"][rows])


def _loss_and_cotangent(term: Callable, preds, dists, pm, n_tot):
    """This shard's share of the masked loss (its sum of ``term`` over the
    global count) and the share's cotangent on ``preds``."""
    with torch.enable_grad():
        p = preds.detach().requires_grad_(True)
        share = (term(p, dists) * pm).sum() / n_tot
        dpreds, = torch.autograd.grad(share, p)
    return share.detach(), dpreds


def _leaves(params, tree) -> List[torch.Tensor]:
    """The leaves of ``tree`` in the order of ``params``' leaves, each in the
    shape of its parameter."""
    out: List[torch.Tensor] = []

    def walk(p, g):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], g[k])
        elif isinstance(p, (list, tuple)):
            for a, b in zip(p, g):
                walk(a, b)
        else:
            out.append(g.reshape(p.shape))

    walk(params, tree)
    return out


def sharded_fused_loss_and_grads(params, batch: Dict[str, torch.Tensor], cfg, mesh: Mesh,
                                 term: Callable) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The masked loss and every parameter gradient through the fused
    kernels, batch over ``data`` and pairs over ``pair``, with the backward
    written out (no autograd).  Every rank passes the whole batch dict
    (``codes``, ``dists``, optional ``site_mask`` / ``seq_mask``; B a
    multiple of the data axis).  ``term``: the loss's term per pair
    (``train.losses.get_term``).  The loss is the global masked sum of it
    over the global count, never a mean of the ranks' means.  Returns ``(loss,
    gradients)``, the gradients in the order of the parameter tree's leaves,
    both the same on every rank."""
    site_mask, seq_mask = _defaults(batch["codes"], batch.get("site_mask"),
                                    batch.get("seq_mask"))
    codes, smask, pm, count, shard, rows = _local_inputs(batch["codes"], site_mask, seq_mask,
                                                         mesh)
    dists = shard.columns(batch["dists"][rows].to(torch.float32))
    mxu, eps, n_heads = _mxu(cfg), cfg.ln_eps, cfg.n_heads
    # the loss's global count of real pairs, exact from the whole batch's mask
    n_tot = real_pairs(seq_mask).sum().to(torch.float32).clamp_min(1.0)

    with torch.no_grad():
        we, be = params["embed"]["w"].detach(), params["embed"]["b"].detach()
        z = we[codes.long()] + be
        emb = torch.relu(z)
        x = shard.build(emb)
        res = []
        for layer in params["layers"]:
            blk = BlockWeights.of(layer)
            x1, stats = fused_kernel_a(x, blk, smask, pm, eps, mxu)
            stats = all_reduce_sum(stats, shard.group)
            res.append((x, x1, stats, layer))
            x = kernel_b_host(x1, stats, count, blk, eps, mxu)

        wh, bh = params["head"]["w"].detach(), params["head"]["b"].detach()
        hpre = x @ wh + bh  # (b, P, L, 1)
        sp = F.softplus(hpre)[..., 0]
        m = smask[:, None, :]
        scount = m.sum(dim=-1).clamp_min(1.0)  # (b, 1)
        preds = (sp * m).sum(dim=-1) / scount
        loss, dpreds = _loss_and_cotangent(term, preds, dists, pm, n_tot)

        d_sp = dpreds[:, :, None] * m / scount[:, :, None]
        d_hpre = d_sp[..., None] * torch.sigmoid(hpre)
        dwh = torch.einsum("bpld,bplo->do", x, d_hpre)
        dbh = d_hpre.sum(dim=(0, 1, 2))
        g = torch.einsum("bplo,do->bpld", d_hpre, wh)
        del x, hpre, sp, d_sp, d_hpre

        dlayers = []
        for x0, x1, stats, layer in reversed(res):
            g, dlayer = fused_axial_block_bwd(x0, x1, stats, g, layer, smask, pm, n_heads,
                                              eps, pair_count=count,
                                              mxu_precision=mxu, pair_group=shard.group)
            dlayers.append(dlayer)
        dlayers.reverse()
        del res

        demb = torch.zeros_like(emb)
        demb.index_add_(1, shard.i, g)
        demb.index_add_(1, shard.j, g)
        dz = demb * (z > 0)
        d = dz.shape[-1]
        dwe = torch.zeros_like(we).index_add_(0, codes.reshape(-1).long(), dz.reshape(-1, d))
        dbe = dz.sum(dim=(0, 1, 2))

        grads = _leaves(params, {"embed": {"w": dwe, "b": dbe}, "layers": dlayers,
                                 "head": {"w": dwh, "b": dbh}})
        # one all-reduce of the loss and every gradient over the whole mesh
        flat = all_reduce_sum(torch.cat([loss.reshape(1)] + [t.reshape(-1) for t in grads]),
                              mesh.world_group)
    sizes = [1] + [t.numel() for t in grads]
    parts = flat.split(sizes)
    return parts[0][0], [p.view(t.shape) for p, t in zip(parts[1:], grads)]
