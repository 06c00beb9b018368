"""Training engine: state, train and eval steps.

The counterpart of ``phyloformer_tpu/train/trainer.py``.  The state is a
dict ``{"params", "opt_state", "step"}``: the parameter tree (leaf tensors
that require grad), the :class:`Optimizer` (optax's chain of optional
global-norm clipping, Adam(W) with the schedule, and ``optax.MultiSteps``
when ``grad_accum > 1``) and the count of micro-batches.  ``use_pallas``
runs the fused kernels forward and backward
(:func:`..models.phyloformer.forward_fused_ad`); otherwise the eager model
runs under plain autograd, the JAX package's XLA path.  Steps run on the
device of the parameters.  ``matmul_precision`` "float32" computes every
product in fp32 (the kernels' in three TF32 passes, PyTorch's with TF32
off); "tensorfloat32" and "default" run the kernels' products in one TF32
pass and, on the eager route, PyTorch's in TF32 (:func:`_step_products`).

With a :class:`..parallel.mesh.Mesh` every rank passes the whole batch and
takes its part (:func:`route`): with ``shard_pairs`` and a pair axis the
pair activations are split over the ranks of a pair row
(:func:`..ops.kernels.sharded.sharded_fused_loss_and_grads`, or the eager
model on its pair shard), otherwise each rank runs the single-card step on
its rows of the batch.  The loss is the global masked sum over the global
count, its gradients all-reduced over the ranks that hold different work,
so every rank takes the same update.  Without a mesh the steps run on
:func:`..parallel.mesh.local_mesh`, one rank, where the all-reduces are
the identity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data.pairs import n_pairs
from ..device import resolve_device, tf32_products
from ..infer.engine import real_pair_selector
from ..models.params import Params, PhyloformerConfig, init_params, map_params
from ..models.phyloformer import forward, forward_fused_ad, pair_mask_from_seq_mask
from ..ops.kernels.sharded import (
    pair_shard,
    real_pairs,
    sharded_fused_loss_and_grads,
    sharded_fused_predict,
)
from ..parallel.mesh import Mesh, all_reduce_sum, local_mesh, shard_batch
from .losses import get_term
from .profiling import check_finite, nan_checks_enabled
from .schedule import clip_by_global_norm, global_norm, linear_warmup_decay, make_optimizer


def _not_ported(what: str) -> ValueError:
    return ValueError(f"{what} is not yet ported, see ROADMAP.md")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    loss: str = "mae"
    learning_rate: float = 1e-4
    warmup_steps: int = 5000
    total_steps: int = 100_000
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    remat: bool = False
    seed: int = 1337
    shard_pairs: bool = False  # shard the pair axis over the mesh's 'pair' axis
    # The fused kernels forward and backward (dropout 0 only);
    # PF_PALLAS_BWD=remat backpropagates through the eager block instead.
    use_pallas: bool = False
    # Average the gradients of this many micro-batches before each update
    # (optax.MultiSteps); the schedule advances once per update, `step`
    # counts micro-batches.
    grad_accum: int = 1


TrainState = Dict[str, Any]  # {'params', 'opt_state', 'step'}


def param_leaves(params: Params) -> List[torch.Tensor]:
    """The parameter tree's leaves in a fixed order."""
    out: List[torch.Tensor] = []
    map_params(out.append, params)
    return out


class Optimizer:
    """Optional global-norm clipping, then Adam (AdamW with weight decay)
    under the warmup-decay schedule; with ``grad_accum = k > 1`` the mean
    of k micro-batch gradients (Welford, as ``optax.MultiSteps``) is
    applied once every k calls of :meth:`update`."""

    def __init__(self, leaves: List[torch.Tensor], tcfg: TrainConfig):
        self.leaves = leaves
        self.opt, self.sched = make_optimizer(leaves, tcfg.learning_rate, tcfg.warmup_steps,
                                              tcfg.total_steps, tcfg.weight_decay)
        self.grad_clip = tcfg.grad_clip
        self.every_k = max(1, tcfg.grad_accum)
        self.acc: Optional[List[torch.Tensor]] = None
        self.mini_step = 0

    def update(self, grads) -> bool:
        """Feed one micro-batch's gradients; returns whether the parameters
        were updated."""
        grads = [g.detach() for g in grads]
        if self.every_k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            n = self.mini_step
            self.acc = [a + (g - a) / (n + 1) for a, g in zip(self.acc, grads)]
            self.mini_step += 1
            if self.mini_step < self.every_k:
                return False
            grads, self.acc, self.mini_step = self.acc, None, 0
        grads = [g.clone() for g in grads]
        if self.grad_clip and self.grad_clip > 0:
            clip_by_global_norm(grads, self.grad_clip)
        for p, g in zip(self.leaves, grads):
            p.grad = g
        self.opt.step()
        self.sched.step()
        for p in self.leaves:
            p.grad = None
        return True

    def state_dict(self) -> Dict[str, Any]:
        return {"optimizer": self.opt.state_dict(), "scheduler": self.sched.state_dict(),
                "acc": None if self.acc is None else [a.cpu() for a in self.acc],
                "mini_step": self.mini_step}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.opt.load_state_dict(sd["optimizer"])
        self.sched.load_state_dict(sd["scheduler"])
        dev = self.leaves[0].device
        self.acc = None if sd["acc"] is None else [a.to(dev) for a in sd["acc"]]
        self.mini_step = int(sd["mini_step"])


def create_train_state(
    cfg: PhyloformerConfig,
    tcfg: TrainConfig,
    params: Optional[Params] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Tuple[TrainState, Optimizer]:
    """Initialise (or wrap pre-loaded) params and the optimizer on
    ``device`` (``None`` = the card, raising without one; ``"cpu"`` runs
    the plain versions).  ``params`` may hold tensors or numpy arrays."""
    dev = resolve_device(device)
    if params is None:
        params = init_params(cfg, generator or torch.Generator().manual_seed(tcfg.seed))

    def leaf(t) -> torch.Tensor:
        t = t if torch.is_tensor(t) else torch.as_tensor(np.asarray(t))
        return t.to(dev, torch.float32).detach().clone().requires_grad_(True)

    params = map_params(leaf, params)
    tx = Optimizer(param_leaves(params), tcfg)
    return {"params": params, "opt_state": tx, "step": 0}, tx


def _check_supported(cfg: PhyloformerConfig) -> None:
    if cfg.dropout:
        raise _not_ported(f"dropout={cfg.dropout}")


def route(tcfg: TrainConfig, mesh: Mesh) -> str:
    """The step's route, the JAX trainer's (``train/trainer.py:165-203``):
    "sharded_fused" (the fused kernels, pair axis sharded) or
    "sharded_eager" (the eager model on a pair shard, JAX's
    ``act_sharding``) where ``shard_pairs`` meets a pair axis, else "fused"
    or "eager" on each rank's rows of the batch (JAX falls back to XLA under
    a mesh because a Pallas call does not partition under GSPMD, a limit of
    its toolchain).  JAX's ``PF_PALLAS_TRAIN_MAX_SITES`` hatch is not
    ported: the port's kernels have no site cap, and ``use_pallas=False``
    selects the eager model."""
    if tcfg.shard_pairs and mesh.pair > 1:
        return "sharded_fused" if tcfg.use_pallas else "sharded_eager"
    return "fused" if tcfg.use_pallas else "eager"


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, Optional[torch.Tensor]]:
    """Host batch (numpy arrays or tensors) → tensors on ``device``."""
    kinds = {"codes": torch.int32, "dists": torch.float32, "site_mask": torch.bool,
             "seq_mask": torch.bool}
    out = {}
    for key, dtype in kinds.items():
        v = batch.get(key)
        out[key] = None if v is None else torch.as_tensor(v).to(device, dtype)
    return out


def _predict(params, batch, cfg, tcfg, how: str, mesh: Mesh):
    """``(preds, pair mask, targets)`` of this rank's part of a batch (both
    masks given, :func:`_mesh_batch`) on the route ``how``."""
    if how == "sharded_fused":
        return sharded_fused_predict(params, batch, cfg, mesh)
    batch = shard_batch(mesh, batch)
    codes, site_mask, seq_mask = batch["codes"], batch["site_mask"], batch["seq_mask"]
    if how == "sharded_eager":
        shard = pair_shard(codes.shape[1], mesh, codes.device)
        preds = forward(params, codes, cfg, site_mask, seq_mask, remat=tcfg.remat, shard=shard)
        return preds, shard.pair_mask(seq_mask), shard.columns(batch["dists"])
    if how == "fused":
        preds = forward_fused_ad(params, codes, cfg, site_mask, seq_mask)
    else:
        preds = forward(params, codes, cfg, site_mask, seq_mask, remat=tcfg.remat)
    return preds, pair_mask_from_seq_mask(seq_mask, codes.shape[1]), batch["dists"]


def _mesh_batch(batch, mesh: Mesh, device) -> Dict[str, torch.Tensor]:
    """The whole batch on ``device`` with both masks, its rows padded to a
    multiple of the data axis with fully masked rows."""
    b = batch_to_device(batch, device)
    bsz, n, l = b["codes"].shape
    if b["site_mask"] is None:
        b["site_mask"] = torch.ones((bsz, l), dtype=torch.bool, device=device)
    if b["seq_mask"] is None:
        b["seq_mask"] = torch.ones((bsz, n), dtype=torch.bool, device=device)
    pad = -bsz % mesh.data
    if pad:
        b = {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])]) for k, v in b.items()}
    return b


def _reduce_group(mesh: Mesh, how: str):
    """The ranks whose work differs: the whole mesh on a pair-sharded route,
    else the data axis (the ranks of a pair row are then replicas)."""
    return mesh.world_group if how.startswith("sharded") else mesh.data_group


def _step_products(cfg: PhyloformerConfig, how: str, device: torch.device):
    """PyTorch's own products in a step, as JAX runs its XLA parts under
    ``jax.default_matmul_precision(cfg.matmul_precision)``: one TF32 pass on
    the card for the eager routes at "tensorfloat32" or "default", IEEE fp32
    otherwise (the fused routes' kernels take their passes from the config,
    and their head stays fp32).  A context manager; the flags are restored
    after it."""
    one_pass = cfg.matmul_precision != "float32" and how.endswith("eager")
    return tf32_products(device.type == "cuda" and one_pass)


def make_train_step(
    cfg: PhyloformerConfig,
    tcfg: TrainConfig,
    tx: Optimizer,
    mesh: Optional[Mesh] = None,
) -> Callable[..., Tuple[TrainState, Dict[str, Any]]]:
    """The train step ``step(state, batch[, key]) -> (state, logs)``.

    Batch dict: ``codes (B,n,L)`` integers, ``dists (B,P)`` fp32, optional
    ``site_mask (B,L)`` and ``seq_mask (B,n)`` bool.  ``logs``: the loss,
    the global norm of the micro-batch gradients and the learning rate of
    the update, ``sched(step // grad_accum)``.  The state is updated in
    place.  After :func:`.profiling.enable_nan_checks` a non-finite loss or
    gradient raises ``FloatingPointError`` before the update.

    ``mesh``: every rank of it calls the step with the same whole batch;
    the routes are :func:`route`'s, the loss and the gradients global (the
    same on every rank).  None: this process alone."""
    _check_supported(cfg)
    term = get_term(tcfg.loss)
    mesh = mesh if mesh is not None else local_mesh()
    sched = linear_warmup_decay(tcfg.learning_rate, tcfg.warmup_steps, tcfg.total_steps)
    every_k = max(1, tcfg.grad_accum)

    def loss_and_grads(params, leaves, b, how):
        if how == "sharded_fused":
            return sharded_fused_loss_and_grads(params, b, cfg, mesh, term)
        # this rank's share: its masked sum over the global count
        n_tot = real_pairs(b["seq_mask"]).sum().to(torch.float32).clamp_min(1.0)
        preds, pair_mask, dists = _predict(params, b, cfg, tcfg, how, mesh)
        share = (term(preds, dists) * pair_mask.to(preds.dtype)).sum() / n_tot
        if nan_checks_enabled():  # a NaN from the forward, before the backward sees it;
            # the sum over the ranks, so that every rank raises alike
            check_finite(all_reduce_sum(share.detach(), _reduce_group(mesh, how)))
        grads = torch.autograd.grad(share, leaves)
        flat = all_reduce_sum(torch.cat([share.detach().reshape(1)]
                                        + [g.reshape(-1) for g in grads]),
                              _reduce_group(mesh, how))
        parts = flat.split([1] + [g.numel() for g in grads])
        return parts[0][0], [p.view(g.shape) for p, g in zip(parts[1:], grads)]

    def step_fn(state: TrainState, batch, dropout_key=None):
        leaves = param_leaves(state["params"])
        device = leaves[0].device
        b = _mesh_batch(batch, mesh, device)
        how = route(tcfg, mesh)
        with _step_products(cfg, how, device):
            loss, grads = loss_and_grads(state["params"], leaves, b, how)
        if nan_checks_enabled():
            check_finite(loss, grads)
        logs = {"train_loss": loss.detach(), "grad_norm": global_norm(grads).detach(),
                "learning_rate": sched(state["step"] // every_k)}
        state["opt_state"].update(grads)
        state["step"] += 1
        return state, logs

    return step_fn


def make_eval_step(cfg: PhyloformerConfig, tcfg: TrainConfig,
                   mesh: Optional[Mesh] = None) -> Callable:
    """Validation step ``eval(params, batch) -> {val_loss, val_mae,
    val_mre, val_rmse}``, on the forward the train step uses; each metric
    is the masked sum over the count of real pairs, global on a mesh."""
    _check_supported(cfg)
    terms = [get_term(k) for k in (tcfg.loss, "mae", "mre", "mse")]
    mesh = mesh if mesh is not None else local_mesh()

    def eval_fn(params, batch):
        device = param_leaves(params)[0].device
        b = _mesh_batch(batch, mesh, device)
        how = route(tcfg, mesh)
        with _step_products(cfg, how, device), torch.no_grad():
            preds, pair_mask, dists = _predict(params, b, cfg, tcfg, how, mesh)
            m = pair_mask.to(preds.dtype)
            sums = all_reduce_sum(torch.stack([(t(preds, dists) * m).sum() for t in terms]),
                                  _reduce_group(mesh, how))
            loss, mae, mre, mse = sums / real_pairs(b["seq_mask"]).sum().clamp_min(1)
        return {"val_loss": loss, "val_mae": mae, "val_mre": mre, "val_rmse": mse.sqrt()}

    return eval_fn


def pad_batch_to_multiple(batch: Dict[str, np.ndarray], multiple: int) -> Dict[str, np.ndarray]:
    """Pad the batch axis to a multiple with fully masked rows; they add
    nothing to the masked losses and metrics."""
    bsz = batch["codes"].shape[0]
    target = -(-bsz // multiple) * multiple
    if target == bsz:
        return batch
    pad = target - bsz
    out = {}
    for key, arr in batch.items():
        if arr is None:
            out[key] = None
            continue
        out[key] = np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], dtype=arr.dtype)],
                                  axis=0)
    return out


def make_batch(alns, trees_vecs, pad_n: int, pad_l: int) -> Dict[str, np.ndarray]:
    """A host-side padded batch from parsed alignments and their target
    distance vectors (upper-triangle order)."""
    bsz = len(alns)
    codes = np.zeros((bsz, pad_n, pad_l), dtype=np.int32)
    site_mask = np.zeros((bsz, pad_l), dtype=bool)
    seq_mask = np.zeros((bsz, pad_n), dtype=bool)
    dists = np.zeros((bsz, n_pairs(pad_n)), dtype=np.float32)
    for row, (a, vec) in enumerate(zip(alns, trees_vecs)):
        codes[row, : a.n_seqs, : a.seq_len] = a.codes
        site_mask[row, : a.seq_len] = True
        seq_mask[row, : a.n_seqs] = True
        dists[row, real_pair_selector(pad_n, a.n_seqs)] = vec
    return {"codes": codes, "dists": dists, "site_mask": site_mask, "seq_mask": seq_mask}
