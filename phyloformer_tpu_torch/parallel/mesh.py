"""Device meshes over ``torch.distributed``.

The counterpart of ``phyloformer_tpu/parallel/mesh.py``.  JAX runs one
controller over a ``('data', 'pair')`` mesh of devices; PyTorch runs one
process per card (SPMD), so a mesh here is the ``torch.distributed`` world
arranged as a ``data × pair`` grid of ranks, rank ``r`` at ``(r // pair,
r % pair)`` as JAX reshapes its device list:

- ``data``: batch data parallelism; each rank takes its rows of a batch that
  every rank holds whole (:func:`batch_slice`, :func:`shard_batch`);
- ``pair``: the quadratic pair axis (P = n(n-1)/2) of the activations split
  over the ranks of one pair row.  Linear attention's pair-axis state is a
  pure sum (Σq, Σk, Σk·v), so the shards' partials are all-reduced over the
  row's process group and the result equals the unsharded one up to the
  order of summation;
- parameters are replicated: every rank builds them from the same seed or
  file.

:func:`init_distributed` is the counterpart of ``jax.distributed.initialize()``:
it reads torchrun's ``env://`` variables, puts each rank on its card and
starts the process group (``nccl`` on the card, ``gloo`` on the CPU, or
``gloo`` on the card when asked).  gloo all-reduces and broadcasts CUDA
tensors by staging them through the host; it gathers none, so
:meth:`Mesh.gather` is an all-reduce of zero-padded blocks on both backends.
A mesh larger than one rank needs an initialized process group: nothing runs
unsharded in its place.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..device import resolve_device

DATA_AXIS = "data"
PAIR_AXIS = "pair"
BACKENDS = ("auto", "nccl", "gloo")


def world() -> Tuple[int, int]:
    """``(rank, world size)`` of the process group, ``(0, 1)`` without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(backend: str = "auto", device=None) -> torch.device:
    """Join the process group described by torchrun's ``env://`` variables
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) and return
    this rank's device: on ``cuda`` (the default) the card ``LOCAL_RANK``,
    made current.  ``backend``: "auto" = ``nccl`` on the card, ``gloo`` on
    the CPU; "gloo" also runs on the card (collectives staged through the
    host), "nccl" only there."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: expected one of {BACKENDS}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if backend == "auto":
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs the card; use gloo with --device cpu")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    return dev


def shutdown_distributed() -> None:
    """Leave the process group, where one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group`` as a new tensor; ``t``
    itself where ``group`` is None (a group of one rank).  Under gloo a
    CUDA tensor is staged through the host."""
    if group is None:
        return t
    staged = t.is_cuda and dist.get_backend(group) == "gloo"
    # a tensor of our own (a copy on the host, or on t's device)
    out = t.detach().cpu().contiguous() if staged else t.detach().contiguous().clone()
    dist.all_reduce(out, group=group)
    return out.to(t.device) if staged else out


class _AllReduceSum(torch.autograd.Function):
    """All-reduce whose backward all-reduces the cotangents: each rank's
    output feeds every rank's share of a loss summed over the ranks."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


def all_reduce_sum_ad(t: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_reduce_sum`, differentiable."""
    return t if group is None else _AllReduceSum.apply(t, group)


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a ``data × pair`` grid of ranks and the process
    groups of its pair row and data column (None where the axis has one
    rank).  ``device``: where collectives of host data run (the card under
    nccl, the CPU under gloo)."""

    shape: Dict[str, int]
    rank: int
    pair_group: Any = None
    data_group: Any = None
    world_group: Any = None
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))

    @property
    def data(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def pair(self) -> int:
        return self.shape[PAIR_AXIS]

    @property
    def world(self) -> int:
        return self.data * self.pair

    @property
    def data_index(self) -> int:
        return self.rank // self.pair

    @property
    def pair_index(self) -> int:
        return self.rank % self.pair

    def gather(self, local: torch.Tensor, rows: int, cols: int,
               pair_sharded: bool) -> torch.Tensor:
        """Every rank's ``(rows / data, c)`` block of a ``(rows, cols)``
        output, whole on every rank: the blocks of the data axis stacked, and
        with ``pair_sharded`` those of the pair axis side by side (``c = cols
        / pair``), else each pair row's copy once."""
        b, c = local.shape
        if b * self.data != rows or c * (self.pair if pair_sharded else 1) != cols:
            raise ValueError(f"block {tuple(local.shape)} does not tile ({rows}, {cols}) on "
                             f"the mesh {self.shape}")
        if self.world == 1:
            return local
        out = local.new_zeros((rows, cols))
        c0 = self.pair_index * c if pair_sharded else 0
        out[self.data_index * b:(self.data_index + 1) * b, c0:c0 + c] = local
        return all_reduce_sum(out, self.world_group if pair_sharded else self.data_group)

    def barrier(self) -> None:
        """Wait for every rank of the mesh."""
        all_reduce_sum(torch.zeros(1, device=self.device), self.world_group)


def _group(ranks, size: int):
    """A process group of ``ranks``: None for one rank, the world for all."""
    if len(ranks) == 1:
        return None
    if len(ranks) == size:
        return dist.group.WORLD
    return dist.new_group(list(ranks))


def make_mesh(data: Optional[int] = None, pair: int = 1) -> Mesh:
    """A ``('data', 'pair')`` mesh over the ranks of the process group (one
    rank without one).  ``data=None`` takes every rank that ``pair`` leaves.
    Every rank calls it with the same arguments, in the same order as its
    other process-group calls."""
    rank, n = world()
    if data is None:
        if n % pair != 0:
            raise ValueError(f"{n} devices not divisible by pair={pair}" + _hint(n))
        data = n // pair
    if data * pair != n:
        raise ValueError(f"mesh {data}x{pair} != {n} devices" + _hint(n))
    pair_group = data_group = world_group = None
    if n > 1:
        # every rank creates every group, in one order
        rows = [_group(range(d * pair, (d + 1) * pair), n) for d in range(data)]
        cols = [_group(range(p, n, pair), n) for p in range(pair)]
        pair_group, data_group = rows[rank // pair], cols[rank % pair]
        world_group = dist.group.WORLD
    device = torch.device("cpu")
    if n > 1 and dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh({DATA_AXIS: data, PAIR_AXIS: pair}, rank, pair_group, data_group,
                world_group, device)


def local_mesh() -> Mesh:
    """The mesh of this process alone (1 x 1, no process group): the
    single-process train and eval steps run on it."""
    return Mesh({DATA_AXIS: 1, PAIR_AXIS: 1}, 0)


def _hint(n: int) -> str:
    if n == 1 and not (dist.is_available() and dist.is_initialized()):
        return (" (no process group: start one process per rank, e.g. with torchrun, and "
                "pass --distributed-init)")
    return ""


def batch_slice(mesh: Mesh, bsz: int) -> slice:
    """This rank's rows of a batch of ``bsz`` (a multiple of the data axis)."""
    if bsz % mesh.data:
        raise ValueError(f"batch of {bsz} does not split over the data axis of {mesh.data}")
    per = bsz // mesh.data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def shard_batch(mesh: Mesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's rows of every array of a batch dict (None stays None)."""
    rows = batch_slice(mesh, len(batch["codes"]))
    return {k: None if v is None else v[rows] for k, v in batch.items()}


def host_local_slice(global_count: int, rank: Optional[int] = None,
                     size: Optional[int] = None) -> Tuple[int, int]:
    """``[start, stop)`` of this rank's share of a global work list (the
    files of ``pf-infer-torch --multihost``), by rank and world size."""
    if rank is None or size is None:
        rank, size = world()
    per = -(-global_count // size)
    start = min(rank * per, global_count)
    return start, min(start + per, global_count)
