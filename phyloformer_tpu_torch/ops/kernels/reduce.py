"""The fixed-order slot reduction ``out[g, n] = Σ_s partial[g, s, n]``.

The launch plan and the ordered PyTorch twin of ``csrc/slot_reduce.cu``
(``pf_reduce_slots``), the one kernel behind :func:`.pipeline.reduce_stats`
(the column-stat partials of kernels P0, A-only, M, A and A2) and
:func:`.axial_block_bwd.reduce_partials` (A1 and the weight gradients of
kernels C, D, E and E2).  :func:`reduce_plan` picks the column tiles and the
warps from ``(G, S, N)`` and the SM count alone; the order of every sum
follows from the plan, and :func:`reduce_slots_ordered` adds in exactly that
order, so the kernel equals it bit for bit on the card.  The wrappers' CPU
path stays ``partial.sum(dim=1)``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

TILE_COLS = 128  # columns per block: 32 lanes x 4 (TILE in slot_reduce.cu)
ACCS = 4  # independent accumulators per thread (ACC)
MAX_WARPS = 8  # warps per block at most (MAX_WARPS)
# Warps per block: as many as give the grid about WARPS_PER_SM warps per SM,
# at least MIN_WARPS and at most MAX_WARPS, and no more than leave each warp
# two rounds of ACCS loads.  Fit on the H100 to a sweep of 1 to 8 warps at the
# paths' ten partials (PERF.md, PR 5): fewer warps are faster where the column
# tiles alone fill the card (each warp's run is longer, the combine shorter),
# 8 where they do not (D's and E's 38 and 71 tiles); one-warp blocks lost at
# the long training stats.
WARPS_PER_SM = 40
MIN_WARPS = 2
# Partials above this size are read with streaming loads (evict first):
# they come from device memory.  Smaller ones, which their producer has just
# left in the 50 MB L2, go through the read-only path.  On the H100 the paths'
# partials of up to 20 MB read faster that way and those from 52 MB up
# faster streamed (chip_smoke.py's reduction table); the cut lies between.
STREAM_BYTES = 32 * 1024 * 1024


def _part(idx: int, n: int, parts: int) -> int:
    """Start of part ``idx`` when ``n`` items are split into ``parts``
    contiguous parts (``warp * S / W`` in slot_reduce.cu)."""
    return idx * n // parts


@dataclass(frozen=True)
class ReducePlan:
    """One launch: a grid of ``tiles`` x ``G`` blocks of ``warps`` warps.
    Block (tile, g) sums columns ``[128 tile, 128 (tile + 1))`` of ``g``
    over all the slots, each warp a contiguous run of them."""

    G: int
    S: int
    N: int
    tiles: int  # column tiles of TILE_COLS, the last one ragged
    warps: int  # warps per block (W)
    streaming: bool  # streaming loads (above STREAM_BYTES); no effect on the order

    @property
    def blocks(self) -> int:
        return self.G * self.tiles

    def runs(self) -> List[Tuple[int, int]]:
        """``[start, stop)`` slots of each warp."""
        return [(_part(w, self.S, self.warps), _part(w + 1, self.S, self.warps))
                for w in range(self.warps)]


@functools.lru_cache(maxsize=None)
def reduce_plan(G: int, S: int, N: int, sms: int) -> ReducePlan:
    """The launch plan of a ``(G, S, N)`` partial on a card of ``sms`` SMs:
    128-column tiles, one block per tile and g; ``WARPS_PER_SM`` warps per
    SM over the grid, between ``MIN_WARPS`` and ``MAX_WARPS`` a block and at
    most one per ``2 ACCS`` slots; streaming loads above ``STREAM_BYTES``."""
    if min(G, S, N, sms) < 1:
        raise ValueError(f"reduce_plan: G={G}, S={S}, N={N}, sms={sms} must all be >= 1")
    tiles = -(-N // TILE_COLS)
    fill = max(MIN_WARPS, -(-WARPS_PER_SM * sms // (G * tiles)))
    warps = max(1, min(MAX_WARPS, fill, -(-S // (2 * ACCS))))
    return ReducePlan(G, S, N, tiles, warps, 4 * G * S * N > STREAM_BYTES)


def reduce_slots_ordered(partial: torch.Tensor, plan: ReducePlan) -> torch.Tensor:
    """``(G, S, N)`` → ``(G, N)`` in fp32, adding in exactly the kernel's
    order: accumulator j of a warp's run takes slots ``start + j``,
    ``start + j + 4``, … from +0.0; a warp's sum is ``((a0 + a1) + a2) + a3``;
    the output the warps' sums in warp order.  Runs of every column at once,
    on any device."""
    G, S, N = partial.shape
    if (G, S, N) != (plan.G, plan.S, plan.N):
        raise ValueError(f"partial {tuple(partial.shape)} does not match the plan "
                         f"({plan.G}, {plan.S}, {plan.N})")
    runs = np.array(plan.runs())  # (W, 2)
    steps = int((-(-(runs[:, 1] - runs[:, 0]) // ACCS)).max())
    first = (np.repeat(runs[:, 0], ACCS) + np.tile(np.arange(ACCS), len(runs)))[:, None]
    slot = first + ACCS * np.arange(steps)[None]  # (W * ACCS, steps)
    valid = slot < np.repeat(runs[:, 1], ACCS)[:, None]
    slot = torch.as_tensor(np.where(valid, slot, 0), device=partial.device)
    valid = torch.as_tensor(valid, device=partial.device)

    acc = torch.zeros((G, slot.shape[0], N), device=partial.device, dtype=torch.float32)
    for m in range(steps):
        x = partial.index_select(1, slot[:, m]).float()
        acc = torch.where(valid[None, :, m, None], acc + x, acc)
    a = acc.view(G, plan.warps, ACCS, N)
    warp = ((a[:, :, 0] + a[:, :, 1]) + a[:, :, 2]) + a[:, :, 3]
    out = warp[:, 0]
    for w in range(1, plan.warps):
        out = out + warp[:, w]
    return out.contiguous()
