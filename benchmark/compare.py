"""The comparisons that decide ``correct``: the program's outputs against
the plain reference's, each reduced to one number that a limit holds."""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

# A leaf whose reference gradient norm is under this share of the median
# leaf's moves under Adam by round-off alone (a q or k bias where phi is
# exp): its change is not compared.
STILL_LEAF = 1e-3


def dist_gap(pairs: Iterable[Tuple[np.ndarray, np.ndarray]]) -> float:
    """The widest gap of a distance against the reference's, over every
    answer, each answer's gaps over ``max(1, max |reference|)``."""
    worst = 0.0
    for got, ref in pairs:
        got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
        if got.shape != ref.shape:
            return float("inf")
        scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
        gap = float(np.abs(got - ref).max(initial=0.0)) / scale
        if not np.isfinite(gap):
            return float("inf")
        worst = max(worst, gap)
    return worst


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              names: Sequence[str]) -> Dict[str, float]:
    """Each leaf's gap of norms, ``|got - ref|`` over the larger of the
    reference's norm of that leaf and of the median leaf."""
    median = statistics.median(ref[n] for n in ref)
    return {n: (abs(got[n] - ref[n]) / max(ref[n], median)
                if n in got and np.isfinite(got[n]) else float("inf")) for n in names}


def leaf_gap(got: Dict[str, float], ref: Dict[str, float], names: Sequence[str]) -> float:
    """The worst leaf's gap of :func:`leaf_gaps`."""
    return max(leaf_gaps(got, ref, names).values(), default=float("inf"))


def worst_leaves(prog: Dict, ref: Dict, k: int = 3) -> List[str]:
    """The ``k`` worst leaves of the first gradient and of the change, with
    their gaps: for the record, not compared."""
    out = []
    for key in ("grad", "change"):
        gaps = leaf_gaps(prog[key], ref[key], list(ref[key]))
        for n in sorted(gaps, key=gaps.get, reverse=True)[:k]:
            out.append(f"{key} {n} {gaps[n]:.3e} (ref norm {ref[key][n]:.3e})")
    return out


def train_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Each step's loss (the worst relative gap), the first gradient's norm
    by the worst leaf, and the parameters' change after the checked steps
    by the worst leaf, leaving out the leaves that ``STILL_LEAF`` names."""
    losses = [abs(a - b) / abs(b) if np.isfinite(a) else float("inf")
              for a, b in zip(prog["losses"], ref["losses"])]
    g_med = statistics.median(ref["grad"].values())
    moving = [n for n in ref["change"] if ref["grad"][n] >= STILL_LEAF * g_med]
    return {
        "loss_gap": max(losses) if len(losses) == len(ref["losses"]) else float("inf"),
        "grad_gap": leaf_gap(prog["grad"], ref["grad"], list(ref["grad"])),
        "change_gap": leaf_gap(prog["change"], {n: ref["change"][n] for n in moving}, moving),
    }


def late_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The window's last step made again by the reference from the
    program's state before it: the loss's relative gap, and the step's
    change of each leaf by the worst leaf, leaving out the leaves that
    ``STILL_LEAF`` names by the reference's gradient of that step."""
    g_med = statistics.median(ref["grad"].values())
    moving = [n for n in ref["change"] if ref["grad"][n] >= STILL_LEAF * g_med]
    loss = prog["loss"]
    return {
        "late_loss_gap": (abs(loss - ref["loss"]) / abs(ref["loss"]) if np.isfinite(loss)
                          else float("inf")),
        "late_change_gap": leaf_gap(prog["change"], {n: ref["change"][n] for n in moving},
                                    moving),
    }
