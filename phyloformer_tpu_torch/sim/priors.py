"""Empirical priors driving simulator realism.

The reference samples per-tree diameters and per-alignment gamma shapes from
pickled empirical lists (the reference's `simulate_trees.py:227-230`,
``alisim.py:14,251``; files ``data/hogenom_{alphas,diams}.txt``,
``data/raxml_diams.txt``).  We ship compact quantile tables derived from
those lists (inverse-CDF sampling is equivalent in distribution); the raw
pickle files can also be supplied to reproduce the reference byte-for-byte.
"""

from __future__ import annotations

import pathlib
import pickle
from typing import Optional, Sequence

import numpy as np

_DATA = pathlib.Path(__file__).parent / "data" / "priors.npz"


class QuantileSampler:
    """Inverse-CDF sampler over a precomputed quantile grid."""

    def __init__(self, quantiles: np.ndarray):
        self.q = np.asarray(quantiles, dtype=np.float64)

    def sample(self, rng: np.random.Generator, size=None) -> np.ndarray:
        u = rng.uniform(0.0, 1.0, size=size)
        return np.interp(u * (len(self.q) - 1), np.arange(len(self.q)), self.q)

    @classmethod
    def from_values(cls, values: Sequence[float], n_quantiles: int = 1025):
        vals = np.asarray(values, dtype=np.float64)
        return cls(np.quantile(vals, np.linspace(0, 1, n_quantiles)))


def _load_pickle_list(path) -> np.ndarray:
    with open(path, "rb") as fh:
        return np.asarray(pickle.load(fh), dtype=np.float64)


def diameter_sampler(
    diam_files: Optional[Sequence[str]] = None,
    lo: float = 0.02,
    hi: float = 15.0,
) -> QuantileSampler:
    """Tree-diameter prior.

    With ``diam_files`` (reference pickles; first weighted 1x, rest 10x per
    ``simulate_trees.py:227-229``) builds the exact reference mixture;
    otherwise uses the shipped derived quantile table.
    """
    if diam_files:
        parts = []
        for i, f in enumerate(diam_files):
            vals = _load_pickle_list(f)
            parts.append(vals if i == 0 else np.repeat(vals, 10))
        diams = np.concatenate(parts)
        diams = diams[(diams > lo) & (diams < hi)]
        return QuantileSampler.from_values(diams)
    data = np.load(_DATA)
    return QuantileSampler(data["diam_quantiles"])


def alpha_sampler(alpha_file: Optional[str] = None) -> QuantileSampler:
    """Gamma-shape (rate heterogeneity) prior (``alisim.py:14,251``)."""
    if alpha_file:
        return QuantileSampler.from_values(_load_pickle_list(alpha_file))
    data = np.load(_DATA)
    return QuantileSampler(data["alpha_quantiles"])


def sample_scale(rng: np.random.Generator, mean: float, minimum: float) -> float:
    """Reference ``sample_scale``: Normal(mean, mean/10) clamped at a floor
    (the reference's `simulate_trees.py:53-59`, ``alisim.py:23-26``)."""
    return max(float(rng.normal(mean, mean / 10.0)), minimum)
