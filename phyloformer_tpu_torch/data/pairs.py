"""Pair-index utilities.

Pairs are enumerated in upper-triangle order (``for i in range(n): for j in
range(i+1, n)``), the row order of the reference's seq2pair matrix; the pair
representation is the gather-add ``pair[k] = seq[i_k] + seq[j_k]``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np


def n_pairs(n_seqs: int) -> int:
    return n_seqs * (n_seqs - 1) // 2


@lru_cache(maxsize=None)
def pair_indices(n_seqs: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(i_idx, j_idx)`` int32 arrays of length ``C(n,2)`` in upper-triangle
    order."""
    i_idx, j_idx = np.triu_indices(n_seqs, k=1)
    return i_idx.astype(np.int32), j_idx.astype(np.int32)


def vector_to_square(vec: np.ndarray, n_seqs: int) -> np.ndarray:
    """Scatter an upper-triangle vector into a symmetric ``(n, n)`` matrix
    with a zero diagonal."""
    vec = np.asarray(vec)
    if vec.shape[-1] != n_pairs(n_seqs):
        raise ValueError(
            f"expected {n_pairs(n_seqs)} pair distances for n={n_seqs}, got {vec.shape[-1]}"
        )
    i_idx, j_idx = pair_indices(n_seqs)
    square = np.zeros(vec.shape[:-1] + (n_seqs, n_seqs), dtype=vec.dtype)
    square[..., i_idx, j_idx] = vec
    square[..., j_idx, i_idx] = vec
    return square
