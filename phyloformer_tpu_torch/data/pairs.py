"""Pair-index utilities.

Pairs are enumerated in upper-triangle order (``for i in range(n): for j in
range(i+1, n)``), the row order of the reference's seq2pair matrix; the pair
representation is the gather-add ``pair[k] = seq[i_k] + seq[j_k]``;
:func:`seq2pair_matrix` is that sum as the reference's dense ``(P, n)`` matrix.
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


def seq2pair_matrix(n_seqs: int, dtype=np.float32) -> np.ndarray:
    """The reference's ``(P, n)`` 0/1 seq2pair matrix: row ``k`` has ones at
    the columns of pair ``k``'s two sequences."""
    i_idx, j_idx = pair_indices(n_seqs)
    mat = np.zeros((len(i_idx), n_seqs), dtype=dtype)
    rows = np.arange(len(i_idx))
    mat[rows, i_idx] = 1
    mat[rows, j_idx] = 1
    return mat


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


def square_to_vector(mat: np.ndarray) -> np.ndarray:
    """Inverse of :func:`vector_to_square` (reads the upper triangle)."""
    n = mat.shape[-1]
    i_idx, j_idx = pair_indices(n)
    return mat[..., i_idx, j_idx]
