"""Square PHYLIP distance-matrix writer/reader.

A header line with the taxon count, then one row per taxon: ``<id> <d0> <d1>
...`` with 10-decimal fixed-point floats separated by single spaces — the
format the native tree tools consume.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np

from .pairs import vector_to_square


def matrix_to_phylip(matrix: np.ndarray, ids: Sequence[str]) -> str:
    n = len(ids)
    if matrix.shape != (n, n):
        raise ValueError(f"matrix shape {matrix.shape} != ({n}, {n})")
    lines = [f"{n}\n"]
    for taxon, row in zip(ids, matrix):
        row_s = " ".join(f"{x:.10f}" for x in row)
        lines.append(f"{taxon} {row_s}\n")
    return "".join(lines)


def vec_to_phylip(preds: np.ndarray, ids: Sequence[str]) -> Tuple[np.ndarray, str]:
    """Upper-triangle prediction vector -> (symmetric matrix, phylip text)."""
    dm = vector_to_square(np.asarray(preds), len(ids))
    return dm, matrix_to_phylip(dm, ids)


def read_phylip(path_or_text: Union[str, bytes]) -> Tuple[np.ndarray, List[str]]:
    """Parse a square PHYLIP distance matrix -> (matrix float64, ids)."""
    if isinstance(path_or_text, bytes):
        text = path_or_text.decode()
    elif isinstance(path_or_text, str) and "\n" in path_or_text:
        text = path_or_text
    else:
        with open(path_or_text) as fh:
            text = fh.read()
    lines = [ln for ln in text.splitlines() if ln.strip()]
    n = int(lines[0].split()[0])
    if len(lines) != n + 1:
        raise ValueError(f"expected {n} matrix rows, found {len(lines) - 1}")
    ids, rows = [], []
    for line in lines[1:]:
        fields = line.split()
        ids.append(fields[0])
        rows.append([float(x) for x in fields[1 : n + 1]])
    return np.asarray(rows, dtype=np.float64), ids
