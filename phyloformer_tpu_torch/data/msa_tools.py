"""MSA manipulation utilities (a goalign-equivalent subset).

Phyloformer's published pipeline calls the external Go tool ``goalign`` to
manipulate and deduplicate alignments; the operations the pipelines need
are first-party here: dedup, trim, subset, sample, concat, degap, stats.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .alphabet import GAP_CODE
from .fasta import Alignment


def dedup(aln: Alignment) -> Tuple[Alignment, List[str]]:
    """Drop duplicate sequences (keep first); returns (aln, dropped ids)."""
    seen: Dict[bytes, str] = {}
    keep_rows, dropped = [], []
    for i, row in enumerate(aln.codes):
        key = row.tobytes()
        if key in seen:
            dropped.append(aln.ids[i])
        else:
            seen[key] = aln.ids[i]
            keep_rows.append(i)
    return (
        Alignment(codes=aln.codes[keep_rows], ids=[aln.ids[i] for i in keep_rows]),
        dropped,
    )


def trim(aln: Alignment, length: int, start: int = 0) -> Alignment:
    """Keep columns [start, start+length)."""
    return Alignment(codes=aln.codes[:, start : start + length], ids=list(aln.ids))


def subset(aln: Alignment, ids: Sequence[str]) -> Alignment:
    """Select sequences by id (order follows ``ids``)."""
    index = {name: i for i, name in enumerate(aln.ids)}
    rows = [index[name] for name in ids]
    return Alignment(codes=aln.codes[rows], ids=list(ids))


def sample(aln: Alignment, n: int, seed: Optional[int] = None) -> Alignment:
    """Random subsample of n sequences."""
    rng = np.random.default_rng(seed)
    rows = sorted(rng.choice(aln.n_seqs, size=n, replace=False).tolist())
    return Alignment(codes=aln.codes[rows], ids=[aln.ids[i] for i in rows])


def remove_gap_columns(aln: Alignment, max_gap_frac: float = 0.0) -> Alignment:
    """Drop columns whose gap fraction exceeds ``max_gap_frac``."""
    gap_frac = (aln.codes == GAP_CODE).mean(axis=0)
    keep = gap_frac <= max_gap_frac
    return Alignment(codes=aln.codes[:, keep], ids=list(aln.ids))


def concat(alns: Sequence[Alignment]) -> Alignment:
    """Concatenate alignments column-wise (same taxa required)."""
    base = list(alns[0].ids)
    blocks = [alns[0].codes]
    for a in alns[1:]:
        if sorted(a.ids) != sorted(base):
            raise ValueError("concat: taxon sets differ")
        blocks.append(subset(a, base).codes)
    return Alignment(codes=np.concatenate(blocks, axis=1), ids=base)


def stats(aln: Alignment) -> Dict[str, float]:
    gaps = (aln.codes == GAP_CODE).mean()
    return {
        "n_seqs": aln.n_seqs,
        "seq_len": aln.seq_len,
        "gap_fraction": float(gaps),
        "n_duplicate_seqs": aln.n_seqs - len({r.tobytes() for r in aln.codes}),
    }
