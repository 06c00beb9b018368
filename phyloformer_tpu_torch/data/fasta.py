"""FASTA reading and writing for protein MSAs.

Ids are the full header text after ``>``; sequences may span several lines;
all sequences must have the same length.  :func:`read_fasta` returns integer
codes ``(n, L)``, the compact form the inference engine ships to the device;
:func:`load_alignment` the reference's one-hot ``(22, L, n)`` layout and the ids.
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass
from typing import List, Tuple, Union

import numpy as np

from .alphabet import decode_codes, encode_bytes, one_hot


@dataclass
class Alignment:
    """A parsed MSA: integer codes ``(n, L)`` int8 + taxon ids in file order."""

    codes: np.ndarray  # (n_seqs, seq_len) int8
    ids: List[str]

    @property
    def n_seqs(self) -> int:
        return self.codes.shape[0]

    @property
    def seq_len(self) -> int:
        return self.codes.shape[1]

    def one_hot_ref_layout(self, dtype=np.float32) -> np.ndarray:
        """The reference's ``(22, L, n)`` one-hot layout: codes ``(n, L)`` one-hot
        on a trailing axis, transposed as torch's ``one_hot(...).permute(2, 1, 0)``."""
        return one_hot(self.codes, dtype=dtype).transpose(2, 1, 0)


def read_fasta(path_or_bytes: Union[str, os.PathLike, bytes], strict: bool = True) -> Alignment:
    """Parse a FASTA alignment into an :class:`Alignment`."""
    if isinstance(path_or_bytes, bytes):
        raw = path_or_bytes
    else:
        with open(path_or_bytes, "rb") as fh:
            raw = fh.read()

    ids: List[str] = []
    chunks: List[List[bytes]] = []
    for line in raw.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(b">"):
            ids.append(line[1:].decode("utf8"))
            chunks.append([])
        else:
            if not chunks:
                raise ValueError("FASTA sequence data before first '>' header")
            chunks[-1].append(line)

    if not ids:
        raise ValueError("empty FASTA file")

    seqs = [encode_bytes(b"".join(c), strict=strict) for c in chunks]
    lengths = {len(s) for s in seqs}
    if len(lengths) != 1:
        raise ValueError(f"unaligned FASTA: sequence lengths differ ({sorted(lengths)})")

    return Alignment(codes=np.stack(seqs).astype(np.int8), ids=ids)


def load_alignment(path: Union[str, os.PathLike]) -> Tuple[np.ndarray, List[str]]:
    """The reference's loader: one-hot ``(22, L, n)`` float32 and the ids."""
    aln = read_fasta(path, strict=True)
    return aln.one_hot_ref_layout(), aln.ids


def write_fasta(path: Union[str, os.PathLike], aln: Alignment, width: int = 0) -> None:
    """Write an alignment back to FASTA (width=0 means one line per sequence)."""
    buf = io.StringIO()
    for taxon, row in zip(aln.ids, aln.codes):
        buf.write(f">{taxon}\n")
        seq = decode_codes(row).decode("ascii")
        if width and width > 0:
            for start in range(0, len(seq), width):
                buf.write(seq[start : start + width] + "\n")
        else:
            buf.write(seq + "\n")
    with open(path, "w") as fh:
        fh.write(buf.getvalue())


def has_fasta_ext(path: Union[str, os.PathLike]) -> bool:
    """True for ``.fa`` / ``.fasta`` (any case)."""
    p = str(path).lower()
    return p.endswith(".fa") or p.endswith(".fasta")
