"""Amino-acid alphabet and integer codec.

22 symbols = 20 amino acids + ``X`` (unknown) + ``-`` (gap), encoded by their
index in the string below; the one-hot depth (and the embedding table's row
count) is therefore 22.  Lowercase residues map to the same codes; ``strict``
mode rejects them, as the reference codec does.
"""

from __future__ import annotations

import numpy as np

ALPHABET: bytes = b"ARNDCQEGHILKMFPSTWYVX-"
ALPHABET_SIZE: int = len(ALPHABET)  # 22
GAP_CODE: int = ALPHABET.index(b"-")  # 21
UNKNOWN_CODE: int = ALPHABET.index(b"X")  # 20

# 256-entry lookup table: byte value -> code, or -1 for invalid bytes.
_LUT = np.full(256, -1, dtype=np.int16)
for _i, _c in enumerate(ALPHABET):
    _LUT[_c] = _i
for _i, _c in enumerate(ALPHABET.lower()):
    if _c != ALPHABET[_i]:
        _LUT[_c] = _i


def encode_bytes(seq: bytes, strict: bool = True) -> np.ndarray:
    """Encode a residue byte-string into int8 codes of shape ``(L,)``."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    codes = _LUT[arr]
    if strict:
        exact = np.isin(arr, np.frombuffer(ALPHABET, dtype=np.uint8))
        if not exact.all():
            bad = arr[~exact][0]
            raise ValueError(f"invalid residue byte {bytes([bad])!r} in sequence")
    elif (codes < 0).any():
        raise ValueError("unencodable residue byte in sequence")
    return codes.astype(np.int8)


def one_hot(codes: np.ndarray, dtype=np.float32) -> np.ndarray:
    """One-hot encode integer codes along a new trailing axis of size 22."""
    codes = np.asarray(codes)
    out = np.zeros(codes.shape + (ALPHABET_SIZE,), dtype=dtype)
    np.put_along_axis(out, codes[..., None].astype(np.int64), 1, axis=-1)
    return out


def decode_codes(codes: np.ndarray) -> bytes:
    """Inverse of :func:`encode_bytes`."""
    table = np.frombuffer(ALPHABET, dtype=np.uint8)
    return table[np.asarray(codes, dtype=np.int64)].tobytes()
