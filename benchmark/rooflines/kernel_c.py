"""Kernel C (``pf_kernel_c``, the backward of the column-attention finish
and the FFN, once a block a step): the products that its plain version
(``kernel_c_plain`` in the port's ``ops/kernels/axial_block_bwd.py``, as of
the benchmark's first version) computes a pair-site, frozen here: the
recomputed q (d x H), o and FFN up-projection (d x d, d x 4d), the FFN's
four backward products (d(w2), g3 w2^T, du w1^T, d(w1): 4 x d x 4d) and
o's two (d(wo), g2 wo^T: 2 x d x d).  Bytes: x1 and
g3 read and g2 written once in fp32.  Nothing in the program reads this
file."""

from __future__ import annotations

from typing import Dict

KERNEL = r"\bkernel_c\b"


def flop_per_pair_site(sizes: Dict) -> int:
    d, h, f = sizes["embed_dim"], sizes["n_heads"], sizes["ffn_dim"]
    forward = d * h + d * d + d * f
    backward = 4 * d * f + 2 * d * d
    return 2 * (forward + backward)


def bytes_per_pair_site(sizes: Dict) -> int:
    return 3 * 4 * sizes["embed_dim"]
