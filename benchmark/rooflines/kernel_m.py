"""Kernel M (``pf_kernel_m``, the pipeline's block boundary): the products
of the published model that it takes a pair-site, frozen here: block i's
column-attention finish (q, d x H, and o, d x d) and FFN (d x 4d, 4d x d),
then block i+1's row attention (q and k, d x H; v and o, d x d) and column
sums (q and k, d x H; v, d x d), as its plain version (``kernel_m_plain``
in the port's ``ops/kernels/pipeline.py``) groups them.  The plain version
repeats each head's q and k over the head's d / H lanes and so computes
them as d x d products; the count takes the model's d x H.  Bytes: the
pair activation read once and written once in fp32.  Nothing in the
program reads this file."""

from __future__ import annotations

from typing import Dict

KERNEL = r"\bkernel_m\b"  # the device trace's kernel name


def flop_per_pair_site(sizes: Dict) -> int:
    d, h, f = sizes["embed_dim"], sizes["n_heads"], sizes["ffn_dim"]
    finish_b = d * h + d * d + d * f + f * d
    row_a = 2 * d * h + 2 * d * d
    col_stats = 2 * d * h + d * d
    return 2 * (finish_b + row_a + col_stats)


def bytes_per_pair_site(sizes: Dict) -> int:
    return 2 * 4 * sizes["embed_dim"]
