"""The published model's operations, fixed here so that no change to the
program moves the yardstick.

2 x the multiply-adds of every product of the forward, on real (unpadded)
pair-sites: per block the q, k (d -> H), v and o (d -> d) projections of
both attentions, the K^T V and Q (K^T V) contractions (d each a position),
and the FFN (d -> 4d -> d); after the blocks the head (d -> 1); before them
the embedding (22 -> d) on each sequence-site.  The reference's seq2pair
product is a gather written as a product and is not counted.  Training
counts 3 x the forward (the backward's two products per forward product).

For the published sizes: 100,864 FLOP a pair-site a block, 605,312 with
the head, and 2,816 a sequence-site for the embedding.
"""

from __future__ import annotations

from typing import Dict

TRAIN_FACTOR = 3


def per_block_flop(sizes: Dict) -> int:
    """FLOP a pair-site of one axial block."""
    d, h, f = sizes["embed_dim"], sizes["n_heads"], sizes["ffn_dim"]
    attention = d * h + d * h + d * d + d * d + d + d  # q, k, v, o, K^T V, Q (K^T V)
    return 2 * (2 * attention + d * f + f * d)


def per_pair_site_flop(sizes: Dict) -> int:
    """FLOP a pair-site of the blocks and the head."""
    return sizes["n_blocks"] * per_block_flop(sizes) + 2 * sizes["embed_dim"]


def forward_flop(n: int, l: int, sizes: Dict) -> int:
    """The forward of one ``n x l`` alignment."""
    p = n * (n - 1) // 2
    return p * l * per_pair_site_flop(sizes) + n * l * 2 * sizes["in_channels"] * sizes["embed_dim"]


def train_flop(n: int, l: int, sizes: Dict) -> int:
    """Forward and backward of one example."""
    return TRAIN_FACTOR * forward_flop(n, l, sizes)
