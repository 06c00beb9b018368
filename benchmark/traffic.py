"""The benchmark's one traffic generator: alignments, targets and arrivals
from a seed.  It reads the parameters of a mix from a workload file; a new
mix is a new data file, not new code.

Alignments evolve down a random binary tree (a copy of ``chip_smoke.py``'s
``evolved_alignment``, which also keeps the tree): a random root sequence is
split until ``n`` lineages remain, each branch of exponential length ``t``
(mean ``mean_branch``, at least ``min_branch`` substitutions a site, the floor
the reference's tree simulator puts on its leaf branches) mutating every site
with probability ``1 - exp(-20 t / 19)`` to one of the other 19 amino acids
(the Poisson model).  The targets are the tree's patristic distances, in
upper-triangle pair order.

Every seed gives the same sizes; the seed changes the sequences and the
trees.  Arrivals follow a pattern of their own seed, which a workload file
fixes, so that every run offers the same sizes at the same times.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List, Sequence

import numpy as np

ALPHABET = b"ARNDCQEGHILKMFPSTWYVX-"


def rng_for(seed: int, *tags: int) -> np.random.Generator:
    """An independent stream for one use of the seed (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 64), *tags])


def evolve(rng: np.random.Generator, n: int, l: int, mean_branch: float,
           min_branch: float):
    """``(codes (n, l) int8, patristic distances (C(n, 2),) float64)``."""
    seqs = [rng.integers(0, 20, l)]
    paths: List[List[int]] = [[0]]  # each lineage's nodes from the root
    depth = [0.0]
    while len(seqs) < n:
        k = int(rng.integers(len(seqs)))
        parent, path = seqs.pop(k), paths.pop(k)
        for _ in range(2):
            t = max(min_branch, float(rng.exponential(mean_branch)))
            child = parent.copy()
            mut = rng.random(l) < 1.0 - math.exp(-t * 20.0 / 19.0)
            child[mut] = (child[mut] + rng.integers(1, 20, int(mut.sum()))) % 20
            depth.append(depth[path[-1]] + t)
            seqs.append(child)
            paths.append(path + [len(depth) - 1])
    dists = np.empty(n * (n - 1) // 2)
    for k, (i, j) in enumerate(itertools.combinations(range(n), 2)):
        a, b = paths[i], paths[j]
        m = 0
        while m < min(len(a), len(b)) and a[m] == b[m]:
            m += 1
        lca = a[m - 1]
        dists[k] = depth[a[-1]] + depth[b[-1]] - 2.0 * depth[lca]
    return np.stack(seqs).astype(np.int8), dists


def sizes(mix: Dict) -> List[tuple]:
    """The mix's ``(n, l)`` list: every tips count of ``tips`` (a list, or
    ``[lo, hi]`` under ``tips_range`` for every count in between) at every
    length of ``sites``, ``reps`` times."""
    tips = (list(range(mix["tips_range"][0], mix["tips_range"][1] + 1))
            if "tips_range" in mix else list(mix["tips"]))
    return [(n, l) for _ in range(int(mix.get("reps", 1))) for n in tips for l in mix["sites"]]


def pool(mix: Dict, seed: int) -> List[Dict]:
    """The mix's alignments from ``seed``, in the order of :func:`sizes`:
    dicts with ``n``, ``l``, ``codes`` and ``dists``."""
    rng = rng_for(seed, 1)
    out = []
    for n, l in sizes(mix):
        codes, dists = evolve(rng, n, l, mix["mean_branch"], mix["min_branch"])
        out.append({"n": n, "l": l, "codes": codes, "dists": dists})
    return out


def fasta(codes: np.ndarray) -> bytes:
    """FASTA text of ``codes`` with ids ``s0 .. s{n-1}``."""
    lut = np.frombuffer(ALPHABET, dtype=np.uint8)
    return b"".join(b">s%d\n" % i + lut[row.astype(np.int64)].tobytes() + b"\n"
                    for i, row in enumerate(codes))


def poisson_schedule(rate: float, seconds: float, n_pool: int, seed: int):
    """Open-loop arrivals at about ``rate`` a second over ``seconds``:
    ``(due times (N,), pool indices (N,))``.  The schedule is ``k`` rounds,
    ``k = round(rate * seconds / n_pool)`` (at least 1), each asking for
    every pool entry once in an order drawn from ``seed``, so
    ``N = k * n_pool``.  The gaps are the N quantiles of the exponential
    distribution, scaled to span the window, dealt to the rounds so that
    each round holds every k-th quantile, and shuffled within their round.
    Every round so offers the same load."""
    k = max(1, int(round(rate * seconds / n_pool)))
    n = k * n_pool
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps *= seconds / gaps.sum()
    order, pick = rng_for(seed, 3), rng_for(seed, 4)
    rounds = [order.permutation(gaps[r::k]) for r in order.permutation(k)]
    gaps = np.concatenate(rounds)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    idx = np.concatenate([pick.permutation(n_pool) for _ in range(k)])
    return due, idx


def real_pair_sites(items: Sequence[Dict]) -> int:
    return sum(it["n"] * (it["n"] - 1) // 2 * it["l"] for it in items)
