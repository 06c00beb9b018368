"""Training data: pair discovery, the train/validation split, bucketed
batching with a parsing thread pool.

- trees and alignments are paired by filename stem, with an optional regex
  filter (:func:`make_pairs`);
- without validation directories the pairs are shuffled with a seed and
  split 90/10 (:func:`choose_data`);
- examples are grouped into (n, L) shape buckets, the engine's own, so each
  batch has one padded shape; padding is masked exactly.
"""

from __future__ import annotations

import dataclasses
import queue
import random
import re
import threading
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..data.fasta import read_fasta
from ..data.newick import patristic_vector, read_newick
from ..infer.engine import DEFAULT_L_BUCKETS, DEFAULT_N_BUCKETS, _bucketize
from ..spans import setup_span, span
from .trainer import make_batch

TREE_EXTS = (".nwk", ".newick", ".tree", ".treefile")
ALN_EXTS = (".fa", ".fasta")


def stem(path) -> str:
    """Filename minus its final extension."""
    return Path(path).stem


def make_pairs(tree_dir, aln_dir, regex: Optional[str] = None) -> List[Tuple[str, str]]:
    """Match tree files to same-stem alignments, in sorted order."""
    pattern = re.compile(regex) if regex else None
    trees: Dict[str, Path] = {}
    for p in sorted(Path(tree_dir).iterdir()):
        if p.suffix.lower() in TREE_EXTS:
            trees[stem(p)] = p
    pairs = []
    for p in sorted(Path(aln_dir).iterdir()):
        if p.suffix.lower() not in ALN_EXTS:
            continue
        s = stem(p)
        if s not in trees:
            continue
        if pattern and not pattern.search(p.name):
            continue
        pairs.append((str(trees[s]), str(p)))
    return pairs


def choose_data(
    train_trees,
    train_alns,
    val_trees=None,
    val_alns=None,
    train_regex: Optional[str] = None,
    val_regex: Optional[str] = None,
    seed: int = 1337,
    val_frac: float = 0.1,
) -> Tuple[List[Tuple[str, str]], List[Tuple[str, str]]]:
    """Explicit validation directories, else a seeded 90/10 split."""
    train_pairs = make_pairs(train_trees, train_alns, train_regex)
    if val_trees and val_alns:
        return train_pairs, make_pairs(val_trees, val_alns, val_regex)
    shuffled = list(train_pairs)
    random.Random(seed).shuffle(shuffled)
    n_val = max(1, int(len(shuffled) * val_frac)) if shuffled else 0
    return shuffled[n_val:], shuffled[:n_val]


def load_example(tree_path: str, aln_path: str):
    """One example: (Alignment, target distances in the alignment's id order)."""
    aln = read_fasta(aln_path)
    return aln, patristic_vector(read_newick(tree_path), aln.ids)


@dataclasses.dataclass
class LoaderConfig:
    batch_size: int = 4
    n_buckets: Sequence[int] = DEFAULT_N_BUCKETS
    l_buckets: Sequence[int] = DEFAULT_L_BUCKETS
    num_workers: int = 4
    shuffle: bool = True
    seed: int = 1337
    drop_last: bool = False
    prefetch: int = 4
    # Optional cap on activation tokens (pairs x sites x batch) per batch:
    # each bucket's batch is min(batch_size, max_batch_tokens // tokens per
    # example), so a mixed-length corpus does not run out of memory on its
    # largest bucket.  None keeps the flat batch size.
    max_batch_tokens: Optional[int] = None

    def bucket_batch_size(self, pad_n: int, pad_l: int) -> int:
        if self.max_batch_tokens is None:
            return self.batch_size
        tokens = pad_n * (pad_n - 1) // 2 * pad_l
        return max(1, min(self.batch_size, self.max_batch_tokens // max(tokens, 1)))


class BucketedLoader:
    """Iterates host-side padded batches grouped by (pad_n, pad_l) bucket.

    Each epoch shuffles the examples, loads them in a thread pool, collects
    them per bucket and emits a batch once a bucket holds its batch size;
    the rest are flushed at the end of the epoch unless ``drop_last``.
    ``load(item)`` gives an item's ``(Alignment, target distances)``; by
    default the items are ``(tree file, alignment file)`` pairs, parsed with
    :func:`load_example`."""

    def __init__(self, items: Sequence, cfg: LoaderConfig,
                 load: Optional[Callable] = None):
        if not items:
            raise ValueError("no (tree, alignment) pairs to load")
        with setup_span("setup.loader", examples=len(items)):
            self.items = list(items)
            self.cfg = cfg
            self.load = load or (lambda pair: load_example(*pair))
            self._epoch = 0

    def __len__(self):  # number of examples
        return len(self.items)

    def batches_per_epoch(self) -> int:
        return -(-len(self.items) // self.cfg.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        cfg = self.cfg
        order = list(range(len(self.items)))
        if cfg.shuffle:
            random.Random(cfg.seed + self._epoch).shuffle(order)
        self._epoch += 1

        out_q: "queue.Queue" = queue.Queue(maxsize=max(cfg.prefetch * cfg.batch_size, 8))
        stop = threading.Event()

        def producer(indices):
            try:
                for i in indices:
                    if stop.is_set():
                        return
                    try:
                        with span("loader.load"):
                            example = self.load(self.items[i])
                        out_q.put((i, example))
                    except Exception as err:  # surface parse errors with context
                        out_q.put((i, err))
            finally:
                out_q.put((None, None))

        nw = max(1, cfg.num_workers)
        threads = [threading.Thread(target=producer, args=(order[w::nw],), daemon=True)
                   for w in range(nw)]
        for t in threads:
            t.start()

        buckets: Dict[Tuple[int, int], List] = {}
        finished = 0
        try:
            while finished < nw:
                idx, item = out_q.get()
                if idx is None:
                    finished += 1
                    continue
                if isinstance(item, Exception):
                    raise RuntimeError(f"failed loading {self.items[idx]}") from item
                aln, vec = item
                key = (_bucketize(aln.n_seqs, cfg.n_buckets, True),
                       _bucketize(aln.seq_len, cfg.l_buckets, True))
                buckets.setdefault(key, []).append((aln, vec))
                if len(buckets[key]) >= cfg.bucket_batch_size(*key):
                    yield self._assemble(buckets.pop(key), key)
            if not cfg.drop_last:
                for key in sorted(buckets):
                    if buckets[key]:
                        yield self._assemble(buckets[key], key)
        finally:
            stop.set()

    @staticmethod
    def _assemble(items, key) -> Dict[str, np.ndarray]:
        with span("loader.assemble", examples=len(items)):
            return make_batch([a for a, _ in items], [v for _, v in items], key[0], key[1])
