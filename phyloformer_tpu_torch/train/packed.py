"""Packed training data: parse a corpus once, memory-map it every epoch.

The counterpart of ``phyloformer_tpu/train/packed.py``, in the same shard
format, so either package reads the other's shards:

    shard_<k>.codes.npy   int8  the concatenated (n_i * L_i) alignment codes
    shard_<k>.dists.npy   f32   the concatenated C(n_i, 2) target distances
    shard_<k>.index.json  per example: n, L, codes_offset, dists_offset, id
    manifest.json         n_examples and the shard names

Parsing FASTA and Newick every epoch costs most on long alignments; here
loading is ``np.memmap`` slicing.  :class:`PackedBucketedLoader` gives the
batches of :class:`.data.BucketedLoader`: the same (n, L) buckets, padding,
masks and shuffling.
"""

from __future__ import annotations

import dataclasses
import json
import random
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..data.fasta import Alignment
from ..spans import setup_span
from .data import BucketedLoader, LoaderConfig, load_example


def preprocess(pairs: Sequence[Tuple[str, str]], out_dir, shard_size: int = 512,
               progress: bool = False) -> Path:
    """Pack ``(tree file, alignment file)`` pairs into shards of at most
    ``shard_size`` examples under ``out_dir``; returns ``out_dir``."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    manifest = {"n_examples": 0, "shards": []}
    for shard_id, start in enumerate(range(0, len(pairs), shard_size)):
        codes_parts: List[np.ndarray] = []
        dists_parts: List[np.ndarray] = []
        index = []
        codes_off = dists_off = 0
        for tree_path, aln_path in pairs[start:start + shard_size]:
            aln, vec = load_example(tree_path, aln_path)
            flat = np.ascontiguousarray(aln.codes, dtype=np.int8).reshape(-1)
            vec = np.ascontiguousarray(vec, dtype=np.float32)
            index.append({"n": aln.n_seqs, "L": aln.seq_len, "codes_offset": codes_off,
                          "dists_offset": dists_off, "id": Path(aln_path).stem})
            codes_parts.append(flat)
            dists_parts.append(vec)
            codes_off += flat.size
            dists_off += vec.size
        np.save(out / f"shard_{shard_id}.codes.npy", np.concatenate(codes_parts))
        np.save(out / f"shard_{shard_id}.dists.npy", np.concatenate(dists_parts))
        (out / f"shard_{shard_id}.index.json").write_text(json.dumps(index))
        manifest["shards"].append(f"shard_{shard_id}")
        manifest["n_examples"] += len(index)
        if progress:
            print(f"shard {shard_id}: {len(index)} examples")
    (out / "manifest.json").write_text(json.dumps(manifest))
    return out


class PackedDataset:
    """Memory-mapped random access over a packed corpus: ``ds[i]`` is
    ``(Alignment, target distances)``; the ids are ``s0 .. s{n-1}``, since
    the targets are already in the alignment's order."""

    def __init__(self, directory):
        self.dir = Path(directory)
        self._examples: List[Tuple[int, Dict]] = []  # (shard index, index entry)
        self._codes: List[np.ndarray] = []
        self._dists: List[np.ndarray] = []
        with setup_span("setup.loader"):
            manifest = json.loads((self.dir / "manifest.json").read_text())
            for si, shard in enumerate(manifest["shards"]):
                self._codes.append(np.load(self.dir / f"{shard}.codes.npy", mmap_mode="r"))
                self._dists.append(np.load(self.dir / f"{shard}.dists.npy", mmap_mode="r"))
                for meta in json.loads((self.dir / f"{shard}.index.json").read_text()):
                    self._examples.append((si, meta))

    def __len__(self) -> int:
        return len(self._examples)

    def __getitem__(self, i: int):
        si, meta = self._examples[i]
        n, L = meta["n"], meta["L"]
        co, do = meta["codes_offset"], meta["dists_offset"]
        codes = np.asarray(self._codes[si][co:co + n * L]).reshape(n, L)
        vec = np.asarray(self._dists[si][do:do + n * (n - 1) // 2])
        return Alignment(codes=codes, ids=[f"s{k}" for k in range(n)]), vec


class PackedSubset:
    """A view of some examples of a :class:`PackedDataset` (the train and
    validation splits)."""

    def __init__(self, dataset: PackedDataset, indices):
        self.ds = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.ds[self.indices[i]]


def split(dataset: PackedDataset, val_fraction: float, seed: int):
    """``(train, validation)`` subsets: a seeded shuffle, then the first
    ``max(1, int(n * val_fraction))`` examples validate; ``(dataset, None)``
    for a fraction of 0."""
    if val_fraction <= 0:
        return dataset, None
    idx = list(range(len(dataset)))
    random.Random(seed).shuffle(idx)
    n_val = max(1, int(len(idx) * val_fraction))
    return PackedSubset(dataset, idx[n_val:]), PackedSubset(dataset, idx[:n_val])


class PackedBucketedLoader(BucketedLoader):
    """Bucketed batches over a :class:`PackedDataset` or
    :class:`PackedSubset`: :class:`.data.BucketedLoader` with memory-map
    slicing in place of parsing, on one loading thread, so that the batches
    come in the epoch's shuffled order."""

    def __init__(self, dataset, cfg: LoaderConfig):
        if not len(dataset):
            raise ValueError("no packed examples to load")
        super().__init__(range(len(dataset)), dataclasses.replace(cfg, num_workers=1),
                         load=dataset.__getitem__)
