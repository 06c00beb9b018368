"""Native MSA simulator: evolve protein alignments along trees.

Replaces the reference's IQ-TREE2/AliSim subprocess dependency
(`alisim.py:91-120`) with an in-process simulator:

- GTR-class substitution models (LG/WAG/JTT/Poisson/PAML files,
  :mod:`.models`) via the reversible eigendecomposition — per-branch,
  per-site transition sampling is fully vectorized;
- gamma rate heterogeneity: continuous per-site rates (AliSim ``GC``) with
  alpha drawn from the hogenom empirical prior clamped >= 0.05
  (``alisim.py:23-26,82-84``), or discrete ``G{k}``;
- indels (AliSim parameterization: rates relative to the substitution rate,
  geometric lengths — reference uses ``--indel 0.01,0.01 --indel-size
  GEO{5},GEO{4}``, ``alisim.py:86-88``) with full insertion-history column
  tracking, plus post-hoc trim to the target length keeping an
  ``.untrimmed`` copy (``trim_alignment``, ``alisim.py:38-45``);
- duplicate-sequence rejection with bounded retries (``alisim.py:29-35,
  73-128``).

An ``iqtree2`` passthrough (:mod:`.iqtree`) remains available for byte-level
AliSim compatibility when the external binary exists.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..data.alphabet import GAP_CODE
from ..data.fasta import Alignment, write_fasta
from ..data.newick import Node, read_newick
from .models import (
    FrequencyMixture,
    SubstitutionModel,
    discrete_gamma_rates,
    get_model,
    load_mdef_nexus,
)
from .priors import QuantileSampler, alpha_sampler


@dataclasses.dataclass
class MsaSimConfig:
    substitution: str = "LG"
    length: int = 500
    # gamma: None, "GC" (continuous per-site), or "G<k>" (discrete k categories)
    gamma: Optional[str] = None
    alpha: Optional[float] = None  # fixed alpha; None = sample from prior
    # IQ-TREE -mdef nexus path: custom frequency-mixture classes layered on
    # the base exchangeabilities (the reference's --custom-model,
    # `alisim.py:185-191,255-263`)
    mdef: Optional[str] = None
    indels: bool = False
    insertion_rate: float = 0.01
    deletion_rate: float = 0.01
    insertion_mean_len: float = 5.0  # GEO{5}
    deletion_mean_len: float = 4.0  # GEO{4}
    max_attempts: int = 20
    allow_duplicates: bool = False


class _Evolver:
    """Evolves (column-id, state) sequences down a tree.

    With a :class:`FrequencyMixture` every column carries a frequency class
    (shared exchangeabilities, per-class equilibrium frequencies and
    eigensystem), matching IQ-TREE's ``-mdef`` custom models."""

    def __init__(
        self,
        model: SubstitutionModel,
        rng: np.random.Generator,
        mixture: Optional[FrequencyMixture] = None,
    ):
        self.rng = rng
        models = mixture.class_models(model) if mixture else [model]
        self.class_weights = (
            np.asarray(mixture.weights) if mixture else np.ones(1)
        )
        eig = [m.eigensystem() for m in models]
        self.lam = np.stack([e[0] for e in eig])  # (K, 20)
        self.left = np.stack([e[1] for e in eig])  # (K, 20, 20)
        self.right = np.stack([e[2] for e in eig])  # (K, 20, 20)
        self.class_freqs = np.stack([m.freqs for m in models])  # (K, 20)
        # per-class rate multipliers (IQ-TREE FMIX{NAME:rate:weight})
        self.class_rate = (
            np.asarray(mixture.class_rates()) if mixture else np.ones(1)
        )
        self.freqs = (self.class_weights[:, None] * self.class_freqs).sum(0)
        # global column order: list of column ids; columns only ever inserted
        self.column_order: List[int] = []
        self._next_col = 0
        self.col_rate: Dict[int, float] = {}
        self.col_class: Dict[int, int] = {}

    def sample_classes_and_states(self, count: int):
        """Vectorized (class, root-state) draws for ``count`` fresh columns."""
        k = len(self.class_weights)
        if k == 1:
            cls = np.zeros(count, dtype=np.int64)
            states = self.rng.choice(20, size=count, p=self.class_freqs[0])
        else:
            cls = self.rng.choice(k, size=count, p=self.class_weights)
            states = np.empty(count, dtype=np.int64)
            for c in range(k):
                m = cls == c
                if m.any():
                    states[m] = self.rng.choice(
                        20, size=int(m.sum()), p=self.class_freqs[c]
                    )
        return cls, states

    def new_column(self, after: Optional[int], rate: float, cls: int = 0) -> int:
        cid = self._next_col
        self._next_col += 1
        if after is None:
            self.column_order.append(cid)
        else:
            self.column_order.insert(self.column_order.index(after) + 1, cid)
        self.col_rate[cid] = rate
        self.col_class[cid] = cls
        return cid

    def root_sequence(self, length: int, rates: np.ndarray) -> List[Tuple[int, int]]:
        cls, states = self.sample_classes_and_states(length)
        seq = []
        prev = None
        for i in range(length):
            cid = self.new_column(
                prev, float(rates[i] * self.class_rate[cls[i]]), int(cls[i])
            )
            prev = cid
            seq.append((cid, int(states[i])))
        return seq

    def substitute(self, seq, t: float):
        """Vectorized site-wise substitution over branch length t."""
        if not seq or t <= 0:
            return list(seq)
        cols = np.array([c for c, _ in seq])
        states = np.array([s for _, s in seq])
        rates = np.array([self.col_rate[c] for c in cols])
        cls = np.array([self.col_class[c] for c in cols])
        # P rows: p[s, j] = sum_k right[cls_s, state_s, k] e^{lam[cls_s]_k t r_s} left[cls_s, k, j]
        e = np.exp(self.lam[cls] * (t * rates)[:, None])  # (S, 20)
        a = self.right[cls, states] * e  # (S, 20)
        probs = np.einsum("sk,skj->sj", a, self.left[cls])  # (S, 20)
        probs = np.clip(probs, 0.0, None)
        probs /= probs.sum(axis=1, keepdims=True)
        u = self.rng.uniform(size=len(seq))
        cdf = np.cumsum(probs, axis=1)
        new_states = (u[:, None] > cdf).sum(axis=1)
        return [(int(c), int(s)) for c, s in zip(cols, new_states)]

    def apply_indels(self, seq, t: float, cfg: MsaSimConfig, sample_rate):
        """Gillespie-ish indel process over the branch (sequential events)."""
        seq = list(seq)
        L = len(seq)
        n_ins = self.rng.poisson(cfg.insertion_rate * t * (L + 1))
        n_del = self.rng.poisson(cfg.deletion_rate * t * max(L, 1))
        events = ["I"] * n_ins + ["D"] * n_del
        self.rng.shuffle(events)
        for ev in events:
            if ev == "I":
                size = int(self.rng.geometric(1.0 / cfg.insertion_mean_len))
                pos = int(self.rng.integers(0, len(seq) + 1))
                after = seq[pos - 1][0] if pos > 0 else None
                cls, states = self.sample_classes_and_states(size)
                for c, s in zip(cls, states):
                    rate = float(sample_rate()) * float(self.class_rate[c])
                    cid = self.new_column(after, rate, int(c))
                    seq.insert(pos, (cid, int(s)))
                    after = cid
                    pos += 1
            else:
                if not seq:
                    continue
                size = int(self.rng.geometric(1.0 / cfg.deletion_mean_len))
                pos = int(self.rng.integers(0, len(seq)))
                del seq[pos : pos + size]
        return seq


def _gamma_rate_sampler(cfg: MsaSimConfig, rng: np.random.Generator,
                        alpha_prior: Optional[QuantileSampler]):
    """Returns (per_site_rates(length), single_rate()) callables."""
    if cfg.gamma is None:
        return (lambda n: np.ones(n)), (lambda: 1.0)
    alpha = cfg.alpha
    if alpha is None:
        prior = alpha_prior or alpha_sampler()
        mean = float(prior.sample(rng))
        alpha = max(float(rng.normal(mean, mean / 10.0)), 0.05)  # alisim.py:23-26
    mode = cfg.gamma.upper()
    if mode == "GC":
        def vec(n):
            return rng.gamma(alpha, 1.0 / alpha, size=n)

        return vec, (lambda: float(rng.gamma(alpha, 1.0 / alpha)))
    if mode.startswith("G"):
        k = int(mode[1:]) if len(mode) > 1 else 4
        cats = discrete_gamma_rates(alpha, k)

        def vec(n):
            return cats[rng.integers(0, k, size=n)]

        return vec, (lambda: float(cats[rng.integers(0, k)]))
    raise ValueError(f"gamma must be 'GC' or 'G<k>', got {cfg.gamma!r}")


def evolve_alignment(
    tree: Node,
    cfg: MsaSimConfig,
    rng: np.random.Generator,
    alpha_prior: Optional[QuantileSampler] = None,
) -> Alignment:
    """Simulate one alignment along ``tree`` (single attempt, may contain
    duplicates)."""
    model = get_model(cfg.substitution)
    mixture = load_mdef_nexus(cfg.mdef) if cfg.mdef else None
    ev = _Evolver(model, rng, mixture)
    rate_vec, rate_one = _gamma_rate_sampler(cfg, rng, alpha_prior)

    root_seq = ev.root_sequence(cfg.length, rate_vec(cfg.length))
    leaf_seqs: Dict[str, List[Tuple[int, int]]] = {}

    def down(node: Node, seq):
        if node.is_leaf:
            leaf_seqs[node.name] = seq
            return
        for child in node.children:
            t = child.length or 0.0
            child_seq = ev.substitute(seq, t)
            if cfg.indels:
                child_seq = ev.apply_indels(child_seq, t, cfg, rate_one)
            down(child, child_seq)

    down(tree, root_seq)

    col_index = {c: i for i, c in enumerate(ev.column_order)}
    ncols = len(ev.column_order)
    names = [leaf.name for leaf in tree.leaves()]
    codes = np.full((len(names), ncols), GAP_CODE, dtype=np.int8)
    for r, name in enumerate(names):
        for cid, state in leaf_seqs[name]:
            codes[r, col_index[cid]] = state
    if cfg.indels:
        # drop all-gap columns (can appear when an inserted column is later
        # deleted in every carrying lineage)
        keep = (codes != GAP_CODE).any(axis=0)
        codes = codes[:, keep]
    return Alignment(codes=codes, ids=names)


def simulate_msa(
    tree_path,
    out_path,
    cfg: MsaSimConfig,
    rng: Optional[np.random.Generator] = None,
    alpha_prior: Optional[QuantileSampler] = None,
) -> Tuple[bool, int]:
    """Simulate with duplicate rejection; returns (success, attempts).

    With indels, writes the full alignment to ``<out>.untrimmed`` and the
    first ``cfg.length`` columns to ``out`` (reference trim semantics).
    """
    rng = rng if rng is not None else np.random.default_rng()
    tree = read_newick(tree_path)
    out_path = Path(out_path)
    for attempt in range(1, cfg.max_attempts + 1):
        aln = evolve_alignment(tree, cfg, rng, alpha_prior)
        if not cfg.allow_duplicates:
            rows = {r.tobytes() for r in aln.codes}
            if len(rows) != aln.n_seqs:
                continue
        if cfg.indels:
            write_fasta(str(out_path) + ".untrimmed", aln)
            aln = Alignment(codes=aln.codes[:, : cfg.length], ids=aln.ids)
        write_fasta(out_path, aln)
        return True, attempt
    return False, cfg.max_attempts
