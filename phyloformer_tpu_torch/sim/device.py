"""Batched MSA simulation on the card (PyTorch).

The native evolver (:mod:`.msa`) simulates one alignment at a time on the
host.  This module runs the same substitution process over a *batch* of
trees on one device, ``cuda`` unless the caller asks for ``cpu``:

- transition weights from the shared reversible eigensystem
  (``SubstitutionModel.eigensystem``, stacked in float32), evaluated per
  (branch, site rate) on the device;
- one step per preorder node, the node loop in Python over parent-pointer
  arrays (any topology; trees padded to a common node count);
- Gumbel-argmax categorical sampling (the weights enter only up to scale,
  so they are not normalised).

Semantics match the native evolver: the same eigensystem, the same gamma
rate conventions (continuous ``GC`` / discrete ``G<k>``, alpha from the
hogenom prior), the same ``-mdef`` frequency-mixture handling (a class per
site, shared exchangeabilities, per-class rate multipliers) and the same
duplicate-rejection retry loop.  Indels are sequential per-branch edits and
stay with the native engine.

The host draws (alpha, site rates, classes, root states), the packed trees
and the drawn device seed follow the JAX package's engine step for step, so
one numpy seed gives the same values in both.  The substitution draws come
from a ``torch.Generator`` seeded with the drawn seed: they differ from the
JAX engine's threefry stream and from the native engine's draws, with the
same distribution.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..data.fasta import Alignment
from ..data.newick import Node
from ..device import resolve_device, tf32_products
from .models import get_model, load_mdef_nexus
from .msa import MsaSimConfig, _gamma_rate_sampler
from .priors import QuantileSampler


@dataclasses.dataclass
class _PackedTrees:
    """Parent-pointer encoding of a tree batch, padded to a common size."""

    parent: np.ndarray  # (K, N) int32; parent[.,0] = 0 (root self-loop)
    blen: np.ndarray  # (K, N) float32 branch length to parent
    leaf_node: np.ndarray  # (K, n_max) int32 node index of each leaf (pad: 0)
    n_leaves: List[int]
    names: List[List[str]]


def _pack_trees(trees: Sequence[Node], pad_nodes: int = 0) -> _PackedTrees:
    per = []
    for tree in trees:
        # parent indices from the children structure (``.parent`` backlinks
        # can go stale under tree surgery, e.g. the simulator's root pruning)
        order = list(tree.traverse_preorder())
        index = {id(node): i for i, node in enumerate(order)}
        parent = np.zeros(len(order), dtype=np.int32)
        blen = np.zeros(len(order), dtype=np.float32)
        leaf_node, names = [], []
        for i, node in enumerate(order):
            for child in node.children:
                j = index[id(child)]
                parent[j] = i
                blen[j] = float(child.length or 0.0)
            if node.is_leaf:
                leaf_node.append(i)
                names.append(node.name)
        per.append((parent, blen, leaf_node, names))

    n_nodes = max(max(len(p[0]) for p in per), pad_nodes)
    n_max = max(len(p[2]) for p in per)
    K = len(per)
    parent = np.zeros((K, n_nodes), dtype=np.int32)
    blen = np.zeros((K, n_nodes), dtype=np.float32)
    leaf_node = np.zeros((K, n_max), dtype=np.int32)
    for k, (p, b, ln, _) in enumerate(per):
        parent[k, : len(p)] = p
        blen[k, : len(b)] = b
        leaf_node[k, : len(ln)] = ln
    return _PackedTrees(
        parent=parent,
        blen=blen,
        leaf_node=leaf_node,
        n_leaves=[len(p[2]) for p in per],
        names=[p[3] for p in per],
    )


def step_weights(lamc: torch.Tensor, leftc: torch.Tensor, right: torch.Tensor,
                 cls: torch.Tensor, p_state: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Unnormalised transition weights of one step, ``(K, L, 20)``.

    ``lamc`` ``(K, L, 20)`` and ``leftc`` ``(K, L, 20, 20)`` are the per-site
    class stacks, ``right`` ``(C, 20, 20)`` the classes' right eigenvectors,
    ``cls`` and ``p_state`` ``(K, L)`` the sites' classes and parent states,
    ``t`` ``(K, L)`` the branch length times the site rate:
    ``w[k, l, j] = sum_m right[c, s, m] exp(lam[c, m] t) left[c, m, j]``."""
    e = torch.exp(lamc * t[..., None])
    a = right[cls, p_state] * e  # the row of right at the parent state
    # The 20 x 20 contraction is a batched matmul in IEEE fp32: TF32 off.
    with tf32_products(False):
        return torch.matmul(a.unsqueeze(-2), leftc).squeeze(-2)


def gumbel_argmax(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of ``logits`` (log-weights on the last
    axis, unnormalised): the argmax of ``logits + g``, ``g = -log(-log U)``."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min_(torch.finfo(torch.float32).tiny)  # torch.rand can return 0
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


class DeviceSimulator:
    """Reusable batched simulator for one (model, mixture) configuration on
    one device (``None``: ``cuda``, which raises without a card).

    Holds the float32 eigensystem stacks on the device.
    """

    def __init__(self, cfg: MsaSimConfig, device: Union[str, torch.device, None] = None):
        if cfg.indels:
            raise ValueError("indels are CPU-only; use the 'native' engine")
        self.device = resolve_device(device)
        self.cfg = cfg
        model = get_model(cfg.substitution)
        mixture = load_mdef_nexus(cfg.mdef) if cfg.mdef else None
        models = mixture.class_models(model) if mixture else [model]
        eig = [m.eigensystem() for m in models]
        self.lam, self.left, self.right = (
            torch.as_tensor(np.stack([e[i] for e in eig]), dtype=torch.float32,
                            device=self.device) for i in range(3))
        self.class_weights = (
            np.asarray(mixture.weights) if mixture else np.ones(1)
        )
        self.class_freqs = np.stack([m.freqs for m in models])
        self.class_rate = (
            np.asarray(mixture.class_rates()) if mixture else np.ones(1)
        )

    # -- device steps ---------------------------------------------------------
    def _evolve(self, packed: _PackedTrees, rates: np.ndarray, cls: np.ndarray,
                roots: np.ndarray, seed: int) -> np.ndarray:
        """The leaves' states ``(K, n_max, L)`` after one step per preorder
        node, as a host array."""
        dev = self.device
        K, N = packed.parent.shape
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        parent = torch.as_tensor(packed.parent, dtype=torch.int64, device=dev)
        blen = torch.as_tensor(packed.blen, device=dev)
        rates_d = torch.as_tensor(rates, device=dev)
        cls_d = torch.as_tensor(cls, dtype=torch.int64, device=dev)
        # the per-site class stacks, gathered once a batch
        lamc, leftc = self.lam[cls_d], self.left[cls_d]
        states = torch.zeros((K, N, rates.shape[1]), dtype=torch.int32, device=dev)
        states[:, 0] = torch.as_tensor(roots, device=dev)
        batch = torch.arange(K, device=dev)
        for i in range(1, N):
            p_state = states[batch, parent[:, i]].long()
            w = step_weights(lamc, leftc, self.right, cls_d, p_state,
                             blen[:, i, None] * rates_d)
            states[:, i] = gumbel_argmax(torch.log(w.clamp_min(1e-30)), gen).int()
        leaves = torch.as_tensor(packed.leaf_node, dtype=torch.int64, device=dev)
        return states[batch[:, None], leaves].cpu().numpy()

    # -- host orchestration ---------------------------------------------------
    def _host_draws(self, K: int, rng: np.random.Generator,
                    alpha_prior: Optional[QuantileSampler]):
        """Per-alignment site rates (incl. class-rate multiplier), classes,
        root states — same conventions as the CPU evolver."""
        L = self.cfg.length
        nclass = len(self.class_weights)
        rates = np.empty((K, L), dtype=np.float32)
        cls = np.empty((K, L), dtype=np.int32)
        roots = np.empty((K, L), dtype=np.int32)
        for k in range(K):
            rate_vec, _ = _gamma_rate_sampler(self.cfg, rng, alpha_prior)
            if nclass == 1:
                c = np.zeros(L, dtype=np.int64)
                roots[k] = rng.choice(20, size=L, p=self.class_freqs[0])
            else:
                c = rng.choice(nclass, size=L, p=self.class_weights)
                r = np.empty(L, dtype=np.int64)
                for ci in range(nclass):
                    m = c == ci
                    if m.any():
                        r[m] = rng.choice(
                            20, size=int(m.sum()), p=self.class_freqs[ci]
                        )
                roots[k] = r
            cls[k] = c
            rates[k] = rate_vec(L) * self.class_rate[c]
        return rates, cls, roots

    def simulate(
        self,
        trees: Sequence[Node],
        rng: np.random.Generator,
        alpha_prior: Optional[QuantileSampler] = None,
        seed: Optional[int] = None,
        pad_nodes: int = 0,
    ) -> List[Alignment]:
        """One simulation attempt per tree (duplicates possible; see
        :func:`simulate_msas_device` for the rejection loop)."""
        K = len(trees)
        packed = _pack_trees(trees, pad_nodes)
        rates, cls, roots = self._host_draws(K, rng, alpha_prior)
        seed = int(rng.integers(2**63 - 1)) if seed is None else seed
        leaves = self._evolve(packed, rates, cls, roots, seed)

        out = []
        for k in range(K):
            nl = packed.n_leaves[k]
            out.append(Alignment(codes=leaves[k, :nl].astype(np.int8),
                                 ids=packed.names[k]))
        return out


def simulate_msas_device(
    trees: Sequence[Node],
    cfg: MsaSimConfig,
    rng: Optional[np.random.Generator] = None,
    alpha_prior: Optional[QuantileSampler] = None,
    batch_size: int = 64,
    device: Union[str, torch.device, None] = None,
) -> Tuple[List[Optional[Alignment]], List[int]]:
    """Simulate one alignment per tree with duplicate rejection, on
    ``device`` (``None``: ``cuda``).

    Returns ``(alignments, attempts)`` in tree order; a ``None`` alignment
    marks a tree whose ``cfg.max_attempts`` simulations all contained
    duplicate sequences (reference retry semantics, ``alisim.py:29-35``).
    Trees run in device batches of a fixed size with a fixed node padding
    (partial/retry batches are padded by repetition), so every batch of the
    call, retries included, has one shape.
    """
    rng = rng if rng is not None else np.random.default_rng()
    sim = DeviceSimulator(cfg, device)
    results: List[Optional[Alignment]] = [None] * len(trees)
    attempts = [0] * len(trees)
    K = min(batch_size, len(trees))
    pad_nodes = max(
        sum(1 for _ in t.traverse_preorder()) for t in trees
    )

    pending = list(range(len(trees)))
    for _ in range(cfg.max_attempts):
        if not pending:
            break
        fresh: List[int] = []
        for start in range(0, len(pending), K):
            chunk = pending[start : start + K]
            padded = chunk + [chunk[-1]] * (K - len(chunk))
            alns = sim.simulate(
                [trees[i] for i in padded], rng, alpha_prior, pad_nodes=pad_nodes
            )
            for idx, aln in zip(chunk, alns):
                attempts[idx] += 1
                if not cfg.allow_duplicates:
                    rows = {r.tobytes() for r in aln.codes}
                    if len(rows) != aln.n_seqs:
                        fresh.append(idx)
                        continue
                results[idx] = aln
        pending = fresh
    return results, attempts
