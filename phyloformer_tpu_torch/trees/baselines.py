"""Baseline tree-inference methods for benchmark parity.

Phyloformer's benchmark roster (its ``make_plots.py``) includes the
distance/ML baselines IQTree_LG+GC, IQTree_MF, FastTree, FastME, and
Hamming+FastME alongside the PF variants.  Natively provided here:

- **Hamming + FastME**: p-distance (optionally Poisson/JC-corrected) matrix
  from the MSA → our BME+NNI+SPR builder;
- **ML distances + FastME**: pairwise maximum-likelihood distances under
  LG(+Γ) (1-D Brent optimization of the pair likelihood) → BME builder;
- **approximate ML refinement**: likelihood-scored NNI hill climbing with
  per-branch length optimization on a starting tree (FastTree's role);
- **FastTree adapter**: shell-out when a FastTree binary is available
  (found on ``PATH``, or named by the caller).
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..data.alphabet import ALPHABET_SIZE
from ..data.fasta import Alignment, write_fasta
from ..data.newick import Node, parse_newick
from ..sim.models import SubstitutionModel, get_model


def hamming_distance_matrix(aln: Alignment, correction: str = "none") -> np.ndarray:
    """Pairwise p-distances over ungapped site pairs.

    correction: "none" (raw p), "poisson" (-ln(1-p)), "jc" (Jukes-Cantor
    20-state: -19/20 ln(1 - 20p/19)).
    """
    codes = aln.codes
    n = aln.n_seqs
    valid = codes < 20  # residues only
    d = np.zeros((n, n))
    for i in range(n):
        both = valid[i] & valid
        diff = (codes[i][None, :] != codes) & both
        counts = both.sum(axis=1)
        p = np.where(counts > 0, diff.sum(axis=1) / np.maximum(counts, 1), 0.0)
        d[i] = p
    np.fill_diagonal(d, 0.0)
    if correction == "poisson":
        d = -np.log(np.clip(1.0 - d, 1e-9, 1.0))
    elif correction == "jc":
        d = -(19.0 / 20.0) * np.log(np.clip(1.0 - 20.0 * d / 19.0, 1e-9, 1.0))
    return d


def ml_pairwise_distances(
    aln: Alignment,
    model: Optional[SubstitutionModel] = None,
    max_t: float = 15.0,
) -> np.ndarray:
    """Pairwise ML distances under a reversible model (per-pair 1-D
    optimization of Σ_sites log(pi_a P_t[a,b]) via golden-section)."""
    model = model or get_model("LG")
    lam, left, right = model.eigensystem()
    logpi = np.log(model.freqs)
    codes = aln.codes
    n = aln.n_seqs

    def neg_ll(t: float, pairs_a, pairs_b):
        e = np.exp(lam * t)
        p = np.clip((right * e[None, :]) @ left, 1e-12, None)
        return -np.sum(np.log(p[pairs_a, pairs_b]) + logpi[pairs_a])

    d = np.zeros((n, n))
    gr = (np.sqrt(5.0) - 1) / 2
    for i in range(n):
        for j in range(i + 1, n):
            mask = (codes[i] < 20) & (codes[j] < 20)
            a, b = codes[i][mask].astype(int), codes[j][mask].astype(int)
            if len(a) == 0:
                continue
            lo, hi = 1e-4, max_t
            for _ in range(40):  # golden-section search
                m1 = hi - gr * (hi - lo)
                m2 = lo + gr * (hi - lo)
                if neg_ll(m1, a, b) < neg_ll(m2, a, b):
                    hi = m2
                else:
                    lo = m1
            d[i, j] = d[j, i] = 0.5 * (lo + hi)
    return d


def hamming_fastme_tree(aln: Alignment, correction: str = "poisson") -> str:
    """The reference's Hamming+FastME baseline on our native builder."""
    from .native import build_tree

    return build_tree(hamming_distance_matrix(aln, correction), aln.ids)


def ml_fastme_tree(aln: Alignment, model: str = "LG") -> str:
    from .native import build_tree

    return build_tree(ml_pairwise_distances(aln, get_model(model)), aln.ids)


# ---------------------------------------------------------------------------
# Approximate ML refinement (FastTree-role)
# ---------------------------------------------------------------------------

def optimize_branch_lengths(
    aln: Alignment,
    tree: Node,
    model: Optional[SubstitutionModel] = None,
    gamma_alpha: Optional[float] = None,
    rounds: int = 2,
    max_t: float = 10.0,
) -> float:
    """Per-branch golden-section likelihood optimization, in place.

    Returns the final log-likelihood.  O(branches x evals x pruning); fine
    for benchmark-scale trees.
    """
    from .likelihood import log_likelihood

    model = model or get_model("LG")
    branches = [node for node in tree.traverse_preorder() if node.parent is not None]
    gr = (np.sqrt(5.0) - 1) / 2
    ll = log_likelihood(aln, tree, model, gamma_alpha)
    for _ in range(rounds):
        for node in branches:
            def score(t):
                node.length = t
                return log_likelihood(aln, tree, model, gamma_alpha)

            lo, hi = 1e-6, max_t
            for _ in range(12):
                m1 = hi - gr * (hi - lo)
                m2 = lo + gr * (hi - lo)
                if score(m1) > score(m2):
                    hi = m2
                else:
                    lo = m1
            node.length = 0.5 * (lo + hi)
        ll = log_likelihood(aln, tree, model, gamma_alpha)
    return ll


def ml_nni_refine(
    aln: Alignment,
    start_nwk: str,
    model: str = "LG",
    gamma_alpha: Optional[float] = None,
    max_sweeps: int = 3,
    optimize_lengths: bool = True,
) -> Tuple[str, float]:
    """Likelihood-scored NNI hill climbing (compat wrapper over
    :func:`ml_refine` with SPR and CAT off)."""
    return ml_refine(
        aln, start_nwk, model=model, gamma_alpha=gamma_alpha,
        max_sweeps=max_sweeps, optimize_lengths=optimize_lengths,
        spr=False, cat_categories=0,
    )


def ml_refine(
    aln: Alignment,
    start_nwk: str,
    model: str = "LG",
    gamma_alpha: Optional[float] = None,
    max_sweeps: int = 3,
    optimize_lengths: bool = True,
    spr: bool = True,
    spr_radius: int = 3,
    cat_categories: int = 0,
    engine: str = "fast",
) -> Tuple[str, float]:
    """FastTree-class approximate-ML refinement: likelihood-scored NNI +
    radius-limited SPR hill climbing, optionally under CAT-style per-site
    rate categories (FastTree 2.1's two ingredients beyond plain NNI —
    Phyloformer's paper benchmarks against FastTree 2.1.11).

    - ``spr``: after each NNI pass, try pruning every subtree and
      regrafting within ``spr_radius`` edges of its original position,
      scoring each candidate's likelihood at current branch lengths.
    - ``cat_categories > 0``: estimate per-site rate categories on the
      current tree each sweep (:func:`..likelihood.estimate_site_categories`)
      and score all candidates under them (mutually exclusive with
      ``gamma_alpha``).
    - ``engine``: "fast" (default) uses the directional-partial engine
      (:mod:`.ml_fast` — O(L·S²) per NNI edge, radius-walk SPR, eigenspace
      branch lengths; what makes 100-tip grid columns feasible); "slow"
      keeps the first-generation full-rescoring hill climb (also the
      fallback for ``gamma_alpha`` mixtures, which the fast engine does
      not carry).  ``PFML_SLOW=1`` forces "slow" globally (regression
      escape hatch).

    Returns (newick, log_likelihood).
    """
    import os as _os

    if (engine == "fast" and gamma_alpha is None
            and _os.environ.get("PFML_SLOW") != "1"):
        from .ml_fast import ml_refine_fast

        return ml_refine_fast(
            aln, start_nwk, model=model, cat_categories=cat_categories,
            max_sweeps=max_sweeps, spr=spr, spr_radius=spr_radius,
            optimize_lengths=optimize_lengths,
        )

    from .likelihood import estimate_site_categories, log_likelihood

    m = get_model(model)
    best_tree = parse_newick(start_nwk)

    site_cats = None

    def score(tree):
        return log_likelihood(aln, tree, m, gamma_alpha,
                              site_categories=site_cats)

    if optimize_lengths:
        best_ll = optimize_branch_lengths(aln, best_tree, m, gamma_alpha, rounds=1)
    if cat_categories:
        site_cats = estimate_site_categories(aln, best_tree, m,
                                             n_cats=cat_categories)
    best_ll = score(best_tree)

    import itertools

    def neighbors(tree):
        # NNI first so the SPR-enabled search follows the identical NNI
        # trajectory before reaching for long-range moves (guarantees
        # final ll >= the NNI-only run's)
        its = [_nni_neighbors(tree)]
        if spr:
            its.append(_spr_neighbors(tree, spr_radius))
        return itertools.chain(*its)

    for _ in range(max_sweeps):
        improved = False
        # first-improvement hill climb, re-enumerating from the CURRENT
        # tree after every accepted move (a stale generator walks
        # neighbors of an outdated topology)
        for _move in range(50 * max(len(aln.ids), 4)):
            found = None
            for variant in neighbors(best_tree):
                ll = score(variant)
                if ll > best_ll + 1e-9:
                    found = (variant, ll)
                    break
            if found is None:
                break
            best_tree, best_ll = found
            improved = True
        if cat_categories and improved:
            site_cats = estimate_site_categories(aln, best_tree, m,
                                                 n_cats=cat_categories)
            best_ll = score(best_tree)
        if not improved:
            break
    if optimize_lengths:
        optimize_branch_lengths(aln, best_tree, m, gamma_alpha, rounds=1)
        best_ll = score(best_tree)
    return best_tree.to_newick(), best_ll


def _nni_neighbors(root: Node):
    """Yield copies of the tree with one NNI applied (both swaps per internal
    edge of the child-list representation)."""
    import copy

    nodes = [n for n in root.traverse_preorder()]
    for idx, node in enumerate(nodes):
        if node.parent is None or node.is_leaf or node.parent.parent is None and len(node.parent.children) < 3:
            pass
        if node.parent is None or node.is_leaf:
            continue
        parent = node.parent
        siblings = [c for c in parent.children if c is not node]
        if not siblings or len(node.children) < 2:
            continue
        sib = siblings[0]
        for child_i in range(len(node.children)):
            clone_root = copy.deepcopy(root)
            clone_nodes = [n for n in clone_root.traverse_preorder()]
            cnode = clone_nodes[idx]
            cparent = cnode.parent
            csib = [c for c in cparent.children if c is not cnode][0]
            cchild = cnode.children[child_i]
            # swap csib <-> cchild
            cparent.children[cparent.children.index(csib)] = cchild
            cnode.children[child_i] = csib
            cchild.parent, csib.parent = cparent, cnode
            yield clone_root


def _spr_neighbors(root: Node, radius: int = 3):
    """Yield copies of the tree with one subtree pruned and regrafted onto
    an edge within ``radius`` edges of its original attachment (FastTree's
    distance-limited SPR neighborhood)."""
    import copy

    nodes = list(root.traverse_preorder())
    for idx, node in enumerate(nodes):
        parent = node.parent
        if parent is None:
            continue
        in_s = {id(x) for x in node.traverse_preorder()}
        # BFS over the tree graph from the prune point, skipping S's interior
        dist = {id(parent): 0}
        frontier = [parent]
        target_idxs = []
        while frontier:
            nxt = []
            for u in frontier:
                adj = list(u.children)
                if u.parent is not None:
                    adj.append(u.parent)
                for v in adj:
                    if id(v) in in_s or id(v) in dist:
                        continue
                    dist[id(v)] = dist[id(u)] + 1
                    if dist[id(v)] <= radius:
                        nxt.append(v)
                        # regrafting onto a sibling's edge after the prune
                        # splice recreates the original topology — skip
                        if v.parent is not None and v.parent is not parent:
                            target_idxs.append(nodes.index(v))
                        elif v.parent is parent and len(parent.children) > 2:
                            target_idxs.append(nodes.index(v))
            frontier = nxt
        for tgt_idx in target_idxs:
            clone = copy.deepcopy(root)
            cn = list(clone.traverse_preorder())
            new_root = _apply_spr(clone, cn[idx], cn[tgt_idx])
            if new_root is not None:
                yield new_root


def _apply_spr(root: Node, s: Node, tgt: Node) -> Optional[Node]:
    """Prune subtree ``s``, regraft onto the edge above ``tgt``.  Returns
    the (possibly re-rooted) tree, or None when the move is degenerate."""
    p = s.parent
    if p is None or tgt is s or tgt.parent is None:
        return None
    p.children.remove(s)
    s.parent = None
    if len(p.children) == 1:
        c = p.children[0]
        if p.parent is not None:  # splice the degree-2 node away
            if c.length is not None or p.length is not None:
                c.length = (c.length or 0.0) + (p.length or 0.0)
            p.parent.children[p.parent.children.index(p)] = c
            c.parent = p.parent
        else:  # p was the root: re-root at the surviving child
            c.parent = None
            c.length = None
            root = c
        if tgt is p:  # the target edge vanished with the splice
            return None
    if tgt.parent is None:  # target became the root (re-root case)
        return None
    # split the target edge, attach s
    half = (tgt.length or 0.0) / 2
    mid = Node("", half)
    tp = tgt.parent
    tp.children[tp.children.index(tgt)] = mid
    mid.parent = tp
    tgt.length = half
    mid.add_child(tgt)
    mid.add_child(s)
    return root


def fasttree_adapter(
    aln: Alignment,
    binary: Optional[str] = None,
    model_flag: str = "-lg",
) -> str:
    """Run an external FastTree: ``binary``, else ``FastTree`` or
    ``fasttree`` on ``PATH``; raises FileNotFoundError when there is none."""
    candidates = [binary] if binary else ["FastTree", "fasttree"]
    exe = next((c for c in candidates if c and (shutil.which(c) or Path(c).exists())), None)
    if exe is None:
        raise FileNotFoundError("no FastTree binary found")
    with tempfile.TemporaryDirectory() as td:
        fa = Path(td) / "aln.fa"
        write_fasta(fa, aln)
        proc = subprocess.run(
            [exe, model_flag, str(fa)], capture_output=True, text=True, timeout=600
        )
        if proc.returncode != 0:
            raise RuntimeError(f"FastTree failed: {proc.stderr[-500:]}")
        return proc.stdout.strip()
