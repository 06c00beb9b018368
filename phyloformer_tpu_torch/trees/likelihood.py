"""Phylogenetic likelihood: Felsenstein pruning under GTR-class AA models.

Phyloformer's benchmark vocabulary includes per-tree log-likelihood ratios
(``likelihoods_lggc.csv`` of its ``make_plots.py``), computed there with
IQ-TREE.  This module computes alignment log-likelihoods natively:
reversible substitution models from :mod:`..sim.models`, optional
discrete-gamma rate mixtures, vectorized over sites x categories (host
NumPy in float64; small trees).

Gaps/unknowns (codes >= 20) are treated as missing data (partial likelihood
1 for every state), the standard convention.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..data.fasta import Alignment
from ..data.newick import Node
from ..sim.models import SubstitutionModel, discrete_gamma_rates, get_model


def _postorder_arrays(root: Node, leaf_index: dict) -> Tuple[List, List]:
    """Flatten the tree into a postorder schedule.

    Returns (schedule, root_children) where schedule entries are
    ``(node_key, [(child_key, branch_len, child_is_leaf, leaf_row)])``.
    """
    schedule = []
    for node in root.traverse_postorder():
        if node.is_leaf:
            continue
        entry = []
        for c in node.children:
            entry.append(
                (
                    id(c),
                    float(c.length or 0.0),
                    c.is_leaf,
                    leaf_index.get(c.name, -1) if c.is_leaf else -1,
                )
            )
        schedule.append((id(node), entry))
    return schedule, id(root)


def _site_category_logliks(
    aln: Alignment,
    tree: Node,
    model: SubstitutionModel,
    rates: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Felsenstein pruning over all rate categories at once.

    Returns ``(site_lik (L, C), log_scale (L,))``: per-site per-category
    likelihoods (to be mixed, selected, or argmax'd by the caller) and the
    shared per-site log rescaling term."""
    lam, left, right = model.eigensystem()
    pi = model.freqs
    n_states = len(pi)
    n_cats = len(rates)

    leaf_index = {name: i for i, name in enumerate(aln.ids)}
    missing = {leaf.name for leaf in tree.leaves()} - set(aln.ids)
    if missing:
        raise ValueError(f"alignment missing taxa: {sorted(missing)[:3]}...")

    codes = aln.codes  # (n, L)
    L = aln.seq_len

    # leaf partials: (L, n_cats, n_states); gaps/X -> all ones
    def leaf_partial(row: int) -> np.ndarray:
        c = codes[row]
        p = np.zeros((L, n_states))
        valid = c < n_states
        p[np.arange(L)[valid], c[valid].astype(int)] = 1.0
        p[~valid] = 1.0
        return np.broadcast_to(p[:, None, :], (L, n_cats, n_states))

    def pmatrix(t: float) -> np.ndarray:
        # (n_cats, n_states, n_states)
        e = np.exp(lam[None, :] * (t * rates)[:, None])  # (C, S)
        return np.clip(np.einsum("ik,ck,kj->cij", right, e, left), 0.0, None)

    schedule, root_key = _postorder_arrays(tree, leaf_index)
    partials = {}
    log_scale = np.zeros((L,))

    for node_key, children in schedule:
        acc = np.ones((L, n_cats, n_states))
        for child_key, blen, is_leaf, leaf_row in children:
            p = leaf_partial(leaf_row) if is_leaf else partials.pop(child_key)
            pm = pmatrix(blen)  # (C, S, S)
            # message: sum_j P(t)[i, j] * p[., c, j]
            acc = acc * np.einsum("cij,lcj->lci", pm, p)
        # rescale per site to avoid underflow
        mx = acc.max(axis=(1, 2))
        mx = np.where(mx > 0, mx, 1.0)
        acc = acc / mx[:, None, None]
        log_scale += np.log(mx)
        partials[node_key] = acc

    root_p = partials[root_key]  # (L, C, S)
    site_lik = np.einsum("lcs,s->lc", root_p, pi)
    return site_lik, log_scale


def log_likelihood(
    aln: Alignment,
    tree: Node,
    model: Optional[SubstitutionModel] = None,
    gamma_alpha: Optional[float] = None,
    gamma_categories: int = 4,
    site_categories: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> float:
    """Total alignment log-likelihood under ``model``.

    Rate heterogeneity, one of:
    - ``gamma_alpha``: discrete-gamma mixture (mean over categories);
    - ``site_categories = (rates (C,), cat_of_site (L,) int)``: CAT-style
      per-site rate assignment (FastTree 2's -cat semantics): each site is
      scored at exactly its assigned category's rate.
    """
    model = model or get_model("LG")
    if site_categories is not None:
        rates, cat_of_site = site_categories
        site_lik, log_scale = _site_category_logliks(
            aln, tree, model, np.asarray(rates, float))
        chosen = site_lik[np.arange(aln.seq_len), np.asarray(cat_of_site, int)]
        return float(np.sum(np.log(np.maximum(chosen, 1e-300)) + log_scale))
    rates = (
        discrete_gamma_rates(gamma_alpha, gamma_categories)
        if gamma_alpha is not None
        else np.ones(1)
    )
    site_lik, log_scale = _site_category_logliks(aln, tree, model, rates)
    mixed = site_lik.mean(axis=1)  # gamma mixture mean
    return float(np.sum(np.log(np.maximum(mixed, 1e-300)) + log_scale))


def estimate_site_categories(
    aln: Alignment,
    tree: Node,
    model: Optional[SubstitutionModel] = None,
    n_cats: int = 16,
    rate_range: Tuple[float, float] = (1.0 / 16.0, 16.0),
) -> Tuple[np.ndarray, np.ndarray]:
    """CAT-style per-site rate categories (FastTree 2's approximation of
    rate heterogeneity): score every site under a geometric grid of rates on
    the given tree, assign each site its maximum-likelihood category, then
    renormalize the grid so the mean assigned rate is 1 (keeps branch
    lengths on the expected-substitutions scale).

    Returns ``(rates (C,), cat_of_site (L,))`` for
    :func:`log_likelihood`'s ``site_categories``.
    """
    model = model or get_model("LG")
    rates = np.geomspace(rate_range[0], rate_range[1], n_cats)
    site_lik, _ = _site_category_logliks(aln, tree, model, rates)
    cat_of_site = np.argmax(site_lik, axis=1)
    mean_rate = float(np.mean(rates[cat_of_site]))
    if mean_rate > 0:
        rates = rates / mean_rate
    return rates, cat_of_site


def log_likelihood_ratio(
    aln: Alignment,
    tree_a: Node,
    tree_b: Node,
    model: Optional[SubstitutionModel] = None,
    gamma_alpha: Optional[float] = None,
) -> float:
    """ll(tree_a) / ll(tree_b) as a ratio of log-likelihoods (the reference's
    ``ratio`` column semantics: inferred vs true tree)."""
    la = log_likelihood(aln, tree_a, model, gamma_alpha)
    lb = log_likelihood(aln, tree_b, model, gamma_alpha)
    return la / lb if lb != 0 else float("nan")
