"""Phylogeny simulator: training/eval tree generation.

Re-implements the reference's `simulate_trees.py` without dendropy/ete3:

- **birth-death** topologies (birth 1.0, death 0.5, conditioned on the number
  of extant tips — reference ``:79-81``) or **uniform** random topologies
  (ete3 ``populate`` equivalent: random binary topology, unit branches,
  reference ``:174-178``);
- per-branch compound-Poisson **rate heterogeneity**: two competing
  exponential clocks (small: scale 0.03, lognormal sigma 0.1; big: scale 1.0,
  sigma 0.2) modulate a heritable rate along each branch; branch length is
  re-integrated over the rate path (``scaleBranch``, reference ``:22-26``,
  process ``:86-155``, constants ``:218-222``);
- whole-tree **rescale to an empirical diameter** drawn from the
  hogenom/raxml priors (``rescale_tree``/``sample_scale``, ``:29-59``);
- leaf branches **clamped** ≥ 0.001 by redrawing Normal(0.001, 0.005)
  (reference ``:164-170``);
- output naming ``{i}_{ntips}_tips.nwk`` (``:77``).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..data.newick import Node, tree_diameter
from .priors import QuantileSampler, diameter_sampler


@dataclasses.dataclass
class TreeSimConfig:
    ntips: int = 20
    tree_type: str = "birth-death"  # or "uniform"
    birth_rate: float = 1.0
    death_rate: float = 0.5
    # compound-Poisson rate-heterogeneity constants (reference :218-222)
    rate_small: float = 0.03
    multiplier_small: float = 0.1
    rate_big: float = 1.0
    multiplier_big: float = 0.2
    min_branch: float = 0.001
    use_bl: bool = False  # reference hard-codes False (:217)
    heterogeneity: bool = True


def birth_death_topology(
    rng: np.random.Generator, ntips: int, birth: float, death: float
) -> Node:
    """Forward-time birth-death simulation conditioned on reaching ``ntips``
    extant lineages (restarting on extinction), extinct lineages pruned."""
    while True:
        root = Node("")
        # each extant lineage: (node, birth_time)
        t = 0.0
        extant = [(root, 0.0)]
        ok = True
        while len(extant) < ntips:
            k = len(extant)
            if k == 0:
                ok = False
                break
            total = k * (birth + death)
            t += rng.exponential(1.0 / total)
            idx = rng.integers(k)
            node, t0 = extant.pop(idx)
            node.length = t - t0
            if rng.uniform() < birth / (birth + death):
                left, right = Node(""), Node("")
                node.add_child(left)
                node.add_child(right)
                extant.append((left, t))
                extant.append((right, t))
            # death: simply dropped from extant (will be pruned)
        if not ok:
            continue
        # close extant branches at the stop time
        for node, t0 in extant:
            node.length = t - t0
        # prune dead lineages: keep only ancestors of extant leaves
        alive = {id(n) for n, _ in extant}

        def prune(node: Node) -> Optional[Node]:
            if not node.children:
                return node if id(node) in alive else None
            kept = [c for c in (prune(ch) for ch in node.children) if c is not None]
            if not kept:
                return None
            if len(kept) == 1:
                child = kept[0]
                child.length = (child.length or 0.0) + (node.length or 0.0)
                return child
            node.children = []
            for c in kept:
                node.add_child(c)
            return node

        pruned = prune(root)
        if pruned is None or len(pruned.leaves()) != ntips:
            continue
        pruned.length = None
        leaves = pruned.leaves()
        for i, leaf in enumerate(leaves):
            leaf.name = f"T{i + 1}"
        return pruned


def uniform_topology(rng: np.random.Generator, ntips: int) -> Node:
    """Random binary topology with unit branch lengths (ete3 populate
    equivalent)."""
    nodes: List[Node] = [Node(f"T{i + 1}", 1.0) for i in range(ntips)]
    while len(nodes) > 2:
        i, j = sorted(rng.choice(len(nodes), 2, replace=False))
        parent = Node("", 1.0)
        parent.add_child(nodes[i])
        parent.add_child(nodes[j])
        nodes = [nodes[k] for k in range(len(nodes)) if k not in (i, j)] + [parent]
    root = Node("")
    for n in nodes:
        root.add_child(n)
    return root


def apply_rate_heterogeneity(rng: np.random.Generator, root: Node, cfg: TreeSimConfig):
    """Compound-Poisson heritable rate modulation (reference ``:86-155``)."""
    branches = [n for n in root.traverse_preorder() if n is not root]
    if not branches:
        return
    avg = float(np.mean([n.length or 0.0 for n in branches]))
    if avg <= 0:
        return
    rate_at: dict = {id(root): 1.0}
    for n in root.traverse_preorder():
        if n is root:
            continue
        bl = n.length or 0.0
        if cfg.use_bl:
            d, norm = bl, 1.0
        else:
            d, norm = avg, bl / avg
        times = [0.0]
        rates = [rate_at[id(n.parent)]]
        latest = 0.0
        event_time = 0.0
        while event_time < d:
            t_small = rng.exponential(cfg.rate_small)
            t_big = rng.exponential(cfg.rate_big)
            if t_small < t_big:
                event_time = latest + t_small
                mult = rng.lognormal(0.0, cfg.multiplier_small)
            else:
                event_time = latest + t_big
                mult = rng.lognormal(0.0, cfg.multiplier_big)
            if event_time < d:
                times.append(event_time * norm)
                rates.append(rates[-1] * mult)
            latest = event_time
        times.append(d * norm)
        # re-integrate branch length over the piecewise-constant rate path
        new_len = 0.0
        for i in range(1, len(times)):
            new_len += rates[i - 1] * (times[i] - times[i - 1])
        n.length = new_len
        rate_at[id(n)] = rates[-1]


def rescale_to_diameter(root: Node, target: float):
    diam = tree_diameter(root)
    if diam <= 0:
        return
    f = target / diam
    for n in root.traverse_preorder():
        if n is not root and n.length is not None:
            n.length *= f


def clamp_leaf_branches(rng: np.random.Generator, root: Node, minimum: float):
    for leaf in root.leaves():
        if (leaf.length or 0.0) < minimum:
            v = leaf.length or 0.0
            while v < minimum:
                v = float(rng.normal(minimum, 0.005))
            leaf.length = v


def simulate_tree(
    rng: np.random.Generator,
    cfg: TreeSimConfig,
    diam_prior: Optional[QuantileSampler] = None,
) -> Node:
    diam_prior = diam_prior or diameter_sampler()
    mean = float(diam_prior.sample(rng))
    scale = max(float(rng.normal(mean, mean / 10.0)), 0.02)  # sample_scale :53-59

    if cfg.tree_type == "birth-death":
        root = birth_death_topology(rng, cfg.ntips, cfg.birth_rate, cfg.death_rate)
        if cfg.heterogeneity:
            apply_rate_heterogeneity(rng, root, cfg)
    elif cfg.tree_type == "uniform":
        root = uniform_topology(rng, cfg.ntips)
    else:
        raise ValueError("tree_type must be birth-death or uniform")

    rescale_to_diameter(root, scale)
    if cfg.tree_type == "birth-death":
        clamp_leaf_branches(rng, root, cfg.min_branch)
    return root


def simulate_trees(
    outdir,
    ntrees: int = 50,
    cfg: Optional[TreeSimConfig] = None,
    seed: Optional[int] = None,
    diam_files: Optional[List[str]] = None,
) -> List[Path]:
    cfg = cfg or TreeSimConfig()
    rng = np.random.default_rng(seed)
    prior = diameter_sampler(diam_files)
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(ntrees):
        tree = simulate_tree(rng, cfg, prior)
        p = out / f"{i}_{cfg.ntips}_tips.nwk"  # reference naming (:77)
        p.write_text(tree.to_newick() + "\n")
        paths.append(p)
    return paths
