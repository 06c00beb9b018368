"""FastTree-class approximate-ML engine: edge-partial NNI/SPR + Newton
branch lengths.

The first-generation :func:`..baselines.ml_refine` re-ran a full
Felsenstein pruning for every candidate rearrangement — O(n·L·S²) per
candidate, which capped it at ~20 tips in the real benchmark grid.  This
module keeps *directional* partials the way FastTree 2 does
(Phyloformer's paper benchmarks against FastTree 2.1.11):

- one post-order pass gives ``U[v]`` (data below v, given state at v) and
  per-edge messages ``M[v] = P(t_v) @ U[v]``;
- one pre-order pass gives ``W[v]`` (data outside v's subtree, given state
  at v, with the stationary prior folded in);
- any edge then scores the whole tree as ``Σ_s W[v]·U[v]`` per site, and
  every NNI candidate at an internal edge is three cheap recombinations of
  already-computed messages — O(L·S²) per edge instead of per candidate
  per full pruning;
- branch lengths optimize per-edge in eigenspace: with
  ``P(t) = R e^{Λt} Lᵀ`` the per-site edge likelihood is
  ``f_l(t) = Σ_s a_{l,s} e^{λ_s t}`` whose coefficients are computed once,
  making each 1-D likelihood evaluation O(L·S);
- radius-limited SPR recomputes only the O(radius) messages along the walk
  from the pruning site (the pruned subtree's message is reusable
  unchanged), scoring each regraft in two einsums.

Rate heterogeneity is CAT-style per-site rates (FastTree's -cat): in
eigenspace a per-site rate is one elementwise ``exp(λ_s · t · r_l)``
factor, so CAT costs the same as a single category.

Everything is float64 NumPy on flattened arrays; trees stay
:class:`..data.newick.Node` between sweeps.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..data.fasta import Alignment
from ..data.newick import Node, parse_newick
from ..sim.models import SubstitutionModel, get_model

_TINY = 1e-300


def _unroot(root: Node) -> Node:
    """Collapse a binary root (rooted representation) into the unrooted
    convention (trifurcating root), merging the two root-edge lengths."""
    while len(root.children) == 2 and any(not c.is_leaf for c in root.children):
        a, b = root.children
        keep, move = (a, b) if not a.is_leaf else (b, a)
        # reattach `move` under `keep` with the summed edge length
        move.length = (move.length or 0.0) + (keep.length or 0.0)
        keep.children.append(move)
        move.parent = keep
        keep.length = None
        keep.parent = None
        root = keep
    return root


class EdgeEngine:
    """Directional-partial likelihood engine for one alignment + model.

    Site rates ``r_l`` (CAT) default to 1.  All partials carry per-site
    log-scaling; the scales cancel inside a candidate comparison at one
    edge and are added back for absolute log-likelihoods.
    """

    def __init__(self, aln: Alignment, model: SubstitutionModel,
                 site_rates: Optional[np.ndarray] = None):
        self.aln = aln
        self.model = model
        lam, left, right = model.eigensystem()
        # P(t) = right @ diag(e^{lam t}) @ left
        self.lam = np.asarray(lam, float)          # (S,)
        self.left = np.asarray(left, float)        # (S, S)
        self.right = np.asarray(right, float)      # (S, S)
        self.pi = np.asarray(model.freqs, float)   # (S,)
        self.S = len(self.pi)
        self.L = aln.seq_len
        self.rates = (np.ones(self.L) if site_rates is None
                      else np.asarray(site_rates, float))
        self.leaf_index = {name: i for i, name in enumerate(aln.ids)}
        codes = aln.codes
        lp = np.zeros((aln.n_seqs, self.L, self.S))
        valid = codes < self.S
        rows, cols = np.nonzero(valid)
        lp[rows, cols, codes[valid].astype(int)] = 1.0
        lp[~valid] = 1.0  # gaps / unknowns: missing data
        self.leaf_partials = lp

    # -- flattened tree state ---------------------------------------------
    def set_tree(self, root: Node) -> None:
        self.root = root
        nodes = list(root.traverse_postorder())
        self.nodes = nodes
        self.idx = {id(n): i for i, n in enumerate(nodes)}
        n = len(nodes)
        self.parent = np.full(n, -1, int)
        self.t = np.zeros(n)
        for i, nd in enumerate(nodes):
            if nd.parent is not None:
                self.parent[i] = self.idx[id(nd.parent)]
                self.t[i] = float(nd.length or 0.0)
        self._up_pass()
        self._down_pass()

    def _pt_exp(self, t: float) -> np.ndarray:
        """e^{λ_s · t · r_l}: (L, S).  Broadcast, not np.outer — this runs
        tens of thousands of times per refine and outer's ravel/reshape
        overhead measured ~15% of the whole wall clock at 100 tips."""
        return np.exp(self.rates[:, None] * (t * self.lam)[None, :])

    def t_rates(self, t: float) -> np.ndarray:
        return t * self.rates

    def _message(self, U: np.ndarray, t: float) -> np.ndarray:
        """M_i = Σ_j P(t·r_l)[i,j] U_j  per site: (L,S) -> (L,S)."""
        y = U @ self.left.T            # (L, S) in eigenbasis
        return (self._pt_exp(t) * y) @ self.right.T

    def _up_pass(self) -> None:
        n = len(self.nodes)
        self.U = np.empty((n, self.L, self.S))
        self.sU = np.zeros((n, self.L))       # per-site log scale of U
        self.M = np.empty((n, self.L, self.S))  # message at parent end
        self.sM = np.zeros((n, self.L))
        for i, nd in enumerate(self.nodes):
            if nd.is_leaf:
                row = self.leaf_index.get(nd.name)
                if row is None:
                    raise ValueError(f"alignment missing taxon {nd.name!r}")
                self.U[i] = self.leaf_partials[row]
                self.sU[i] = 0.0
            else:
                acc = np.ones((self.L, self.S))
                sc = np.zeros(self.L)
                for c in nd.children:
                    ci = self.idx[id(c)]
                    acc = acc * self.M[ci]
                    sc = sc + self.sM[ci]
                mx = np.maximum(acc.max(axis=1), _TINY)
                self.U[i] = acc / mx[:, None]
                self.sU[i] = sc + np.log(mx)
            if self.parent[i] >= 0:
                self.M[i] = np.clip(self._message(self.U[i], self.t[i]),
                                    0.0, None)
                self.sM[i] = self.sU[i]

    def _down_pass(self) -> None:
        n = len(self.nodes)
        self.W = np.empty((n, self.L, self.S))   # rest partial AT node i
        self.sW = np.zeros((n, self.L))
        self.A = np.empty((n, self.L, self.S))   # rest at TOP of i's edge
        self.sA = np.zeros((n, self.L))          # (pre-transport)
        order = list(reversed(range(n)))  # root first (postorder reversed)
        ri = self.idx[id(self.root)]
        for i in order:
            nd = self.nodes[i]
            if self.parent[i] < 0:
                continue
            p = self.parent[i]
            if p == ri:
                rest = np.broadcast_to(self.pi, (self.L, self.S)).copy()
                sc = np.zeros(self.L)
            else:
                rest = self.W[p].copy()
                sc = self.sW[p].copy()
            for s in self.nodes[p].children:
                si = self.idx[id(s)]
                if si == i:
                    continue
                rest = rest * self.M[si]
                sc = sc + self.sM[si]
            self.A[i] = rest
            self.sA[i] = sc
            # transport through edge (p -> i): W_j = Σ_i rest_i P[i,j]
            y = rest @ self.right                # eigenbasis (L, S)
            w = (self._pt_exp(self.t[i]) * y) @ self.left
            w = np.clip(w, 0.0, None)
            mx = np.maximum(w.max(axis=1), _TINY)
            self.W[i] = w / mx[:, None]
            self.sW[i] = sc + np.log(mx)

    # -- scoring -----------------------------------------------------------
    def log_likelihood(self) -> float:
        ri = self.idx[id(self.root)]
        site = np.einsum("ls,s->l", self.U[ri], self.pi)
        return float(np.sum(np.log(np.maximum(site, _TINY)) + self.sU[ri]))

    def edge_log_likelihood(self, i: int) -> float:
        """Whole-tree ll evaluated at the edge above node i (sanity)."""
        site = np.einsum("ls,ls->l", self.W[i], self.U[i])
        return float(np.sum(np.log(np.maximum(site, _TINY))
                            + self.sU[i] + self.sW[i]))

    # -- NNI ----------------------------------------------------------------
    def nni_gains(self) -> List[Tuple[float, int, int]]:
        """Score both NNI alternatives at every internal edge.

        Returns [(gain_in_ll, node_index_v, alt)] for gains > 0, where the
        edge is (parent(v), v), v internal with exactly 2 children, and
        ``alt`` 0 swaps the sibling with v's first child, 1 with the
        second.  Scores share U/W scales per edge, so gains are exact ll
        differences."""
        out = []
        ri = self.idx[id(self.root)]
        for i, nd in enumerate(self.nodes):
            p = self.parent[i]
            if p < 0 or nd.is_leaf or len(nd.children) != 2:
                continue
            pn = self.nodes[p]
            # sibling component at p (exactly one for binary-internal p;
            # at a trifurcating root every co-child is a separate
            # candidate — use each in turn)
            sibs = [self.idx[id(s)] for s in pn.children if id(s) != id(nd)]
            if p == ri:
                base_rest = np.broadcast_to(self.pi, (self.L, self.S))
                base_sc = np.zeros(self.L)
            else:
                base_rest = self.W[p]
                base_sc = self.sW[p]
            ci, di = (self.idx[id(nd.children[0])],
                      self.idx[id(nd.children[1])])
            for k, bi in enumerate(sibs):
                rest = base_rest
                for other in sibs:
                    if other != bi:
                        rest = rest * self.M[other]
                # current: rest · M[B] · P(t_v) @ (M[C] ⊙ M[D])
                cur = self._edge_site_ll(rest * self.M[bi],
                                         self.M[ci] * self.M[di], self.t[i])
                alt1 = self._edge_site_ll(rest * self.M[ci],
                                          self.M[bi] * self.M[di], self.t[i])
                alt2 = self._edge_site_ll(rest * self.M[di],
                                          self.M[ci] * self.M[bi], self.t[i])
                if alt1 - cur > 1e-9:
                    out.append((alt1 - cur, i, 2 * k + 0))
                if alt2 - cur > 1e-9:
                    out.append((alt2 - cur, i, 2 * k + 1))
        return out

    def _edge_site_ll(self, above: np.ndarray, below_prod: np.ndarray,
                      t: float) -> float:
        """Σ_l log( above_l · P(t r_l) @ below_l ) without scale terms
        (caller compares candidates sharing identical scales)."""
        msg = self._message(below_prod, t)
        site = np.einsum("ls,ls->l", above, np.clip(msg, 0.0, None))
        return float(np.sum(np.log(np.maximum(site, _TINY))))

    def apply_nni(self, i: int, alt: int) -> None:
        """Apply the NNI chosen by :meth:`nni_gains` to the Node tree."""
        nd = self.nodes[i]
        pn = self.nodes[self.parent[i]]
        sibs = [s for s in pn.children if id(s) != id(nd)]
        b = sibs[alt // 2]
        c = nd.children[alt % 2]
        # swap b (child of p) with c (child of nd); branch lengths travel
        # with their subtrees (standard NNI at fixed lengths)
        bi_pos = pn.children.index(b)
        ci_pos = nd.children.index(c)
        pn.children[bi_pos], nd.children[ci_pos] = c, b
        b.parent, c.parent = nd, pn

    # -- SPR ----------------------------------------------------------------
    def spr_candidates(self, radius: int = 5):
        """Radius-limited SPR: for every prunable subtree S (node with a
        parent of degree 3 in the unrooted sense), walk edges within
        ``radius`` of the attachment, recomputing only the walked messages
        with S removed; score each regraft at half-split target lengths.

        Returns [(gain, prune_idx, target_idx)] with gain vs the current
        tree's ll (> 0 only), using exact ll differences (scales cancel
        along the corrected walk because corrections are computed from the
        same scaled inputs)."""
        out = []
        ri = self.idx[id(self.root)]
        for i, nd in enumerate(self.nodes):
            p = self.parent[i]
            if p < 0:
                continue
            pn = self.nodes[p]
            pp = self.parent[p]
            # the pruned tree contracts p; need p internal with exactly 2
            # children and a parent (so two other components join)
            if len(pn.children) != 2 or pp < 0:
                continue
            sib = next(s for s in pn.children if id(s) != id(nd))
            si = self.idx[id(sib)]
            # current ll at the pruning edge (baseline for gains)
            cur = float(np.sum(
                np.log(np.maximum(
                    np.einsum("ls,ls->l", self.W[i], self.U[i]), _TINY))
                + self.sU[i] + self.sW[i]))
            t_joined = self.t[si] + self.t[p]
            # corrected rest-partial at the TOP of the contracted edge
            # (pp <-> sib): it is A[p] — the pre-transport rest above p —
            # unchanged by pruning.  Walk outward in both directions.
            targets = []
            # direction 1: into sib's subtree
            targets += self._walk_down(si, self.A[p], self.sA[p],
                                       t_joined, radius)
            # direction 2: toward pp and beyond: treat edge (pp, p) as
            # carrying M[sib] upward.  Equivalent: prune-side message at
            # pp is M'[p] = P(t_joined) @ U[sib]
            targets += self._walk_up(p, si, t_joined, radius)
            for (ti, above, sc_above, below, sc_below, t_split) in targets:
                if ti == si:
                    # regrafting onto the contracted edge reproduces the
                    # current topology — its "gain" is only the implicit
                    # halving of the split (a branch-length change blopt
                    # makes anyway), so it must not compete with real moves
                    continue
                t1 = 0.5 * t_split
                # regraft S with its original branch length t[i]
                ms = np.clip(self._message(self.U[i], self.t[i]), 0.0, None)
                a = np.clip(self._message_rev(above, t1), 0.0, None)
                bmsg = np.clip(self._message(below, t_split - t1), 0.0, None)
                site = np.einsum("ls,ls->l", a * bmsg, ms)
                ll = float(np.sum(np.log(np.maximum(site, _TINY))
                                  + sc_above + sc_below + self.sU[i]))
                if ll - cur > 1e-9:
                    out.append((ll - cur, i, ti))
        return out

    def _message_rev(self, above: np.ndarray, t: float) -> np.ndarray:
        """Transport a rest-partial DOWN through an edge: Σ_i a_i P[i,j]."""
        y = above @ self.right
        return (self._pt_exp(t) * y) @ self.left

    def _walk_down(self, start: int, above, sc_above, t_start, radius):
        """Walk into subtree(start); candidate = edge above each visited
        node.  ``above`` is the corrected rest partial at the top of
        ``start``'s edge; first candidate is the contracted edge itself."""
        res = [(start, above, sc_above, self.U[start], self.sU[start],
                t_start)]
        # frontier entries carry the length of the edge ABOVE node i (the
        # contracted edge for the first hop, t[i] afterwards)
        frontier = [(start, above, sc_above, t_start, 0)]
        while frontier:
            i, ab, sc, t_edge, depth = frontier.pop()
            if depth >= radius:
                continue
            nd = self.nodes[i]
            if nd.is_leaf:
                continue
            # descend: rest at child c = transport(ab) down i's edge, then
            # multiply the other children's messages
            a_at_i = np.clip(self._message_rev(ab, t_edge), 0.0, None)
            for c in nd.children:
                ci = self.idx[id(c)]
                rest = a_at_i
                scc = sc
                for o in nd.children:
                    oi = self.idx[id(o)]
                    if oi != ci:
                        rest = rest * self.M[oi]
                        scc = scc + self.sM[oi]
                mx = np.maximum(rest.max(axis=1), _TINY)
                rest = rest / mx[:, None]
                scc = scc + np.log(mx)
                res.append((ci, rest, scc, self.U[ci], self.sU[ci],
                            self.t[ci]))
                frontier.append((ci, rest, scc, self.t[ci], depth + 1))
        return res

    def _walk_up(self, p: int, si: int, t_joined: float, radius: int):
        """Walk from the contracted node p upward/outward: candidates are
        edges NOT in subtree(p), with the prune-side message corrected to
        exclude S (subtree message through the joined edge)."""
        res = []
        # corrected message arriving at pp from p's direction
        msg = np.clip(self._message(self.U[si], t_joined), 0.0, None)
        smsg = self.sU[si]
        cur = p
        depth = 0
        ri = self.idx[id(self.root)]
        while depth < radius:
            pp = self.parent[cur]
            if pp < 0:
                break
            ppn = self.nodes[pp]
            # siblings of cur at pp: their edges are candidates (rest =
            # W-side of pp × corrected msg × other siblings)
            if pp == ri:
                above0 = np.broadcast_to(self.pi, (self.L, self.S))
                sc0 = np.zeros(self.L)
            else:
                above0 = self.W[pp]
                sc0 = self.sW[pp]
            sib_ids = [self.idx[id(s)] for s in ppn.children
                       if self.idx[id(s)] != cur]
            for s1 in sib_ids:
                rest = above0 * msg
                sc = sc0 + smsg
                for s2 in sib_ids:
                    if s2 != s1:
                        rest = rest * self.M[s2]
                        sc = sc + self.sM[s2]
                res.append((s1, rest, sc, self.U[s1], self.sU[s1],
                            self.t[s1]))
            # continue upward: propagate the corrected message through pp's
            # edge.  (pp's own parent edge is NOT emitted as a candidate:
            # its above-partial lives at parent(pp) and would need one more
            # W-style reconstruction — the sibling edges at the next level
            # cover the same neighborhood.)
            if self.parent[pp] >= 0:
                below = msg
                sb = smsg
                for s2 in sib_ids:
                    below = below * self.M[s2]
                    sb = sb + self.sM[s2]
                msg = np.clip(self._message(below, self.t[pp]), 0.0, None)
                mx = np.maximum(msg.max(axis=1), _TINY)
                msg = msg / mx[:, None]
                smsg = sb + np.log(mx)
            cur = pp
            depth += 1
        return res

    def neighborhood_ids(self, seeds, radius: int):
        """Node indices within ``radius`` edges of any seed (over the
        parent/child graph).  Used by the batched-apply refine loop to
        detect conflicting moves: two moves whose neighborhoods overlap
        may invalidate each other's cached gains."""
        seen = set(seeds)
        frontier = list(seeds)
        for _ in range(radius):
            nxt = []
            for i in frontier:
                nd = self.nodes[i]
                # .get: mid-batch the tree may hold freshly spliced nodes
                # not in idx (their whole vicinity is already dirty)
                nbrs = [self.idx.get(id(c)) for c in nd.children]
                if self.parent[i] >= 0:
                    nbrs.append(self.parent[i])
                for j in nbrs:
                    if j is not None and j not in seen:
                        seen.add(j)
                        nxt.append(j)
            frontier = nxt
        return seen

    def apply_spr(self, prune_idx: int, target_idx: int) -> Node:
        """Prune subtree at ``prune_idx`` and regraft onto the edge above
        ``target_idx`` (splitting it in half), contracting the old parent.
        Returns the (possibly new) root."""
        nd = self.nodes[prune_idx]
        pn = nd.parent
        sib = next(s for s in pn.children if id(s) != id(nd))
        gp = pn.parent
        # contract pn
        sib.length = (sib.length or 0.0) + (pn.length or 0.0)
        gp.children[gp.children.index(pn)] = sib
        sib.parent = gp
        pn.children = []
        # note: target == sib would regraft onto the contracted edge
        # (topology-identical no-op) — spr_candidates filters it out
        target = self.nodes[target_idx]
        tp = target.parent
        new = Node(name="", length=(target.length or 0.0) * 0.5)
        target.length = (target.length or 0.0) * 0.5
        tp.children[tp.children.index(target)] = new
        new.parent = tp
        new.children = [target, nd]
        target.parent = new
        nd.parent = new
        return self.root

    # -- branch lengths ------------------------------------------------------
    def optimize_lengths(self, rounds: int = 1, max_t: float = 10.0) -> None:
        """Per-edge 1-D optimization in eigenspace.

        Preorder sweep with the rest-partial refreshed immediately before
        each edge: parents are optimized before children (so U below is
        current) and the rest above is rebuilt from the just-updated W of
        the parent and the sibling messages.  Monotone up to stale-sibling
        partials: an earlier-processed sibling's M is rebuilt from its
        round-start U, so after that sibling's *subtree* lengths move,
        later edges at the same parent optimize against slightly stale
        coefficients (the keep-current-length guard evaluates both
        candidates with the same coefficients, so regressions are bounded
        by the staleness, not the search).  A full up/down refresh runs
        between rounds.  (The earlier postorder version used the
        start-of-round W everywhere; those much-staler coefficients made
        whole rounds non-monotone — caught by the round-4 grid probe.)

        Coefficients once per edge (2 einsums), O(L·S) per evaluation.
        Updates Node lengths in place and leaves all partials fresh."""
        gr = (np.sqrt(5.0) - 1) / 2
        ri = self.idx[id(self.root)]
        for _ in range(rounds):
            for i in reversed(range(len(self.nodes))):  # preorder
                nd = self.nodes[i]
                p = self.parent[i]
                if p < 0:
                    continue
                if p == ri:
                    rest = np.broadcast_to(self.pi, (self.L, self.S)).copy()
                    sc = np.zeros(self.L)
                else:
                    rest = self.W[p].copy()
                    sc = self.sW[p].copy()
                for s in self.nodes[p].children:
                    si = self.idx[id(s)]
                    if si != i:
                        rest = rest * self.M[si]
                        sc = sc + self.sM[si]
                mx = np.maximum(rest.max(axis=1), _TINY)
                rest = rest / mx[:, None]
                sc = sc + np.log(mx)
                self.A[i] = rest
                self.sA[i] = sc
                # a_{l,s} = (above R)_s (Lᵀ U)_s ; f_l(t) = Σ_s a e^{λ t r_l}
                a = (rest @ self.right) * (self.U[i] @ self.left.T)

                rates_col = self.rates[:, None]

                def ll(t):
                    site = np.maximum(
                        np.sum(a * np.exp(rates_col * (t * self.lam)[None, :]),
                               axis=1), _TINY)
                    return float(np.sum(np.log(site)))

                # keep the current length when the search can't beat it
                # (golden section assumes unimodality; guard regressions).
                # Standard one-eval-per-iteration reuse: ~26 ll() calls
                # instead of 48 for the same bracket shrinkage.
                t_cur = max(self.t[i], 1e-6)
                lo, hi = 1e-6, max_t
                m1 = hi - gr * (hi - lo)
                m2 = lo + gr * (hi - lo)
                f1, f2 = ll(m1), ll(m2)
                for _ in range(23):
                    if f1 > f2:
                        hi, m2, f2 = m2, m1, f1
                        m1 = hi - gr * (hi - lo)
                        f1 = ll(m1)
                    else:
                        lo, m1, f1 = m1, m2, f2
                        m2 = lo + gr * (hi - lo)
                        f2 = ll(m2)
                t_new = 0.5 * (lo + hi)
                if ll(t_new) < ll(t_cur):
                    t_new = t_cur
                nd.length = t_new
                self.t[i] = t_new
                self.M[i] = np.clip(self._message(self.U[i], t_new), 0.0,
                                    None)
                # refresh W[i] (children read it next): transport the
                # fresh rest through the new length
                y = rest @ self.right
                w = np.clip((self._pt_exp(t_new) * y) @ self.left, 0.0, None)
                mxw = np.maximum(w.max(axis=1), _TINY)
                self.W[i] = w / mxw[:, None]
                self.sW[i] = sc + np.log(mxw)
            # refresh upward partials (U/M unchanged mid-round only for
            # unprocessed children; after the round everything moves)
            self._up_pass()
            self._down_pass()


def ml_refine_fast(
    aln: Alignment,
    start_nwk: str,
    model: str = "LG",
    site_rates: Optional[np.ndarray] = None,
    cat_categories: int = 0,
    max_sweeps: int = 3,
    spr: bool = True,
    spr_radius: int = 5,
    optimize_lengths: bool = True,
    batch_moves: bool = True,
) -> Tuple[str, float]:
    """FastTree-class refinement via :class:`EdgeEngine`.

    Sweeps of candidate scans with batched best-first applies (round 5):
    every positive-gain move whose radius-2 neighborhood doesn't conflict
    with an already-applied move is applied from ONE scan, the tree is
    rebuilt once, and the net ll verified (rollback + single-best retry on
    regression) — this is what turned 100-tip refinement from ~32 s into
    ~4 s (docs/performance.md round 5).  ``batch_moves=False`` restores
    one-move-per-scan steepest ascent (regression escape hatch).  Branch
    lengths re-optimized once per sweep.  With ``cat_categories > 0`` the
    per-site CAT rates are re-estimated each sweep on the current tree
    (FastTree -cat semantics).
    """
    m = get_model(model)
    root = _unroot(parse_newick(start_nwk))
    eng = EdgeEngine(aln, m, site_rates)
    eng.set_tree(root)
    if optimize_lengths:
        eng.optimize_lengths(rounds=1)

    if cat_categories and site_rates is None:
        from .likelihood import estimate_site_categories

        rates, cat_of_site = estimate_site_categories(
            aln, root, m, n_cats=cat_categories)
        eng = EdgeEngine(aln, m, rates[cat_of_site])
        eng.set_tree(root)

    def batch_apply(cands, apply_one, region_of):
        """Best-first batched applies from ONE candidate scan (the same
        batching the native BME toolkit uses for its SPR sweep, round-5):
        moves are applied in descending gain order, skipping any whose
        neighborhood overlaps an already-applied move's, then the tree is
        rebuilt ONCE and the net ll verified.  Gains of non-conflicting
        moves are computed from slightly stale partials (second-order in
        the applied moves' perturbations), so the net check + rollback is
        what guarantees monotonicity; on a failed multi-move batch, the
        single best move (whose gain IS exact) is retried alone.

        Returns True if the tree improved."""
        cands.sort(reverse=True)
        before = eng.log_likelihood()
        snapshot = eng.root.to_newick()
        dirty = set()
        n_applied = 0
        for cand in cands:
            if n_applied and not batch_moves:
                break
            region = region_of(cand)
            if region & dirty:
                continue
            apply_one(cand)
            dirty |= region
            n_applied += 1
        eng.set_tree(eng.root)
        if eng.log_likelihood() > before + 1e-9:
            return True
        # net regression (stale-gain conflict beyond the neighborhood
        # radius): roll back; retry the exact-gain best move alone
        eng.set_tree(_unroot(parse_newick(snapshot)))
        if n_applied <= 1:
            return False  # the exact best move failed = numerical tie
        apply_one(cands[0])
        eng.set_tree(eng.root)
        if eng.log_likelihood() > before + 1e-9:
            return True
        eng.set_tree(_unroot(parse_newick(snapshot)))
        return False

    for _ in range(max_sweeps):
        improved = False
        # NNI to local optimum (batched best-first applies per scan)
        while True:
            gains = eng.nni_gains()
            if not gains:
                break
            if not batch_apply(
                gains,
                lambda c: eng.apply_nni(c[1], c[2]),
                lambda c: eng.neighborhood_ids({c[1], eng.parent[c[1]]}, 2),
            ):
                break
            improved = True
        if spr:
            while True:
                cands = eng.spr_candidates(spr_radius)
                if not cands:
                    break
                if not batch_apply(
                    cands,
                    lambda c: eng.apply_spr(c[1], c[2]),
                    lambda c: eng.neighborhood_ids(
                        {c[1], eng.parent[c[1]], c[2]}, 2),
                ):
                    break
                improved = True
        if optimize_lengths:
            eng.optimize_lengths(rounds=1)
        if not improved:
            break
    return eng.root.to_newick(), eng.log_likelihood()
