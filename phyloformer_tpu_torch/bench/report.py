"""Evaluation report generation — the reference's benchmark CSV vocabulary.

Phyloformer's ``make_plots.py`` consumes result CSVs with these schemas
and draws the paper figures:

- ``topos_*.csv``:   ``marker,id,norm_rf,kf_score,weighted_rf``  (:306-318,1466-1531)
- ``dists_*.csv``:   ``marker,id,ref_dist,cmp_dist``             (:1706-1718)
- ``execution_*.csv``: ``timer,marker,id,elapsed_sec,MaxRSS_kb`` (:166-190)
- ``brlens_*.csv``:  ``marker,id,ref_len,cmp_len``               (:2010-2023)

This module *produces* those CSVs from our own pipeline runs (the reference
only ships the consumer; producers were ad-hoc shell), plus summary stats
(MAE/MRE/MRD on distances, mean topo metrics) and optional matplotlib
figures (matplotlib is imported only when figures are asked for).
"""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..data.newick import parse_newick, patristic_matrix, read_newick
from ..data.pairs import square_to_vector
from ..data.phylip import read_phylip


def _tree_files(directory) -> Dict[str, Path]:
    out = {}
    for p in sorted(Path(directory).glob("*.nwk")):
        stem = p.stem
        for suffix in (".nj", ".bme"):
            if stem.endswith(suffix):
                stem = stem[: -len(suffix)]
        out.setdefault(stem, p)
    return out


def collect_topo_rows(
    ref_tree_dir, cmp_tree_dir, marker: str
) -> List[Dict]:
    """Tree-vs-tree topology metrics (topos_* schema)."""
    from ..trees.native import compare_newick

    refs = _tree_files(ref_tree_dir)
    cmps = _tree_files(cmp_tree_dir)
    rows = []
    for stem, ref_path in refs.items():
        if stem not in cmps:
            continue
        r = compare_newick(ref_path.read_text(), cmps[stem].read_text())
        rows.append(
            {
                "marker": marker,
                "id": stem,
                "norm_rf": r.norm_rf,
                "kf_score": r.kf,
                "weighted_rf": r.weighted_rf,
            }
        )
    return rows


def collect_dist_rows(
    true_tree_dir, matrix_dir, marker: str
) -> List[Dict]:
    """Pairwise-distance comparisons (dists_* schema): every (true patristic,
    predicted) pair across all examples."""
    rows = []
    for phy in sorted(Path(matrix_dir).glob("*.phy")):
        stem = phy.stem
        tree_path = Path(true_tree_dir) / f"{stem}.nwk"
        if not tree_path.exists():
            continue
        mat, ids = read_phylip(phy)
        true_mat, _ = patristic_matrix(read_newick(tree_path), ids)
        ref_vec = square_to_vector(true_mat)
        cmp_vec = square_to_vector(mat)
        for rv, cv in zip(ref_vec, cmp_vec):
            rows.append(
                {"marker": marker, "id": stem, "ref_dist": float(rv), "cmp_dist": float(cv)}
            )
    return rows


def collect_brlen_rows(ref_tree_dir, cmp_tree_dir, marker: str) -> List[Dict]:
    """Matched-bipartition branch lengths (brlens_* schema)."""
    refs = _tree_files(ref_tree_dir)
    cmps = _tree_files(cmp_tree_dir)
    rows = []
    for stem, ref_path in refs.items():
        if stem not in cmps:
            continue
        ref_bl = _bipartition_lengths(ref_path.read_text())
        cmp_bl = _bipartition_lengths(cmps[stem].read_text())
        for key, ref_len in ref_bl.items():
            if key in cmp_bl:
                rows.append(
                    {
                        "marker": marker,
                        "id": stem,
                        "ref_len": ref_len,
                        "cmp_len": cmp_bl[key],
                    }
                )
    return rows


def _bipartition_lengths(nwk: str) -> Dict[frozenset, float]:
    """Internal bipartition -> branch length (python-side, n is small)."""
    root = parse_newick(nwk)
    all_leaves = frozenset(root.leaf_names())
    out: Dict[frozenset, float] = {}

    def below(node) -> frozenset:
        if node.is_leaf:
            return frozenset([node.name])
        leaves = frozenset().union(*[below(c) for c in node.children])
        if node.length is not None and 1 < len(leaves) < len(all_leaves) - 1:
            key = min(leaves, all_leaves - leaves, key=lambda s: (len(s), sorted(s)))
            out[key] = out.get(key, 0.0) + node.length
        return leaves

    below(root)
    return out


def collect_likelihood_rows(
    msa_dir, true_tree_dir, cmp_tree_dir, marker: str,
    model: str = "LG", gamma_alpha: Optional[float] = None,
) -> List[Dict]:
    """Log-likelihood ratios inferred-vs-true (likelihoods_* schema:
    ``marker,id,ratio`` of ``make_plots.py:321-328``), computed
    natively (the reference shelled out to IQ-TREE)."""
    from ..data.fasta import read_fasta
    from ..sim.models import get_model
    from ..trees.likelihood import log_likelihood

    m = get_model(model)
    refs = _tree_files(true_tree_dir)
    cmps = _tree_files(cmp_tree_dir)
    rows = []
    for fa in sorted(Path(msa_dir).glob("*.fa")):
        stem = fa.stem
        if stem not in refs or stem not in cmps:
            continue
        aln = read_fasta(fa, strict=False)
        ll_cmp = log_likelihood(aln, parse_newick(cmps[stem].read_text()), m, gamma_alpha)
        ll_ref = log_likelihood(aln, parse_newick(refs[stem].read_text()), m, gamma_alpha)
        rows.append({"marker": marker, "id": stem,
                     "ratio": ll_cmp / ll_ref if ll_ref else float("nan")})
    return rows


def distance_summary(rows: Sequence[Dict]) -> Dict[str, float]:
    """MAE / MRE / MRD over dists rows (make_plots derived metrics)."""
    ref = np.array([r["ref_dist"] for r in rows])
    cmp_ = np.array([r["cmp_dist"] for r in rows])
    err = np.abs(cmp_ - ref)
    return {
        "mae": float(err.mean()),
        "mre": float((err / np.maximum(ref, 1e-9)).mean()),
        "mrd": float((2 * err / np.maximum(ref + cmp_, 1e-9)).mean()),
        "n_pairs": int(len(rows)),
    }


def topo_summary(rows: Sequence[Dict]) -> Dict[str, float]:
    return {
        "mean_norm_rf": float(np.mean([r["norm_rf"] for r in rows])),
        "mean_kf": float(np.mean([r["kf_score"] for r in rows])),
        "mean_weighted_rf": float(np.mean([r["weighted_rf"] for r in rows])),
        "n_trees": len(rows),
    }


def write_csv(path, rows: Sequence[Dict]) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if not rows:
        path.write_text("")
        return
    with open(path, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)


def full_report(
    true_tree_dir,
    matrix_dir,
    cmp_tree_dir,
    out_dir,
    marker: str = "PF",
    make_figures: bool = False,
) -> Dict:
    """Emit topos/dists/brlens CSVs + a JSON summary (and optional figures)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    topo = collect_topo_rows(true_tree_dir, cmp_tree_dir, marker)
    dist = collect_dist_rows(true_tree_dir, matrix_dir, marker)
    brlen = collect_brlen_rows(true_tree_dir, cmp_tree_dir, marker)
    write_csv(out / f"topos_{marker.lower()}.csv", topo)
    write_csv(out / f"dists_{marker.lower()}.csv", dist)
    write_csv(out / f"brlens_{marker.lower()}.csv", brlen)
    summary = {
        "marker": marker,
        "topo": topo_summary(topo) if topo else {},
        "dist": distance_summary(dist) if dist else {},
    }
    (out / f"summary_{marker.lower()}.json").write_text(json.dumps(summary, indent=2))
    if make_figures:
        _figures(out, marker, topo, dist)
    return summary


def _figures(out: Path, marker: str, topo: List[Dict], dist: List[Dict]) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if dist:
        ref = [r["ref_dist"] for r in dist]
        cmp_ = [r["cmp_dist"] for r in dist]
        fig, ax = plt.subplots(figsize=(5, 5))
        ax.scatter(ref, cmp_, s=2, alpha=0.3)
        lim = max(max(ref), max(cmp_))
        ax.plot([0, lim], [0, lim], "k--", lw=1)
        ax.set_xlabel("true patristic distance")
        ax.set_ylabel(f"{marker} predicted distance")
        fig.tight_layout()
        fig.savefig(out / f"dists_{marker.lower()}.pdf")
        plt.close(fig)
    if topo:
        by_tips: Dict[str, List[float]] = {}
        for r in topo:
            tips = r["id"].split("_")[1] if "_" in r["id"] else "?"
            by_tips.setdefault(tips, []).append(r["kf_score"])
        keys = sorted(by_tips, key=lambda x: int(x) if x.isdigit() else 0)
        fig, ax = plt.subplots(figsize=(5, 4))
        ax.boxplot([by_tips[k] for k in keys], tick_labels=keys)
        ax.set_xlabel("tips")
        ax.set_ylabel("KF distance")
        fig.tight_layout()
        fig.savefig(out / f"topos_{marker.lower()}.pdf")
        plt.close(fig)
