"""Figure suite over the benchmark CSV schemas.

Renders the main figure families of the reference's ``make_plots.py`` from
CSVs produced by :mod:`.report` / :mod:`.harness` — works on any set of
markers (PF, PF_Base, Hamming+FastME, ...):

- topology metrics by tip count (box plots; topos_*)
- predicted-vs-true distance scatter + error-by-distance (dists_*)
- branch-length scatter (brlens_*)
- pipeline runtime / memory bars (execution_*)
- likelihood-ratio distributions (likelihoods_*)
- model-misspecification heatmap (mean metric for model x dataset runs)

matplotlib is imported inside each renderer, so importing this module needs
none.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np


def _read_csv(path) -> List[Dict[str, str]]:
    with open(path) as fh:
        return list(csv.DictReader(fh))


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _tips_of(example_id: str) -> Optional[int]:
    parts = example_id.split("_")
    return int(parts[1]) if len(parts) > 1 and parts[1].isdigit() else None


def _length_of(example_id: str) -> Optional[int]:
    """Alignment length from paper-scale ids ``rep_tips_tips_length`` (the
    reference reads it as ``id.split("_")[-1]``, `make_plots.py:188`).  The
    bundled-testdata ids ``rep_tips_tips`` carry no length -> None."""
    parts = example_id.split("_")
    if len(parts) >= 4 and parts[-1].isdigit():
        return int(parts[-1])
    return None


def topology_by_tips(topo_csvs: Sequence, out_pdf, metric: str = "kf_score"):
    """Grouped box plot of a topology metric vs tip count, one color per
    marker (reference topos figures)."""
    plt = _plt()
    data: Dict[str, Dict[int, List[float]]] = {}
    for path in topo_csvs:
        for row in _read_csv(path):
            tips = _tips_of(row["id"])
            if tips is None:
                continue
            data.setdefault(row["marker"], {}).setdefault(tips, []).append(
                float(row[metric])
            )
    if not data:
        return
    markers = sorted(data)
    tips_all = sorted({t for m in data.values() for t in m})
    fig, ax = plt.subplots(figsize=(1.5 + 1.2 * len(tips_all), 4))
    width = 0.8 / max(len(markers), 1)
    for mi, marker in enumerate(markers):
        pos = [i + mi * width for i in range(len(tips_all))]
        vals = [data[marker].get(t, []) for t in tips_all]
        bp = ax.boxplot(vals, positions=pos, widths=width * 0.9, patch_artist=True)
        color = plt.cm.tab10(mi)
        for box in bp["boxes"]:
            box.set_facecolor(color)
        ax.plot([], [], color=color, label=marker)
    ax.set_xticks([i + 0.4 - width / 2 for i in range(len(tips_all))])
    ax.set_xticklabels(tips_all)
    ax.set_xlabel("tips")
    ax.set_ylabel(metric)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_pdf)
    plt.close(fig)


def distance_error_panels(dists_csv, out_pdf):
    """Scatter + relative-error-by-true-distance panels (reference dists)."""
    plt = _plt()
    rows = _read_csv(dists_csv)
    if not rows:
        return
    ref = np.array([float(r["ref_dist"]) for r in rows])
    cmp_ = np.array([float(r["cmp_dist"]) for r in rows])
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(9, 4))
    a1.scatter(ref, cmp_, s=2, alpha=0.25)
    lim = max(ref.max(), cmp_.max())
    a1.plot([0, lim], [0, lim], "k--", lw=1)
    a1.set_xlabel("true distance")
    a1.set_ylabel("predicted distance")
    rel = np.abs(cmp_ - ref) / np.maximum(ref, 1e-9)
    bins = np.quantile(ref, np.linspace(0, 1, 11))
    centers, med = [], []
    for lo, hi in zip(bins[:-1], bins[1:]):
        m = (ref >= lo) & (ref < hi)
        if m.any():
            centers.append((lo + hi) / 2)
            med.append(np.median(rel[m]))
    a2.plot(centers, med, "o-")
    a2.set_xlabel("true distance")
    a2.set_ylabel("median relative error")
    fig.tight_layout()
    fig.savefig(out_pdf)
    plt.close(fig)


def runtime_bars(execution_csvs: Sequence, out_pdf):
    """Stacked per-stage runtime bars per marker (reference execution plots,
    `make_plots.py:166-190` aggregation)."""
    plt = _plt()
    totals: Dict[str, Dict[str, float]] = {}
    rss: Dict[str, float] = {}
    for path in execution_csvs:
        for row in _read_csv(path):
            marker = row["marker"]
            totals.setdefault(marker, {}).setdefault(row["timer"], 0.0)
            totals[marker][row["timer"]] += float(row["elapsed_sec"])
            rss[marker] = max(rss.get(marker, 0), float(row["MaxRSS_kb"]))
    if not totals:
        return
    markers = sorted(totals)
    stages = sorted({s for t in totals.values() for s in t})
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(10, 4))
    bottom = np.zeros(len(markers))
    for si, stage in enumerate(stages):
        vals = np.array([totals[m].get(stage, 0.0) for m in markers])
        a1.bar(markers, vals, bottom=bottom, label=stage, color=plt.cm.tab10(si))
        bottom += vals
    a1.set_ylabel("elapsed (s)")
    a1.legend(fontsize=8)
    a2.bar(markers, [rss[m] / 1024 for m in markers], color="gray")
    a2.set_ylabel("peak RSS (MB)")
    fig.tight_layout()
    fig.savefig(out_pdf)
    plt.close(fig)


def likelihood_violins(likelihood_csvs: Sequence, out_pdf):
    """Distribution of inferred/true log-likelihood ratios per marker
    (reference likelihoods figure; ratios near 1 are good)."""
    plt = _plt()
    data: Dict[str, List[float]] = {}
    for path in likelihood_csvs:
        for row in _read_csv(path):
            data.setdefault(row["marker"], []).append(float(row["ratio"]))
    if not data:
        return
    markers = sorted(data)
    fig, ax = plt.subplots(figsize=(1.5 + len(markers), 4))
    ax.violinplot([data[m] for m in markers], showmedians=True)
    ax.axhline(1.0, color="k", ls="--", lw=1)
    ax.set_xticks(range(1, len(markers) + 1))
    ax.set_xticklabels(markers, rotation=30)
    ax.set_ylabel("ll(inferred) / ll(true)")
    fig.tight_layout()
    fig.savefig(out_pdf)
    plt.close(fig)


def metric_lines_by_length(topo_csvs: Sequence, out_pdf, metric: str = "norm_rf"):
    """Mean metric vs tip count, one line per marker, one panel per alignment
    length (the reference's `build_plot`/`side_by_side` grids,
    `make_plots.py:220-303`).  Ids without a length collapse to one panel."""
    plt = _plt()
    # data[length][marker][tips] -> values
    data: Dict[Optional[int], Dict[str, Dict[int, List[float]]]] = {}
    for path in topo_csvs:
        for row in _read_csv(path):
            tips = _tips_of(row["id"])
            if tips is None:
                continue
            length = _length_of(row["id"])
            data.setdefault(length, {}).setdefault(row["marker"], {}).setdefault(
                tips, []
            ).append(float(row[metric]))
    if not data:
        return
    lengths = sorted(data, key=lambda x: (x is None, x))
    fig, axes = plt.subplots(
        1, len(lengths), figsize=(4 * len(lengths), 4), sharey=True, squeeze=False
    )
    for ax, length in zip(axes[0], lengths):
        for mi, marker in enumerate(sorted(data[length])):
            series = data[length][marker]
            tips_all = sorted(series)
            mean = [float(np.mean(series[t])) for t in tips_all]
            sd = [float(np.std(series[t])) for t in tips_all]
            color = plt.cm.tab10(mi)
            ax.plot(tips_all, mean, "o-", color=color, label=marker, ms=4)
            ax.fill_between(
                tips_all,
                np.array(mean) - sd,
                np.array(mean) + sd,
                color=color,
                alpha=0.15,
                lw=0,
            )
        ax.set_title("all lengths" if length is None else f"Alignment length = {length}")
        ax.set_xlabel("Number of leaves")
    axes[0][0].set_ylabel(metric)
    axes[0][-1].legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_pdf)
    plt.close(fig)


def finetuned_panels(
    dataset_topo_csvs: Dict[str, Sequence],
    out_pdf,
    metrics: Sequence[str] = ("norm_rf", "kf_score", "weighted_rf"),
):
    """Metric x dataset grid of per-marker box plots — the reference's
    fine-tuned-model figure families (`fine_tuned_plot`/`cherry_pastek_topos`/
    `base_vs_ft`, `make_plots.py:759-1115`): pass topo CSVs per dataset (e.g.
    gaps/cherry/pastek) with whatever markers should be compared (PF_Base vs
    fine-tuned variants, baselines, ...)."""
    plt = _plt()
    # data[dataset][marker][metric] -> values
    data: Dict[str, Dict[str, Dict[str, List[float]]]] = {}
    for dataset, paths in dataset_topo_csvs.items():
        for path in paths:
            for row in _read_csv(path):
                by_marker = data.setdefault(dataset, {}).setdefault(row["marker"], {})
                for metric in metrics:
                    by_marker.setdefault(metric, []).append(float(row[metric]))
    if not data:
        return
    datasets = sorted(data)
    markers = sorted({m for d in data.values() for m in d})
    fig, axes = plt.subplots(
        len(metrics),
        len(datasets),
        figsize=(1.0 + 2.2 * len(datasets), 2.6 * len(metrics)),
        squeeze=False,
        sharey="row",
    )
    for ri, metric in enumerate(metrics):
        for ci, dataset in enumerate(datasets):
            ax = axes[ri][ci]
            vals, used = [], []
            for marker in markers:
                v = data[dataset].get(marker, {}).get(metric)
                if v:
                    vals.append(v)
                    used.append(marker)
            if vals:
                bp = ax.boxplot(vals, patch_artist=True)
                for box, marker in zip(bp["boxes"], used):
                    box.set_facecolor(plt.cm.tab10(markers.index(marker)))
                ax.set_xticklabels(used, rotation=45, fontsize=7)
            if ri == 0:
                ax.set_title(dataset)
            if ci == 0:
                ax.set_ylabel(metric)
    fig.tight_layout()
    fig.savefig(out_pdf)
    plt.close(fig)


def distance_hist_grid(dists_csvs: Sequence, out_pdf):
    """Grid of true-vs-predicted distance histograms, rows = tip counts,
    cols = alignment lengths (the reference's `hist_4x4`/`hist_ft` families,
    `make_plots.py:1154-1345`), overlaying each marker on the reference
    distribution."""
    plt = _plt()
    # cell[(tips, length)][marker] -> list of cmp; cell_ref -> list of ref
    cmp_by: Dict[tuple, Dict[str, List[float]]] = {}
    ref_by: Dict[tuple, List[float]] = {}
    for path in dists_csvs:
        for row in _read_csv(path):
            tips = _tips_of(row["id"])
            if tips is None:
                continue
            key = (tips, _length_of(row["id"]))
            cmp_by.setdefault(key, {}).setdefault(row["marker"], []).append(
                float(row["cmp_dist"])
            )
            ref_by.setdefault(key, []).append(float(row["ref_dist"]))
    if not ref_by:
        return
    tips_all = sorted({k[0] for k in ref_by})
    lens_all = sorted({k[1] for k in ref_by}, key=lambda x: (x is None, x))
    fig, axes = plt.subplots(
        len(tips_all),
        len(lens_all),
        figsize=(3 * len(lens_all), 2.2 * len(tips_all)),
        squeeze=False,
    )
    for ri, tips in enumerate(tips_all):
        for ci, length in enumerate(lens_all):
            ax = axes[ri][ci]
            key = (tips, length)
            if key not in ref_by:
                ax.axis("off")
                continue
            bins = np.linspace(0, max(ref_by[key]) * 1.1 + 1e-9, 40)
            ax.hist(ref_by[key], bins=bins, color="0.6", alpha=0.6, label="true")
            for mi, marker in enumerate(sorted(cmp_by.get(key, {}))):
                ax.hist(
                    cmp_by[key][marker],
                    bins=bins,
                    histtype="step",
                    color=plt.cm.tab10(mi),
                    label=marker,
                )
            ax.set_title(
                f"{tips} tips" + ("" if length is None else f", L={length}"),
                fontsize=8,
            )
            if ri == 0 and ci == 0:
                ax.legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(out_pdf)
    plt.close(fig)


def branch_length_scatter(brlens_csv, out_pdf):
    """True vs inferred branch lengths for shared bipartitions (the
    reference's `plot_brlen_dists`, `make_plots.py:1391` / brlens_lggc.csv)."""
    plt = _plt()
    rows = _read_csv(brlens_csv)
    if not rows:
        return
    markers = sorted({r["marker"] for r in rows})
    fig, axes = plt.subplots(
        1, len(markers), figsize=(4 * len(markers), 4), squeeze=False, sharey=True
    )
    for ax, marker in zip(axes[0], markers):
        ref = np.array([float(r["ref_len"]) for r in rows if r["marker"] == marker])
        cmp_ = np.array([float(r["cmp_len"]) for r in rows if r["marker"] == marker])
        ax.scatter(ref, cmp_, s=3, alpha=0.3)
        lim = max(ref.max(), cmp_.max())
        ax.plot([0, lim], [0, lim], "k--", lw=1)
        ax.set_xlabel("true branch length")
        ax.set_title(marker)
    axes[0][0].set_ylabel("inferred branch length")
    fig.tight_layout()
    fig.savefig(out_pdf)
    plt.close(fig)


def misspecification_heatmap(
    summaries: Dict[str, Dict[str, float]], out_pdf, metric_label: str = "mean KF"
):
    """Model x dataset heatmap (the reference's misspecification cross-matrix,
    `make_plots.py:1929-1977`): ``summaries[model][dataset] = metric``."""
    plt = _plt()
    models = sorted(summaries)
    datasets = sorted({d for row in summaries.values() for d in row})
    mat = np.full((len(models), len(datasets)), np.nan)
    for i, m in enumerate(models):
        for j, d in enumerate(datasets):
            if d in summaries[m]:
                mat[i, j] = summaries[m][d]
    fig, ax = plt.subplots(figsize=(2 + len(datasets), 1.5 + 0.6 * len(models)))
    im = ax.imshow(mat, cmap="viridis_r")
    ax.set_xticks(range(len(datasets)), datasets, rotation=30)
    ax.set_yticks(range(len(models)), models)
    for i in range(len(models)):
        for j in range(len(datasets)):
            if np.isfinite(mat[i, j]):
                ax.text(j, i, f"{mat[i, j]:.3f}", ha="center", va="center",
                        color="white", fontsize=8)
    fig.colorbar(im, label=metric_label)
    fig.tight_layout()
    fig.savefig(out_pdf)
    plt.close(fig)
