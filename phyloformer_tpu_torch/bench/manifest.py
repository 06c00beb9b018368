"""1:1 reference figure roster.

Phyloformer's ``make_plots.py`` emits 43 specific figure files.  This
module enumerates every one of them (``REFERENCE_FIGURES``) and renders each
from the same CSV schemas (``topos_*``, ``dists_*``, ``execution_*``,
``likelihoods_*``, ``brlens_*`` + ``model_load_times.txt``) that
:mod:`.report` / :mod:`.harness` produce — pure csv/numpy/matplotlib, no
pandas/seaborn.  The port's copy of the JAX package's ``bench/manifest.py``.

Figures are re-designed, not copied: each renderer shows the same quantity
with the same grouping as its reference counterpart (panel-per-length line
grids, per-dataset fine-tune panels, load-time overlays, quantile/binned
error curves, misspecification mean grids, branch-length error panels, ...).

Usage::

    from phyloformer_tpu_torch.bench.manifest import render_all
    rendered = render_all(data_dir, figures_dir)

``render_all`` renders every figure whose inputs exist in ``data_dir`` and
returns ``{figure_name: path | None}``.  matplotlib is imported inside the
renderers, so importing this module needs none; :func:`require_matplotlib`
raises a message that names it where it is missing.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

# Every file make_plots.py saves, in emission order
# (``make_plots.py``, savefig call sites).
REFERENCE_FIGURES = [
    "combined_LGGC_rf.pdf",
    "combined_LGGC_kf.pdf",
    "combined_LGGC_wrf.pdf",
    "LGGC_500_rf.pdf",
    "LGGC_500_kf.pdf",
    "LGGC_500_wrf.pdf",
    "cherry_pastek_rf.pdf",
    "cherry_pastek_kf.pdf",
    "cherry_pastek_wrf.pdf",
    "cherry_pastek_topos.pdf",
    "fine_tune_rf.pdf",
    "fine_tune_kf.pdf",
    "fine_tune_wrf.pdf",
    "LGGC_500_elapsed.pdf",
    "LGGC_500_mem.pdf",
    "fine_tune_elapsed.pdf",
    "fine_tune_mem.pdf",
    "elapsed.pdf",
    "elapsed_pf_loads.pdf",
    "LGGC_500_mre.pdf",
    "LGGC_500_mae.pdf",
    "LGGC_500_quantile_mae.pdf",
    "LGGC_500_quantile_mre.pdf",
    "LGGC_500_quantile_mrd.pdf",
    "LGGC_500_binned_mae.pdf",
    "LGGC_500_binned_mre.pdf",
    "LGGC_500_binned_mrd.pdf",
    "pairwise_dist_testset.pdf",
    "base_vs_mre.pdf",
    "fine_tune_mae.pdf",
    "dist_hist_LGGC.png",
    "dist_hist_cherry.png",
    "dist_hist_pastek.png",
    "lggc_all.pdf",
    "cherry_all.pdf",
    "pastek_all.pdf",
    "gaps_all.pdf",
    "misspecification_50tips.pdf",
    "misspecification_alltips.pdf",
    "combined_LGGC_lik.pdf",
    "LGGC_500_lik.pdf",
    "branch_length_errors.pdf",
    "branch_length_errors.svg",
]

_METRIC_OF = {"rf": "norm_rf", "kf": "kf_score", "wrf": "weighted_rf"}
_PF_FAMILY = ("PF", "PF_Base", "PF_MRE", "PF_Indel", "PF_Cherry", "PF_SelReg")


def require_matplotlib() -> None:
    """Raise, naming matplotlib, where it is not installed."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError("pf-bench-torch manifest renders with matplotlib, which is not "
                          "installed here") from e


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _read(path: Path) -> List[Dict[str, str]]:
    with open(path) as fh:
        return list(csv.DictReader(fh))


def _tips(example_id: str) -> Optional[int]:
    parts = example_id.split("_")
    return int(parts[1]) if len(parts) > 1 and parts[1].isdigit() else None


def _length(example_id: str) -> Optional[int]:
    parts = example_id.split("_")
    return int(parts[-1]) if len(parts) >= 4 and parts[-1].isdigit() else None


def _base_marker(marker: str) -> str:
    """'PF_Indel+FastME' -> 'PF_Indel' (the reference strips the suffix for
    the misspecification plots)."""
    return marker.split("+")[0]


class _Data:
    """Lazy CSV loader over a reference-layout data directory."""

    def __init__(self, data_dir):
        self.dir = Path(data_dir)
        self._cache: Dict[str, Optional[List[Dict]]] = {}

    def rows(self, name: str) -> Optional[List[Dict]]:
        if name not in self._cache:
            path = self.dir / name
            self._cache[name] = _read(path) if path.exists() else None
        return self._cache[name]

    def load_time(self) -> Optional[float]:
        path = self.dir / "model_load_times.txt"
        if not path.exists():
            return None
        vals = [float(x) for x in path.read_text().split() if x.strip()]
        return sum(vals) / len(vals) if vals else None


# ---------------------------------------------------------------------------
# renderer primitives
# ---------------------------------------------------------------------------

def _lines_by_tips(rows, value_of, ylabel, out, lengths=None, log_y=False,
                   overlay_of=None):
    """Mean±sd of a per-row value vs tip count, one line per marker, one
    panel per alignment length (None = single panel over everything).
    ``overlay_of(marker)`` may return a constant to add as a dashed line
    (the reference's model-load-time offset, `make_plots.py:544-559`)."""
    plt = _plt()
    panels = lengths if lengths else [None]
    data: Dict[Optional[int], Dict[str, Dict[int, List[float]]]] = {}
    for r in rows:
        tips = _tips(r["id"])
        if tips is None:
            continue
        length = _length(r["id"])
        for panel in panels:
            if panel is not None and length is not None and length != panel:
                continue
            v = value_of(r)
            if v is None or not np.isfinite(v):
                continue
            data.setdefault(panel, {}).setdefault(r["marker"], {}).setdefault(
                tips, []).append(v)
    if not any(data.get(p) for p in panels):
        return False
    fig, axes = plt.subplots(1, len(panels), figsize=(4.2 * len(panels), 3.6),
                             sharey=True, squeeze=False)
    for ax, panel in zip(axes[0], panels):
        for mi, marker in enumerate(sorted(data.get(panel, {}))):
            series = data[panel][marker]
            ts = sorted(series)
            mean = np.array([np.mean(series[t]) for t in ts])
            sd = np.array([np.std(series[t]) for t in ts])
            color = plt.cm.tab10(mi % 10)
            ax.plot(ts, mean, "o-", color=color, label=marker, ms=3)
            ax.fill_between(ts, mean - sd, mean + sd, color=color, alpha=0.15,
                            lw=0)
            if overlay_of is not None:
                extra = overlay_of(marker)
                if extra:
                    ax.plot(ts, mean + extra, "--", color=color, lw=1)
        if panel is not None:
            ax.set_title(f"Alignment length = {panel}")
        ax.set_xlabel("Number of leaves")
        if log_y:
            ax.set_yscale("log")
    axes[0][0].set_ylabel(ylabel)
    axes[0][-1].legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    return True


def _boxes_by_marker(panel_rows: Dict[str, list], value_of, ylabel, out,
                     panel_order: Optional[Sequence[str]] = None):
    """One panel per dataset, box per marker (fine-tune figure families)."""
    plt = _plt()
    panels = list(panel_order or sorted(panel_rows))
    fig, axes = plt.subplots(1, len(panels), figsize=(3.4 * len(panels), 3.8),
                             sharey=True, squeeze=False)
    drew = False
    for ax, panel in zip(axes[0], panels):
        data: Dict[str, List[float]] = {}
        for r in panel_rows.get(panel) or []:
            v = value_of(r)
            if v is not None and np.isfinite(v):
                data.setdefault(r["marker"], []).append(v)
        markers = sorted(data)
        if markers:
            bp = ax.boxplot([data[m] for m in markers], patch_artist=True,
                            showfliers=False)
            for bi, box in enumerate(bp["boxes"]):
                box.set_facecolor(plt.cm.tab10(bi % 10))
            ax.set_xticklabels(markers, rotation=45, fontsize=7)
            drew = True
        ax.set_title(panel)
    if not drew:
        plt.close(fig)
        return False
    axes[0][0].set_ylabel(ylabel)
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    return True


def _error_curves(rows, metric: str, out, binned: bool, length=500):
    """MAE/MRE/MRD vs true-distance percentile (100 quantiles) or
    log-binned true distance, per marker (LGGC_500_quantile_* /
    LGGC_500_binned_*)."""
    plt = _plt()
    per_marker: Dict[str, List] = {}
    for r in rows:
        if _length(r["id"]) not in (length, None):
            continue
        ref, cmp_ = float(r["ref_dist"]), float(r["cmp_dist"])
        if ref <= 0:
            continue
        err = {"mae": abs(ref - cmp_), "mre": abs(ref - cmp_) / ref,
               "mrd": (ref - cmp_) / ref}[metric]
        per_marker.setdefault(r["marker"], []).append((ref, err))
    if not per_marker:
        return False
    fig, ax = plt.subplots(figsize=(6, 4))
    for mi, marker in enumerate(sorted(per_marker)):
        arr = np.array(per_marker[marker])
        ref, err = arr[:, 0], arr[:, 1]
        if binned:
            edges = np.logspace(np.log10(ref.min()), np.log10(ref.max()), 40)
        else:
            edges = np.quantile(ref, np.linspace(0, 1, 101))
        xs, ys = [], []
        for lo, hi in zip(edges[:-1], edges[1:]):
            m = (ref >= lo) & (ref <= hi)
            if m.any():
                xs.append(hi)
                ys.append(float(np.mean(err[m])))
        ax.plot(xs, ys, "-", color=plt.cm.tab10(mi % 10), label=marker, lw=1.2)
    if binned:
        ax.set_xscale("log")
        ax.set_xlabel("true distance (log bins)")
    else:
        ax.set_xlabel("true-distance percentile edge")
    ax.set_ylabel(metric.upper())
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    return True


def _exec_by_tips(rows, out, mem: bool, load_time=None, panels=None,
                  title=None):
    """Total pipeline elapsed (or peak RSS) vs tips, line per marker — the
    reference first sums elapsed across stages per (marker, id)
    (`make_plots.py:166-190`); with ``load_time``, PF markers also get the
    dashed +model-load overlay (`:544-559,1597-1599`)."""
    agg: Dict[tuple, Dict[str, float]] = {}
    for r in rows:
        if r["id"] == "all":
            # whole-run stages (model/data load) are spread per example later
            continue
        key = (r["marker"], r["id"])
        a = agg.setdefault(key, {"elapsed": 0.0, "rss": 0.0})
        a["elapsed"] += float(r["elapsed_sec"])
        a["rss"] = max(a["rss"], float(r["MaxRSS_kb"]))
    flat = [
        {"marker": m, "id": i,
         "val": a["rss"] / 1024.0 if mem else a["elapsed"]}
        for (m, i), a in agg.items()
    ]

    def overlay(marker):
        if load_time is not None and _base_marker(marker) in _PF_FAMILY:
            return load_time
        return None

    return _lines_by_tips(
        flat, lambda r: r["val"], "peak RSS (MB)" if mem else "elapsed (s)",
        out, lengths=panels, log_y=not mem,
        overlay_of=overlay if load_time is not None else None,
    )


def _dataset_all(topo_rows, dist_rows, out, markers=None):
    """2x2 grid — norm_rf / kf_score / weighted_rf boxes + MAE box per
    marker (the reference ``dataset_plot`` -> *_all.pdf)."""
    plt = _plt()
    topo: Dict[str, Dict[str, List[float]]] = {}
    for r in topo_rows or []:
        if markers and r["marker"] not in markers:
            continue
        for metric in ("norm_rf", "kf_score", "weighted_rf"):
            topo.setdefault(metric, {}).setdefault(r["marker"], []).append(
                float(r[metric]))
    mae: Dict[str, List[float]] = {}
    for r in dist_rows or []:
        if markers and r["marker"] not in markers:
            continue
        mae.setdefault(r["marker"], []).append(
            abs(float(r["ref_dist"]) - float(r["cmp_dist"])))
    if not topo and not mae:
        return False
    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    cells = [("norm_rf", topo.get("norm_rf", {})),
             ("kf_score", topo.get("kf_score", {})),
             ("weighted_rf", topo.get("weighted_rf", {})),
             ("MAE", mae)]
    for ax, (label, data) in zip(axes.flat, cells):
        ms = sorted(data)
        if ms:
            bp = ax.boxplot([data[m] for m in ms], patch_artist=True,
                            showfliers=False)
            for bi, box in enumerate(bp["boxes"]):
                box.set_facecolor(plt.cm.tab10(bi % 10))
            ax.set_xticklabels(ms, rotation=45, fontsize=7)
        ax.set_ylabel(label)
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    return True


def _misspecification(topo_by_ds, dists_by_ds, out, tips=None):
    """Mean norm_rf / kf_score / MAE / MRE per (dataset, PF model) as
    grouped bars — the reference's misspecification cross-comparison
    (`make_plots.py:1929-1977`), 50-tips-only or all-tips variants."""
    plt = _plt()
    metrics = ["norm_rf", "kf_score", "MAE", "MRE"]
    # means[metric][dataset][model] = value
    means: Dict[str, Dict[str, Dict[str, float]]] = {m: {} for m in metrics}
    models = set()
    for ds, rows in (topo_by_ds or {}).items():
        acc: Dict[str, Dict[str, List[float]]] = {}
        for r in rows or []:
            model = _base_marker(r["marker"])
            if model not in ("PF", "PF_Indel", "PF_Cherry", "PF_SelReg"):
                continue
            if tips is not None and _tips(r["id"]) != tips:
                continue
            a = acc.setdefault(model, {"norm_rf": [], "kf_score": []})
            a["norm_rf"].append(float(r["norm_rf"]))
            a["kf_score"].append(float(r["kf_score"]))
        for model, a in acc.items():
            models.add(model)
            for m in ("norm_rf", "kf_score"):
                means[m].setdefault(ds, {})[model] = float(np.mean(a[m]))
    for ds, rows in (dists_by_ds or {}).items():
        acc2: Dict[str, Dict[str, List[float]]] = {}
        for r in rows or []:
            model = _base_marker(r["marker"])
            if model not in ("PF", "PF_Indel", "PF_Cherry", "PF_SelReg"):
                continue
            if tips is not None and _tips(r["id"]) != tips:
                continue
            ref, cmp_ = float(r["ref_dist"]), float(r["cmp_dist"])
            if ref <= 0:
                continue
            a = acc2.setdefault(model, {"MAE": [], "MRE": []})
            a["MAE"].append(abs(ref - cmp_))
            a["MRE"].append(abs(ref - cmp_) / ref)
        for model, a in acc2.items():
            models.add(model)
            for m in ("MAE", "MRE"):
                means[m].setdefault(ds, {})[model] = float(np.mean(a[m]))
    if not models:
        return False
    model_order = [m for m in ("PF", "PF_Indel", "PF_Cherry", "PF_SelReg")
                   if m in models]
    fig, axes = plt.subplots(2, 2, figsize=(9, 7))
    for ax, metric in zip(axes.flat, metrics):
        datasets = sorted(means[metric])
        width = 0.8 / max(len(model_order), 1)
        for mi, model in enumerate(model_order):
            vals = [means[metric].get(ds, {}).get(model, np.nan)
                    for ds in datasets]
            pos = [i + mi * width for i in range(len(datasets))]
            ax.bar(pos, vals, width=width * 0.9,
                   color=plt.cm.tab10(mi), label=model)
        ax.set_xticks([i + 0.4 - width / 2 for i in range(len(datasets))])
        ax.set_xticklabels(datasets, fontsize=8)
        ax.set_ylabel(f"mean {metric}")
    axes[0][0].legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    return True


def _pairwise_dist_density(rows, out, marker_contains="PF", length=500):
    """Density of true pairwise distances per tip count, log x (the
    reference's seaborn kdeplot, pairwise_dist_testset.pdf)."""
    plt = _plt()
    by_tips: Dict[int, List[float]] = {}
    for r in rows:
        if _length(r["id"]) not in (length, None):
            continue
        if not r["marker"].startswith(marker_contains):
            continue
        t = _tips(r["id"])
        ref = float(r["ref_dist"])
        if t is not None and ref > 0:
            by_tips.setdefault(t, []).append(ref)
    if not by_tips:
        return False
    fig, ax = plt.subplots(figsize=(6, 4))
    for ti, t in enumerate(sorted(by_tips)):
        vals = np.log10(np.array(by_tips[t]))
        hist, edges = np.histogram(vals, bins=50, density=True)
        centers = 10 ** ((edges[:-1] + edges[1:]) / 2)
        ax.plot(centers, hist, "-", color=plt.cm.viridis(ti / len(by_tips)),
                label=f"{t}")
    ax.set_xscale("log")
    ax.set_xlabel("Pairwise Distance")
    ax.set_ylabel("Density")
    ax.legend(title="Number of leaves", fontsize=7)
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    return True


def _base_vs_ft(topo_rows, dist_rows, out, length=500):
    """PF_Base vs fine-tuned PF (MRE) comparison: topology + distance
    metrics side by side (base_vs_mre.pdf)."""
    plt = _plt()
    want = {m for m in ("PF", "PF_Base", "PF_MRE")}
    topo: Dict[str, Dict[str, List[float]]] = {}
    for r in topo_rows or []:
        if _base_marker(r["marker"]) not in want:
            continue
        if _length(r["id"]) not in (length, None):
            continue
        for metric in ("norm_rf", "kf_score"):
            topo.setdefault(metric, {}).setdefault(r["marker"], []).append(
                float(r[metric]))
    dist: Dict[str, Dict[str, List[float]]] = {}
    for r in dist_rows or []:
        if _base_marker(r["marker"]) not in want:
            continue
        if _length(r["id"]) not in (length, None):
            continue
        ref, cmp_ = float(r["ref_dist"]), float(r["cmp_dist"])
        if ref <= 0:
            continue
        dist.setdefault("MAE", {}).setdefault(r["marker"], []).append(
            abs(ref - cmp_))
        dist.setdefault("MRE", {}).setdefault(r["marker"], []).append(
            abs(ref - cmp_) / ref)
    cells = [("norm_rf", topo.get("norm_rf", {})),
             ("kf_score", topo.get("kf_score", {})),
             ("MAE", dist.get("MAE", {})), ("MRE", dist.get("MRE", {}))]
    if not any(d for _, d in cells):
        return False
    fig, axes = plt.subplots(2, 2, figsize=(9, 8))
    for ax, (label, data) in zip(axes.flat, cells):
        ms = sorted(data)
        if ms:
            bp = ax.boxplot([data[m] for m in ms], patch_artist=True,
                            showfliers=False)
            for bi, box in enumerate(bp["boxes"]):
                box.set_facecolor(plt.cm.tab10(bi % 10))
            ax.set_xticklabels(ms, rotation=30, fontsize=8)
        ax.set_ylabel(label)
    fig.tight_layout()
    fig.savefig(out)
    plt.close(fig)
    return True


def _brlens(rows, outs):
    """Branch-length error panels: true-vs-inferred scatter for shared
    bipartitions plus length histograms of ref-only / inferred-only branches
    (branch_length_errors.pdf/.svg; empty cells in the CSV mark unmatched
    bipartitions, `make_plots.py:2010-2023`)."""
    plt = _plt()
    common, ref_only, cmp_only = [], [], []
    for r in rows:
        ref = r.get("ref_len") or ""
        cmp_ = r.get("cmp_len") or ""
        if ref and cmp_:
            common.append((float(ref), float(cmp_)))
        elif ref:
            ref_only.append(float(ref))
        elif cmp_:
            cmp_only.append(float(cmp_))
    if not (common or ref_only or cmp_only):
        return False
    fig, (a1, a2, a3) = plt.subplots(1, 3, figsize=(12, 4))
    if common:
        arr = np.array(common)
        a1.scatter(arr[:, 0], arr[:, 1], s=3, alpha=0.3)
        lim = arr.max()
        a1.plot([0, lim], [0, lim], "k--", lw=1)
    a1.set_xlabel("true branch length")
    a1.set_ylabel("inferred branch length")
    a1.set_title("common bipartitions")
    for ax, vals, title in ((a2, ref_only, "true-only branches"),
                            (a3, cmp_only, "inferred-only branches")):
        if vals:
            ax.hist(vals, bins=30, color="0.5")
        ax.set_xlabel("branch length")
        ax.set_title(title)
    fig.tight_layout()
    for out in outs:
        fig.savefig(out)
    plt.close(fig)
    return True


# ---------------------------------------------------------------------------
# manifest
# ---------------------------------------------------------------------------

def render_all(data_dir, out_dir) -> Dict[str, Optional[Path]]:
    """Render every reference figure whose inputs exist under ``data_dir``.

    Returns a dict over ``REFERENCE_FIGURES``: output path, or None when the
    required CSVs are absent."""
    from .figures import distance_hist_grid

    data = _Data(data_dir)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    done: Dict[str, Optional[Path]] = {name: None for name in REFERENCE_FIGURES}

    def mark(name: str, ok: bool):
        done[name] = out / name if ok else None

    lggc = data.rows("topos_lggc.csv")
    cherry = data.rows("topos_cherry.csv")
    pastek = data.rows("topos_pastek.csv")
    gaps = data.rows("topos_gaps.csv")
    d_lggc = data.rows("dists_lggc.csv")
    d_cherry = data.rows("dists_cherry.csv")
    d_pastek = data.rows("dists_pastek.csv")
    d_gaps = data.rows("dists_gaps.csv")
    load_time = data.load_time()

    lengths = None
    if lggc:
        found = sorted({_length(r["id"]) for r in lggc} - {None})
        lengths = found or None

    for short, metric in _METRIC_OF.items():
        if lggc:
            mark(f"combined_LGGC_{short}.pdf",
                 _lines_by_tips(lggc, lambda r, m=metric: float(r[m]), metric,
                                out / f"combined_LGGC_{short}.pdf",
                                lengths=lengths))
            only500 = [r for r in lggc if _length(r["id"]) in (500, None)]
            mark(f"LGGC_500_{short}.pdf",
                 _lines_by_tips(only500, lambda r, m=metric: float(r[m]),
                                metric, out / f"LGGC_500_{short}.pdf"))
        if cherry or pastek:
            mark(f"cherry_pastek_{short}.pdf",
                 _boxes_by_marker(
                     {"Cherry": cherry, "SelReg": pastek},
                     lambda r, m=metric: float(r[m]), metric,
                     out / f"cherry_pastek_{short}.pdf",
                     panel_order=["Cherry", "SelReg"]))
        if gaps or cherry or pastek:
            mark(f"fine_tune_{short}.pdf",
                 _boxes_by_marker(
                     {"Indels": gaps, "Cherry": cherry, "SelReg": pastek},
                     lambda r, m=metric: float(r[m]), metric,
                     out / f"fine_tune_{short}.pdf",
                     panel_order=["Indels", "Cherry", "SelReg"]))

    if cherry or pastek:
        # all three metrics side by side for the two simulators
        plt = _plt()
        fig, axes = plt.subplots(3, 2, figsize=(7, 9), squeeze=False)
        plt.close(fig)
        ok = True
        # render as a stacked pdf via _boxes_by_marker per metric into one
        # multi-metric figure
        fig, axes = plt.subplots(3, 2, figsize=(7, 9), squeeze=False)
        drew = False
        for ri, metric in enumerate(["norm_rf", "kf_score", "weighted_rf"]):
            for ci, (ds, rows) in enumerate(
                    [("Cherry", cherry), ("SelReg", pastek)]):
                ax = axes[ri][ci]
                by: Dict[str, List[float]] = {}
                for r in rows or []:
                    by.setdefault(r["marker"], []).append(float(r[metric]))
                ms = sorted(by)
                if ms:
                    bp = ax.boxplot([by[m] for m in ms], patch_artist=True,
                                    showfliers=False)
                    for bi, box in enumerate(bp["boxes"]):
                        box.set_facecolor(plt.cm.tab10(bi % 10))
                    ax.set_xticklabels(ms, rotation=45, fontsize=6)
                    drew = True
                if ri == 0:
                    ax.set_title(ds)
                if ci == 0:
                    ax.set_ylabel(metric)
        ok = drew
        if drew:
            fig.tight_layout()
            fig.savefig(out / "cherry_pastek_topos.pdf")
        plt.close(fig)
        mark("cherry_pastek_topos.pdf", ok)

    # execution metadata
    e_lggc = data.rows("execution_lggc.csv")
    e_cherry = data.rows("execution_cherry.csv")
    e_pastek = data.rows("execution_pastek.csv")
    e_gaps = data.rows("execution_gaps.csv")
    if e_lggc:
        only500 = [r for r in e_lggc if _length(r["id"]) in (500, None)]
        mark("LGGC_500_elapsed.pdf",
             _exec_by_tips(only500, out / "LGGC_500_elapsed.pdf", mem=False,
                           load_time=load_time))
        mark("LGGC_500_mem.pdf",
             _exec_by_tips(only500, out / "LGGC_500_mem.pdf", mem=True))
        mark("elapsed.pdf",
             _exec_by_tips(only500, out / "elapsed.pdf", mem=False))
        mark("elapsed_pf_loads.pdf",
             _exec_by_tips(only500, out / "elapsed_pf_loads.pdf", mem=False,
                           load_time=load_time or 0.0))
    if e_gaps or e_cherry or e_pastek:
        merged = (e_gaps or []) + (e_cherry or []) + (e_pastek or [])
        mark("fine_tune_elapsed.pdf",
             _exec_by_tips(merged, out / "fine_tune_elapsed.pdf", mem=False))
        mark("fine_tune_mem.pdf",
             _exec_by_tips(merged, out / "fine_tune_mem.pdf", mem=True))

    # distance errors (LGGC 500)
    if d_lggc:
        only500 = [r for r in d_lggc if _length(r["id"]) in (500, None)]

        def mre_of(r):
            ref = float(r["ref_dist"])
            return abs(ref - float(r["cmp_dist"])) / ref if ref > 0 else None

        def mae_of(r):
            return abs(float(r["ref_dist"]) - float(r["cmp_dist"]))

        mark("LGGC_500_mre.pdf",
             _lines_by_tips(only500, mre_of, "MRE", out / "LGGC_500_mre.pdf"))
        mark("LGGC_500_mae.pdf",
             _lines_by_tips(only500, mae_of, "MAE", out / "LGGC_500_mae.pdf"))
        for metric in ("mae", "mre", "mrd"):
            mark(f"LGGC_500_quantile_{metric}.pdf",
                 _error_curves(only500, metric,
                               out / f"LGGC_500_quantile_{metric}.pdf",
                               binned=False))
            mark(f"LGGC_500_binned_{metric}.pdf",
                 _error_curves(only500, metric,
                               out / f"LGGC_500_binned_{metric}.pdf",
                               binned=True))
        mark("pairwise_dist_testset.pdf",
             _pairwise_dist_density(d_lggc, out / "pairwise_dist_testset.pdf"))
        mark("base_vs_mre.pdf",
             _base_vs_ft(lggc, d_lggc, out / "base_vs_mre.pdf"))
        distance_hist_grid([data.dir / "dists_lggc.csv"],
                           out / "dist_hist_LGGC.png")
        mark("dist_hist_LGGC.png", (out / "dist_hist_LGGC.png").exists())

    if d_gaps or d_cherry or d_pastek:
        mark("fine_tune_mae.pdf",
             _boxes_by_marker(
                 {"Indels": d_gaps, "Cherry": d_cherry, "SelReg": d_pastek},
                 lambda r: abs(float(r["ref_dist"]) - float(r["cmp_dist"])),
                 "MAE", out / "fine_tune_mae.pdf",
                 panel_order=["Indels", "Cherry", "SelReg"]))
    for name, rows_path in (("dist_hist_cherry.png", "dists_cherry.csv"),
                            ("dist_hist_pastek.png", "dists_pastek.csv")):
        if data.rows(rows_path):
            distance_hist_grid([data.dir / rows_path], out / name)
            mark(name, (out / name).exists())

    # per-dataset "all metrics" grids
    for name, topo_rows, dist_rows in (
        ("lggc_all.pdf", lggc, d_lggc),
        ("cherry_all.pdf", cherry, d_cherry),
        ("pastek_all.pdf", pastek, d_pastek),
        ("gaps_all.pdf", gaps, d_gaps),
    ):
        if topo_rows or dist_rows:
            mark(name, _dataset_all(topo_rows, dist_rows, out / name))

    # misspecification cross-comparisons
    topo_by_ds = {"LG+GC": lggc, "Indels": gaps, "Cherry": cherry,
                  "SelReg": pastek}
    dists_by_ds = {"LG+GC": d_lggc, "Indels": d_gaps, "Cherry": d_cherry,
                   "SelReg": d_pastek}
    if any(topo_by_ds.values()) or any(dists_by_ds.values()):
        mark("misspecification_50tips.pdf",
             _misspecification(topo_by_ds, dists_by_ds,
                               out / "misspecification_50tips.pdf", tips=50))
        mark("misspecification_alltips.pdf",
             _misspecification(topo_by_ds, dists_by_ds,
                               out / "misspecification_alltips.pdf"))

    # likelihoods
    lik = data.rows("likelihoods_lggc.csv")
    if lik:
        mark("combined_LGGC_lik.pdf",
             _lines_by_tips(lik, lambda r: float(r["ratio"]), "ll ratio",
                            out / "combined_LGGC_lik.pdf", lengths=lengths))
        only500 = [r for r in lik if _length(r["id"]) in (500, None)]
        mark("LGGC_500_lik.pdf",
             _lines_by_tips(only500, lambda r: float(r["ratio"]), "ll ratio",
                            out / "LGGC_500_lik.pdf"))

    # branch lengths
    brlens = data.rows("brlens_lggc.csv")
    if brlens:
        ok = _brlens(brlens, [out / "branch_length_errors.pdf",
                              out / "branch_length_errors.svg"])
        mark("branch_length_errors.pdf", ok)
        mark("branch_length_errors.svg", ok)

    return done
