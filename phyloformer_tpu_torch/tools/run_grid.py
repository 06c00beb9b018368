"""Run the benchmark grid: every method over simulated alignments of a lengths
x tips grid, written in the reference's CSV vocabulary.

Methods:

  PF*               the port's inference engine -> .phy -> native
                    BME+NNI+SPR trees (any checkpoint; marker = --pf-marker)
  Hamming_FastME    Poisson-corrected Hamming distances -> native BME+NNI+SPR
  ML_FastME         pairwise ML distances under LG -> native BME+NNI+SPR
  ml_refine         approximate ML (NNI+SPR+CAT) from a Hamming_FastME (or
                    ML_FastME) start tree; tips-capped
  FastTree          an external FastTree binary (raises FileNotFoundError
                    without one)

Inputs: ``--grid-root`` with ``L<length>/{trees,msas}/`` per length (stems
match; :mod:`.make_grid_data` writes them).  Outputs per length under
``--out/L<length>/``:

  matrices_<marker>/*.phy   trees_<marker>/*.nwk
  execution_<marker>.csv    (timer,marker,id,elapsed_sec,MaxRSS_kb)
  topos_<marker>.csv        (marker,id,norm_rf,kf_score,weighted_rf)
  brlens_<marker>.csv       (marker,id,ref_len,cmp_len)
  dists_<marker>.csv        (marker,id,ref_dist,cmp_dist)
  stages_<marker>.json      (the seconds of each (marker, id))

and ``--out/grid_metrics.csv`` (one row a marker x length x tips).

    python -m phyloformer_tpu_torch.tools.run_grid --grid-root DIR --out DIR \\
        --lengths 250,500,1000 --methods PF,Hamming_FastME --pf-weights W [--device cpu]

PF runs on the card unless ``--device cpu`` is given: there the engine's
kernels at one TF32 pass (the benched fast path), on the CPU the plain fp32
model; either way an untimed ``compile_warmup`` pass before the timed
``inference``.  The other methods run on the host.  The JAX package's
``tools/run_grid.py``.
"""

from __future__ import annotations

import argparse
import csv
import json
import shutil
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np


def _tips_of(stem: str) -> int:
    """The tips count of a ``{rep}_{tips}_tips`` stem, -1 for another name."""
    try:
        return int(stem.split("_")[1])
    except (IndexError, ValueError):
        return -1


def pf_engine(params, cfg, device):
    """The grid's PF engine: on the card the kernels at one TF32 pass (the
    fast path), on the CPU the plain fp32 model; 2^22 tokens a batch."""
    from ..infer.engine import InferenceConfig, InferenceEngine

    on_card = device.type == "cuda"
    return InferenceEngine(params, cfg, InferenceConfig(
        matmul_precision="tensorfloat32" if on_card else "float32",
        use_kernels=on_card, max_batch_tokens=1 << 22), device=device)


def run_method(method, length_dir, out_dir, args, rec):
    """Build one tree per MSA with ``method``; write matrices (if any) and trees."""
    from ..data.fasta import read_fasta
    from ..data.phylip import matrix_to_phylip, vec_to_phylip
    from ..trees import baselines
    from ..trees.native import build_tree_from_phylip

    msas = sorted((length_dir / "msas").glob("*.fa"))
    msas = [p for p in msas if _tips_of(p.stem) <= args.max_tips.get(method, 10**9)]
    skipped = [p.stem for p in sorted((length_dir / "msas").glob("*.fa")) if p not in msas]
    if skipped:
        print(f"[{method}] tips cap {args.max_tips.get(method)}: "
              f"skipping {len(skipped)} MSAs: {', '.join(skipped)}", file=sys.stderr)

    mat_dir = out_dir / f"matrices_{method.lower()}"
    tree_dir = out_dir / f"trees_{method.lower()}"
    mat_dir.mkdir(parents=True, exist_ok=True)
    tree_dir.mkdir(parents=True, exist_ok=True)

    if method.startswith("PF"):
        from ..device import resolve_device
        from ..io.ckpt_import import load_pretrained

        with rec.stage("model_load", method, "all"):
            params, cfg, _ = load_pretrained(args.pf_weights)
            engine = pf_engine(params, cfg, resolve_device(args.device))
        alns = [read_fasta(p) for p in msas]
        # an untimed pass first: the kernels' load and the first batches'
        # allocations stay out of the timed inference
        with rec.stage("compile_warmup", method, "all"):
            engine.predict(alns)
        with rec.stage("inference", method, "all"):
            preds = engine.predict(alns)
        for p, aln, vec in zip(msas, alns, preds):
            _, phy = vec_to_phylip(np.asarray(vec, np.float64), aln.ids)
            (mat_dir / f"{p.stem}.phy").write_text(phy)
            with rec.stage("fastme", method, p.stem):
                nwk = build_tree_from_phylip(phy, "bme", nni=True, spr=True)
            (tree_dir / f"{p.stem}.nwk").write_text(nwk + "\n")
        return

    for p in msas:
        aln = read_fasta(p)
        if method == "Hamming_FastME":
            with rec.stage("distances", method, p.stem):
                mat = baselines.hamming_distance_matrix(aln, correction="poisson")
        elif method == "ML_FastME":
            with rec.stage("distances", method, p.stem):
                mat = baselines.ml_pairwise_distances(aln)
        elif method == "ml_refine":
            # the start tree is built inside the timed stage, as FastTree's
            # own start is inside its time
            with rec.stage("ml_refine", method, p.stem):
                if args.ml_refine_start == "ml":
                    start = baselines.ml_fastme_tree(aln)
                else:
                    start = baselines.hamming_fastme_tree(aln)
                nwk, _ = baselines.ml_refine(
                    aln, start, spr=True, cat_categories=16,
                    max_sweeps=args.ml_refine_sweeps, spr_radius=args.ml_refine_radius)
            (tree_dir / f"{p.stem}.nwk").write_text(nwk + "\n")
            continue
        elif method == "FastTree":
            with rec.stage("fasttree", method, p.stem):
                nwk = baselines.fasttree_adapter(aln)
            (tree_dir / f"{p.stem}.nwk").write_text(nwk + "\n")
            continue
        else:
            raise SystemExit(f"unknown method {method}")
        phy = matrix_to_phylip(mat, aln.ids)
        (mat_dir / f"{p.stem}.phy").write_text(phy)
        with rec.stage("fastme", method, p.stem):
            nwk = build_tree_from_phylip(phy, "bme", nni=True, spr=True)
        (tree_dir / f"{p.stem}.nwk").write_text(nwk + "\n")


def summarize(out_root: Path, lengths, methods) -> None:
    """Aggregate the topos/dists CSVs into grid_metrics.csv (marker x L x tips)."""
    rows = []
    for L in lengths:
        out_dir = out_root / f"L{L}"
        for method in methods:
            topo_csv = out_dir / f"topos_{method.lower()}.csv"
            if not topo_csv.exists():
                continue
            by_tips = defaultdict(lambda: defaultdict(list))
            with open(topo_csv) as fh:
                for r in csv.DictReader(fh):
                    t = _tips_of(r["id"])
                    by_tips[t]["kf"].append(float(r["kf_score"]))
                    by_tips[t]["nrf"].append(float(r["norm_rf"]))
                    by_tips[t]["wrf"].append(float(r["weighted_rf"]))
            dist_err = defaultdict(lambda: defaultdict(list))
            dist_csv = out_dir / f"dists_{method.lower()}.csv"
            if dist_csv.exists():
                with open(dist_csv) as fh:
                    for r in csv.DictReader(fh):
                        t = _tips_of(r["id"])
                        rd, cd = float(r["ref_dist"]), float(r["cmp_dist"])
                        dist_err[t]["ae"].append(abs(cd - rd))
                        if rd > 0:
                            dist_err[t]["re"].append(abs(cd - rd) / rd)
            for t in sorted(by_tips):
                m = by_tips[t]
                rows.append({
                    "marker": method, "length": L, "tips": t,
                    "n": len(m["kf"]),
                    "mean_kf": np.mean(m["kf"]),
                    "mean_norm_rf": np.mean(m["nrf"]),
                    "mean_wrf": np.mean(m["wrf"]),
                    "dist_mae": np.mean(dist_err[t]["ae"]) if dist_err[t]["ae"] else "",
                    "dist_mre": np.mean(dist_err[t]["re"]) if dist_err[t]["re"] else "",
                })
    if rows:
        with open(out_root / "grid_metrics.csv", "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {out_root / 'grid_metrics.csv'} ({len(rows)} rows)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m phyloformer_tpu_torch.tools.run_grid")
    ap.add_argument("--grid-root", default="data/grid")
    ap.add_argument("--out", default="bench_results/grid")
    ap.add_argument("--lengths", default="250,500,1000")
    ap.add_argument("--methods", default="PF")
    ap.add_argument("--pf-weights", help="PF's weights (anything load_pretrained reads); "
                                         "needed when --methods holds PF")
    ap.add_argument("--pf-marker", default="PF")
    ap.add_argument("--ml-refine-max-tips", type=int, default=1000,
                    help="cost cap; skipped MSAs are listed")
    ap.add_argument("--ml-fastme-max-tips", type=int, default=1000)
    ap.add_argument("--ml-refine-sweeps", type=int, default=3)
    ap.add_argument("--ml-refine-radius", type=int, default=3, help="SPR walk radius")
    ap.add_argument("--ml-refine-start", choices=["hamming", "ml"], default="hamming",
                    help="start-tree distances for ml_refine (built inside the timed stage)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where PF runs (default: the card)")
    ap.add_argument("--summarize-only", action="store_true")
    args = ap.parse_args(argv)

    lengths = [int(x) for x in args.lengths.split(",")]
    methods = [m if m != "PF" else args.pf_marker for m in args.methods.split(",") if m]
    args.max_tips = {"ml_refine": args.ml_refine_max_tips,
                     "ML_FastME": args.ml_fastme_max_tips}

    out_root = Path(args.out)
    if args.pf_marker in methods and not args.pf_weights and not args.summarize_only:
        ap.error("PF needs --pf-weights")
    if args.summarize_only:
        summarize(out_root, lengths, methods)
        return 0

    from ..bench.harness import BenchmarkRecorder
    from ..bench.report import collect_brlen_rows, collect_dist_rows, collect_topo_rows, write_csv
    from ..trees import native

    native.get_lib()  # the native toolkit built (once) before any stage is timed
    for L in lengths:
        length_dir = Path(args.grid_root) / f"L{L}"
        out_dir = out_root / f"L{L}"
        out_dir.mkdir(parents=True, exist_ok=True)
        for method in methods:
            rec = BenchmarkRecorder()
            run_method("PF" if method == args.pf_marker else method, length_dir, out_dir,
                       args, rec)
            # PF writes under matrices_pf/trees_pf: renamed to the marker
            # (a stale directory of an earlier run is replaced)
            if method == args.pf_marker and args.pf_marker != "PF":
                for sub in ("matrices", "trees"):
                    src = out_dir / f"{sub}_pf"
                    dst = out_dir / f"{sub}_{method.lower()}"
                    if src.exists():
                        if dst.exists():
                            shutil.rmtree(dst)
                        src.rename(dst)
            rec.write_csv(out_dir / f"execution_{method.lower()}.csv")
            topo = collect_topo_rows(length_dir / "trees", out_dir / f"trees_{method.lower()}",
                                     method)
            write_csv(out_dir / f"topos_{method.lower()}.csv", topo)
            brlens = collect_brlen_rows(length_dir / "trees",
                                        out_dir / f"trees_{method.lower()}", method)
            write_csv(out_dir / f"brlens_{method.lower()}.csv", brlens)
            mat_dir = out_dir / f"matrices_{method.lower()}"
            if any(mat_dir.glob("*.phy")):
                dist = collect_dist_rows(length_dir / "trees", mat_dir, method)
                write_csv(out_dir / f"dists_{method.lower()}.csv", dist)
            if topo:
                print(f"L{L} {method}: mean KF "
                      f"{np.mean([r['kf_score'] for r in topo]):.4f} over {len(topo)} trees")
            stages = {f"{m}/{i}": v for (m, i), v in rec.group_elapsed().items()}
            with open(out_dir / f"stages_{method.lower()}.json", "w") as fh:
                json.dump({"length": L, "method": method, "stages": stages}, fh)
    summarize(out_root, lengths, methods)
    return 0


if __name__ == "__main__":
    sys.exit(main())
