"""Benchmark CLI of the port.

    pf-bench-torch pipeline CKPT <alndir> [--true-trees dir] [-o exec.csv]
    pf-bench-torch crossmatrix --models CKPT... --datasets name=msa_dir:tree_dir... -o DIR
    pf-bench-torch report <true_trees> <matrices> <cmp_trees> -o DIR [--figures]
    pf-bench-torch figures -o DIR [--topos ...] [--dists ...] [--brlens ...] [--exec ...]
    pf-bench-torch manifest <data_dir> -o DIR
    pf-bench-torch accuracy-grid [--weights CKPT] [--grid 50x250,200x1000] [--reps 2]
    pf-bench-torch throughput CKPT [--tips 60] [--length 250] [--count 256]

The commands that run the model (pipeline, crossmatrix, accuracy-grid,
throughput) run on the card unless ``--device cpu`` is given; pipeline and
crossmatrix take ``pf-infer-torch``'s routes: the hand-written kernels by
default (``--pallas`` names them, so a JAX ``pf-bench`` command line runs
unchanged), ``--eager`` the eager model.  ``--precision`` is the engine's
``matmul_precision``.  report, figures and manifest run on the host;
figures, manifest (the reference's 43-figure roster), ``report --figures``
and crossmatrix's heatmap need matplotlib.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

PRECISIONS = ("float32", "tensorfloat32", "default")
_DEFAULT_WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "artifacts", "pf_mre_r5.ckpt")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pf-bench-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pp = sub.add_parser("pipeline", help="timed end-to-end inference->tree pipeline")
    pp.add_argument("weights")
    pp.add_argument("alndir")
    pp.add_argument("--true-trees", default=None)
    pp.add_argument("-o", "--output-csv", default=None)
    pp.add_argument("--marker", default="PF")
    pp.add_argument("--precision", default="float32", choices=PRECISIONS,
                    help="matmul precision of the kernels' products")
    _route_flags(pp)

    pc = sub.add_parser(
        "crossmatrix",
        help="model-misspecification matrix: every checkpoint x every dataset",
    )
    pc.add_argument("--models", nargs="+", required=True,
                    help="checkpoints (name=path or path; stem used as name)")
    pc.add_argument("--datasets", nargs="+", required=True,
                    help="datasets as name=msa_dir:tree_dir")
    pc.add_argument("-o", "--outdir", required=True)
    pc.add_argument("--precision", default="float32", choices=PRECISIONS,
                    help="matmul precision of the kernels' products")
    _route_flags(pc)

    pr = sub.add_parser("report", help="emit topos/dists/brlens CSVs + summary")
    pr.add_argument("true_trees")
    pr.add_argument("matrices")
    pr.add_argument("cmp_trees")
    pr.add_argument("-o", "--outdir", required=True)
    pr.add_argument("--marker", default="PF")
    pr.add_argument("--figures", action="store_true")

    pf = sub.add_parser(
        "figures",
        help="render the make_plots.py figure families from benchmark CSVs",
    )
    pf.add_argument("-o", "--outdir", required=True)
    pf.add_argument("--topos", nargs="*", default=[],
                    help="topos_*.csv files (any markers)")
    pf.add_argument("--dists", nargs="*", default=[], help="dists_*.csv files")
    pf.add_argument("--brlens", nargs="*", default=[], help="brlens_*.csv files")
    pf.add_argument("--exec", dest="exec_csvs", nargs="*", default=[],
                    help="execution_*.csv files")
    pf.add_argument("--likelihoods", nargs="*", default=[],
                    help="likelihoods_*.csv files")
    pf.add_argument("--datasets", nargs="*", default=[],
                    help="fine-tuned panels: name=topos.csv[,topos2.csv...]")
    pf.add_argument("--metrics", nargs="*",
                    default=["norm_rf", "kf_score", "weighted_rf"])

    pa = sub.add_parser("accuracy-grid",
                        help="reduced-precision drift vs an fp32 oracle across (n, L) corners")
    pa.add_argument("--weights", default=_DEFAULT_WEIGHTS)
    pa.add_argument("--grid", default=None,
                    help="comma-separated nxL corners, e.g. '50x250,200x1000' "
                         "(default: the single-card envelope)")
    pa.add_argument("--reps", type=int, default=2)
    pa.add_argument("--seed", type=int, default=0)
    pa.add_argument("--max-rel", type=float, default=0.01,
                    help="fail (exit 1) if any corner's relative drift exceeds this")
    pa.add_argument("--device", choices=["cuda", "cpu"], default="cuda")

    pt = sub.add_parser("throughput", help="synthetic-throughput benchmark")
    pt.add_argument("weights")
    pt.add_argument("--tips", type=int, default=60)
    pt.add_argument("--length", type=int, default=250)
    pt.add_argument("--count", type=int, default=256)
    pt.add_argument("--precision", default="tensorfloat32", choices=PRECISIONS,
                    help="matmul precision of the kernels' products")
    pt.add_argument("--batch-tokens", type=int, default=1 << 23)
    pt.add_argument("--device", choices=["cuda", "cpu"], default="cuda")

    pm = sub.add_parser(
        "manifest",
        help="render the reference's full 43-figure roster from a data dir "
             "holding topos_*/dists_*/execution_*/likelihoods_*/brlens_* CSVs",
    )
    pm.add_argument("data_dir")
    pm.add_argument("-o", "--outdir", required=True)
    return p


def _route_flags(parser: argparse.ArgumentParser) -> None:
    """``pf-infer-torch``'s route and device flags."""
    route = parser.add_mutually_exclusive_group()
    route.add_argument("--pallas", action="store_true",
                       help="the hand-written kernels (the default)")
    route.add_argument("--eager", action="store_true", help="the eager model")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda = the card (default); cpu = the kernels' plain "
                             "PyTorch versions, or the eager model")


def _pipeline(args) -> int:
    from ..device import resolve_device
    from .harness import run_pipeline_benchmark

    summary = run_pipeline_benchmark(
        args.weights,
        args.alndir,
        out_csv=args.output_csv,
        marker=args.marker,
        true_tree_dir=args.true_trees,
        engine_kwargs={"matmul_precision": args.precision, "use_kernels": not args.eager},
        device=resolve_device(args.device),
    )
    stages = {f"{m}/{i}": v for (m, i), v in summary.pop("stages").items()}
    summary["stages"] = stages
    print(json.dumps(summary, indent=2))
    return 0


def _crossmatrix(args) -> int:
    from pathlib import Path

    from ..device import resolve_device
    from .crossmatrix import run_crossmatrix

    models = {}
    for spec in args.models:
        if "=" in spec:
            name, path = spec.split("=", 1)
        else:
            name, path = Path(spec).stem, spec
        models[name] = path
    datasets = {}
    for spec in args.datasets:
        name, rest = spec.split("=", 1)
        msa_dir, tree_dir = rest.split(":", 1)
        datasets[name] = (msa_dir, tree_dir)
    summary = run_crossmatrix(models, datasets, args.outdir, precision=args.precision,
                              use_kernels=not args.eager, device=resolve_device(args.device))
    print(json.dumps(summary, indent=2))
    return 0


def _report(args) -> int:
    from .report import full_report

    summary = full_report(
        args.true_trees, args.matrices, args.cmp_trees, args.outdir,
        marker=args.marker, make_figures=args.figures,
    )
    print(json.dumps(summary, indent=2))
    return 0


def _figures(args) -> int:
    from pathlib import Path

    from . import figures as F

    out = Path(args.outdir)
    out.mkdir(parents=True, exist_ok=True)
    made = []
    if args.topos:
        for metric in args.metrics:
            F.topology_by_tips(args.topos, out / f"topo_{metric}.pdf", metric)
            F.metric_lines_by_length(args.topos, out / f"lines_{metric}.pdf", metric)
            made += [f"topo_{metric}.pdf", f"lines_{metric}.pdf"]
    if args.dists:
        for d in args.dists:
            stem = Path(d).stem
            F.distance_error_panels(d, out / f"{stem}_errors.pdf")
            made.append(f"{stem}_errors.pdf")
        F.distance_hist_grid(args.dists, out / "dist_hist_grid.pdf")
        made.append("dist_hist_grid.pdf")
    for b in args.brlens:
        stem = Path(b).stem
        F.branch_length_scatter(b, out / f"{stem}_scatter.pdf")
        made.append(f"{stem}_scatter.pdf")
    if args.exec_csvs:
        F.runtime_bars(args.exec_csvs, out / "runtime.pdf")
        made.append("runtime.pdf")
    if args.likelihoods:
        F.likelihood_violins(args.likelihoods, out / "likelihoods.pdf")
        made.append("likelihoods.pdf")
    if args.datasets:
        ds = {}
        for spec in args.datasets:
            name, paths = spec.split("=", 1)
            ds[name] = paths.split(",")
        F.finetuned_panels(ds, out / "finetuned_panels.pdf", tuple(args.metrics))
        made.append("finetuned_panels.pdf")
    print(json.dumps({"outdir": str(out), "figures": made}))
    return 0


def _accuracy_grid(args) -> int:
    from ..device import resolve_device
    from .accuracy import DEFAULT_GRID, check_rows, drift_grid

    device = resolve_device(args.device)
    grid = DEFAULT_GRID
    if args.grid:
        grid = tuple(tuple(int(v) for v in corner.lower().split("x"))
                     for corner in args.grid.split(","))
    rows = drift_grid(args.weights, grid, reps=args.reps, seed=args.seed, device=device,
                      on_row=lambda r: print(json.dumps(r), flush=True))
    ok, msg = check_rows(rows, args.max_rel)
    print(msg)
    return 0 if ok else 1


def _throughput(args) -> int:
    import numpy as np
    import torch

    from ..data.fasta import Alignment
    from ..device import resolve_device
    from ..infer.engine import InferenceConfig, InferenceEngine
    from ..io.ckpt_import import load_pretrained

    device = resolve_device(args.device)
    params, cfg, _ = load_pretrained(args.weights)
    engine = InferenceEngine(params, cfg, InferenceConfig(
        matmul_precision=args.precision, max_batch_tokens=args.batch_tokens), device=device)
    rng = np.random.default_rng(0)
    alns = [Alignment(codes=rng.integers(0, 20, (args.tips, args.length)).astype(np.int8),
                      ids=[f"T{j}" for j in range(args.tips)])
            for _ in range(args.count)]
    engine.predict(alns[:4])  # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.predict(alns)
    elapsed = time.perf_counter() - t0
    print(json.dumps({
        "alignments": args.count, "elapsed_s": round(elapsed, 3),
        "alignments_per_s": round(args.count / elapsed, 3), "tips": args.tips,
        "length": args.length, "precision": args.precision, "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }))
    return 0


def _manifest(args) -> int:
    from .manifest import render_all, require_matplotlib

    require_matplotlib()
    rendered = render_all(args.data_dir, args.outdir)
    print(json.dumps({
        "outdir": args.outdir,
        "rendered": sorted(k for k, v in rendered.items() if v),
        "skipped_missing_inputs": sorted(k for k, v in rendered.items() if v is None),
    }, indent=2))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    commands = {"pipeline": _pipeline, "crossmatrix": _crossmatrix, "report": _report,
                "figures": _figures, "manifest": _manifest, "accuracy-grid": _accuracy_grid,
                "throughput": _throughput}
    return commands[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
