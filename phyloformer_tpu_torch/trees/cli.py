"""Tree-toolkit CLI: build trees from distance matrices, compare tree sets.

The subcommands mirror the native binaries of Phyloformer's pipeline
(FastME, phylocompare) and its likelihood tools:

    pf-tree-torch fastme -i mat.phy -o tree.nwk [--nni] [--spr] [-m bme|nj|bionj]
    pf-tree-torch fastme-dir <matdir> <outdir> [-j N] [...]   # batch
    pf-tree-torch mlrefine aln.fa tree.nwk [-o out.nwk] [--cat 16]
    pf-tree-torch likelihood aln.fa tree.nwk [--gamma-alpha 1.0]
    pf-tree-torch compare <ref_tree_dir> <cmp_tree_dir> [-o cmp.csv]

Host code only (the C++ toolkit through ctypes, and numpy): nothing here
imports torch, so ``fastme-dir``'s worker processes start from a process
that holds no CUDA context.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def _build_one(spec):
    """Worker for fastme-dir parallelism (module-level for pickling)."""
    path, method, nni, spr = spec
    from .native import build_tree_from_phylip as _btp

    return _btp(Path(path).read_text(), method, nni, spr)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="pf-tree-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_fm = sub.add_parser("fastme", help="distance matrix -> tree")
    p_fm.add_argument("-i", "--input", required=True)
    p_fm.add_argument("-o", "--output", default=None)
    p_fm.add_argument("-m", "--method", default="bme", choices=["bme", "nj", "bionj"])
    p_fm.add_argument("--nni", action="store_true")
    p_fm.add_argument("--spr", action="store_true")

    p_fd = sub.add_parser("fastme-dir", help="batch: every .phy in a directory")
    p_fd.add_argument("matdir")
    p_fd.add_argument("outdir")
    p_fd.add_argument("-m", "--method", default="bme", choices=["bme", "nj", "bionj"])
    p_fd.add_argument("--nni", action="store_true")
    p_fd.add_argument("--spr", action="store_true")
    p_fd.add_argument("-j", "--jobs", type=int, default=None,
                      help="parallel workers (default: CPU count)")

    p_ml = sub.add_parser(
        "mlrefine",
        help="approximate-ML refinement: likelihood-scored NNI + SPR "
             "(+ optional CAT rate categories) — the FastTree-class baseline",
    )
    p_ml.add_argument("alignment")
    p_ml.add_argument("tree")
    p_ml.add_argument("-o", "--output", default=None)
    p_ml.add_argument("--model", default="LG")
    p_ml.add_argument("--gamma-alpha", type=float, default=None)
    p_ml.add_argument("--max-sweeps", type=int, default=3)
    p_ml.add_argument("--no-spr", action="store_true",
                      help="NNI only (round-1 behavior)")
    p_ml.add_argument("--spr-radius", type=int, default=3)
    p_ml.add_argument("--cat", type=int, default=0, metavar="N",
                      help="CAT-style per-site rate categories (e.g. 16); "
                           "0 = homogeneous/gamma")

    p_ll = sub.add_parser("likelihood", help="alignment log-likelihood given a tree")
    p_ll.add_argument("alignment")
    p_ll.add_argument("tree")
    p_ll.add_argument("--model", default="LG")
    p_ll.add_argument("--gamma-alpha", type=float, default=None)
    p_ll.add_argument("--gamma-categories", type=int, default=4)

    p_cmp = sub.add_parser("compare", help="compare matching .nwk trees in two dirs")
    p_cmp.add_argument("refdir")
    p_cmp.add_argument("cmpdir")
    p_cmp.add_argument("-o", "--output", default=None)
    p_cmp.add_argument("--include-external", action="store_true")

    args = parser.parse_args(argv)

    from .native import build_tree_from_phylip, compare_newick

    if args.cmd == "fastme":
        nwk = build_tree_from_phylip(
            Path(args.input).read_text(), args.method, args.nni, args.spr
        )
        if args.output:
            Path(args.output).write_text(nwk + "\n")
        else:
            print(nwk)
        return 0

    if args.cmd == "fastme-dir":
        import multiprocessing
        import os
        from concurrent.futures import ProcessPoolExecutor

        outdir = Path(args.outdir)
        outdir.mkdir(parents=True, exist_ok=True)
        mats = sorted(Path(args.matdir).glob("*.phy"))
        jobs = args.jobs or os.cpu_count() or 1
        if jobs > 1 and len(mats) > 1:
            # build once up front (build_native is lock-safe; this just
            # saves every worker the wait on its lock); the workers start
            # from a fresh interpreter
            from .native import build_native

            build_native()
            with ProcessPoolExecutor(max_workers=jobs,
                                     mp_context=multiprocessing.get_context("spawn")) as pool:
                for phy, nwk in zip(
                    mats,
                    pool.map(_build_one,
                             [(str(p), args.method, args.nni, args.spr)
                              for p in mats]),
                ):
                    (outdir / (phy.stem + ".nwk")).write_text(nwk + "\n")
        else:
            for phy in mats:
                nwk = build_tree_from_phylip(
                    phy.read_text(), args.method, args.nni, args.spr
                )
                (outdir / (phy.stem + ".nwk")).write_text(nwk + "\n")
        print(f"built {len(mats)} trees -> {outdir}", file=sys.stderr)
        return 0

    if args.cmd == "mlrefine":
        import json

        from ..data.fasta import read_fasta
        from .baselines import ml_refine

        aln = read_fasta(args.alignment, strict=False)
        nwk, ll = ml_refine(
            aln, Path(args.tree).read_text(), model=args.model,
            gamma_alpha=args.gamma_alpha, max_sweeps=args.max_sweeps,
            spr=not args.no_spr, spr_radius=args.spr_radius,
            cat_categories=args.cat,
        )
        if args.output:
            Path(args.output).write_text(nwk + "\n")
        else:
            print(nwk)
        print(json.dumps({"log_likelihood": ll}), file=sys.stderr)
        return 0

    if args.cmd == "likelihood":
        import json

        from ..data.fasta import read_fasta
        from ..data.newick import read_newick
        from ..sim.models import get_model
        from .likelihood import log_likelihood

        aln = read_fasta(args.alignment, strict=False)
        tree = read_newick(args.tree)
        ll = log_likelihood(
            aln, tree, get_model(args.model),
            gamma_alpha=args.gamma_alpha, gamma_categories=args.gamma_categories,
        )
        print(json.dumps({"log_likelihood": ll, "model": args.model,
                          "n_seqs": aln.n_seqs, "seq_len": aln.seq_len}))
        return 0

    if args.cmd == "compare":
        rows = ["id,rf,norm_rf,weighted_rf,kf_score,n_common"]
        kf_sum, count = 0.0, 0
        for ref in sorted(Path(args.refdir).glob("*.nwk")):
            stem = ref.stem
            cand = None
            for alt in (f"{stem}.nwk", f"{stem}.nj.nwk", f"{stem}.bme.nwk"):
                p = Path(args.cmpdir) / alt
                if p.exists():
                    cand = p
                    break
            if cand is None:
                continue
            r = compare_newick(ref.read_text(), cand.read_text(), args.include_external)
            rows.append(
                f"{stem},{r.rf:g},{r.norm_rf:g},{r.weighted_rf:g},{r.kf:g},{r.n_common}"
            )
            kf_sum += r.kf
            count += 1
        csv = "\n".join(rows) + "\n"
        if args.output:
            Path(args.output).write_text(csv)
        else:
            print(csv, end="")
        if count:
            print(f"mean kf over {count} trees: {kf_sum / count:.3f}", file=sys.stderr)
        return 0

    return 2


if __name__ == "__main__":
    sys.exit(main())
