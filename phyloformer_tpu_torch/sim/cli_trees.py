"""Tree-simulation CLI, mirroring the reference's `simulate_trees.py:183-209`.

    pf-simulate-trees-torch -n 50 -t 20 --type birth-death -o outdir/
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pf-simulate-trees-torch")
    p.add_argument("-n", "--ntrees", type=int, default=50,
                   help="Number of trees to simulate")
    p.add_argument("-t", "--ntips", type=int, default=20,
                   help="Size of the trees to simulate")
    p.add_argument("--type", default="birth-death",
                   choices=["birth-death", "uniform"])
    p.add_argument("-o", "--output", default="trees")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--diam-files", nargs="*", default=None,
                   help="reference empirical diameter pickles (hogenom first, "
                        "then raxml x10); default: shipped quantile prior")
    p.add_argument("--no-heterogeneity", action="store_true",
                   help="disable compound-Poisson branch rate heterogeneity")
    args = p.parse_args(argv)

    from .trees import TreeSimConfig, simulate_trees

    cfg = TreeSimConfig(
        ntips=args.ntips,
        tree_type=args.type,
        heterogeneity=not args.no_heterogeneity,
    )
    paths = simulate_trees(
        args.output, args.ntrees, cfg, seed=args.seed, diam_files=args.diam_files
    )
    print(f"wrote {len(paths)} trees to {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
