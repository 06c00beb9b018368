"""Coevolution (CherryML-style) MSA simulation CLI — the ``simcherry.sh``
pipeline (the reference's `bin/simcherry.sh:23-38`) without external deps.

    pf-simulate-coevolution-torch trees/ msas/ --seqlen 500
    pf-simulate-coevolution-torch trees/ msas/ --rates coevolution.txt \
        --stationary coevolution_stationary.txt
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pf-simulate-coevolution-torch")
    p.add_argument("treedir")
    p.add_argument("outdir")
    p.add_argument("--seqlen", type=int, default=500,
                   help="protein length L (L/2 pair-sites, simcherry convention)")
    p.add_argument("--rates", default=None,
                   help="400-state exchangeability table (CherryML coevolution.txt)")
    p.add_argument("--stationary", default=None,
                   help="stationary distribution file")
    p.add_argument("--coupling", type=float, default=0.5,
                   help="LGxLG product-model coupling when no rate files given")
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)

    import numpy as np

    from ..data.fasta import write_fasta
    from ..data.newick import read_newick
    from .gillespie import (
        coevolution_model_from_files,
        paired_lg_model,
        simulate_coevolution_msa,
    )

    if args.rates and args.stationary:
        model = coevolution_model_from_files(args.rates, args.stationary)
    else:
        model = paired_lg_model(coupling=args.coupling)

    rng = np.random.default_rng(args.seed)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    trees = sorted(Path(args.treedir).glob("*.nwk"))
    if not trees:
        print(f"no trees in {args.treedir}", file=sys.stderr)
        return 1
    for tree_path in trees:
        tree = read_newick(tree_path)
        aln = simulate_coevolution_msa(tree, args.seqlen, model, rng)
        write_fasta(outdir / (tree_path.stem + ".fa"), aln)
    print(f"simulated {len(trees)} coevolution alignments -> {outdir}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
