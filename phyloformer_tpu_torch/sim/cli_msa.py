"""Alignment-simulation CLI, mirroring the reference's `alisim.py:141-246`
but running the native simulator by default (no IQ-TREE2 dependency).

    pf-simulate-alignments-torch trees/ msas/ --length 500 --substitution LG --gamma GC
    pf-simulate-alignments-torch trees/ msas/ --indels            # +GEO indels
    pf-simulate-alignments-torch trees/ msas/ --engine device     # batched on the card
    pf-simulate-alignments-torch trees/ msas/ --engine device --device cpu
    pf-simulate-alignments-torch trees/ msas/ --engine iqtree2    # external passthrough

``--engine device`` runs on the card unless ``--device cpu`` is given, and
raises without a card.  With ``--indels`` it says so and runs the native
engine, as the JAX package's CLI does.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pf-simulate-alignments-torch")
    p.add_argument("treedir", help="directory containing newick trees")
    p.add_argument("outdir", help="output directory for .fa alignments")
    p.add_argument("-l", "--length", type=int, default=500)
    p.add_argument("-s", "--substitution", default="LG",
                   help="LG | WAG | JTT | Poisson | path to PAML .dat")
    p.add_argument("-g", "--gamma", default=None,
                   help="'GC' (continuous) or 'G<k>' (discrete k categories)")
    p.add_argument("--alpha", type=float, default=None,
                   help="fixed gamma shape (default: sample hogenom prior)")
    p.add_argument("--alpha-file", default=None,
                   help="reference hogenom_alphas.txt pickle for the prior")
    p.add_argument("--mdef", "--custom-model", dest="mdef", default=None,
                   help="IQ-TREE nexus model-definition file (custom "
                        "frequency-mixture model, reference --custom-model)")
    p.add_argument("-i", "--indels", action="store_true")
    p.add_argument("--allow-duplicate-sequences", action="store_true")
    p.add_argument("--max-attempts", type=int, default=20)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--engine", default="native",
                   choices=["native", "device", "iqtree2"],
                   help="native CPU simulator, batched on-device (PyTorch) "
                        "simulator, or external iqtree2 --alisim")
    p.add_argument("--batch-size", type=int, default=64,
                   help="device-engine trees per device batch")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of --engine device (default: the card)")
    p.add_argument("--iqtree2-binary", default="iqtree2")
    args = p.parse_args(argv)

    treedir, outdir = Path(args.treedir), Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    trees = sorted(
        t for t in treedir.iterdir()
        if t.suffix.lower() in (".nwk", ".newick", ".tree", ".treefile")
    )
    if not trees:
        print(f"no trees found in {treedir}", file=sys.stderr)
        return 1

    if args.engine == "iqtree2":
        from .iqtree import alisim_passthrough

        failures = alisim_passthrough(
            trees, outdir, binary=args.iqtree2_binary, length=args.length,
            substitution=args.substitution, gamma=args.gamma,
            indels=args.indels, max_attempts=args.max_attempts,
            mdef=args.mdef,
        )
    else:
        import numpy as np

        from .msa import MsaSimConfig, simulate_msa
        from .priors import alpha_sampler

        rng = np.random.default_rng(args.seed)
        prior = alpha_sampler(args.alpha_file) if args.gamma else None
        cfg = MsaSimConfig(
            substitution=args.substitution,
            length=args.length,
            gamma=args.gamma,
            alpha=args.alpha,
            mdef=args.mdef,
            indels=args.indels,
            max_attempts=args.max_attempts,
            allow_duplicates=args.allow_duplicate_sequences,
        )
        failures = []
        if args.engine == "device":
            if args.indels:
                # indels are sequential per-branch edits — CPU only
                print("--engine device does not support --indels; "
                      "falling back to the native CPU engine", file=sys.stderr)
            else:
                from ..data.fasta import write_fasta
                from ..data.newick import read_newick
                from .device import simulate_msas_device

                nodes = [read_newick(t) for t in trees]
                alns, attempts = simulate_msas_device(
                    nodes, cfg, rng, prior, batch_size=args.batch_size,
                    device=args.device,
                )
                for tree_path, aln, att in zip(trees, alns, attempts):
                    if aln is None:
                        failures.append((str(tree_path), att))
                    else:
                        write_fasta(outdir / (tree_path.stem + ".fa"), aln)
        if args.engine == "native" or (args.engine == "device" and args.indels):
            for tree_path in trees:
                out = outdir / (tree_path.stem + ".fa")
                ok, attempts = simulate_msa(tree_path, out, cfg, rng, prior)
                if not ok:
                    failures.append((str(tree_path), attempts))

    if failures:  # reference failure summary (alisim.py:288-291)
        print(f"{len(failures)} simulations failed:", file=sys.stderr)
        for item in failures:
            print(f"  {item}", file=sys.stderr)
        return 1
    print(f"simulated {len(trees)} alignments -> {outdir}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
