"""pf-msa-torch — alignment manipulation CLI (goalign-equivalent surface).

    pf-msa-torch stats aln.fa
    pf-msa-torch dedup aln.fa -o out.fa
    pf-msa-torch trim aln.fa -o out.fa --length 250 [--start 0]
    pf-msa-torch subset aln.fa -o out.fa --ids T1 T2 T3
    pf-msa-torch sample aln.fa -o out.fa -n 10 [--seed 0]
    pf-msa-torch degap aln.fa -o out.fa [--max-gap-frac 0.5]

Host numpy only: it imports no torch and runs without a card.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pf-msa-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def io_parser(name, **kw):
        sp = sub.add_parser(name, **kw)
        sp.add_argument("alignment")
        if name != "stats":
            sp.add_argument("-o", "--output", required=True)
        return sp

    io_parser("stats", help="print alignment statistics JSON")
    io_parser("dedup", help="drop duplicate sequences")
    t = io_parser("trim", help="keep a column window")
    t.add_argument("--length", type=int, required=True)
    t.add_argument("--start", type=int, default=0)
    s = io_parser("subset", help="select sequences by id")
    s.add_argument("--ids", nargs="+", required=True)
    sa = io_parser("sample", help="random subsample of sequences")
    sa.add_argument("-n", type=int, required=True)
    sa.add_argument("--seed", type=int, default=None)
    d = io_parser("degap", help="drop gappy columns")
    d.add_argument("--max-gap-frac", type=float, default=0.0)

    args = p.parse_args(argv)

    from .fasta import read_fasta, write_fasta
    from . import msa_tools as mt

    aln = read_fasta(args.alignment, strict=False)

    if args.cmd == "stats":
        print(json.dumps(mt.stats(aln)))
        return 0
    if args.cmd == "dedup":
        out, dropped = mt.dedup(aln)
        if dropped:
            print(f"dropped {len(dropped)} duplicates: {dropped[:5]}...", file=sys.stderr)
    elif args.cmd == "trim":
        out = mt.trim(aln, args.length, args.start)
    elif args.cmd == "subset":
        out = mt.subset(aln, args.ids)
    elif args.cmd == "sample":
        out = mt.sample(aln, args.n, args.seed)
    elif args.cmd == "degap":
        out = mt.remove_gap_columns(aln, args.max_gap_frac)
    else:
        return 2
    write_fasta(args.output, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
