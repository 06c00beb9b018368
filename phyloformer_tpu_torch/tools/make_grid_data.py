"""Simulate the benchmark grid's input data: one tree set, evolved at each length.

One set of ``--reps`` birth-death trees of each tips count in ``TIPS`` (seed
``--seed + tips``), evolved at each length in ``LENGTHS`` under LG+GC by
``pf-simulate-alignments-torch --engine native`` (the host's engine; seed
``--seed + 7 * length``) with duplicate rejection raised to 60 attempts.  The
layout is what :mod:`.run_grid` reads with ``--grid-root``:
``OUT/L<length>/{trees,msas}``, and the tree set itself in ``OUT/trees``.

    python -m phyloformer_tpu_torch.tools.make_grid_data OUT [--seed 31000] [--reps 5]

Host only: the native engine needs no card.  The JAX package's
``tools/make_grid_data.py``.
"""

from __future__ import annotations

import argparse
import shutil
import sys
import time
from pathlib import Path

from . import run_module

TIPS = (10, 20, 40, 60, 80, 100)
LENGTHS = (250, 500, 1000)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m phyloformer_tpu_torch.tools.make_grid_data")
    ap.add_argument("outdir")
    ap.add_argument("--seed", type=int, default=31000)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    out = Path(args.outdir)
    tree_master = out / "trees"
    from ..sim.trees import TreeSimConfig, simulate_trees

    for t in TIPS:
        simulate_trees(tree_master, args.reps, TreeSimConfig(ntips=t), seed=args.seed + t)
    print(f"simulated {args.reps * len(TIPS)} trees -> {tree_master}", flush=True)

    for L in LENGTHS:
        ldir = out / f"L{L}"
        ltrees = ldir / "trees"
        if ltrees.exists():
            shutil.rmtree(ltrees)
        shutil.copytree(tree_master, ltrees)
        t0 = time.time()
        r = run_module("phyloformer_tpu_torch.sim.cli_msa",
                       [ltrees, ldir / "msas", "-l", L, "-s", "LG", "-g", "GC",
                        "--engine", "native", "--max-attempts", 60,
                        "--seed", args.seed + 7 * L])
        tail = r.stderr.strip().splitlines()[-1] if r.stderr.strip() else ""
        print(f"L{L}: rc={r.returncode} {tail!r} in {time.time() - t0:.0f}s", flush=True)
        if r.returncode not in (0, 1):  # 1: some trees kept duplicate rows
            print(r.stderr[-2000:], file=sys.stderr)
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
