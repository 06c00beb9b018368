"""Build the mixed-length pretraining corpus, re-runnable.

For each length class of ``LENGTH_COUNTS`` (times ``--scale``): birth-death
trees with tips spread evenly over ``TIPS_RANGE`` and the hogenom diameter
prior (``pf-simulate-trees-torch``'s, seed ``--seed + L + tips``); LG+GC
alignments of that length evolved on them by the batched evolver on the card
(``pf-simulate-alignments-torch --engine device``, seed ``--seed + 7 * L``);
packed with ``pf-preprocess-torch``; then every class merged by
:mod:`.merge_packed` into one loader directory.

    python -m phyloformer_tpu_torch.tools.make_corpus OUT [--seed 20250821] [--scale 1.0] \\
        [--batch-size 64] [--skip-trees] [--skip-msas] [--device cpu]

Writes ``OUT/{trees_L*,msas_L*,packed_L*,packed_all}``; train on it with
``pf-train-torch --packed-data OUT/packed_all``.  The alignments are evolved
on the card unless ``--device cpu`` is given.  The JAX package's
``tools/make_corpus.py``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from . import run_module

# the composition of the pretraining corpus: {250: ~61%, 500: ~26%, 1000: ~13%}
LENGTH_COUNTS = {250: 63_000, 500: 26_000, 1000: 13_500}
TIPS_RANGE = range(10, 51)


def sim_trees(outdir: Path, total: int, seed: int) -> None:
    """``total`` trees spread evenly over ``TIPS_RANGE`` (the first classes
    take one more), tips class ``t`` from seed ``seed + t``."""
    from ..sim.trees import TreeSimConfig, simulate_trees

    per_tips = total // len(TIPS_RANGE)
    extra = total - per_tips * len(TIPS_RANGE)
    t0 = time.time()
    for j, ntips in enumerate(TIPS_RANGE):
        n = per_tips + (1 if j < extra else 0)
        simulate_trees(outdir, n, TreeSimConfig(ntips=ntips), seed=seed + ntips)
    print(f"  {total} trees -> {outdir} in {time.time() - t0:.0f}s", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m phyloformer_tpu_torch.tools.make_corpus")
    p.add_argument("outdir")
    p.add_argument("--seed", type=int, default=20250821)
    p.add_argument("--scale", type=float, default=1.0, help="multiply every length-class count")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--skip-trees", action="store_true")
    p.add_argument("--skip-msas", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the alignments are evolved (default: the card)")
    args = p.parse_args(argv)
    if not args.skip_msas:  # the evolver's device, before any tree is drawn
        from ..device import resolve_device

        resolve_device(args.device)

    out = Path(args.outdir)
    out.mkdir(parents=True, exist_ok=True)

    for L, count in LENGTH_COUNTS.items():
        count = int(count * args.scale)
        tdir, mdir, pdir = out / f"trees_L{L}", out / f"msas_L{L}", out / f"packed_L{L}"
        if not args.skip_trees:
            print(f"[trees] L={L} n={count}", flush=True)
            sim_trees(tdir, count, args.seed + L)
        if not args.skip_msas:
            print(f"[msas] L={L} device engine", flush=True)
            t0 = time.time()
            r = run_module("phyloformer_tpu_torch.sim.cli_msa",
                           [tdir, mdir, "-l", L, "-s", "LG", "-g", "GC", "--engine", "device",
                            "--batch-size", args.batch_size, "--seed", args.seed + 7 * L,
                            "--device", args.device])
            n_fail = r.stderr.count("\n  (")  # the failure summary's lines
            tail = r.stderr.strip().splitlines()[-1] if r.stderr.strip() else ""
            print(f"  rc={r.returncode} {tail!r} (~{n_fail} failed) "
                  f"in {time.time() - t0:.0f}s", flush=True)
            if r.returncode not in (0, 1):  # 1: some trees kept duplicate rows
                print(r.stderr[-2000:], file=sys.stderr)
                return r.returncode
        print(f"[pack] L={L}", flush=True)
        r = run_module("phyloformer_tpu_torch.train.cli_preprocess",
                       ["-t", tdir, "-a", mdir, "-o", pdir])
        if r.returncode != 0:
            print(r.stderr[-2000:], file=sys.stderr)
            return r.returncode
        print(f"  {r.stdout.strip()}", flush=True)

    r = run_module("phyloformer_tpu_torch.tools.merge_packed",
                   [out / "packed_all"] + [out / f"packed_L{L}" for L in LENGTH_COUNTS])
    print(r.stdout.strip() or r.stderr.strip(), flush=True)
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
