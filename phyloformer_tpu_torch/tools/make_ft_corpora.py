"""Build the fine-tune corpora of the indel and cherry legs.

- indel train: birth-death trees with tips spread over ``TIPS_RANGE``,
  LG+GC alignments of 250 sites with indels (``pf-simulate-alignments-torch
  --indels``, the host's engine), packed with ``pf-preprocess-torch``;
- cherry train: the same tree prior, paired-LG coevolution alignments of 250
  sites (``pf-simulate-coevolution-torch``), packed;
- a held-out test set of 30 trees of 20 tips a leg, with its true trees.

    python -m phyloformer_tpu_torch.tools.make_ft_corpora OUT [--indel-n 6000] \\
        [--cherry-n 4000] [--seed 515000]

Writes ``OUT/{indel,indel_test,cherry,cherry_test}``; a leg already built is
skipped.  Host only.  The JAX package's ``tools/make_ft_corpora.py``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from . import run_module

TIPS_RANGE = range(10, 51)


def sim_trees(outdir: Path, total: int, seed: int, tips=None) -> None:
    """``total`` trees of ``tips`` tips (seed ``seed``), or spread evenly over
    ``TIPS_RANGE`` (tips class ``t`` from seed ``seed + t``)."""
    from ..sim.trees import TreeSimConfig, simulate_trees

    if tips is not None:
        simulate_trees(outdir, total, TreeSimConfig(ntips=tips), seed=seed)
        return
    per = total // len(TIPS_RANGE)
    extra = total - per * len(TIPS_RANGE)
    for j, ntips in enumerate(TIPS_RANGE):
        simulate_trees(outdir, per + (1 if j < extra else 0), TreeSimConfig(ntips=ntips),
                       seed=seed + ntips)


def run(cmd, label):
    """``python -m cmd[0] cmd[1:]``; exits on a return code other than 0 or
    1 (1: some trees kept duplicate rows)."""
    t0 = time.time()
    r = run_module(cmd[0], cmd[1:])
    tail = r.stderr.strip().splitlines()[-1] if r.stderr.strip() else r.stdout.strip()
    print(f"[{label}] rc={r.returncode} {tail!r} in {time.time() - t0:.0f}s", flush=True)
    if r.returncode not in (0, 1):
        print(r.stderr[-1500:], file=sys.stderr)
        raise SystemExit(r.returncode)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m phyloformer_tpu_torch.tools.make_ft_corpora")
    ap.add_argument("outdir")
    ap.add_argument("--indel-n", type=int, default=6000)
    ap.add_argument("--cherry-n", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=515000)
    args = ap.parse_args(argv)
    out = Path(args.outdir)
    msa, coev = "phyloformer_tpu_torch.sim.cli_msa", "phyloformer_tpu_torch.sim.cli_coevolution"
    pack = "phyloformer_tpu_torch.train.cli_preprocess"

    tdir = out / "indel/trees"
    if not (out / "indel/packed/manifest.json").exists():
        print(f"[indel] {args.indel_n} trees", flush=True)
        sim_trees(tdir, args.indel_n, args.seed + 1)
        run([msa, str(tdir), str(out / "indel/msas"), "-l", "250", "-s", "LG", "-g", "GC",
             "--indels", "--seed", str(args.seed + 2)], "indel-msas")
        run([pack, "-t", str(tdir), "-a", str(out / "indel/msas"),
             "-o", str(out / "indel/packed")], "indel-pack")

    ttest = out / "indel_test/trees"
    if not ttest.exists():
        sim_trees(ttest, 30, args.seed + 3, tips=20)
        run([msa, str(ttest), str(out / "indel_test/msas"), "-l", "250", "-s", "LG", "-g", "GC",
             "--indels", "--seed", str(args.seed + 4)], "indel-test")

    tdir = out / "cherry/trees"
    if not (out / "cherry/packed/manifest.json").exists():
        print(f"[cherry] {args.cherry_n} trees", flush=True)
        sim_trees(tdir, args.cherry_n, args.seed + 5)
        run([coev, str(tdir), str(out / "cherry/msas"), "--seqlen", "250",
             "--seed", str(args.seed + 6)], "cherry-msas")
        run([pack, "-t", str(tdir), "-a", str(out / "cherry/msas"),
             "-o", str(out / "cherry/packed")], "cherry-pack")

    ttest = out / "cherry_test/trees"
    if not ttest.exists():
        sim_trees(ttest, 30, args.seed + 7, tips=20)
        run([coev, str(ttest), str(out / "cherry_test/msas"), "--seqlen", "250",
             "--seed", str(args.seed + 8)], "cherry-test")

    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
