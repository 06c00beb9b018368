"""Inference CLI — evolutionary distances (and optional trees) from MSAs.

    python -m phyloformer_tpu_torch.infer.cli <weights.ckpt> <alndir> -o <outdir> [--trees]

Writes one 10-decimal PHYLIP distance matrix per alignment (``<stem>.phy``),
optionally a neighbour-joining tree (``--trees``, ``<stem>.nj.nwk``) and the
native BME+NNI+SPR tree (``--fastme``, ``<stem>.nwk``).  The weights are a
reference ``.ckpt``, an ``.npz`` or a ``pf-train-torch`` checkpoint
directory.  Runs the hand-written kernels on the card unless ``--eager``
(the eager model) or ``--device cpu`` is given; ``--pallas`` names the
kernels explicitly, so a JAX ``pf-infer`` command line runs unchanged.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from glob import glob
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="pf-infer-torch",
        description="Infer evolutionary distances with Phyloformer (PyTorch/CUDA)",
    )
    parser.add_argument("weights", help="model weights: reference .ckpt, .npz, or a "
                                        "pf-train-torch checkpoint directory")
    parser.add_argument("alndir", help="directory containing .fa/.fasta alignments")
    parser.add_argument("--outdir", "-o", default=None,
                        help="output directory for .phy distance matrices")
    parser.add_argument("--trees", "-t", action="store_true",
                        help="also write NJ trees (<stem>.nj.nwk)")
    parser.add_argument("--fastme", action="store_true",
                        help="also run the native BME+NNI+SPR search on each "
                             "matrix and write final trees (<stem>.nwk)")
    parser.add_argument("--tree-method", default="bme", choices=["bme", "nj", "bionj"],
                        help="construction method for --fastme")
    parser.add_argument("--precision", choices=["float32", "bfloat16"], default="float32",
                        help="parameter dtype (bfloat16: rounded as the JAX engine casts them)")
    parser.add_argument("--matmul-precision", default="float32",
                        choices=["float32", "tensorfloat32", "default"],
                        help="products of the kernels: float32 = three TF32 passes "
                             "(fp32 grade); tensorfloat32 and default = one TF32 pass")
    route = parser.add_mutually_exclusive_group()
    route.add_argument("--pallas", action="store_true",
                       help="the hand-written kernels (the default)")
    route.add_argument("--eager", action="store_true", help="the eager model")
    parser.add_argument("--gelu", choices=["exact", "tanh"], default="exact",
                        help="FFN activation: exact = erf GELU; tanh = the tanh "
                             "approximation")
    parser.add_argument("--batch-tokens", type=int, default=1 << 22,
                        help="max pair-site tokens per device batch")
    parser.add_argument("--max-batch-size", type=int, default=64)
    parser.add_argument("--no-bucketing", action="store_true",
                        help="run every alignment at its exact shape")
    parser.add_argument("--stats", action="store_true", help="print timing stats JSON")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda = the hand-written kernels on the card (default); "
                             "cpu = their plain PyTorch versions")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..data.fasta import has_fasta_ext, read_fasta
    from ..data.phylip import vec_to_phylip
    from ..device import resolve_device
    from ..infer.engine import InferenceConfig, InferenceEngine
    from ..io.ckpt_import import load_pretrained

    device = resolve_device(args.device)
    in_dir = os.path.abspath(args.alndir)
    out_dir = os.path.abspath(args.outdir) if args.outdir else os.path.join(in_dir, "predictions")
    os.makedirs(out_dir, exist_ok=True)

    t0 = time.perf_counter()
    params, cfg, _ = load_pretrained(args.weights)
    load_s = time.perf_counter() - t0

    paths = [p for p in sorted(glob(os.path.join(in_dir, "*"))) if os.path.isfile(p)]
    for p in paths:
        if not has_fasta_ext(p):
            raise ValueError(f"Input files must be fasta files (.fa or .fasta). Got {p}")
    if not paths:
        print(f"no alignments found in {in_dir}", file=sys.stderr)
        return 1

    alns, kept_paths, skipped = [], [], []
    for p in paths:
        try:
            alns.append(read_fasta(p))
            kept_paths.append(p)
        except ValueError as e:
            skipped.append(p)
            print(f"pf-infer: skipping {p}: {e}", file=sys.stderr)
    paths = kept_paths
    if not alns:
        print("pf-infer: no readable alignments", file=sys.stderr)
        return 1

    common = dict(max_batch_tokens=args.batch_tokens, max_batch_size=args.max_batch_size,
                  pipeline_gelu=args.gelu, matmul_precision=args.matmul_precision,
                  precision=args.precision, use_kernels=not args.eager)
    if args.no_bucketing:
        icfg = InferenceConfig(n_buckets=(), l_buckets=(), allow_oversize=True, **common)
    else:
        icfg = InferenceConfig(**common)
    engine = InferenceEngine(params, cfg, icfg, device=device)

    t1 = time.perf_counter()
    preds = engine.predict(alns)
    infer_s = time.perf_counter() - t1

    for path, aln, vec in zip(paths, alns, preds):
        stem = Path(path).stem
        dm, phylip = vec_to_phylip(vec, aln.ids)
        with open(os.path.join(out_dir, f"{stem}.phy"), "w") as fh:
            fh.write(phylip)
        if args.trees:
            from ..trees.nj import neighbor_joining

            tree = neighbor_joining(dm.astype(np.float64), aln.ids)
            with open(os.path.join(out_dir, f"{stem}.nj.nwk"), "w") as fh:
                fh.write(tree.to_newick() + "\n")
        if args.fastme:
            from ..trees.native import build_tree

            nwk = build_tree(dm.astype(np.float64), aln.ids,
                             method=args.tree_method, nni=True, spr=True)
            with open(os.path.join(out_dir, f"{stem}.nwk"), "w") as fh:
                fh.write(nwk + "\n")

    if args.stats:
        stats = dict(engine.stats)
        stats.update(
            device=str(device),
            model_load_s=round(load_s, 4),
            total_infer_s=round(infer_s, 4),
            alignments=len(alns),
            alignments_per_s=round(len(alns) / infer_s, 4) if infer_s else None,
        )
        print(json.dumps(stats))
    if skipped:
        print(f"pf-infer: {len(skipped)} unreadable alignment(s) skipped", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
