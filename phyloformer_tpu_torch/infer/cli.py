"""Inference CLI — evolutionary distances (and optional trees) from MSAs.

    python -m phyloformer_tpu_torch.infer.cli <weights.ckpt> <alndir> -o <outdir> [--trees]

Writes one 10-decimal PHYLIP distance matrix per alignment (``<stem>.phy``),
optionally a neighbour-joining tree (``--trees``, ``<stem>.nj.nwk``) and the
native BME+NNI+SPR tree (``--fastme``, ``<stem>.nwk``).  The weights are a
reference ``.ckpt``, an ``.npz`` or a ``pf-train-torch`` checkpoint
directory.  Runs the hand-written kernels on the card unless ``--eager``
(the eager model) or ``--device cpu`` is given; ``--pallas`` names the
kernels explicitly, so a JAX ``pf-infer`` command line runs unchanged.

Over several ranks (one process per card, started with ``torchrun``, or
processes given torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``): ``--distributed-init`` joins the process group (nccl on
the card, gloo on the CPU; ``--distributed-init gloo`` runs gloo on the
card), ``--mesh-data`` / ``--mesh-pair`` shape the ranks into a mesh
(:class:`..infer.engine.ShardedInferenceEngine`; rank 0 writes the
outputs), and ``--multihost`` instead splits the files over the ranks,
each writing its own::

    torchrun --nproc-per-node 4 -m phyloformer_tpu_torch.infer.cli W alns/ \
        --distributed-init --mesh-pair 4
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
    parser.add_argument("--stats", action="store_true",
                        help="print the host-clock seconds and counts as JSON")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda = the hand-written kernels on the card (default); "
                             "cpu = their plain PyTorch versions")
    add_distributed_flags(parser)
    parser.add_argument("--multihost", action="store_true",
                        help="split the alignment list over the ranks (each rank runs "
                             "its share alone and writes its own outputs)")
    return parser


def add_distributed_flags(parser: argparse.ArgumentParser) -> None:
    """``--distributed-init``, ``--mesh-data`` and ``--mesh-pair``, as the
    CLIs of the port take them."""
    parser.add_argument("--distributed-init", nargs="?", const="auto", default=None,
                        choices=["auto", "nccl", "gloo"],
                        help="join the torch.distributed process group from torchrun's "
                             "env:// variables first (auto: nccl on the card, gloo on "
                             "the CPU; gloo also runs on the card)")
    parser.add_argument("--mesh-data", type=int, default=None,
                        help="run over a ('data', 'pair') mesh of ranks: data-axis size "
                             "(default: all ranks / --mesh-pair)")
    parser.add_argument("--mesh-pair", type=int, default=1,
                        help="pair-axis mesh size: splits the quadratic pair activations "
                             "over the ranks, for alignments beyond one card's memory")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..device import resolve_device
    from ..parallel.mesh import init_distributed, shutdown_distributed

    device = (init_distributed(args.distributed_init, args.device) if args.distributed_init
              else resolve_device(args.device))
    try:
        return _run(args, device)
    finally:
        shutdown_distributed()


def _run(args, device) -> int:
    from ..data.fasta import has_fasta_ext, read_fasta
    from ..data.phylip import vec_to_phylip
    from ..infer.engine import InferenceConfig, InferenceEngine, ShardedInferenceEngine
    from ..io.ckpt_import import load_pretrained
    from ..parallel.mesh import host_local_slice, make_mesh, world
    from torch import distributed as dist

    meshed = args.mesh_data is not None or args.mesh_pair > 1
    if args.multihost and meshed:
        raise ValueError("--multihost splits the files over the ranks; --mesh-data and "
                         "--mesh-pair run every batch on every rank: pass one or the other")
    # a world of several ranks runs a mesh (data parallel by default) unless
    # the files are split
    mesh = make_mesh(args.mesh_data, args.mesh_pair) if (
        meshed or (world()[1] > 1 and not args.multihost)) else None
    writes = mesh is None or mesh.rank == 0
    in_dir = os.path.abspath(args.alndir)
    out_dir = os.path.abspath(args.outdir) if args.outdir else os.path.join(in_dir, "predictions")
    if writes:
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
    if args.multihost:
        start, stop = host_local_slice(len(paths))
        paths = paths[start:stop]
        if not paths:
            return 0

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
    if mesh is not None:
        if writes:
            print(f"mesh: {dict(mesh.shape)}", file=sys.stderr)
        engine = ShardedInferenceEngine(params, cfg, mesh, icfg, device=device)
    else:
        engine = InferenceEngine(params, cfg, icfg, device=device)

    t1 = time.perf_counter()
    preds = engine.predict(alns)
    infer_s = time.perf_counter() - t1
    if not writes:
        return 0

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
            mesh=None if mesh is None else dict(mesh.shape),
            backend=dist.get_backend() if dist.is_initialized() else None,
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
