"""Benchmark CLI of the port.

    pf-bench-torch accuracy-grid [--weights CKPT] [--grid 50x250,200x1000] [--reps 2]
    pf-bench-torch throughput CKPT [--tips 60] [--length 250] [--count 256]

Both run on the card unless ``--device cpu`` is given.  The JAX package's
other subcommands (pipeline, crossmatrix, report, figures, manifest) are not
yet ported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_NOT_PORTED = ("pipeline", "crossmatrix", "report", "figures", "manifest")
_DEFAULT_WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "artifacts", "pf_mre_r5.ckpt")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pf-bench-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pa = sub.add_parser("accuracy-grid",
                        help="reduced-precision drift vs an fp32 oracle across (n, L) corners")
    pa.add_argument("--weights", default=_DEFAULT_WEIGHTS)
    pa.add_argument("--grid", default=None,
                    help="comma-separated nxL corners, e.g. '50x250,200x1000' "
                         "(default: the single-card envelope)")
    pa.add_argument("--reps", type=int, default=2)
    pa.add_argument("--seed", type=int, default=0)
    pa.add_argument("--max-rel", type=float, default=0.01,
                    help="fail (exit 1) if any corner's relative drift exceeds this")
    pa.add_argument("--device", choices=["cuda", "cpu"], default="cuda")

    pt = sub.add_parser("throughput", help="synthetic-throughput benchmark")
    pt.add_argument("weights")
    pt.add_argument("--tips", type=int, default=60)
    pt.add_argument("--length", type=int, default=250)
    pt.add_argument("--count", type=int, default=256)
    pt.add_argument("--precision", default="tensorfloat32",
                    choices=["float32", "tensorfloat32", "default"],
                    help="matmul precision of the kernels' products")
    pt.add_argument("--batch-tokens", type=int, default=1 << 23)
    pt.add_argument("--device", choices=["cuda", "cpu"], default="cuda")

    for name in _NOT_PORTED:
        sub.add_parser(name, help="not yet ported").add_argument("args", nargs=argparse.REMAINDER)
    return p


def _accuracy_grid(args) -> int:
    from ..device import resolve_device
    from .accuracy import DEFAULT_GRID, check_rows, drift_grid

    device = resolve_device(args.device)
    grid = DEFAULT_GRID
    if args.grid:
        grid = tuple(tuple(int(v) for v in corner.lower().split("x"))
                     for corner in args.grid.split(","))
    rows = drift_grid(args.weights, grid, reps=args.reps, seed=args.seed, device=device,
                      on_row=lambda r: print(json.dumps(r), flush=True))
    ok, msg = check_rows(rows, args.max_rel)
    print(msg)
    return 0 if ok else 1


def _throughput(args) -> int:
    import numpy as np
    import torch

    from ..data.fasta import Alignment
    from ..device import resolve_device
    from ..infer.engine import InferenceConfig, InferenceEngine
    from ..io.ckpt_import import load_pretrained

    device = resolve_device(args.device)
    params, cfg, _ = load_pretrained(args.weights)
    engine = InferenceEngine(params, cfg, InferenceConfig(
        matmul_precision=args.precision, max_batch_tokens=args.batch_tokens), device=device)
    rng = np.random.default_rng(0)
    alns = [Alignment(codes=rng.integers(0, 20, (args.tips, args.length)).astype(np.int8),
                      ids=[f"T{j}" for j in range(args.tips)])
            for _ in range(args.count)]
    engine.predict(alns[:4])  # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.predict(alns)
    elapsed = time.perf_counter() - t0
    print(json.dumps({
        "alignments": args.count, "elapsed_s": round(elapsed, 3),
        "alignments_per_s": round(args.count / elapsed, 3), "tips": args.tips,
        "length": args.length, "precision": args.precision, "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "accuracy-grid":
        return _accuracy_grid(args)
    if args.cmd == "throughput":
        return _throughput(args)
    print(f"pf-bench-torch {args.cmd} is not yet ported, see ROADMAP.md", file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
