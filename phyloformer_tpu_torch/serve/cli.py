"""pf-serve-torch — a long-lived inference service.

    pf-serve-torch WEIGHTS --port 8000 [--precision tensorfloat32]
        [--batch-window-ms 20] [--batch-tokens N] [--eager] [--device cuda|cpu]

Endpoints: ``POST /predict`` (FASTA body → distances JSON, ``?format=phylip``,
``?tree=nj|bme``), ``GET /healthz``.  ``WEIGHTS``: a reference ``.ckpt``, an
``.npz`` or a ``pf-train-torch`` checkpoint directory.  Serves through the
hand-written kernels on the card (``--pallas`` names that default, as the
JAX package's flag does); ``--eager`` serves the eager model instead;
``--device cpu`` runs the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pf-serve-torch")
    p.add_argument("weights")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--precision", default="tensorfloat32",
                   choices=["float32", "tensorfloat32", "default"],
                   help="products: float32 = three TF32 passes; tensorfloat32 and "
                        "default = one TF32 pass")
    route = p.add_mutually_exclusive_group()
    route.add_argument("--pallas", action="store_true",
                       help="the hand-written kernels (the default)")
    route.add_argument("--eager", action="store_true", help="the eager model")
    p.add_argument("--batch-window-ms", type=float, default=20.0)
    p.add_argument("--batch-tokens", type=int, default=1 << 23)
    p.add_argument("--mesh-data", type=int, default=None,
                   help="data-axis size of a device mesh (not yet ported)")
    p.add_argument("--mesh-pair", type=int, default=1,
                   help="pair-axis size of a device mesh (not yet ported)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda = the card (default); cpu = the plain PyTorch versions")
    return p


def build_server(argv=None):
    """Parse ``argv``, load the weights and build the engine and the
    :class:`.server.InferenceServer` (kernels loaded, not yet serving)."""
    args = build_parser().parse_args(argv)
    if (args.mesh_data is not None and args.mesh_data > 1) or args.mesh_pair > 1:
        raise ValueError("serving over a device mesh (--mesh-data, --mesh-pair) is not yet "
                         "ported, see ROADMAP.md")

    from ..infer.engine import InferenceConfig, InferenceEngine
    from ..io.ckpt_import import load_pretrained
    from .server import InferenceServer

    params, cfg, _ = load_pretrained(args.weights)
    icfg = InferenceConfig(
        matmul_precision=args.precision,
        use_kernels=not args.eager,
        max_batch_tokens=args.batch_tokens,
        # batch sizes rounded to powers of two: bursts of requests give a
        # few batch shapes, not one per burst size
        pad_batch_sizes=True,
    )
    engine = InferenceEngine(params, cfg, icfg, device=args.device)
    info = {"model": args.weights, "n_blocks": cfg.n_blocks, "embed_dim": cfg.embed_dim,
            "precision": args.precision}
    return InferenceServer(engine, info, host=args.host, port=args.port,
                           batch_window_ms=args.batch_window_ms)


def main(argv=None) -> int:
    server = build_server(argv)
    print(f"pf-serve-torch listening on {server.httpd.server_address[0]}:{server.port}",
          file=sys.stderr, flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
