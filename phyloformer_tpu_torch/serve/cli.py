"""pf-serve-torch — a long-lived inference service.

    pf-serve-torch WEIGHTS --port 8000 [--precision tensorfloat32]
        [--batch-window-ms 20] [--batch-tokens N] [--eager] [--device cuda|cpu]

Endpoints: ``POST /predict`` (FASTA body → distances JSON, ``?format=phylip``,
``?tree=nj|bme``), ``GET /healthz``.  ``WEIGHTS``: a reference ``.ckpt``, an
``.npz`` or a ``pf-train-torch`` checkpoint directory.  Serves through the
hand-written kernels on the card (``--pallas`` names that default, as the
JAX package's flag does); ``--eager`` serves the eager model instead;
``--device cpu`` runs the kernels' plain versions on the CPU.

Over a mesh of ranks (``torchrun`` or torchrun's ``env://`` variables,
``--distributed-init``, ``--mesh-data`` / ``--mesh-pair``), rank 0 listens
and the other ranks follow it, each micro-batch run sharded on all::

    torchrun --nproc-per-node 2 -m phyloformer_tpu_torch.serve.cli W --distributed-init \
        --mesh-pair 2
"""

from __future__ import annotations

import argparse
import sys

from ..infer.cli import add_distributed_flags


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
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda = the card (default); cpu = the plain PyTorch versions")
    add_distributed_flags(p)
    return p


class Follower:
    """What a rank other than 0 of a mesh serves: :func:`.server.follow`."""

    port = None

    def __init__(self, engine, mesh):
        self.engine, self.mesh = engine, mesh

    def serve_forever(self):
        from .server import follow

        follow(self.engine, self.mesh)

    def shutdown(self):
        pass


def build_server(argv=None):
    """Parse ``argv``, load the weights and build the engine and the
    :class:`.server.InferenceServer` (kernels loaded, not yet serving); on
    a mesh, every rank's kernels are loaded before rank 0 listens, and the
    other ranks get a :class:`Follower`.  A mesh is made where
    ``--mesh-data`` or ``--mesh-pair`` asks for more than one rank, or the
    process group has several."""
    args = build_parser().parse_args(argv)

    from ..infer.engine import InferenceConfig, InferenceEngine, ShardedInferenceEngine
    from ..io.ckpt_import import load_pretrained
    from ..parallel.mesh import init_distributed, make_mesh, world
    from .server import InferenceServer, MeshLeader

    device = (init_distributed(args.distributed_init, args.device) if args.distributed_init
              else args.device)
    mesh = None
    if (args.mesh_data is not None and args.mesh_data > 1) or args.mesh_pair > 1 \
            or world()[1] > 1:
        mesh = make_mesh(args.mesh_data, args.mesh_pair)
    params, cfg, _ = load_pretrained(args.weights)
    icfg = InferenceConfig(
        matmul_precision=args.precision,
        use_kernels=not args.eager,
        max_batch_tokens=args.batch_tokens,
        # batch sizes rounded to powers of two: bursts of requests give a
        # few batch shapes, not one per burst size
        pad_batch_sizes=True,
    )
    if mesh is None:
        engine = InferenceEngine(params, cfg, icfg, device=device)
    else:
        engine = ShardedInferenceEngine(params, cfg, mesh, icfg, device=device)
        if mesh.rank != 0:
            return Follower(engine, mesh)
        engine = MeshLeader(engine, mesh)
    info = {"model": args.weights, "n_blocks": cfg.n_blocks, "embed_dim": cfg.embed_dim,
            "precision": args.precision,
            "mesh": None if mesh is None else dict(mesh.shape)}
    return InferenceServer(engine, info, host=args.host, port=args.port,
                           batch_window_ms=args.batch_window_ms)


def main(argv=None) -> int:
    from ..parallel.mesh import shutdown_distributed

    try:
        server = build_server(argv)
        if server.port is not None:
            print(f"pf-serve-torch listening on {server.httpd.server_address[0]}:"
                  f"{server.port}", file=sys.stderr, flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            server.shutdown()
    finally:
        shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
