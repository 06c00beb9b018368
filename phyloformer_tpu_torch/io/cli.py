"""pf-ckpt-torch — checkpoint interop.

    pf-ckpt-torch inspect <ckpt|npz|trainer-dir>      # summarize any container
    pf-ckpt-torch export <src> <out.ckpt> [--no-seq2pair]   # -> reference format
    pf-ckpt-torch convert <src> <out.npz>             # -> .npz parameter file

``export`` writes a PyTorch checkpoint with the reference's state-dict schema
(:func:`.ckpt_import.save_reference_checkpoint`), so weights trained with
``pf-train-torch`` load in the reference tooling; ``convert`` writes the
``.npz`` that both packages read.  A trainer directory is the port's or the
JAX trainer's (Orbax, read with ``tensorstore``).  The same commands and
output as the JAX package's ``pf-ckpt``.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pf-ckpt-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    p_i = sub.add_parser("inspect", help="summarize a checkpoint")
    p_i.add_argument("path")
    p_e = sub.add_parser("export", help="write a reference-format torch .ckpt")
    p_e.add_argument("src", help="source: reference .ckpt, .npz, or a trainer directory of "
                          "either package")
    p_e.add_argument("out")
    p_e.add_argument("--no-seq2pair", action="store_true",
                     help="omit the non-learnable seq2pair buffer")
    p_c = sub.add_parser("convert", help="write a .npz parameter file")
    p_c.add_argument("src")
    p_c.add_argument("out")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..models.params import count_params
    from .checkpoint import save_params_npz
    from .ckpt_import import load_pretrained, save_reference_checkpoint

    params, cfg, meta = load_pretrained(args.path if args.cmd == "inspect" else args.src)

    if args.cmd == "inspect":
        print(json.dumps({
            "config": {"n_blocks": cfg.n_blocks, "n_heads": cfg.n_heads,
                       "embed_dim": cfg.embed_dim, "dropout": cfg.dropout},
            "learnable_params": count_params(params),
            "metadata_keys": sorted(str(k) for k in meta)[:20],
        }, indent=2))
    elif args.cmd == "export":
        save_reference_checkpoint(args.out, params, cfg, include_seq2pair=not args.no_seq2pair)
        print(f"wrote reference-format checkpoint -> {args.out}", file=sys.stderr)
    else:
        save_params_npz(args.out, params)
        print(f"wrote params npz -> {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
