"""pf-preprocess-torch: pack a (trees, alignments) corpus into binary shards.

    pf-preprocess-torch -t trees/ -a msas/ -o packed/ [--shard-size 512] [-r REGEX]
    python -m phyloformer_tpu_torch.train.cli_preprocess ...

The arguments and the shard format of the JAX package's ``pf-preprocess``;
``pf-train-torch --packed-data packed/`` trains from the shards.  Runs on the
host only.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pf-preprocess-torch")
    p.add_argument("--trees", "-t", required=True)
    p.add_argument("--alignments", "-a", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--shard-size", type=int, default=512)
    p.add_argument("--regex", "-r", default=None)
    args = p.parse_args(argv)

    from .data import make_pairs
    from .packed import preprocess

    pairs = make_pairs(args.trees, args.alignments, args.regex)
    if not pairs:
        print("no (tree, alignment) pairs found", file=sys.stderr)
        return 1
    out = preprocess(pairs, args.output, shard_size=args.shard_size, progress=True)
    print(json.dumps({"examples": len(pairs), "output": str(out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
