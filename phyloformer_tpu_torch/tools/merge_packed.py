"""Merge several ``pf-preprocess-torch`` shard directories into one corpus.

The mixed-length corpus is packed per length class (``pf-preprocess-torch``
once a length, so that tree and alignment stems pair within each class); the
packed loader takes one directory, so this tool hard-links the shards under
unique names and writes a combined manifest.

    python -m phyloformer_tpu_torch.tools.merge_packed OUT_DIR SRC_DIR [SRC_DIR ...]

Host only.  A copy of the JAX package's ``tools/merge_packed.py``.
"""

import json
import os
import sys
from pathlib import Path


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    out = Path(argv[0])
    out.mkdir(parents=True, exist_ok=True)
    manifest = {"n_examples": 0, "shards": []}
    for src_i, src in enumerate(map(Path, argv[1:])):
        src_manifest = json.loads((src / "manifest.json").read_text())
        for shard in src_manifest["shards"]:
            new = f"m{src_i}_{shard}"
            for ext in (".codes.npy", ".dists.npy", ".index.json"):
                dst = out / f"{new}{ext}"
                if dst.exists():
                    dst.unlink()
                os.link(src / f"{shard}{ext}", dst)
            manifest["shards"].append(new)
        manifest["n_examples"] += src_manifest["n_examples"]
    (out / "manifest.json").write_text(json.dumps(manifest))
    print(f"merged {len(manifest['shards'])} shards, "
          f"{manifest['n_examples']} examples -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
