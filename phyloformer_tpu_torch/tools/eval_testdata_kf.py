"""A checkpoint's KF on a test set: inference, then the native BME + NNI +
SPR tree, then the Kuhner-Felsenstein distance to each true tree; prints
one JSON line with the mean and the median (and each alignment's KF).

    python -m phyloformer_tpu_torch.tools.eval_testdata_kf WEIGHTS \\
        --msas DIR --trees DIR [--device cpu]

``WEIGHTS`` is anything ``load_pretrained`` reads (a reference ``.ckpt``,
an ``.npz``, a trainer directory of either package).  ``--msas`` holds
``*.fa`` files and ``--trees`` a ``<stem>.nwk`` for each.  Runs on the
card unless ``--device cpu`` is given.  The JAX package's
``tools/eval_testdata_kf.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Sequence


def add_data_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--msas", required=True, help="directory of *.fa alignments")
    ap.add_argument("--trees", required=True, help="directory of <stem>.nwk true trees")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")


def read_test_set(msas_dir, trees_dir):
    """``(stems, alignments, true Newick texts)`` of a test set, by stem."""
    from ..data.fasta import read_fasta

    paths = sorted(Path(msas_dir).glob("*.fa"))
    if not paths:
        raise FileNotFoundError(f"no *.fa alignments in {msas_dir}")
    return ([p.stem for p in paths], [read_fasta(p) for p in paths],
            [(Path(trees_dir) / f"{p.stem}.nwk").read_text() for p in paths])


def kf_scores(engine, alns: Sequence, truths: Sequence[str]) -> List[float]:
    """Each alignment's KF between its BME + NNI + SPR tree, built from the
    engine's distances, and its true tree."""
    import numpy as np

    from ..data.phylip import vec_to_phylip
    from ..trees import native

    kfs = []
    for aln, vec, truth in zip(alns, engine.predict(alns), truths):
        _, phy = vec_to_phylip(np.asarray(vec, np.float64), aln.ids)
        nwk = native.build_tree_from_phylip(phy, "bme", nni=True, spr=True)
        kfs.append(native.compare_newick(truth, nwk).kf)
    return kfs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m phyloformer_tpu_torch.tools.eval_testdata_kf",
                                 description="a checkpoint's mean KF on a test set")
    ap.add_argument("weights")
    add_data_flags(ap)
    args = ap.parse_args(argv)

    import numpy as np

    from ..infer.engine import InferenceEngine
    from ..io.ckpt_import import load_pretrained

    params, cfg, meta = load_pretrained(args.weights)
    engine = InferenceEngine(params, cfg, device=args.device)
    stems, alns, truths = read_test_set(args.msas, args.trees)
    kfs = kf_scores(engine, alns, truths)
    print(json.dumps({
        "weights": args.weights,
        "step": meta.get("step"),
        "mean_kf": float(np.mean(kfs)),
        "median_kf": float(np.median(kfs)),
        "n": len(kfs),
        "kf": dict(zip(stems, kfs)),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
