"""The fast path's accuracy by (n, L), and its KF at 100 tips x 1000 sites.

First the drift grid (:func:`..bench.accuracy.drift_grid`, ``pf-bench-torch
accuracy-grid``): the fast path's distances against an fp32 oracle at each
corner of ``GRID``, one JSON line a corner.  Then the end metric at scale
(:func:`kf_check`): ``REPS`` birth-death trees of ``N_TIPS`` tips, an LG
alignment of ``N_SITES`` sites evolved on each by the host's engine, BME +
NNI + SPR trees built from the fast path's distances and from the oracle's,
and each tree's KF to the true tree; one JSON line with both means.

    python -m phyloformer_tpu_torch.tools.accuracy_at_scale WEIGHTS [--device cpu]

``WEIGHTS`` is anything ``load_pretrained`` reads.  Runs on the card unless
``--device cpu`` is given.  The JAX package's ``tools/accuracy_at_scale.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

GRID = [(50, 250), (100, 250), (100, 1000), (200, 250), (200, 1000)]
N_TIPS, N_SITES, REPS = 100, 1000, 4


def kf_check(params, cfg, n: int = N_TIPS, l: int = N_SITES, reps: int = REPS, device=None,
             workdir=None) -> Tuple[Dict, Dict[str, Dict[str, List]]]:
    """KF of the fast path's trees and of the oracle's at ``n`` tips x ``l``
    sites over ``reps`` alignments: rep ``k`` draws its tree and alignment
    from ``default_rng(100 + k)`` and writes ``k.nwk`` and ``k.fa`` under
    ``workdir`` (a new temporary directory by default).  Returns the summary
    (JAX's keys) and, by route (``"fused"``, ``"oracle"``), the distances and
    the built trees: ``{"preds": {route: [...]}, "trees": {route: [...]}}``."""
    from ..bench.accuracy import _predict, make_engines
    from ..data.fasta import read_fasta
    from ..data.phylip import vec_to_phylip
    from ..sim.msa import MsaSimConfig, simulate_msa
    from ..sim.priors import diameter_sampler
    from ..sim.trees import TreeSimConfig, simulate_tree
    from ..trees.native import build_tree_from_phylip, compare_newick

    fast, oracle, oracle_name = make_engines(params, cfg, n, l, device)
    kf = {"fused": [], "oracle": []}
    detail = {"preds": {"fused": [], "oracle": []}, "trees": {"fused": [], "oracle": []}}
    tmp = Path(workdir) if workdir else Path(tempfile.mkdtemp(prefix="acc_scale_"))
    tmp.mkdir(parents=True, exist_ok=True)
    for rep in range(reps):
        r = np.random.default_rng(100 + rep)
        tree = simulate_tree(r, TreeSimConfig(ntips=n), diameter_sampler(None))
        (tmp / f"{rep}.nwk").write_text(tree.to_newick())
        ok, _ = simulate_msa(tmp / f"{rep}.nwk", tmp / f"{rep}.fa", MsaSimConfig(length=l),
                             rng=r)
        if not ok:
            raise RuntimeError(f"replicate {rep}: every alignment kept duplicate rows")
        aln = read_fasta(tmp / f"{rep}.fa")
        preds = {"fused": fast.predict([aln])[0], "oracle": _predict(oracle, [aln])[0]}
        for tag, vec in preds.items():
            _, phy = vec_to_phylip(vec.astype(np.float64), aln.ids)
            nwk = build_tree_from_phylip(phy, "bme", True, True)
            detail["preds"][tag].append(vec)
            detail["trees"][tag].append(nwk)
            kf[tag].append(compare_newick(tree.to_newick(), nwk).kf)
    summary = {
        "kf_fused_mean": float(np.mean(kf["fused"])),
        "kf_oracle_mean": float(np.mean(kf["oracle"])),
        "oracle": oracle_name,
        "kf_pairs": list(zip(kf["fused"], kf["oracle"])),
    }
    return summary, detail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m phyloformer_tpu_torch.tools.accuracy_at_scale")
    ap.add_argument("weights")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    from ..bench.accuracy import drift_grid
    from ..device import resolve_device
    from ..io.ckpt_import import load_pretrained

    device = resolve_device(args.device)
    params, cfg, _ = load_pretrained(args.weights)
    for row in drift_grid(args.weights, GRID, device=device):
        print(json.dumps(row), flush=True)
    summary, _ = kf_check(params, cfg, device=device)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
