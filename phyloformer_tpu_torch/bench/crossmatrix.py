"""Model-misspecification cross-matrix runner.

Phyloformer's figure suite evaluates its model variants against several
dataset families (``make_plots.py:1929-1977``); this module runs the whole
grid: for every (checkpoint, dataset) cell, inference → BME+NNI+SPR trees →
KF against the dataset's true trees, then per-cell ``topos_*`` CSVs,
``crossmatrix.json`` and a heatmap.  The heatmap needs matplotlib; where it
is not installed (the card's machine) the rest is written and a note on
stderr names the missing figure.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, Tuple

import numpy as np


def run_crossmatrix(
    models: Dict[str, str],
    datasets: Dict[str, Tuple[str, str]],  # name -> (msa_dir, true_tree_dir)
    outdir,
    precision: str = "float32",
    use_kernels: bool = True,
    device=None,
) -> Dict:
    """``precision`` is the engine's ``matmul_precision``; ``use_kernels``
    and ``device`` as :class:`..infer.engine.InferenceEngine` takes them
    (``device=None`` = the card, which raises without one)."""
    from ..data.fasta import has_fasta_ext, read_fasta
    from ..data.phylip import vec_to_phylip
    from ..infer.engine import InferenceConfig, InferenceEngine
    from ..io.ckpt_import import load_pretrained
    from ..trees.native import build_tree_from_phylip, compare_newick
    from .report import write_csv

    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    matrix: Dict[str, Dict[str, float]] = {}

    for model_name, ckpt_path in models.items():
        params, cfg, _ = load_pretrained(ckpt_path)
        engine = InferenceEngine(
            params, cfg, InferenceConfig(matmul_precision=precision, use_kernels=use_kernels),
            device=device,
        )
        matrix[model_name] = {}
        for ds_name, (msa_dir, tree_dir) in datasets.items():
            paths = sorted(p for p in Path(msa_dir).iterdir() if has_fasta_ext(p))
            alns = [read_fasta(p, strict=False) for p in paths]
            preds = engine.predict(alns)
            kfs = []
            rows = []
            for p, aln, vec in zip(paths, alns, preds):
                true_tree = Path(tree_dir) / (p.stem + ".nwk")
                if not true_tree.exists():
                    continue
                _, phy = vec_to_phylip(vec.astype(np.float64), aln.ids)
                nwk = build_tree_from_phylip(phy, "bme", True, True)
                r = compare_newick(true_tree.read_text(), nwk)
                kfs.append(r.kf)
                rows.append(
                    {"marker": model_name, "id": p.stem, "norm_rf": r.norm_rf,
                     "kf_score": r.kf, "weighted_rf": r.weighted_rf}
                )
            write_csv(out / f"topos_{model_name}_{ds_name}.csv", rows)
            matrix[model_name][ds_name] = float(np.mean(kfs)) if kfs else float("nan")

    (out / "crossmatrix.json").write_text(json.dumps(matrix, indent=2))
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print(f"matplotlib not installed: no {out / 'misspecification_kf.pdf'}",
              file=sys.stderr)
        return matrix
    from .figures import misspecification_heatmap

    misspecification_heatmap(matrix, out / "misspecification_kf.pdf")
    return matrix
