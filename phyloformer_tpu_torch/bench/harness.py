"""Benchmark harness: wall-clock and peak RSS per pipeline stage.

Emits CSV rows in the schema of Phyloformer's ``execution_*.csv`` (columns
``timer,marker,id,elapsed_sec,MaxRSS_kb``; its ``make_plots.py:166-190``
sums ``elapsed_sec`` over a pipeline's stages per ``id`` and takes the
largest RSS).  The timers live in-process, so one run produces the whole
table:

- ``model_load``: the weights read and the engine built, with its kernels
  (built at first use, then loaded) where it runs them on the card, and
  the native tree toolkit (built at first use, then loaded) where trees are
  built, so that the stages below time the work alone;
- ``data_load``: the FASTA files parsed;
- ``inference``: ``InferenceEngine.predict`` over every alignment, which
  returns once the distances are on the host;
- ``fastme`` (one row per alignment): the 10-decimal PHYLIP text and the
  native BME+NNI+SPR tree;
- ``compare`` (one row per alignment with a true tree): RF and KF.
"""

from __future__ import annotations

import contextlib
import csv
import resource
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, List, Optional


def max_rss_kb() -> int:
    """Peak RSS of this process in kB (ru_maxrss is kB on Linux)."""
    return int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)


@dataclass
class StageRecord:
    timer: str  # stage name, e.g. "inference", "fastme"
    marker: str  # method name, e.g. "PF", "PF_Base"
    id: str  # example id, e.g. "0_20_tips"
    elapsed_sec: float
    max_rss_kb: int


@dataclass
class BenchmarkRecorder:
    records: List[StageRecord] = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, timer: str, marker: str, example_id: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.append(
                StageRecord(
                    timer=timer,
                    marker=marker,
                    id=example_id,
                    elapsed_sec=time.perf_counter() - t0,
                    max_rss_kb=max_rss_kb(),
                )
            )

    def write_csv(self, path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w", newline="") as fh:
            writer = csv.writer(fh)
            writer.writerow(["timer", "marker", "id", "elapsed_sec", "MaxRSS_kb"])
            for r in self.records:
                writer.writerow(
                    [r.timer, r.marker, r.id, f"{r.elapsed_sec:.6f}", r.max_rss_kb]
                )

    def group_elapsed(self) -> dict:
        """Total elapsed per (marker, id) across stages (``make_plots.py``'s
        ``group_elapsed`` aggregation)."""
        out: dict = {}
        for r in self.records:
            key = (r.marker, r.id)
            agg = out.setdefault(key, {"elapsed_sec": 0.0, "MaxRSS_kb": 0})
            agg["elapsed_sec"] += r.elapsed_sec
            agg["MaxRSS_kb"] = max(agg["MaxRSS_kb"], r.max_rss_kb)
        return out


def run_pipeline_benchmark(
    weights: str,
    alndir: str,
    out_csv: Optional[str] = None,
    marker: str = "PF",
    build_trees: bool = True,
    true_tree_dir: Optional[str] = None,
    engine_kwargs: Optional[dict] = None,
    device=None,
) -> dict:
    """Timed end-to-end pipeline: load model -> infer -> FastME trees
    [-> KF vs truth].  Returns a summary dict; optionally writes the CSV.

    ``engine_kwargs`` are :class:`..infer.engine.InferenceConfig` fields;
    ``device`` is the engine's (``None`` = the card, which raises without
    one; ``"cpu"`` runs the kernels' plain versions or the eager model)."""
    import numpy as np

    from ..data.fasta import has_fasta_ext, read_fasta
    from ..data.phylip import vec_to_phylip
    from ..infer.engine import InferenceConfig, InferenceEngine
    from ..io.ckpt_import import load_pretrained

    rec = BenchmarkRecorder()

    with rec.stage("model_load", marker, "all"):
        params, cfg, _ = load_pretrained(weights)
        engine = InferenceEngine(params, cfg, InferenceConfig(**(engine_kwargs or {})),
                                 device=device)
        engine.load_kernels()
        if build_trees:
            from ..trees.native import get_lib

            get_lib()

    paths = sorted(p for p in Path(alndir).iterdir() if has_fasta_ext(p))
    with rec.stage("data_load", marker, "all"):
        alns = [read_fasta(p) for p in paths]

    with rec.stage("inference", marker, "all"):
        preds = engine.predict(alns)

    trees = {}
    if build_trees:
        from ..trees.native import build_tree_from_phylip

        for p, aln, vec in zip(paths, alns, preds):
            with rec.stage("fastme", marker, p.stem):
                _, phy = vec_to_phylip(vec.astype(np.float64), aln.ids)
                trees[p.stem] = build_tree_from_phylip(phy, "bme", True, True)

    summary = {
        "n_alignments": len(alns),
        "stages": rec.group_elapsed(),
        "max_rss_kb": max_rss_kb(),
    }
    if true_tree_dir and trees:
        from ..trees.native import compare_newick

        kfs = []
        for stem, nwk in trees.items():
            ref_path = Path(true_tree_dir) / f"{stem}.nwk"
            if ref_path.exists():
                with rec.stage("compare", marker, stem):
                    kfs.append(compare_newick(ref_path.read_text(), nwk).kf)
        if kfs:
            summary["mean_kf"] = float(np.mean(kfs))

    if out_csv:
        rec.write_csv(out_csv)
    return summary
