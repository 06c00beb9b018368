"""Offline inference, as ``pf-infer-torch`` runs a directory of
alignments: one caller, closed loop, one ``InferenceEngine.predict`` of the
whole pool a pass, pass after pass until the window has run its seconds.

Workload keys: ``weights`` (a reference checkpoint in the checkout),
``pool`` (a mix of :func:`benchmark.traffic.pool`), ``limits``.  The
engine runs at the configuration's ``matmul_precision`` and otherwise at
its defaults, as the command line does.
"""

from __future__ import annotations

import gc

import torch

from benchmark import compare, traffic
from benchmark.reference import phyloformer as reference
from benchmark.rooflines import model


class Runner:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.passes = []

    def setup(self) -> None:
        from phyloformer_tpu_torch.data.fasta import Alignment
        from phyloformer_tpu_torch.infer.engine import InferenceConfig, InferenceEngine
        from phyloformer_tpu_torch.io.ckpt_import import load_pretrained

        wl = self.cell.workload
        self.pool = traffic.pool(wl["pool"], self.seed)
        self.alns = [Alignment(codes=it["codes"], ids=[f"s{i}" for i in range(it["n"])])
                     for it in self.pool]
        params, cfg, _ = load_pretrained(self.cell.path(wl["weights"]))
        icfg = InferenceConfig(matmul_precision=self.cell.config["matmul_precision"])
        self.engine = InferenceEngine(params, cfg, icfg, device=self.device)
        self.engine.load_kernels()
        self.engine.predict(self.alns)  # every bucket of the pool, once

    def counters(self):
        return {"engine.batches": self.engine.stats["batches"],
                "engine.alignments": self.engine.stats["alignments"]}

    def window(self, win, seconds: float):
        batches0 = self.engine.stats["batches"]
        while True:
            self.passes.append(self.engine.predict(self.alns))  # host arrays: the pass is done
            if win.elapsed() >= seconds:
                break
        elapsed = win.elapsed()
        n = len(self.passes) * len(self.alns)
        failed = sum(1 for out in self.passes for d in out if d is None)
        k = len(self.passes)
        return {
            "end_to_end": {"aln_per_s": (n - failed) / elapsed},
            "attempted": n, "failed": failed,
            "model_flop": k * sum(model.forward_flop(it["n"], it["l"], self.cell.config)
                                  for it in self.pool),
            "pair_sites": k * traffic.real_pair_sites(self.pool),
            "units": self.engine.stats["batches"] - batches0,
        }

    def settle(self):
        return {}

    def release(self) -> None:
        self.engine = None
        gc.collect()

    def check(self):
        ref_model = reference.from_checkpoint(self.cell.path(self.cell.workload["weights"]),
                                              self.cell.config, self.device)
        refs = [reference.predict(ref_model, it["codes"], self.device).numpy()
                for it in self.pool]
        del ref_model
        pairs = [(out[i] if out[i] is not None else [float("nan")], refs[i])
                 for out in self.passes for i in range(len(self.pool))]
        return {"dist_gap": compare.dist_gap(pairs)}
