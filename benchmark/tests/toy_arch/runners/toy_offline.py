"""The stub architecture's offline runner: a few lines of plain torch stand
in for a second program, over the pool of :func:`benchmark.traffic.pool`,
one closed-loop pass after another.  It reports its ``work`` in
sequence-sites, which a model over sequences counts where Phyloformer counts
pair-sites."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark import compare, traffic
from benchmark.reference import toy as reference
from benchmark.rooflines import toy as roofline


def forward(weights, codes: torch.Tensor) -> torch.Tensor:
    h = weights["embed"][codes.long()]
    for layer in weights["layers"]:
        h = h + torch.tanh(h @ layer)
    z = h.mean(1)
    i, j = torch.triu_indices(len(z), len(z), 1)
    return F.softplus(((z[i] - z[j]) ** 2).sum(-1))


class Runner:
    def __init__(self, cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.passes = []

    def setup(self) -> None:
        self.pool = traffic.pool(self.cell.workload["pool"], self.seed)
        self.codes = [torch.as_tensor(it["codes"], device=self.device) for it in self.pool]
        self.weights = reference.weights(self.cell.config, self.seed, self.device)

    def counters(self):
        return {}

    def window(self, win, seconds: float):
        while True:
            self.passes.append([forward(self.weights, c).cpu().numpy() for c in self.codes])
            if win.elapsed() >= seconds:
                break
        k, sizes = len(self.passes), self.cell.config
        return {
            "end_to_end": {"aln_per_s": k * len(self.pool) / win.elapsed()},
            "attempted": k * len(self.pool), "failed": 0,
            "model_flop": k * sum(roofline.forward_flop(it["n"], it["l"], sizes)
                                  for it in self.pool),
            "pair_sites": k * traffic.real_pair_sites(self.pool),
            "units": k,
            "work": {"sequence_sites": k * sum(it["n"] * it["l"] for it in self.pool)},
        }

    def settle(self):
        return {}

    def release(self) -> None:
        self.weights = None

    def check(self):
        weights = reference.weights(self.cell.config, self.seed, self.device)
        refs = [reference.predict(weights, it["codes"]).numpy() for it in self.pool]
        return {"dist_gap": compare.dist_gap((out[i], refs[i]) for out in self.passes
                                             for i in range(len(self.pool)))}
