"""Find the serving cell's knee once: the server and the load generator of
``serve.tf32.poisson`` set up once, then one open-loop schedule at each
rate, on the cell's own arrival pattern (its ``pattern_seed``).  The
benchmark's own runs do not run this; the cell's rate is fixed in its
workload file from what this prints.  The schedule offers whole rounds of
the pool, so the rates that it can offer are steps of the pool's size over
``--seconds`` (2.4 a second for the grid's 72 alignments at 30 s).

    python3 benchmark/sweep.py --rates 19.2,21.6,24 --seconds 30 --seed 5

One JSON line a rate: requests sent, failed, answered a second, the median
and 95th percentile of latency, how late the generator ran, and the growth
of latency over the window (the mean of the last quarter of requests over
the first quarter's: a backlog that grows reads well above 1).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != HERE]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="serve.tf32.poisson")
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=5, help="the alignments' seed")
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload, ROOT)
    harness.set_cache_dirs(ROOT)
    harness.require_cards(int(cell.entry["chips"]))
    runner = harness.load_runner(cell.bench, "serve").Runner(cell, args.seed, torch.device("cuda"))
    runner.setup()
    try:
        for k, rate in enumerate(float(r) for r in args.rates.split(",")):
            runner.rate = rate
            runner.offer(args.seconds, tag=f"sweep{k}")
            r = runner.records(tag=f"sweep{k}")
            ok = r["status"] == 200
            lat = 1e3 * np.where(ok, r["done"] - r["due"], np.inf)
            q = max(1, len(lat) // 4)
            print(json.dumps({
                "rate": rate, "sent": int(len(lat)), "failed": int((~ok).sum()),
                "answered_per_s": float(ok.sum() / r["done"].max()),
                "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
                "late_p95_ms": float(np.percentile(1e3 * (r["sent"] - r["due"]), 95)),
                "growth": float(lat[-q:].mean() / lat[:q].mean())}), flush=True)
    finally:
        runner.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
