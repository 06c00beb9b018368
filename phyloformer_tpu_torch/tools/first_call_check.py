"""How often a fresh CPU process's first vector-math call comes out wrong.

Each fresh process draws 4M float32 values (seed 0), makes its first call of
one function (``exp``, ``erf`` or ``tanh``: torch hands each thread's share to
MKL's vector math) and compares it with the same function in float64; it
reports the elements more than 1e-6 relative off, their span and the worst
error.  ``--warm`` has the process call ``device.warm_cpu_math`` first, as
every CPU entry point of the port does.  The parent starts ``--processes``
processes per function, ``--at-once`` at a time, each on ``--threads``
threads, and prints the count of processes that came out wrong.

    python -m phyloformer_tpu_torch.tools.first_call_check [--warm] [--processes 60] \\
        [--at-once 6] [--threads 32]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

FUNCTIONS = ("erf", "exp", "tanh")


def one(name: str, warm: bool) -> dict:
    """This process's first call of ``torch.<name>`` against float64."""
    import torch

    if warm:
        from ..device import warm_cpu_math

        warm_cpu_math()
    torch.manual_seed(0)
    x = torch.randn(1 << 22) * 2
    fn = getattr(torch, name)
    y = fn(x)
    ref = fn(x.double())
    rel = (y.double() - ref).abs() / ref.abs().clamp_min(1e-30)
    bad = (rel > 1e-6).nonzero()
    if not len(bad):
        return {"fn": name, "bad": 0}
    return {"fn": name, "bad": len(bad), "span": [int(bad.min()), int(bad.max())],
            "max_rel": float(rel.max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m phyloformer_tpu_torch.tools.first_call_check")
    ap.add_argument("--warm", action="store_true")
    ap.add_argument("--processes", type=int, default=60, help="fresh processes a function")
    ap.add_argument("--at-once", type=int, default=6)
    ap.add_argument("--threads", type=int, default=32)
    ap.add_argument("--one", choices=FUNCTIONS, help=argparse.SUPPRESS)  # a child process
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.one, args.warm)))
        return 0

    from . import child_env

    env = child_env(OMP_NUM_THREADS=str(args.threads))

    def child(name):
        r = subprocess.run([sys.executable, "-m", "phyloformer_tpu_torch.tools.first_call_check",
                            "--one", name] + (["--warm"] if args.warm else []),
                           capture_output=True, text=True, env=env)
        if r.returncode != 0:
            raise RuntimeError(r.stderr[-2000:])
        return json.loads(r.stdout.strip().splitlines()[-1])

    with ThreadPoolExecutor(args.at_once) as pool:
        rows = list(pool.map(child, [f for f in FUNCTIONS for _ in range(args.processes)]))
    for row in rows:
        if row["bad"]:
            print(json.dumps(row))
    wrong = sum(1 for r in rows if r["bad"])
    print(json.dumps({"warm": args.warm, "processes": len(rows), "wrong": wrong,
                      "threads": args.threads, "at_once": args.at_once}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
