"""Run one cell of the benchmark once on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  ``--trace 0`` prints the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics (read from a
``torch.profiler`` trace of the window).  The last line of standard output
is the result's JSON object; the numbers compared with the plain reference
end standard error, each beside its limit.  Exits 2 without a result where
there is no card (or too few), or where the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = str(Path(__file__).resolve().parent)
sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != Path(HERE)]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark import harness

    try:
        result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), ROOT,
                             T_START)
    except harness.Refused as err:
        print(f"refused: {err}", file=sys.stderr, flush=True)
        return 2
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
