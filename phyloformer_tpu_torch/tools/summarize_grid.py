"""Consolidate grid topos/execution CSVs from one or more run roots.

Each source is ROOT[:markerA=markerB,...]: the topos_*/execution_* CSVs under
ROOT/L*/ are read and their markers optionally renamed (so that a variant run
in its own out directory can sit beside the main grid under a marker of its
own).  Writes a per-(marker, length) summary (KF / nRF / wRF means over the
trees, the total and largest method wall clock) as CSV and prints it as an
aligned table.

    python -m phyloformer_tpu_torch.tools.summarize_grid out.csv runs/grid/out \
        runs/grid/out_mlstart:ml_refine=ml_refine_ml

Host only.  A copy of the JAX package's ``tools/summarize_grid.py``.
"""

from __future__ import annotations

import csv
import sys
from collections import defaultdict
from pathlib import Path


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    out_csv = argv[0]

    topo = defaultdict(lambda: defaultdict(list))  # (marker, L) -> metric -> values
    timing = defaultdict(lambda: [0.0, 0.0])       # (marker, L) -> [total, max]
    for spec in argv[1:]:
        root, _, renames = spec.partition(":")
        rename = dict(r.split("=", 1) for r in renames.split(",") if r)
        for ldir in sorted(Path(root).glob("L*")):
            L = int(ldir.name[1:])
            for tcsv in ldir.glob("topos_*.csv"):
                with open(tcsv) as fh:
                    for r in csv.DictReader(fh):
                        m = rename.get(r["marker"], r["marker"])
                        topo[(m, L)]["kf"].append(float(r["kf_score"]))
                        topo[(m, L)]["nrf"].append(float(r["norm_rf"]))
                        topo[(m, L)]["wrf"].append(float(r["weighted_rf"]))
            for ecsv in ldir.glob("execution_*.csv"):
                with open(ecsv) as fh:
                    for r in csv.DictReader(fh):
                        if r["timer"] in ("model_load", "compile_warmup"):
                            continue
                        m = rename.get(r["marker"], r["marker"])
                        t = timing[(m, L)]
                        el = float(r["elapsed_sec"])
                        t[0] += el
                        t[1] = max(t[1], el)

    rows = []
    for (m, L), d in sorted(topo.items(), key=lambda x: (x[0][1], x[0][0])):
        n = len(d["kf"])
        tot, mx = timing.get((m, L), (float("nan"),) * 2)
        rows.append({
            "marker": m, "length": L, "n": n,
            "mean_kf": round(sum(d["kf"]) / n, 4),
            "mean_nrf": round(sum(d["nrf"]) / n, 4),
            "mean_wrf": round(sum(d["wrf"]) / n, 4),
            "wall_total_s": round(tot, 1), "wall_max_s": round(mx, 1),
        })
    with open(out_csv, "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    hdr = f"{'marker':18s} {'L':>5} {'n':>3} {'KF':>7} {'nRF':>7} {'wRF':>7} {'wall':>8} {'max':>7}"
    print(hdr)
    for r in rows:
        print(f"{r['marker']:18s} {r['length']:>5} {r['n']:>3} "
              f"{r['mean_kf']:>7} {r['mean_nrf']:>7} {r['mean_wrf']:>7} "
              f"{r['wall_total_s']:>8} {r['wall_max_s']:>7}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
