"""``pf-bench-torch manifest`` (the port's ``bench/manifest.py``) against the
JAX package's ``render_all``, on the CPU.

The CSVs are those of ``tests/test_report.py``'s manifest test (the same
generator, from the same seed): every schema the 43-figure roster reads,
and a partial directory (the LG+GC topologies and distances alone).  On
each, JAX's ``render_all`` (a JAX subprocess) and the port's command (a
subprocess of its own) render the same figure names and skip the same
ones, and every rendered file is non-empty.
"""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_model import REPO, run_jax

PARTIAL = ("topos_lggc.csv", "dists_lggc.csv")


def write_manifest_csvs(data):
    """``tests/test_report.py``'s synthetic CSVs for the 43-figure roster."""
    rng = np.random.default_rng(0)
    data.mkdir(parents=True)
    markers = ["PF+FastME", "PF_Base+FastME", "FastTree", "IQTree_LG+GC"]
    ft = {"gaps": "PF_Indel+FastME", "cherry": "PF_Cherry+FastME",
          "pastek": "PF_SelReg+FastME"}
    for ds in ("lggc", "cherry", "pastek", "gaps"):
        ms = markers + ([ft[ds]] if ds in ft else [])
        with open(data / f"topos_{ds}.csv", "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=["marker", "id", "norm_rf", "kf_score",
                                               "weighted_rf"])
            w.writeheader()
            for marker in ms:
                for rep in range(3):
                    for tips in (10, 50):
                        for length in (250, 500, 1000):
                            w.writerow({"marker": marker, "id": f"{rep}_{tips}_tips_{length}",
                                        "norm_rf": rng.random(), "kf_score": rng.random(),
                                        "weighted_rf": rng.random() * 3})
        with open(data / f"dists_{ds}.csv", "w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=["marker", "id", "ref_dist", "cmp_dist"])
            w.writeheader()
            for marker in ms:
                for rep in range(3):
                    for tips in (10, 50):
                        for length in (250, 500, 1000):
                            for _ in range(10):
                                r = rng.lognormal(-1, 1)
                                w.writerow({"marker": marker,
                                            "id": f"{rep}_{tips}_tips_{length}",
                                            "ref_dist": r,
                                            "cmp_dist": abs(r + rng.normal(0, 0.1))})
        with open(data / f"execution_{ds}.csv", "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["timer", "marker", "id", "elapsed_sec", "MaxRSS_kb"])
            for marker in ms:
                for rep in range(3):
                    for tips in (10, 50):
                        for stage in ("inference", "fastme"):
                            w.writerow([stage, marker, f"{rep}_{tips}_tips_500",
                                        rng.random() + 0.01, int(rng.integers(1e4, 1e6))])
    with open(data / "likelihoods_lggc.csv", "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=["marker", "id", "ratio"])
        w.writeheader()
        for marker in markers:
            for rep in range(3):
                for tips in (10, 50):
                    for length in (250, 500, 1000):
                        w.writerow({"marker": marker, "id": f"{rep}_{tips}_tips_{length}",
                                    "ratio": 1 + rng.normal(0, 0.02)})
    with open(data / "brlens_lggc.csv", "w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=["marker", "id", "ref_len", "cmp_len"])
        w.writeheader()
        for _ in range(60):
            r = rng.random()
            kind = rng.integers(0, 3)
            w.writerow({"marker": "PF+FastME", "id": "0_50_tips_500",
                        "ref_len": "" if kind == 2 else r,
                        "cmp_len": "" if kind == 1 else r + rng.normal(0, 0.02)})
    (data / "model_load_times.txt").write_text("1.5\n2.5\n")


@pytest.fixture(scope="module")
def manifest_case(tmp_path_factory):
    root = tmp_path_factory.mktemp("manifest")
    write_manifest_csvs(root / "full")
    (root / "partial").mkdir()
    for name in PARTIAL:
        (root / "partial" / name).write_bytes((root / "full" / name).read_bytes())
    # the port's command, one process for both directories, beside JAX's
    code = ("import sys; from phyloformer_tpu_torch.bench import cli; "
            + "; ".join(f"assert cli.main(['manifest', {str(root / d)!r}, '-o', "
                        f"{str(root / ('port_' + d))!r}]) == 0" for d in ("full", "partial")))
    port = subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env={**os.environ, "MPLBACKEND": "Agg"})
    want = run_jax(f"""
import json
from phyloformer_tpu.bench.manifest import REFERENCE_FIGURES, render_all
OUT["roster"] = np.array(json.dumps(REFERENCE_FIGURES))
for d in ("full", "partial"):
    r = render_all({str(root)!r} + "/" + d, {str(root)!r} + "/jax_" + d)
    OUT[d] = np.array(json.dumps({{"rendered": sorted(k for k, v in r.items() if v),
                                   "skipped": sorted(k for k, v in r.items() if v is None)}}))
""", {}, root / "jax")
    out, err = port.communicate(timeout=600)
    assert port.returncode == 0, err[-4000:]
    docs = _json_objects(out)
    got = {d: {"rendered": o["rendered"], "skipped": o["skipped_missing_inputs"]}
           for d, o in zip(("full", "partial"), docs)}
    return root, {k: json.loads(str(v)) for k, v in want.items()}, got


def _json_objects(text):
    """The JSON objects printed one after another (each indented over lines)."""
    dec, i, out = json.JSONDecoder(), 0, []
    while i < len(text):
        if text[i].isspace():
            i += 1
            continue
        obj, i = dec.raw_decode(text, i)
        out.append(obj)
    return out


@pytest.mark.parametrize("data", ["full", "partial"])
def test_manifest_renders_and_skips_what_jax_does(data, manifest_case):
    root, want, got = manifest_case
    assert got[data] == want[data]
    roster = want["roster"]
    assert len(roster) == 43 and sorted(got[data]["rendered"] + got[data]["skipped"]) == sorted(
        roster)
    if data == "full":
        assert got[data]["skipped"] == []
    else:
        assert 0 < len(got[data]["rendered"]) < 43
    for name in got[data]["rendered"]:
        f = root / f"port_{data}" / name
        assert f.is_file() and f.stat().st_size > 0, name
