"""Fixtures of the benchmark's CPU tests: a copy of the manifest and the
benchmark's folder with every mix cut to a few tiny alignments and every
configuration at fp32-grade products, run on the port's plain versions
(``device="cpu"``)."""

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_MIX = {"tips": [4, 6], "sites": [16, 24], "reps": 3}
TINY_TRAIN = {"warmup_steps": 2, "total_steps": 100, "batch_size": 2}


def make_tiny_root(dest: Path) -> Path:
    """``dest`` holding BENCHMARK.json, a copy of ``benchmark/`` whose mixes
    are tiny, and the checkpoints (a link)."""
    shutil.copytree(REPO / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    os.symlink(REPO / "artifacts", dest / "artifacts")
    for f in (dest / "benchmark" / "workloads").glob("*.json"):
        wl = json.loads(f.read_text())
        for key in ("pool", "corpus"):
            if key in wl:
                wl[key].pop("tips_range", None)
                wl[key].update(TINY_MIX)
        if "train" in wl:
            wl["train"].update(TINY_TRAIN)
        if "arrivals" in wl:
            wl["arrivals"]["rate"] = 8.0
        f.write_text(json.dumps(wl))
    # fp32-grade products in every configuration: the plain versions' one
    # TF32 pass reads, at a tiny size, as far from the reference as the
    # card's does at the cells' sizes, where the limits are set
    for f in (dest / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg["matmul_precision"] = "float32"
        f.write_text(json.dumps(cfg))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


@pytest.fixture
def card():
    """The card, or a skip: decided here, never at import."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
