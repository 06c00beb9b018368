"""Tools of the port, each run with ``python -m phyloformer_tpu_torch.tools.<name>``:

- evaluation: :mod:`.eval_testdata_kf` (one checkpoint's KF against true
  trees), :mod:`.eval_curve` (the KF of every step of a training run);
- the benchmark grid: :mod:`.make_grid_data` (its alignments),
  :mod:`.run_grid` (every method over it, the reference's CSVs),
  :mod:`.summarize_grid` (one table from one or more grid runs);
- :mod:`.reference_path` (the reference's execution structure, timed on the
  same card), :mod:`.accuracy_at_scale` (the fast path's drift grid and KF
  at 100 tips x 1000 sites);
- corpora: :mod:`.make_corpus` (the mixed-length pretraining corpus),
  :mod:`.make_ft_corpora` (the indel and cherry fine-tune corpora),
  :mod:`.merge_packed` (packed shard directories into one);
- :mod:`.scaling_bench` (weak scaling of the training step over ranks).

They are the JAX package's ``tools/*.py`` with its arguments and files; where
the JAX tool takes ``--cpu`` the port's takes ``--device cpu``, and it runs on
the card otherwise.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

_ROOT = str(Path(__file__).resolve().parents[2])  # the directory holding the package


def child_env(**extra: str) -> dict:
    """This process's environment with ``extra`` set, for a child process
    that imports this checkout of the port wherever it is started from."""
    env = {**os.environ, **extra}
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    return env


def run_module(module: str, args) -> subprocess.CompletedProcess:
    """``python -m module args`` in a child process (:func:`child_env`);
    output captured as text."""
    return subprocess.run([sys.executable, "-m", module] + [str(a) for a in args],
                          capture_output=True, text=True, env=child_env())
