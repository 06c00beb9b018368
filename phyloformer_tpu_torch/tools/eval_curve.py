"""The KF on a test set of every saved step of a training run: one engine,
its kernels loaded once, takes each step's parameters in turn; one JSON
line a step.

    python -m phyloformer_tpu_torch.tools.eval_curve RUN_DIR \\
        --msas DIR --trees DIR [--steps 2000,4000] [--out curve.jsonl] [--device cpu]

``RUN_DIR`` is a checkpoint directory of the port's trainer
(``ckpt_<step>.pt``) or a run directory of the JAX trainer (Orbax, read
with ``tensorstore``).  Runs on the card unless ``--device cpu`` is given.
The JAX package's ``tools/eval_curve.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .eval_testdata_kf import add_data_flags, kf_scores, read_test_set


def run_steps(run_dir):
    """``(steps, load)`` of a run directory of either trainer: its saved
    steps in order, and ``load(step) -> (params, config dict or None)``."""
    from ..io import orbax
    from ..io.checkpoint import CheckpointManager

    if orbax.is_orbax_dir(run_dir):
        def load(step):
            state, _ = orbax.read_state(run_dir, step)
            return (state["params"] if "params" in state else state,
                    orbax.read_metadata(run_dir, step).get("config"))

        return orbax.steps(run_dir), load
    mgr = CheckpointManager(run_dir)

    def load(step):
        state, _ = mgr.restore(step)
        return state["params"], (state.get("metadata") or {}).get("config")

    return mgr.all_steps(), load


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m phyloformer_tpu_torch.tools.eval_curve",
                                 description="the mean KF of every step of a training run")
    ap.add_argument("ckpt_dir")
    add_data_flags(ap)
    ap.add_argument("--out", default=None, help="also write the rows to this JSONL file")
    ap.add_argument("--steps", default=None,
                    help="comma-separated checkpoint steps (default: all)")
    args = ap.parse_args(argv)

    import numpy as np

    from ..infer.engine import InferenceEngine
    from ..io.checkpoint import _infer_config
    from ..models.params import PhyloformerConfig, params_from_numpy

    saved, load = run_steps(args.ckpt_dir)
    steps = saved if args.steps is None else [int(s) for s in args.steps.split(",")]
    if not steps:
        raise FileNotFoundError(f"{args.ckpt_dir}: no saved step")
    _, alns, truths = read_test_set(args.msas, args.trees)
    engine, rows = None, []
    for step in steps:
        params, cfg_dict = load(step)
        params = params_from_numpy(params)
        if engine is None:
            cfg = PhyloformerConfig(**cfg_dict) if cfg_dict else _infer_config(params)
            engine = InferenceEngine(params, cfg, device=args.device)
        else:
            engine.set_params(params)  # same shapes: the engine and its kernels stay
        kfs = kf_scores(engine, alns, truths)
        row = {"step": step, "mean_kf": float(np.mean(kfs)), "n": len(kfs)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
