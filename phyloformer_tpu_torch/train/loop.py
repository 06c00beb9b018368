"""The fit loop: epochs and steps, periodic validation, early stopping,
checkpointing, metric logging, resume and fine-tune.

The counterpart of ``phyloformer_tpu/train/loop.py``:
- validation every ``check_val_every`` updates, each followed by a
  checkpoint, and a final validation and checkpoint;
- two early stops: a train-loss ceiling (checked at every logging step) and
  no validation improvement for ``no_improvement_stop`` checks; a
  non-finite loss stops at once;
- SIGTERM / SIGINT checkpoint and stop at the next step boundary;
- scalar logs to JSONL, optionally to wandb / TensorBoard;
- ``resume``: continue from the latest checkpoint of the run's directory.

On a :class:`..parallel.mesh.Mesh` every rank runs the loop on the same
batches (the loaders are seeded alike) and the step takes each rank's part;
the losses are global, so every rank stops at the same step.  Rank 0 alone
logs and writes checkpoints; every rank resumes from the same one.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import signal
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from ..io.checkpoint import CheckpointManager
from ..models.params import PhyloformerConfig
from ..parallel.mesh import all_reduce_sum
from .data import BucketedLoader
from .trainer import (
    TrainConfig,
    create_train_state,
    make_eval_step,
    make_train_step,
    param_leaves,
)


@dataclasses.dataclass
class FitConfig:
    nb_epochs: int = 100
    max_steps: Optional[int] = None
    check_val_every: int = 10_000
    log_every: int = 100
    hard_loss_ceiling: float = 3.0
    no_improvement_stop: int = 5
    output_dir: str = "."
    run_name: str = "phyloformer"
    keep_checkpoints: Optional[int] = None  # None = keep all
    # optional metric sinks next to the JSONL writer
    use_wandb: bool = False  # offline mode
    use_tensorboard: bool = False
    project_name: str = "PHYLOFORMER_EXPERIMENTS"


class MetricLogger:
    """JSONL metric writer (one object per event), with optional extra sinks
    (wandb / TensorBoard) under the same scalar names (train_loss,
    learning_rate, grad_norm, val_loss, val_mae, val_mre, val_rmse)."""

    def __init__(self, path, sinks: Sequence = ()):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")
        self.sinks = [s for s in sinks if s is not None]

    def log(self, step: int, **scalars):
        rec = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            if isinstance(v, str):
                rec[k] = v
            elif np.isscalar(v) or hasattr(v, "item"):
                rec[k] = float(v)
            else:
                rec[k] = v
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        numeric = {k: v for k, v in rec.items()
                   if k not in ("step", "time") and isinstance(v, float)}
        for sink in self.sinks:
            sink.log(int(step), numeric)

    def close(self):
        self._fh.close()
        for sink in self.sinks:
            sink.close()


def make_wandb_sink(project: str, run_name: str, save_dir, offline: bool = True,
                    config: Optional[Dict] = None):
    """Optional wandb sink, offline by default.  Returns None with a
    warning when wandb is not installed."""
    try:
        import wandb
    except ImportError:
        print("wandb not installed; metrics go to JSONL only", flush=True)
        return None
    run = wandb.init(
        project=project, name=run_name, dir=str(save_dir),
        mode="offline" if offline else "online", config=config or {},
    )

    class _WandbSink:
        def log(self, step, scalars):
            run.log(scalars, step=step)

        def close(self):
            run.finish()

    return _WandbSink()


def make_tensorboard_sink(logdir):
    """Optional TensorBoard sink (tensorboardX).  Returns None with a warning
    when unavailable."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        print("tensorboardX not installed; metrics go to JSONL only", flush=True)
        return None
    writer = SummaryWriter(str(logdir))

    class _TbSink:
        def log(self, step, scalars):
            for k, v in scalars.items():
                writer.add_scalar(k, v, step)

        def close(self):
            writer.close()

    return _TbSink()


def evaluate(eval_step, params, loader: Iterable) -> Dict[str, float]:
    sums: Dict[str, float] = {}
    count = 0
    for batch in loader:
        out = eval_step(params, batch)
        for k, v in out.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        count += 1
    if count == 0:
        return {}
    return {k: v / count for k, v in sums.items()}


def _load_into(state, payload) -> None:
    """Copy a checkpoint's parameters and optimizer state into ``state``."""
    with torch.no_grad():
        for leaf, saved in zip(param_leaves(state["params"]), param_leaves(payload["params"])):
            leaf.copy_(saved)
    state["opt_state"].load_state_dict(payload["opt_state"])
    state["step"] = int(payload["step"])


def _any_rank(flag: bool, mesh) -> bool:
    """Whether ``flag`` is set on any rank of ``mesh`` (a signal reaches one
    rank; every rank must stop at the same step)."""
    if mesh is None or mesh.world == 1:
        return flag
    t = torch.tensor([float(flag)], device=mesh.device)
    return bool(all_reduce_sum(t, mesh.world_group).item() > 0)


def fit(
    cfg: PhyloformerConfig,
    tcfg: TrainConfig,
    fcfg: FitConfig,
    train_loader: BucketedLoader,
    val_loader: Optional[BucketedLoader] = None,
    mesh=None,
    init_params=None,
    resume: Union[bool, str, os.PathLike] = False,
    device=None,
) -> Dict:
    """Run training on ``device`` (``None`` = the card); returns a summary
    dict with the final state and why it stopped.  ``resume``: ``True``
    continues from the latest checkpoint of this run's directory, if any; a
    directory continues from its latest checkpoint, which must exist.
    ``mesh``: every rank of it calls ``fit`` alike; rank 0 logs, prints and
    writes the checkpoints."""
    out_dir = Path(fcfg.output_dir)
    run_dir = out_dir / f"checkpoints_{fcfg.run_name}"
    main = mesh is None or mesh.rank == 0
    state, tx = create_train_state(cfg, tcfg, params=init_params, device=device)
    train_step = make_train_step(cfg, tcfg, tx, mesh=mesh)
    eval_step = make_eval_step(cfg, tcfg, mesh=mesh)
    # every rank looks for the same checkpoint before rank 0 makes the directory
    if isinstance(resume, (str, os.PathLike)):
        payload, restored_step = CheckpointManager(resume).restore()
    elif resume and run_dir.is_dir() and CheckpointManager(run_dir).latest_step() is not None:
        payload, restored_step = CheckpointManager(run_dir).restore()
    else:
        payload = None
    if mesh is not None:
        mesh.barrier()
    logger = ckpt = None
    if main:
        sinks = []
        if fcfg.use_wandb:
            sinks.append(make_wandb_sink(fcfg.project_name, fcfg.run_name, out_dir,
                                         config=dataclasses.asdict(tcfg)))
        if fcfg.use_tensorboard:
            sinks.append(make_tensorboard_sink(out_dir / f"tb_{fcfg.run_name}"))
        logger = MetricLogger(out_dir / f"{fcfg.run_name}_metrics.jsonl", sinks=sinks)
        ckpt = CheckpointManager(run_dir, max_to_keep=fcfg.keep_checkpoints)
    if payload is not None:
        _load_into(state, payload)
        if main:
            print(f"resumed from step {restored_step}")

    def log(step_, **scalars):
        if logger is not None:
            logger.log(step_, **scalars)

    step = int(state["step"])
    train_loss = math.nan
    best_val = math.inf
    bad_checks = 0
    stop_reason = None
    t_start = time.time()

    # SIGTERM/SIGINT request a checkpoint and a clean stop at the next step.
    preempted = {"flag": False}

    def _handle(signum, frame):
        preempted["flag"] = True

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, _handle)
        except ValueError:  # not the main thread
            pass

    def run_validation():
        nonlocal best_val, bad_checks, stop_reason
        # without a validation set, still checkpoint on the cadence
        metrics = {}
        if val_loader is not None:
            metrics = evaluate(eval_step, state["params"], val_loader)
        if metrics:
            log(step, **metrics)
            val_loss = metrics.get("val_loss", math.inf)
            if val_loss < best_val - 1e-12:
                best_val = val_loss
                bad_checks = 0
            else:
                bad_checks += 1
                if bad_checks >= fcfg.no_improvement_stop:
                    stop_reason = f"early stop: no val improvement for {bad_checks} checks"
        if ckpt is not None:
            ckpt.save(step, state, metadata={
                "step": step,
                "val": metrics,
                "config": dataclasses.asdict(cfg),
                "train_config": dataclasses.asdict(tcfg),
            })

    for epoch in range(fcfg.nb_epochs):
        if stop_reason:
            break
        for batch in train_loader:
            state, logs = train_step(state, batch)
            step = int(state["step"])
            train_loss = float(logs["train_loss"])
            if not math.isfinite(train_loss):
                stop_reason = f"divergence stop: train_loss={train_loss}"
                log(step, train_loss=train_loss, event="divergence_stop")
                break
            # the loss ceiling, checked at every logging step
            if (fcfg.log_every and step % fcfg.log_every == 0
                    and train_loss > fcfg.hard_loss_ceiling):
                stop_reason = (f"divergence stop: train_loss={train_loss} > "
                               f"{fcfg.hard_loss_ceiling}")
                log(step, train_loss=train_loss, event="divergence_stop")
                break
            if step % fcfg.log_every == 0:
                log(step, train_loss=train_loss,
                           learning_rate=float(logs["learning_rate"]),
                           grad_norm=float(logs["grad_norm"]), epoch=epoch)
            if fcfg.check_val_every and step % fcfg.check_val_every == 0:
                run_validation()
            if _any_rank(preempted["flag"], mesh):
                stop_reason = "preemption signal: checkpointing and stopping"
            if stop_reason or (fcfg.max_steps and step >= fcfg.max_steps):
                stop_reason = stop_reason or f"max_steps {fcfg.max_steps} reached"
                break

    run_validation()  # final validation and checkpoint
    for sig, handler in old_handlers.items():
        signal.signal(sig, handler)
    if main:
        logger.close()
        ckpt.close()
    return {
        "state": state,
        "steps": step,
        "last_train_loss": train_loss,
        "best_val_loss": best_val if best_val < math.inf else None,
        "stop_reason": stop_reason or "completed all epochs",
        "wall_time_s": time.time() - t_start,
        "checkpoint_dir": str(run_dir),
    }
