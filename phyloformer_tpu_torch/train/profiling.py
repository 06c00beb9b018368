"""Profiling and NaN checks for training.

The counterpart of ``phyloformer_tpu/train/profiling.py``:

- :func:`trace`: a ``torch.profiler`` trace of the enclosed block (host ops,
  and the card's kernels when there is one; shapes and memory recorded),
  written as a Chrome trace (``*.pt.trace.json``, for Perfetto or
  TensorBoard) into a directory;
- :func:`profile_n_steps`: a number of train steps under :func:`trace`
  (``pf-train-torch --profile`` runs 10, then exits);
- :func:`enable_nan_checks`: fail fast on a non-finite loss or gradient.
  Autograd's anomaly mode raises (a ``RuntimeError`` naming the node) where
  a backward returns a NaN, but it does not see one that comes out of a
  kernel's forward, so the train step also checks the loss before the
  backward and every gradient after it (:func:`check_finite`), raising
  ``FloatingPointError``.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import socket
import time
from typing import Iterator, Sequence

import torch

_nan_checks = False


@contextlib.contextmanager
def trace(log_dir) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block into a Chrome trace under ``log_dir``;
    yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    path = pathlib.Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=True, profile_memory=True) as prof:
        yield prof
    # the name TensorBoard's trace handler gives: worker, then a timestamp
    prof.export_chrome_trace(
        str(path / f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def profile_n_steps(step_fn, state, batches, n_steps: int, log_dir, generator=None):
    """Run ``n_steps`` train steps of ``batches`` under :func:`trace`, with
    the dropout ``generator`` (or None); returns ``(state, logs, steps
    run)``."""
    logs, done = None, 0
    with trace(log_dir):
        for _, batch in zip(range(n_steps), batches):
            state, logs = step_fn(state, batch, generator)
            done += 1
        if logs is not None:
            float(logs["train_loss"])  # waits for the device
    return state, logs, done


def enable_nan_checks(enabled: bool = True) -> None:
    """Turn the NaN checks of every later train step (and autograd's anomaly
    mode) on or off, for the whole process, as the JAX package's
    ``jax_debug_nans`` switch does."""
    global _nan_checks
    _nan_checks = enabled
    torch.autograd.set_detect_anomaly(enabled)


def nan_checks_enabled() -> bool:
    return _nan_checks


def check_finite(loss: torch.Tensor, grads: Sequence[torch.Tensor] = ()) -> None:
    """Raise ``FloatingPointError`` if the loss or a gradient is not finite."""
    if not bool(torch.isfinite(loss).all()):
        raise FloatingPointError(f"non-finite loss: {loss.item()}")
    bad = [i for i, g in enumerate(grads) if not bool(torch.isfinite(g).all())]
    if bad:
        raise FloatingPointError(f"non-finite gradients in {len(bad)} of {len(grads)} "
                                 f"parameter leaves (first: leaf {bad[0]})")
