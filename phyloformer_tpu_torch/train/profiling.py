"""Profiling and NaN checks for training.

The counterpart of ``phyloformer_tpu/train/profiling.py``:

- :func:`trace`: a ``torch.profiler`` trace of the enclosed block (host ops,
  and the card's kernels when there is one; shapes and memory recorded),
  written as a Chrome trace (``*.pt.trace.json``, for Perfetto or
  TensorBoard) into a directory, with the program's spans of the block
  (:mod:`..spans`: the loader's threads, the train step, the engine, the
  micro-batcher and HTTP threads) on rows of their own;
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
import json
import os
import pathlib
import socket
import time
from typing import Iterator, Sequence

import torch

from .. import spans

_nan_checks = False
# the program spans' rows of a Chrome trace: this offset plus the thread's id
SPAN_ROW = 1 << 32


@contextlib.contextmanager
def trace(log_dir) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block into a Chrome trace under ``log_dir``,
    the program's spans of the block added (:func:`add_spans`); yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    path = pathlib.Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    begin = time.time_ns()
    with profile(activities=activities, record_shapes=True, profile_memory=True) as prof:
        yield prof
    # the name TensorBoard's trace handler gives: worker, then a timestamp
    out = path / f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(str(out))
    rec = spans.recorded()
    if rec is not None and rec.start_ns >= begin:  # this block's recording
        add_spans(out, rec)


def add_spans(path, rec: spans.Recording) -> None:
    """Append a recording's spans to the Chrome trace at ``path``: complete
    events on the trace's time base, each thread's on a row of its own."""
    path = pathlib.Path(path)
    doc = json.loads(path.read_text())
    base = int(doc.get("baseTimeNanoseconds", 0))  # the trace's "ts" are us after it
    pid, events = os.getpid(), doc.setdefault("traceEvents", [])
    for tid, name in list(rec.threads.items()):
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": SPAN_ROW + tid,
                       "args": {"name": f"spans: {name}"}})
    for s in list(rec.spans):
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                       "tid": SPAN_ROW + s.tid, "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {**s.attrs, "id": s.id, "parent": s.parent}})
    path.write_text(json.dumps(doc))


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
