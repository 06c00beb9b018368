"""The traced window: ``torch.profiler`` over the measured window, reduced
to what the per-layer metrics read.

The trace's raw Kineto events are read directly (no event tree is built,
which on a window of many thousand launches would take minutes).  From
them: the device's busy seconds (the union of every device interval,
copies included), the kernels' busy seconds (the union of the kernel
intervals), each kernel launch's name and duration, the device operations
that took the most time, and the idle gaps labelled with the innermost host
operation that was running at the middle of each gap.
"""

from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

TOP = 10  # entries of each list of the breakdown


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


@dataclass
class Summary:
    window_s: float
    busy_s: float = 0.0
    kernel_busy_s: float = 0.0
    kernels: List[Tuple[str, float]] = field(default_factory=list)  # (name, seconds) a launch
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def launches(self, pattern: Optional[str] = None) -> int:
        if pattern is None:
            return len(self.kernels)
        rx = re.compile(pattern)
        return sum(1 for name, _ in self.kernels if rx.search(name))

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(s for name, s in self.kernels if rx.search(name))


def summarize(prof, window_s: float) -> Summary:
    events = prof.profiler.kineto_results.events()
    device, host = [], []
    for e in events:
        kind = e.device_type()
        start, dur = e.start_ns(), e.duration_ns()
        if e.is_user_annotation():  # a host range mirrored on the device's timeline
            continue
        if kind == torch.autograd.DeviceType.CUDA:
            device.append((e.name(), start, start + dur))
        elif kind == torch.autograd.DeviceType.CPU and dur > 0:
            host.append((start, start + dur, e.name()))
    out = Summary(window_s=window_s)
    if not device:
        return out
    busy = _union([(s, e) for _, s, e in device])
    out.busy_s = sum(e - s for s, e in busy) / 1e9
    kernels = [(n, s, e) for n, s, e in device if not _is_copy(n)]
    out.kernel_busy_s = sum(e - s for s, e in _union([(s, e) for _, s, e in kernels])) / 1e9
    out.kernels = [(n, (e - s) / 1e9) for n, s, e in kernels]
    by_name: Dict[str, float] = {}
    for n, s, e in device:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    out.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    out.idle_gaps = _label_gaps(busy, host)
    return out


SHORT_GAP_NS = 10_000  # gaps shorter than this are summed under one label
LOOKBACK = 256  # host ops searched back from each gap's middle


def _label_gaps(busy: List[Tuple[int, int]], host: List[Tuple[int, int, str]]):
    """Idle time between device intervals, summed by the innermost host
    operation that spans each gap's middle ("no host op" where none of the
    ``LOOKBACK`` ops that started last before it does); gaps under 10 us
    are summed under one label."""
    host.sort()
    starts = [h[0] for h in host]
    by_label: Dict[str, float] = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        gap = s1 - e0
        if gap <= 0:
            continue
        label = "gaps under 10 us"
        if gap >= SHORT_GAP_NS:
            mid = e0 + gap // 2
            label, best = "no host op", None
            last = bisect.bisect_right(starts, mid) - 1
            for k in range(last, max(-1, last - LOOKBACK), -1):
                s, e, name = host[k]
                if e >= mid and (best is None or e - s < best):
                    label, best = name, e - s
        by_label[label] = by_label.get(label, 0.0) + gap / 1e9
    return sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]


class Window:
    """The measured window, traced or not: ``with Window(trace) as w: ...``;
    ``w.seconds`` is its host-clock length and ``w.summary`` the trace's
    reduction (None untraced).  The device is synchronised at both ends."""

    def __init__(self, trace: bool, device: torch.device):
        self.trace, self.device = trace, device
        self.prof = None
        self.summary: Optional[Summary] = None
        self.seconds = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def __exit__(self, *exc):
        self._sync()
        self.seconds = time.perf_counter() - self.t0
        if self.prof is not None:
            self.prof.__exit__(*exc)
            if exc[0] is None:
                self.summary = summarize(self.prof, self.seconds)
        return False
