"""Spans of the port's layers, recorded while a ``torch.profiler`` records.

One recorder for the whole package.  A span site is

    with span("engine.batch", alignments=4):
        ...

or ``mark(name, start_ns, end_ns, **attrs)`` for an interval measured
elsewhere (a request's wait in the micro-batcher's queue).  Spans are
recorded from every thread, but only while a profiler records: the switch
is ``torch.autograd.profiler._is_profiler_enabled``, a module global that
every thread sees (the profiler's own per-thread state reads False on
threads other than the one that started it).  Off, a span site costs that
attribute read and a shared no-op context.  This module does not import
torch: where torch is not loaded no profiler can be on.

Clock: ``time.time_ns()``, the clock of the profiler's event timestamps,
so a span can be placed against the device's intervals.  While on, each
span also opens a profiler range of its name on its own thread
(``torch._C._profiler._RecordFunctionFast``; kept where that thread is
profiled, the one that started the profiler), so the trace names the
program's layer where no operator covers an idle gap.  A torch without the
switch records nothing; ``tests/test_torch_spans.py`` pins both names.

A recording starts with the first span after the profiler went from off to
on, in a buffer of at most ``MAX_SPANS`` (the rest are counted as
dropped); :func:`recorded` returns the last one.  Set-up spans
(:func:`setup_span`, names ``setup.*``) are always recorded, into a list
of their own (:func:`setup_spans`).
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from typing import Dict, List, Optional

MAX_SPANS = 1 << 20

_prof = None  # torch.autograd.profiler, once torch is loaded
_ids = itertools.count(1)
_tls = threading.local()
_lock = threading.Lock()
_live: Optional["Recording"] = None  # the recording being filled
_last: Optional["Recording"] = None
_setup: List["Span"] = []


def _find() -> bool:
    """Whether a profiler records, looking for torch's profiler module."""
    global _prof
    mod = sys.modules.get("torch.autograd.profiler")
    if mod is None or not hasattr(mod, "_is_profiler_enabled"):
        return False  # no torch, or one without the switch: nothing records
    _prof = mod
    return mod._is_profiler_enabled


def recording() -> bool:
    """Whether a profiler records, so that spans are kept."""
    return _prof._is_profiler_enabled if _prof is not None else _find()


class Recording:
    """The spans of one profiler session: ``spans`` in the order they
    ended, ``dropped`` past ``MAX_SPANS``, ``threads`` names by thread id."""

    def __init__(self):
        self.start_ns = time.time_ns()
        self.spans: List[Span] = []
        self.dropped = 0
        self.threads: Dict[int, str] = {}

    def add(self, s: "Span") -> None:
        if len(self.spans) < MAX_SPANS:
            self.spans.append(s)
        else:
            with _lock:
                self.dropped += 1


class Span:
    """One interval on one thread: ``parent`` is the id of the span that
    enclosed it on that thread (None at the top, and for a :func:`mark`)."""

    __slots__ = ("id", "name", "tid", "start_ns", "end_ns", "parent", "attrs", "_sink", "_rf")

    def __init__(self, name: str, attrs: dict, sink):
        self.id, self.name, self.attrs, self._sink = next(_ids), name, attrs, sink
        self.tid = threading.get_native_id()
        self.start_ns = self.end_ns = 0
        self.parent, self._rf = None, None

    def __enter__(self) -> "Span":
        stack = _tls.__dict__.setdefault("stack", [])
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        if _prof is not None and _prof._is_profiler_enabled:
            # a host operation of the trace (a ``record_function`` range is a
            # user annotation, which reductions of device idle skip)
            self._rf = sys.modules["torch"]._C._profiler._RecordFunctionFast(self.name)
            self._rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        _tls.stack.pop()
        self._sink(self)
        return False


class _Off:
    """The shared context of a span site while nothing records."""

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _recording_now() -> Recording:
    """The recording spans go to, started afresh after the profiler was off."""
    global _live, _last
    rec = _live
    if rec is None:
        with _lock:
            if _live is None:
                _live = _last = Recording()
            rec = _live
    t = threading.current_thread()
    if t.native_id not in rec.threads:
        rec.threads[t.native_id] = t.name
    return rec


def _close() -> None:
    """The profiler is off: the next span starts a new recording."""
    global _live
    with _lock:
        if not recording():
            _live = None


def span(name: str, **attrs):
    """A span of ``name`` around the enclosed block; the context yields the
    :class:`Span`, or None where nothing records."""
    if not (_prof._is_profiler_enabled if _prof is not None else _find()):
        if _live is not None:
            _close()
        return _OFF
    return Span(name, attrs, _recording_now().add)


def mark(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """Record an interval measured elsewhere (``time.time_ns()`` ends)."""
    if not (_prof._is_profiler_enabled if _prof is not None else _find()):
        return
    s = Span(name, attrs, None)
    s.start_ns, s.end_ns = start_ns, end_ns
    _recording_now().add(s)


def new_id() -> Optional[int]:
    """A fresh id to tie spans together (a request's ``rid``), or None
    where nothing records."""
    return next(_ids) if recording() else None


def setup_span(name: str, **attrs) -> Span:
    """A set-up span: recorded whether or not a profiler records."""
    return Span(name, attrs, _setup.append)


def setup_spans() -> List[Span]:
    """The process's set-up spans, in the order they ended."""
    return list(_setup)


def recorded() -> Optional[Recording]:
    """The last recording (None before any); once the profiler is off, the
    next span starts a new one."""
    if _live is not None and not recording():
        _close()
    return _last
