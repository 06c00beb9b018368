"""The program's own spans (``phyloformer_tpu_torch.spans``), for the
per-layer readers that read them.

The port records spans, from every thread, while a ``torch.profiler``
records; a ``--trace 1`` run starts one profiler, around the measured
window, so the port's last recording is the window's.  Set-up spans are
recorded always, in a list of their own.  A program without the recorder
gives nothing to read: every function here then returns None or an empty
list, and the readers return None.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional


def _recorder():
    try:
        from phyloformer_tpu_torch import spans
    except ImportError:
        return None
    return spans


def recording():
    """The window's recording (``start_ns``, ``spans``), or None."""
    rec = _recorder()
    return None if rec is None else rec.recorded()


def setup_spans() -> List:
    """The process's set-up spans, or an empty list."""
    rec = _recorder()
    return [] if rec is None else rec.setup_spans()


def named(rec, name: str) -> List:
    """The recording's spans of ``name``."""
    return [] if rec is None else [s for s in rec.spans if s.name == name]


def seconds(s) -> float:
    return (s.end_ns - s.start_ns) / 1e9


def within(rec, name: str, outer: str) -> Dict[int, List]:
    """The recording's spans of ``name`` by the id of their nearest
    enclosing span of ``outer`` (on their thread), those with none left out."""
    by_id = {s.id: s for s in rec.spans} if rec is not None else {}
    out: Dict[int, List] = {}
    for s in named(rec, name):
        up = by_id.get(s.parent)
        while up is not None and up.name != outer:
            up = by_id.get(up.parent)
        if up is not None:
            out.setdefault(up.id, []).append(s)
    return out


def p95_ms(values_s: List[float]) -> Optional[float]:
    """The 95th percentile in ms (``statistics.quantiles``, as the load
    generator's lateness), None under 20 values."""
    if len(values_s) < 20:
        return None
    return 1e3 * statistics.quantiles(values_s, n=20)[-1]
