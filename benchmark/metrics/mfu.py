"""The whole step's share of the chip's peak: the published model's
operations on the window's inputs (``rooflines/model.py``) over the
seconds in which the system had work, at the TF32 peak
(``rooflines/peaks.py``).  Those seconds are the traced window's for a
closed loop (offline passes, training steps), and for served requests the
union of their times in flight, so that waiting for arrivals, which the
offered load sets, is not counted."""

from benchmark.rooflines import peaks


def read(r):
    return r.share(r.model_flop, r.active_s * peaks.TF32_FLOPS)
