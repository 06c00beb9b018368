"""Share of the traced window in which no operation ran on the device
(the union of the trace's device intervals, copies included).  For closed
loops only: under open-loop arrivals the offered load sets it."""


def read(r):
    if r.trace is None or r.trace.busy_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - r.trace.busy_s / r.window_s)
