"""Kernel launches in the device trace over the engine's batches in the
window: every device kernel the pipeline and its tensor code launch."""


def read(r):
    batches = r.counters.get("engine.batches", 0)
    if r.trace is None or not batches or not r.trace.kernels:
        return None
    return r.trace.launches() / batches
