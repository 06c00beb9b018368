"""Requests a micro-batch over the window, from the batcher's own counters
as ``GET /healthz`` shows them."""


def read(r):
    batches = r.counters.get("batcher.batches", 0)
    return r.counters["batcher.requests"] / batches if batches else None
