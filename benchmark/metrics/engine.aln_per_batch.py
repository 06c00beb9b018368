"""Alignments a batch of the engine over the window, from its own counters
(``InferenceEngine.stats``): how full the buckets run."""


def read(r):
    batches = r.counters.get("engine.batches", 0)
    return r.counters["engine.alignments"] / batches if batches else None
