"""The 95th percentile over the window's requests of their micro-batch's
predict: the duration of the ``batcher.predict`` span whose ``rids`` hold
each request's id, counted once a request."""

from benchmark import program_spans


def read(r):
    return value(program_spans.recording())


def value(rec):
    return program_spans.p95_ms([program_spans.seconds(s)
                                 for s in program_spans.named(rec, "batcher.predict")
                                 for rid in s.attrs.get("rids", ()) if rid is not None])
