"""The 95th percentile over the window's requests of their wait in the
micro-batcher's queue: the ``batcher.queue`` spans, each from the
request's submit to the start of its micro-batch's predict."""

from benchmark import program_spans


def read(r):
    return value(program_spans.recording())


def value(rec):
    return program_spans.p95_ms([program_spans.seconds(s)
                                 for s in program_spans.named(rec, "batcher.queue")])
