"""The 95th percentile over the window's requests of the handler's parse:
each ``http.parse`` span, the body's read and the FASTA parse."""

from benchmark import program_spans


def read(r):
    return value(program_spans.recording())


def value(rec):
    return program_spans.p95_ms([program_spans.seconds(s)
                                 for s in program_spans.named(rec, "http.parse")])
