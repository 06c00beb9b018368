"""The 95th percentile over the window's requests of the HTTP handler's own
time: each ``http.request`` span less its ``http.wait`` child (the wait
for the micro-batch's answer), which leaves the body's read, the FASTA
parse, the answer's PHYLIP and JSON and its write."""

from benchmark import program_spans


def read(r):
    return value(program_spans.recording())


def value(rec):
    waits = program_spans.within(rec, "http.wait", "http.request")
    return program_spans.p95_ms([
        program_spans.seconds(s) - sum(program_spans.seconds(w) for w in waits.get(s.id, ()))
        for s in program_spans.named(rec, "http.request")])
