"""Seconds of set-up inside the program's entry points: the sum of the
outermost ``setup.*`` spans (the kernel library, the weights, the engine,
the train state, the loader, the server; none inside another) that ended
before the window's recording began."""

from benchmark import program_spans


def read(r):
    return value(program_spans.setup_spans(), program_spans.recording())


def value(setup, rec):
    if rec is None or not setup:
        return None
    ids = {s.id for s in setup}
    outer = [s for s in setup if s.parent not in ids and s.end_ns <= rec.start_ns]
    return sum(program_spans.seconds(s) for s in outer) if outer else None
