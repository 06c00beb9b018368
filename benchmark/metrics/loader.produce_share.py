"""Share of the window that the loader's producer threads spent loading
examples: the sum of the ``loader.load`` spans over the window's seconds
(one producer thread in the packed loader, so at most 100)."""

from benchmark import program_spans


def read(r):
    return value(program_spans.recording(), r.window_s)


def value(rec, window_s):
    loads = program_spans.named(rec, "loader.load")
    if not loads or window_s <= 0:
        return None
    return 100.0 * sum(program_spans.seconds(s) for s in loads) / window_s
