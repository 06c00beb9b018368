"""Share of the window that the train step's host code took: each
``train.step`` span less the ``train.wait`` spans inside it (where the
step waits for the device, at any depth), summed over the window's
seconds."""

from benchmark import program_spans


def read(r):
    return value(program_spans.recording(), r.window_s)


def value(rec, window_s):
    steps = program_spans.named(rec, "train.step")
    if not steps or window_s <= 0:
        return None
    waits = program_spans.within(rec, "train.wait", "train.step")
    host = sum(program_spans.seconds(s) - sum(program_spans.seconds(w)
                                              for w in waits.get(s.id, ()))
               for s in steps)
    return 100.0 * host / window_s
