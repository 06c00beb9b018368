"""Share of the window the training loop spent waiting in ``next()`` on
the loader (a span in the benchmark's own loop around each call)."""


def read(r):
    wait = r.spans.get("loader.wait_s")
    return None if wait is None else 100.0 * wait / r.window_s
