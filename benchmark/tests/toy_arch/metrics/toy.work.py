"""Sequence-sites a second of the window, from the runner's ``work``."""


def read(r):
    sites = r.work.get("sequence_sites")
    return sites / r.window_s if sites else None
