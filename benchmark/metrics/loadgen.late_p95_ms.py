"""The 95th percentile of how late the load generator sent each request
against its schedule: where it is high, the generator, not the server,
was behind."""

import statistics


def read(r):
    if len(r.late_ms) < 20:
        return None
    return statistics.quantiles(r.late_ms, n=20)[-1]
