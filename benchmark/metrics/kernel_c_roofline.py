"""Kernel C's share of its roofline: the work its launches in the window
need (``rooflines/kernel_c.py`` a real pair-site, times the pair-sites of
the window's steps, times C's launches a train step as the trace counts them)
at the larger of the TF32 peak's and the memory bandwidth's time, over C's
device seconds."""

from benchmark.rooflines import kernel_c, peaks


def read(r):
    if r.trace is None or not r.units:
        return None
    launches, seconds = r.trace.launches(kernel_c.KERNEL), r.trace.kernel_seconds(kernel_c.KERNEL)
    if not launches:
        return None
    sites = launches / r.units * r.pair_sites
    need = peaks.roofline_seconds(sites * kernel_c.flop_per_pair_site(r.sizes),
                                  sites * kernel_c.bytes_per_pair_site(r.sizes))
    return r.share(need, seconds)
