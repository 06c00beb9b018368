"""Kernel M's share of its roofline: the work its launches in the window
need (``rooflines/kernel_m.py`` a real pair-site, times the pair-sites of
the window's batches, times M's launches a batch as the trace counts them)
at the larger of the TF32 peak's and the memory bandwidth's time, over M's
device seconds."""

from benchmark.rooflines import kernel_m, peaks


def read(r):
    if r.trace is None or not r.units:
        return None
    launches, seconds = r.trace.launches(kernel_m.KERNEL), r.trace.kernel_seconds(kernel_m.KERNEL)
    if not launches:
        return None
    sites = launches / r.units * r.pair_sites
    need = peaks.roofline_seconds(sites * kernel_m.flop_per_pair_site(r.sizes),
                                  sites * kernel_m.bytes_per_pair_site(r.sizes))
    return r.share(need, seconds)
