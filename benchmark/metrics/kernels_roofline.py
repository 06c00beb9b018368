"""The published model's operations on the window's inputs
(``rooflines/model.py``) over the seconds in which a kernel ran, as a share
of the TF32 peak (``rooflines/peaks.py``): the kernels' rate on the work
that the inputs need, whatever the program computes besides."""

from benchmark.rooflines import peaks


def read(r):
    if r.trace is None:
        return None
    return r.share(r.model_flop, r.trace.kernel_busy_s * peaks.TF32_FLOPS)
