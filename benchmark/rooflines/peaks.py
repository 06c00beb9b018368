"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  Every share of a
peak or a roofline in this benchmark is stated against these, with the
card's measured power limit printed beside it."""

TF32_FLOPS = 495e12  # dense TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
RATED_POWER_W = 700.0


def roofline_seconds(flop: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations at
    the TF32 peak and the bytes at the memory bandwidth."""
    return max(flop / TF32_FLOPS, nbytes / HBM_BYTES_PER_S)
