"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit)."""

PEAK_FP32 = 67e12  # FLOP/s on the CUDA cores (the pod step and gain pass)
PEAK_BW = 3.35e12  # bytes/s of HBM3


def bound_s(flops: float, nbytes: float, peak: float = PEAK_FP32) -> float:
    """The least time the chip could take: the larger of operations over
    peak FLOP/s and bytes over peak bandwidth."""
    return max(flops / peak, nbytes / PEAK_BW)
