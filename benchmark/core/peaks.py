"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its full 700 W power limit; a run reports the card's own limit beside
every share of them)."""

F32_FLOPS = 67e12          # float32 outside the tensor cores
HBM_BYTES = 3.35e12        # HBM3 bytes per second


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: operations over the float32
    peak or bytes over the memory bandwidth, whichever is larger."""
    return max(flops / F32_FLOPS, nbytes / HBM_BYTES)
