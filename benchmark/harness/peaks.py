"""The card's peaks that the roofline shares divide by: NVIDIA's data-sheet
figures for one H100 SXM (dense, outside the tensor cores), which assume
its full 700 W power limit.  Each run prints the card's own power limit
beside its numbers (``device.power_limit_w``)."""

FP32_FLOPS = 67e12   # FP32 operations per second
HBM_BYTES = 3.35e12  # bytes per second to and from HBM3


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the FP32 peak and the bytes over the memory peak."""
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES)
