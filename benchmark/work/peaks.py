"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the 700 W limit): float32 outside the tensor cores and HBM3
bandwidth. Every share of a roofline or of the peak in this benchmark is
against these, with the card's power limit reported beside it."""

FLOPS_F32 = 67e12      # operations a second
HBM_BYTES = 3.35e12    # bytes a second


def least_time(ops: float, nbytes: float):
    """(seconds, "operations" | "bytes"): the larger of the two bounds."""
    t_ops, t_bytes = ops / FLOPS_F32, nbytes / HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
