"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit) and the least time a piece of work can
take on it."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12          # outside the tensor cores


def bound_s(nbytes: float, flops: float) -> float:
    """The roofline's least time: the larger of the bytes over the
    memory bandwidth and the float32 operations over their peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)
