"""The NVIDIA H100 SXM's published peaks (NVIDIA's data sheet, dense rates,
at its full 700 W): the roofline's denominators.  A run states the card's
power limit beside every share it reads against them."""

FP64_OPS_PER_S = 34e12  # FP64 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float) -> tuple:
    """(the least time the chip could take, which of the two bounds it)."""
    t_ops, t_bytes = ops / FP64_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
