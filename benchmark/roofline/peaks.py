"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit). The port's kernels do float32 arithmetic
outside the tensor cores."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def least_seconds(n_bytes: float, n_ops: float) -> tuple:
    """(the least seconds the card could take, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
