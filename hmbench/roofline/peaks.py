"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): the least time of a piece of work
is the larger of its operations over the peak of its precision and its
bytes over the memory bandwidth."""

HBM_BYTES_PER_S = 3.35e12
F32_PEAK = 67e12  # float32 without tensor cores
TF32_PEAK = 495e12
BF16_PEAK = 989e12  # bf16 tensor cores

PEAKS = {"f32": F32_PEAK, "tf32": TF32_PEAK, "bf16": BF16_PEAK}


def least_ms(nbytes: float, ops: float, peak: float) -> float:
    """Least time in ms of moving ``nbytes`` and doing ``ops`` at ``peak``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak) * 1e3
