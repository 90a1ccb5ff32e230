"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet, dense rates without sparsity). Every share of a peak or of a
roofline that the benchmark reports is taken against these numbers."""

PEAK_FLOPS = {
    "float32": 67e12,  # outside the tensor cores (the configs run without TF32)
    "bfloat16": 989e12,  # tensor cores, float32 accumulation
}
PEAK_BYTES_PER_S = 3.35e12  # HBM3


def peak_flops(compute_dtype: str) -> float:
    """The peak of a config's `compute_dtype` ("float32" or "bfloat16")."""
    return PEAK_FLOPS[compute_dtype]


def bound_seconds(flops: float, nbytes: float, compute_dtype: str = "float32") -> float:
    """The least time the card could take: operations over the peak or bytes
    over the bandwidth, whichever is larger."""
    return max(flops / peak_flops(compute_dtype), nbytes / PEAK_BYTES_PER_S)
