"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet,
dense rates without sparsity, at the 700 W power limit)."""

BF16_FLOPS = 989e12     # tensor cores, bf16 and fp16
TF32_FLOPS = 495e12     # tensor cores, TF32
F32_FLOPS = 67e12       # CUDA cores, float32
HBM_BYTES = 3.35e12     # HBM3 bytes a second


def bound_s(flops: float, bytes_: float, peak_flops: float) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the memory's rate."""
    return max(flops / peak_flops, bytes_ / HBM_BYTES)
