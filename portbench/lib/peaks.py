"""Peak rates of one NVIDIA H100 SXM (data sheet, dense, at 700 W).

A share of a peak or of a roofline is taken against these.  float32 work
is counted against 495 TFLOP/s, the chip's highest rate on float32
operands (TF32 on the tensor cores): a kernel that keeps float32 accuracy
on the tensor cores (three TF32 products a pair) can run above the 67
TFLOP/s of the float32 pipes, so against 67 its share could pass 100 %.
bfloat16 work is counted against 989 TFLOP/s.  Memory: 3.35 TB/s."""

from __future__ import annotations

FLOPS = {"float32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak for ``dtype`` and the bytes over the memory rate."""
    return max(flops / FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
