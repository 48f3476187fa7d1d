"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, 700 W).

The operations bound uses the dense TF32 tensor-core rate, the card's
fastest rate on float32 operands, so that no faithful float32
implementation can read above 100%.  The float32 rate outside the tensor
cores is printed beside it.
"""

PEAK_BYTES_PER_S = 3.35e12
PEAK_TF32_FLOPS = 495e12
PEAK_F32_SIMT_FLOPS = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take for this work."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_TF32_FLOPS)
