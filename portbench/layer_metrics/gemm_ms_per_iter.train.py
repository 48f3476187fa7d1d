"""Milliseconds per EM iteration of device time in the matrix products
(kernels named gemm, xmma, cutlass or sm90): the Gram, S and cross
statistics."""

from portbench import readers


def read(view):
    return readers.gemm_ms_per_unit(view)
