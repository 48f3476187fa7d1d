"""Bytes and operations of ``ops/kernels.spd_estep``'s contract, independent
of the layout that carries its inputs.

Read once: G's lower triangle, k(k+1)/2 entries a sample, whatever layout
carries it; b; rnorm; d_obs; a sigma per sample where there is one (else
one).  Written once: the variant's outputs, of fullt's second moment the
lower triangle only.  Operations from k: the Cholesky factor k^3/3, the
inverse 2k^3/3 where the variant forms one, k^2 for each triangular solve
and for s s^T.
"""

#: Elements each variant writes a sample, and its operations a sample.
_OUT = {
    "llk": lambda k: 1,
    "states": lambda k: k + 1,
    "fullt": lambda k: k + k * (k + 1) // 2 + 2,
    "infer": lambda k: k + k * k + 2,
    "full": lambda k: k + k * k + 2,
}
_OPS = {
    "llk": lambda k: k ** 3 / 3 + k * k,
    "states": lambda k: k ** 3 / 3 + 2 * k * k,
    "fullt": lambda k: k ** 3 + 3 * k * k,
    "infer": lambda k: k ** 3 + 3 * k * k,
    "full": lambda k: k ** 3 + 3 * k * k,
}


def ops(want: str, k: int) -> float:
    """Operations of one sample."""
    return _OPS[want](k)


def launch(want: str, samples: int, k: int, itemsize: int = 4, sigma_per_sample: bool = False):
    """(bytes, operations) of factoring ``samples`` samples of state size k."""
    read = samples * (k * (k + 1) // 2 + k + 2) + (samples if sigma_per_sample else 1)
    written = samples * _OUT[want](k)
    return (read + written) * itemsize, samples * _OPS[want](k)
