"""Work of one EM iteration over N rows of D columns, M components of
state size k (M = 1: a single model).

Useful operations are the algorithm's own, counted once a row: the masked
Gram and the S statistic on lower triangles, 2 D k(k+1)/2 each; b = R C,
the cross statistic and m^T s, 2 D k each; the per-sample factorization
(fullt's); and, once an iteration, the M-step's row solves.  The E-step
kernel's launches are listed as ``(want, samples, sigma_per_sample)``.
"""

from . import spd_estep


def useful_flops(sizes: dict, units: int, rows: int) -> float:
    """Operations of ``units`` iterations over ``rows`` rows in all."""
    D, k, M = sizes["D"], sizes["k"], sizes["M"]
    per_row = 2 * D * k * (k + 1) + 3 * 2 * D * k + spd_estep.ops("fullt", k)
    return M * (rows * per_row + units * D * spd_estep.ops("states", k))


def estep_launches(sizes: dict, units: int, rows: int):
    D, M = sizes["D"], sizes["M"]
    return [("fullt", M * rows, M > 1), ("states", units * M * D, False)]
