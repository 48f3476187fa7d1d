"""Work of readout passes over ``rows`` rows of D columns, M components
of state size k (M = 1: a single model): a score (the llk variant) and an
imputation (the states variant, then C s + mu) of every row.

Useful operations are counted once a row, where the port builds the Gram
for each verb: the masked Gram on its lower triangle, 2 D k(k+1)/2; b =
R C, 2 D k; one factorization with its two solves; C s, 2 D k.
"""

from . import spd_estep


def useful_flops(sizes: dict, units: int, rows: int) -> float:
    """Operations of ``units`` passes of ``rows`` rows in all."""
    D, k, M = sizes["D"], sizes["k"], sizes["M"]
    per_row = D * k * (k + 1) + 2 * 2 * D * k + spd_estep.ops("states", k)
    return M * rows * per_row


def estep_launches(sizes: dict, units: int, rows: int):
    M = sizes["M"]
    return [("llk", M * rows, M > 1), ("states", M * rows, M > 1)]
