"""Work of one EM iteration on the dense route: N fully observed rows of D
columns, a single model of state size k (``dense_fast.em_stats`` and
``em_finalize``).

Useful operations are the route's own, counted once a row: b = R C and the
cross statistic R^T (w s), 2 D k each; s = b M^{-1}, 2 k^2; the shared
second moment s^T (w s) on its lower triangle, k(k+1); the row sums
(centring, |R|^2, w R), 6 D; and, once an iteration, the M-step's one
solve with D right-hand sides, 2 k^2 D.  The one k x k factorization an
iteration (k^3 / 3) is left out.

Bytes an iteration must move: the values read once, and the weights.  The
route launches no E-step kernel, so no launch is listed.
"""


def useful_flops(sizes: dict, units: int, rows: int) -> float:
    """Operations of ``units`` iterations over ``rows`` rows in all."""
    D, k = sizes["D"], sizes["k"]
    per_row = 2 * 2 * D * k + 2 * k * k + k * (k + 1) + 6 * D
    return rows * per_row + units * 2 * k * k * D


def hbm_bytes(sizes: dict, units: int, rows: int) -> int:
    """Bytes read of ``units`` iterations over ``rows`` rows in all."""
    return rows * (sizes["D"] + 1) * sizes["itemsize"]


def estep_launches(sizes: dict, units: int, rows: int):
    return []
