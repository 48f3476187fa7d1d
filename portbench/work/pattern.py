"""Work of one EM iteration on the pattern route: N rows of D columns in a
few mask patterns, a single model of state size k, the rows sorted by
pattern (``pattern_dedup.em_stats_sorted``).

Useful operations are the route's own, counted once a row: b = R C and the
cross statistic R^T (w s), 2 D k each; s = b Sigma_p, 2 k^2; the segment
Gram (w s)^T s on its lower triangle, k(k+1); the row sums (centring and
masking, |R|^2, w R), 6 D; and, once an iteration, the M-step's row
solves.  The per-pattern work, each pattern's Gram and its ``full``
factorization, is left out, since the counts are given no number of
patterns: at the configuration's 32 patterns, D = 1024 and k = 64 it is
1.4e8 of 2.8e11 operations an iteration (0.05%).

Bytes an iteration must move: the sorted values read once, and the
weights.  The E-step kernel's launches are listed as ``(want, samples,
sigma_per_sample)``: the M-step's ``states``; the tables' one ``full``
launch over the patterns is left out for the same reason, and at the
configuration's sizes its least time is 8% of the ``states`` launch's, so
an E-step share of the roofline reads up to that much of itself low.
"""

from . import spd_estep


def useful_flops(sizes: dict, units: int, rows: int) -> float:
    """Operations of ``units`` iterations over ``rows`` rows in all."""
    D, k = sizes["D"], sizes["k"]
    per_row = 2 * 2 * D * k + 2 * k * k + k * (k + 1) + 6 * D
    return rows * per_row + units * D * spd_estep.ops("states", k)


def hbm_bytes(sizes: dict, units: int, rows: int) -> int:
    """Bytes read of ``units`` iterations over ``rows`` rows in all."""
    return rows * (sizes["D"] + 1) * sizes["itemsize"]


def estep_launches(sizes: dict, units: int, rows: int):
    return [("states", units * sizes["D"], False)]
