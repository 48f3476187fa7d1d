"""The whole EM step's share of the card's memory bandwidth on the dense
route: the bytes an iteration must read (``work/dense.py``: the values
once, and the weights) of the traced iterations over their untraced time,
of 3.35 TB/s.  The route launches no kernel of the port's own, so this is
the step's roofline, not a kernel's."""

from portbench import peaks


def read(view):
    if view.busy_s() <= 0 or view.base_s() <= 0:
        return None
    nbytes = view.work.hbm_bytes(view.sizes, view.units, view.rows)
    return nbytes / view.base_s() / peaks.PEAK_BYTES_PER_S * 100.0
