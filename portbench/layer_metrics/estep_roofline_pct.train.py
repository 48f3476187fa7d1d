"""The E-step kernels' share of their roofline over the traced iterations:
the least time of fullt over every row and the M-step's row solves, over
the device time of the kernels named spd_."""

from portbench import readers


def read(view):
    return readers.estep_roofline_pct(view)
