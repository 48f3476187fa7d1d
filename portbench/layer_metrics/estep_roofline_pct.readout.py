"""The E-step kernels' share of their roofline over the traced passes:
the least time of the llk and states variants over every row, over the
device time of the kernels named spd_."""

from portbench import readers


def read(view):
    return readers.estep_roofline_pct(view)
