"""Kernel launches per EM iteration: device kernels the profiler counts in the
traced iterations, over their number."""

from portbench import readers


def read(view):
    return readers.launches_per_unit(view)
