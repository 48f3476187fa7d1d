"""The whole readout's share of the card's dense TF32 peak: useful
operations of the traced passes over their untraced time."""

from portbench import readers


def read(view):
    return readers.mfu_pct(view)
