"""The whole streamed EM step's share of the card's dense TF32 peak: the
EM's useful operations of the traced iterations over their untraced time,
copies and all."""

from portbench import readers


def read(view):
    return readers.mfu_pct(view)
