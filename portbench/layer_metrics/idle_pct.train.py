"""Share of the traced iterations' untraced time with nothing on the card."""

from portbench import readers


def read(view):
    return readers.idle_pct(view)
