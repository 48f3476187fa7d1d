"""Share of the traced streamed iterations' untraced time with nothing on
the card, copies included."""

from portbench import readers


def read(view):
    return readers.idle_pct(view)
