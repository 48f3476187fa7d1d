"""Share of the traced passes' untraced time with nothing on the card
while the host was in a block of a readout verb (a ``ppca.block`` span
inside ``ppca.readout``: the block's Gram, projections and kernel)."""

from portbench import program_spans


def read(view):
    return program_spans.readout_idle_pct(view, "blocks")
