"""Share of the traced passes' untraced time with nothing on the card
while the host was in a readout verb outside its blocks (``ppca.readout``
with no ``ppca.block``: the route, the parameters' stack, the C s + mu
fill, the concatenations, ``Dataset.unmasked``, and a mixture's combine
of each block's states)."""

from portbench import program_spans


def read(view):
    return program_spans.readout_idle_pct(view, "entry")
