"""Share of the traced iterations' untraced time with nothing on the card
while the host was in neither the statistics pass nor the M-step: the
trainer loop, the llk read, the route, the parameters' stack and unstack.
With the two others it sums to idle_pct.train."""

from portbench import program_spans


def read(view):
    return program_spans.train_idle_pct(view, "loop")
