"""Share of the traced iterations' untraced time with nothing on the card
while the host was in the M-step (the program's ``ppca.em_finalize`` span:
the row solves, the noise and the mean; a mixture's loop over its
components)."""

from portbench import program_spans


def read(view):
    return program_spans.train_idle_pct(view, "mstep")
