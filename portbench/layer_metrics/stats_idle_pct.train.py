"""Share of the traced iterations' untraced time with nothing on the card
while the host was in the EM statistics pass (the program's
``ppca.em_stats`` span: the block loop, its products and kernels)."""

from portbench import program_spans


def read(view):
    return program_spans.train_idle_pct(view, "stats")
