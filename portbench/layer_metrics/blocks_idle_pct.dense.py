"""Share of the traced iterations' untraced time with nothing on the card
while the host was in a row block of the EM statistics pass (a
``ppca.block`` span inside ``ppca.em_stats``: on the dense route, a block
of rows against the one shared factorization).  None where the program
opens no block span (a program older than the dense route's spans)."""

from portbench import program_spans


def part(names):
    return "blocks" if {"ppca.em_stats", "ppca.block"} <= names else None


def read(view):
    if not any(iv.name == "ppca.block" for iv in view.host):
        return None
    split = program_spans.idle_pct_by(view, part, ("blocks",))
    return None if split is None else split["blocks"]
