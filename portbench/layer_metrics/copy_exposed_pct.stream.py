"""Share of the traced iterations' untraced time in which a chunk's copy
from the host ran with no kernel on the card: the copies that the
streaming trainer's prefetch does not hide behind the statistics."""

from portbench import transfer


def read(view):
    return transfer.copy_exposed_pct(view)
