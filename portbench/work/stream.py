"""Work of one streamed EM iteration: the EM of :mod:`.train` on every row
(the same statistics, fullt and M-step), and the chunks' copies from the
host, each row's values, its 0/1 mask a byte an entry and its weight."""

from .train import estep_launches, useful_flops  # noqa: F401 - the same EM a row


def h2d_bytes(sizes: dict, rows: int) -> int:
    """Bytes copied from the host to the card for ``rows`` rows."""
    D = sizes["D"]
    return rows * (D * sizes["itemsize"] + D + max(sizes["itemsize"], 4))
