"""The chunks' copies' share of the host-to-device link: the traced rows'
values, masks and weights over the union of the copies' intervals, of one
direction of PCIe Gen5 x16 (64 GB/s)."""

from portbench import transfer


def read(view):
    return transfer.h2d_roofline_pct(view)
