"""The general traffic generator, one module per traffic ``kind``: it reads
a mix's parameters from ``portbench/traffic/<mix>.json``, sets the cell up,
drives the timed window, and checks what the window's path produced
against the reference."""
