"""Cells cut to sizes a CPU test runs in seconds."""

from portbench.spec import Spec

SIZES = {
    "masked_k64": {"rows": 2048, "output_size": 96, "state_size": 16},
    "masked_k64_5m": {"rows": 2048, "output_size": 96, "state_size": 16},
    "mix_m8_k32": {"rows": 2048, "output_size": 64, "state_size": 8, "components": 3},
}
READOUT = {"check_rows": 16}


def cell(name: str, spec: Spec = None):
    c = (spec or Spec()).cell(name)
    c.config.update(SIZES[c.config["name"]])
    if c.traffic["kind"] == "readout":
        c.traffic.update(READOUT)
    return c
