"""Cells cut to sizes a CPU test runs in seconds."""

from portbench.spec import Spec

SIZES = {
    "masked_k64": {"rows": 2048, "output_size": 96, "state_size": 16},
    "masked_k64_5m": {"rows": 2048, "output_size": 96, "state_size": 16},
    "mix_m8_k32": {"rows": 2048, "output_size": 64, "state_size": 8, "components": 3},
}
READOUT = {"check_rows": 16}


def sizes(cfg: dict) -> dict:
    """The CPU cut of a configuration: its entry in ``SIZES``, else 2048
    rows, D <= 96, k <= 16 and at most 3 components."""
    if cfg["name"] in SIZES:
        return SIZES[cfg["name"]]
    cut = {"rows": 2048, "output_size": min(cfg["output_size"], 96),
           "state_size": min(cfg["state_size"], 16)}
    if "components" in cfg:
        cut["components"] = min(cfg["components"], 3)
    return cut


def cell(name: str, spec: Spec = None):
    c = (spec or Spec()).cell(name)
    c.config.update(sizes(c.config))
    if "check_rows" in c.traffic:
        c.traffic.update(READOUT)
    return c
