"""A single PPCA model over rows with structured missingness: each row's
mask is one of a few patterns, so the program takes its pattern route
(``Dataset.pattern_info``, ``ops/pattern_dedup``).

Rows: ``patterns`` masks, each entry observed with probability
``pattern_observed``; a pattern index drawn uniformly for each row; y = C z
+ mean + noise * eps with C ~ N(0, 1) * transform_std and a constant mean
(0 in the source), where observed
(``bench_suite.py``'s structured-missingness configuration, as
``chip_smoke.make_pattern_dataset`` draws it); made on the device from the
seed, 65,536 rows a call.  Everything else is :mod:`.ppca`'s.
"""

from __future__ import annotations

import torch

from . import common
from .ppca import VERBS, program_model, program_params, train_options, trainer  # noqa: F401


def make_inputs(cfg: dict, gen, device, train: bool) -> dict:
    D, k, n, P = cfg["output_size"], cfg["state_size"], cfg["rows"], cfg["patterns"]
    opts = dict(generator=gen, device=device, dtype=torch.float32)
    patterns = torch.rand(P, D, generator=gen, device=device) < cfg["pattern_observed"]
    mask = patterns[torch.randint(0, P, (n,), generator=gen, device=device)]
    C = torch.randn(D, k, **opts) * cfg["transform_std"]
    data = torch.empty(n, D, device=device, dtype=torch.float32)
    for lo, hi in common.chunks(n):
        y = (torch.randn(hi - lo, k, **opts) @ C.T + cfg["mean"]
             + cfg["noise"] * torch.randn(hi - lo, D, **opts))
        data[lo:hi] = torch.where(mask[lo:hi], y, torch.zeros_like(y))
    truth = {"Cs": C[None], "means": torch.full((1, D), float(cfg["mean"]), device=device),
             "sigmas": torch.full((1,), float(cfg["noise"]), device=device),
             "log_weights": None}
    inputs = {"data": data, "mask": mask, "truth": truth}
    if train:
        inputs["start"] = common.start_params(cfg, 1, gen, device)
    return inputs
