"""A single PPCA model over fully observed rows: the program's dense route
(``ops/dense_fast``), reached as users reach it, through
``Dataset.unmasked``.

Rows: y = C z + mu + noise * eps with C ~ N(0, 1) * transform_std,
mu ~ N(0, 1), z and eps ~ N(0, I), every entry observed
(``bench_suite.py``'s fully observed configuration, with a mean); made on
the device from the seed, 65,536 rows a call.  The benchmark holds no
N x D mask of its own: the reference reads an all-True mask that is a
broadcast view of one row, while the program's dataset allocates its own
mask, as ``Dataset.unmasked`` does for users.  Everything else is
:mod:`.ppca`'s.
"""

from __future__ import annotations

import torch

from . import common
from .ppca import VERBS, program_model, program_params, train_options, trainer  # noqa: F401


def make_inputs(cfg: dict, gen, device, train: bool) -> dict:
    D, k, n = cfg["output_size"], cfg["state_size"], cfg["rows"]
    opts = dict(generator=gen, device=device, dtype=torch.float32)
    C = torch.randn(D, k, **opts) * cfg["transform_std"]
    mean = torch.randn(D, **opts)
    data = torch.empty(n, D, device=device, dtype=torch.float32)
    for lo, hi in common.chunks(n):
        data[lo:hi] = (torch.randn(hi - lo, k, **opts) @ C.T + mean
                       + cfg["noise"] * torch.randn(hi - lo, D, **opts))
    truth = {"Cs": C[None], "means": mean[None],
             "sigmas": torch.full((1,), float(cfg["noise"]), device=device),
             "log_weights": None}
    mask = torch.ones(1, D, dtype=torch.bool, device=device).expand(n, D)
    inputs = {"data": data, "mask": mask, "truth": truth}
    if train:
        inputs["start"] = common.start_params(cfg, 1, gen, device)
    return inputs


def dataset(inputs: dict):
    """The program's dataset over the rows, as users build a complete
    table's: ``Dataset.unmasked`` (which makes its own all-True mask)."""
    from ppca_rs_tpu_torch import Dataset

    return Dataset.unmasked(inputs["data"])
