"""A single masked PPCA model: ``PPCAModel`` trained by ``PPCATrainer``.

Rows: y = C z + mu + noise * eps with C ~ N(0, 1) * transform_std,
mu ~ N(0, 1), z and eps ~ N(0, I), each entry missing with probability
``missing``; made on the device from the seed, 65,536 rows a call.
"""

from __future__ import annotations

import torch

from . import common


def make_inputs(cfg: dict, gen, device, train: bool) -> dict:
    D, k, n = cfg["output_size"], cfg["state_size"], cfg["rows"]
    opts = dict(generator=gen, device=device, dtype=torch.float32)
    C = torch.randn(D, k, **opts) * cfg["transform_std"]
    mean = torch.randn(D, **opts)
    data = torch.empty(n, D, device=device, dtype=torch.float32)
    mask = torch.empty(n, D, device=device, dtype=torch.bool)
    for lo, hi in common.chunks(n):
        z = torch.randn(hi - lo, k, **opts)
        y = z @ C.T + mean + cfg["noise"] * torch.randn(hi - lo, D, **opts)
        m = torch.rand(hi - lo, D, generator=gen, device=device) >= cfg["missing"]
        data[lo:hi] = torch.where(m, y, torch.zeros_like(y))
        mask[lo:hi] = m
    truth = {"Cs": C[None], "means": mean[None],
             "sigmas": torch.full((1,), float(cfg["noise"]), device=device),
             "log_weights": None}
    inputs = {"data": data, "mask": mask, "truth": truth}
    if train:
        inputs["start"] = common.start_params(cfg, 1, gen, device)
    return inputs


def program_model(params: dict, cfg: dict, device):
    return common.model(params, 0, device, common.dtype_of(cfg))


def program_params(model) -> dict:
    return common.params_of([model])


def trainer(dataset):
    from ppca_rs_tpu_torch import PPCATrainer

    return PPCATrainer(dataset)


def train_options(cfg: dict) -> dict:
    return {"state_size": cfg["state_size"]}


#: The readout verbs a traffic mix names, as this kind's calls.
VERBS = {
    "score": lambda model, ds: model.llks(ds),
    "impute": lambda model, ds: model.extrapolate(ds).data,
}
