"""A PPCA mixture: ``PPCAMix`` trained by ``PPCAMixTrainer``.

Rows: each from one of ``components`` components drawn uniformly, y =
C_m z + mu_m + noise * eps with C_m ~ N(0, 1) * transform_std and mu_m ~
mean_scale * N(0, 1), each entry missing with probability ``missing``; made
on the device from the seed, 65,536 rows a call.
"""

from __future__ import annotations

import math

import torch

from . import common


def make_inputs(cfg: dict, gen, device, train: bool) -> dict:
    D, k, n, M = cfg["output_size"], cfg["state_size"], cfg["rows"], cfg["components"]
    opts = dict(generator=gen, device=device, dtype=torch.float32)
    Cs = torch.randn(M, D, k, **opts) * cfg["transform_std"]
    means = cfg["mean_scale"] * torch.randn(M, D, **opts)
    comp = torch.randint(0, M, (n,), generator=gen, device=device)
    data = torch.empty(n, D, device=device, dtype=torch.float32)
    mask = torch.empty(n, D, device=device, dtype=torch.bool)
    for lo, hi in common.chunks(n):
        c = comp[lo:hi]
        z = torch.randn(hi - lo, k, **opts)
        y = means[c] + cfg["noise"] * torch.randn(hi - lo, D, **opts)
        for j in range(M):
            y += torch.where((c == j)[:, None], z @ Cs[j].T, 0.0)
        m = torch.rand(hi - lo, D, generator=gen, device=device) >= cfg["missing"]
        data[lo:hi] = torch.where(m, y, torch.zeros_like(y))
        mask[lo:hi] = m
    truth = {"Cs": Cs, "means": means,
             "sigmas": torch.full((M,), float(cfg["noise"]), device=device),
             "log_weights": torch.full((M,), -math.log(M), device=device)}
    inputs = {"data": data, "mask": mask, "truth": truth}
    if train:
        inputs["start"] = common.start_params(cfg, M, gen, device)
    return inputs


def program_model(params: dict, cfg: dict, device):
    from ppca_rs_tpu_torch import PPCAMix

    dtype = common.dtype_of(cfg)
    models = [common.model(params, j, device, dtype) for j in range(params["Cs"].shape[0])]
    return PPCAMix(models, params["log_weights"].double().cpu().numpy())


def program_params(mix) -> dict:
    return common.params_of(mix.models, mix.log_weights)


def trainer(dataset):
    from ppca_rs_tpu_torch import PPCAMixTrainer

    return PPCAMixTrainer(dataset)


def train_options(cfg: dict) -> dict:
    return {"state_size": cfg["state_size"], "n_models": cfg["components"]}


VERBS = {
    "score": lambda mix, ds: mix.infer_cluster(ds),
    "impute": lambda mix, ds: mix.extrapolate(ds).data,
}
