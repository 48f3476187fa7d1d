"""What the model kinds share: the program's Dataset over the benchmark's
rows, and parameters read back from the program's models."""

from __future__ import annotations

import math

import torch


def dtype_of(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["dtype"])


def dataset(inputs: dict):
    from ppca_rs_tpu_torch import Dataset

    return Dataset.from_parts(inputs["data"], inputs["mask"])


def model(params: dict, index: int, device, dtype):
    """A ``PPCAModel`` of component ``index`` of the benchmark's parameters,
    through the public constructor (host arrays)."""
    from ppca_rs_tpu_torch import PPCAModel

    return PPCAModel(isotropic_noise=float(params["sigmas"][index]),
                     transform=params["Cs"][index].double().cpu().numpy(),
                     mean=params["means"][index].double().cpu().numpy(),
                     device=device, dtype=dtype)


def params_of(models, log_weights=None) -> dict:
    """The benchmark's parameter dict of the program's component models."""
    return {"Cs": torch.stack([m.transform.detach() for m in models]),
            "means": torch.stack([m.mean.detach() for m in models]),
            "sigmas": torch.stack([m.isotropic_noise.detach().reshape(()) for m in models]),
            "log_weights": None if log_weights is None else log_weights.detach()}


def start_params(cfg: dict, M: int, gen, device) -> dict:
    """A training start as ``PPCAModel.init`` draws one: C ~ N(0, 1), mean
    0, sigma 1, uniform weights for a mixture."""
    D, k = cfg["output_size"], cfg["state_size"]
    opts = dict(generator=gen, device=device, dtype=torch.float32)
    return {"Cs": torch.randn(M, D, k, **opts),
            "means": torch.zeros(M, D, device=device),
            "sigmas": torch.ones(M, device=device),
            "log_weights": None if M == 1 else torch.full((M,), -math.log(M), device=device)}


def chunks(n: int, step: int = 1 << 16):
    for lo in range(0, n, step):
        yield lo, min(lo + step, n)
