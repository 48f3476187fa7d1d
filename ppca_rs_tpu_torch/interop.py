"""Carry parameters and datasets across from the JAX package.

Every function takes plain numpy arrays (for example ``jax_model.transform``,
``np.asarray(jax_dataset.data)``), so this module imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import config
from .dataset import Dataset
from .models.mix import PPCAMix
from .models.ppca import PPCAModel


def _torch_dtype(array: np.ndarray, dtype):
    if dtype is not None:
        return dtype
    return torch.from_numpy(np.zeros(0, dtype=array.dtype)).dtype


def model_from_arrays(transform, mean, isotropic_noise, *, device=None,
                      dtype=None) -> PPCAModel:
    """A port ``PPCAModel`` with the given (D, k) transform, (D,) mean and
    scalar isotropic noise, in ``dtype`` (default: the transform's own)."""
    transform = np.asarray(transform)
    return PPCAModel(isotropic_noise=float(np.asarray(isotropic_noise)),
                     transform=transform, mean=np.asarray(mean),
                     device=device, dtype=_torch_dtype(transform, dtype))


def mix_from_arrays(transforms, means, noises, log_weights, *, device=None,
                    dtype=None) -> PPCAMix:
    """A port ``PPCAMix`` with one component per (D, k_i) transform, (D,)
    mean and scalar noise, and the given log-weights (normalized as
    ``PPCAMix`` does), in ``dtype`` (default: each transform's own)."""
    models = [model_from_arrays(C, mu, s, device=device, dtype=dtype)
              for C, mu, s in zip(transforms, means, noises)]
    return PPCAMix(models, np.asarray(log_weights, dtype=np.float64))


def dataset_from_arrays(data, mask, weights=None, *, device=None, dtype=None) -> Dataset:
    """A port ``Dataset`` from (N, D) values (zero-filled where masked),
    the (N, D) bool mask (True = observed) and optional (N,) weights, in
    ``dtype`` (default: the data's own)."""
    device = config.resolve_device(device)
    data = np.asarray(data)
    data = torch.as_tensor(data, dtype=_torch_dtype(data, dtype), device=device)
    return Dataset.from_parts(data, np.asarray(mask, dtype=bool),
                              None if weights is None else np.asarray(weights))
