"""Bayesian priors for MAP EM.

Port of ``ppca_rs_tpu/prior.py`` (itself a rebuild of `ppca/src/prior.rs`):
an immutable bundle, built by chained ``with_*`` calls, of
* a multivariate-normal **mean prior** (stores mean, covariance and its
  inverse/precision, `prior.rs:31-45`),
* an inverse-gamma **isotropic-noise prior** (shape alpha, rate beta,
  `prior.rs:47-56`),
* a scalar **transformation precision** — an independent normal prior per
  entry of C that acts as a ridge ``lambda I`` in the M-step row solves
  (`prior.rs:58-65`).

The default prior is uninformative (`prior.rs:17-28`), making
``iterate_with_prior(dataset, Prior())`` identical to ``iterate(dataset)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class Prior:
    __slots__ = (
        "_mean",
        "_mean_covariance",
        "_mean_precision",
        "_isotropic_noise_alpha",
        "_isotropic_noise_beta",
        "_transformation_precision",
        "_on_device",
    )

    def __init__(self):
        self._mean: Optional[np.ndarray] = None
        self._mean_covariance: Optional[np.ndarray] = None
        self._mean_precision: Optional[np.ndarray] = None
        self._isotropic_noise_alpha: Optional[float] = None
        self._isotropic_noise_beta: Optional[float] = None
        self._transformation_precision: float = 0.0
        self._on_device: dict = {}   # (dtype, device) -> device_pieces()

    def _copy(self) -> "Prior":
        new = Prior()
        new._mean = self._mean
        new._mean_covariance = self._mean_covariance
        new._mean_precision = self._mean_precision
        new._isotropic_noise_alpha = self._isotropic_noise_alpha
        new._isotropic_noise_beta = self._isotropic_noise_beta
        new._transformation_precision = self._transformation_precision
        return new

    # ------------------------------------------------------------------ #
    # with_* constructors (prior.rs:30-65)

    def with_mean_prior(self, mean, mean_covariance) -> "Prior":
        """Normal prior on the model mean; the covariance must be invertible
        (`prior.rs:31-45`)."""
        mean = np.asarray(mean, dtype=np.float64).reshape(-1)
        cov = np.asarray(mean_covariance, dtype=np.float64)
        if cov.shape != (mean.shape[0], mean.shape[0]):
            raise ValueError("mean covariance must be square and match the mean length")
        new = self._copy()
        new._mean = mean
        new._mean_covariance = cov
        new._mean_precision = np.linalg.inv(cov)
        return new

    def with_isotropic_noise_prior(self, alpha: float, beta: float) -> "Prior":
        """Inverse-gamma prior on sigma^2 with shape alpha, rate beta
        (`prior.rs:47-56`)."""
        if alpha < 0.0 or beta < 0.0:
            raise ValueError("alpha and beta must be non-negative")
        new = self._copy()
        new._isotropic_noise_alpha = float(alpha)
        new._isotropic_noise_beta = float(beta)
        return new

    def with_transformation_precision(self, precision: float) -> "Prior":
        """Independent normal prior on each entry of the transform; precision
        is 1/sigma^2 of that normal (`prior.rs:58-65`)."""
        if precision < 0.0:
            raise ValueError("precision must be non-negative")
        new = self._copy()
        new._transformation_precision = float(precision)
        return new

    # ------------------------------------------------------------------ #
    # accessors (prior.rs:67-95)

    def mean(self) -> Optional[np.ndarray]:
        return self._mean

    def mean_covariance(self) -> Optional[np.ndarray]:
        return self._mean_covariance

    def mean_precision(self) -> Optional[np.ndarray]:
        return self._mean_precision

    def has_mean_prior(self) -> bool:
        return self._mean is not None

    def has_isotropic_noise_prior(self) -> bool:
        return self._isotropic_noise_alpha is not None

    def isotropic_noise_alpha(self) -> float:
        if self._isotropic_noise_alpha is None:
            raise ValueError("isotropic noise prior not set")
        return self._isotropic_noise_alpha

    def isotropic_noise_beta(self) -> float:
        if self._isotropic_noise_beta is None:
            raise ValueError("isotropic noise prior not set")
        return self._isotropic_noise_beta

    def transformation_precision(self) -> float:
        return self._transformation_precision

    def device_pieces(self, dtype: torch.dtype, device):
        """(tprec, noise_prior, mean_prior) as tensors on ``device`` for the
        EM step; absent priors stay None.  Made once per (dtype, device) and
        kept, the prior being immutable: the scalars are filled on the
        device and the mean prior's arrays copied there, so later steps
        neither launch nor copy (a copy from pageable memory would wait for
        the device's stream).  Callers only read them."""
        key = (dtype, torch.device(device))
        if key not in self._on_device:
            def t(x):
                return torch.full((), x, dtype=dtype, device=device)

            noise_prior = mean_prior = None
            if self.has_isotropic_noise_prior():
                noise_prior = (t(self._isotropic_noise_alpha), t(self._isotropic_noise_beta))
            if self.has_mean_prior():
                mean_prior = tuple(torch.as_tensor(x, dtype=dtype, device=device)
                                   for x in (self._mean, self._mean_precision))
            self._on_device[key] = (t(self._transformation_precision), noise_prior, mean_prior)
        return self._on_device[key]

    def __repr__(self) -> str:
        parts = []
        if self.has_mean_prior():
            parts.append("mean_prior=set")
        if self.has_isotropic_noise_prior():
            parts.append(
                f"isotropic_noise_prior=(alpha={self._isotropic_noise_alpha}, "
                f"beta={self._isotropic_noise_beta})"
            )
        parts.append(f"transformation_precision={self._transformation_precision}")
        return f"Prior({', '.join(parts)})"
