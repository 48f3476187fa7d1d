"""Probabilistic PCA with missing data — single model, on torch tensors.

Port of ``ppca_rs_tpu/models/ppca.py`` (itself a rebuild of
`ppca/src/ppca_model.rs`).  The statistical model (`ppca_model.rs:24-40`):

    x ~ N(0, I_k)            # latent state
    y = C x + mu + eps       # observed, D dims
    eps ~ N(0, sigma^2 I_D)  # isotropic noise

Every verb has one body: it asks ``parallel/placement.place`` where the
dataset lives and ``models/routes.route`` which route its rows take, and
runs that route with the placement's columns, reduction and gather.
Computations run on the device of the model's parameters, which must match
the dataset's.  On a sharded dataset readouts give this rank's rows, the
llk and the EM steps cover all rows and are the same on every rank, and
every rank must call them at the same point.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import config
from ..dataset import Dataset
from ..ops import kernels
from ..ops import masked_linalg as ml
from ..parallel.placement import place
from ..prior import Prior
from ..utils.profiling import span
from ..utils.rng import ensure_generator
from ..utils.serialization import dump_bytes, load_bytes
from . import routes


def _as_vector(arr, name: str) -> np.ndarray:
    """Accept (D,), (D,1) or (1,D) arrays, like the bindings' numpy->vector
    converter (`src/utils.rs:12-23`)."""
    a = np.asarray(arr, dtype=np.float64)
    if a.ndim == 2:
        if 1 in a.shape:
            a = a.reshape(-1)
        else:
            raise ValueError(f"{name} must be a vector; got shape {a.shape}")
    elif a.ndim != 1:
        raise ValueError(f"{name} must be a vector; got shape {a.shape}")
    return a


class PPCAModel(nn.Module):
    """A PPCA model which can infer missing values (`ppca_model.rs:24-40`).

    ``transform`` (D, k), ``mean`` (D,) and ``isotropic_noise`` (a 0-dim
    tensor) are buffers: EM needs no autograd."""

    transform: torch.Tensor
    mean: torch.Tensor
    isotropic_noise: torch.Tensor

    def __init__(self, isotropic_noise=None, transform=None, mean=None, *,
                 device=None, dtype=None):
        super().__init__()
        if transform is None or mean is None or isotropic_noise is None:
            raise TypeError("PPCAModel requires isotropic_noise, transform and mean")
        t = np.asarray(transform, dtype=np.float64)
        if t.ndim != 2:
            raise ValueError(f"transform must be 2D (D, state_size); got {t.shape}")
        m = _as_vector(mean, "mean")
        if m.shape[0] != t.shape[0]:
            raise ValueError(
                f"mean length {m.shape[0]} does not match transform rows {t.shape[0]}"
            )
        device = config.resolve_device(device)
        dtype = dtype or config.dtype
        self.register_buffer("transform", torch.as_tensor(t, dtype=dtype, device=device))
        self.register_buffer("mean", torch.as_tensor(m, dtype=dtype, device=device))
        self.register_buffer(
            "isotropic_noise", torch.tensor(float(isotropic_noise), dtype=dtype, device=device))

    @classmethod
    def _from_params(cls, transform, mean, isotropic_noise) -> "PPCAModel":
        obj = cls.__new__(cls)
        nn.Module.__init__(obj)
        obj.register_buffer("transform", transform)
        obj.register_buffer("mean", mean)
        obj.register_buffer("isotropic_noise", isotropic_noise.reshape(()))
        return obj

    # ------------------------------------------------------------------ #
    # construction

    @staticmethod
    def init(state_size: int, dataset: Dataset,
             generator: Optional[torch.Generator] = None) -> "PPCAModel":
        """Random untrained model: C ~ N(0,1) with empty-dimension rows
        zeroed, sigma = 1, mu = 0 (`ppca_model.rs:51-70`).  On a sharded
        dataset every rank calls it, and every rank gets rank 0's draw."""
        if dataset.is_empty():
            raise ValueError("dataset must not be empty")
        D = dataset.output_size()
        device = dataset.device
        dtype = torch.promote_types(dataset.dtype, torch.float32)
        gen = ensure_generator(generator, device)
        C = torch.randn((D, state_size), generator=gen, dtype=dtype, device=gen.device).to(device)
        empty = dataset.empty_dimensions()
        if empty:
            C[torch.as_tensor(empty, device=device)] = 0.0
        mean = torch.zeros(D, dtype=dtype, device=device)
        place(dataset).replicate([C])
        return PPCAModel._from_params(C, mean, torch.ones((), dtype=dtype, device=device))

    # ------------------------------------------------------------------ #
    # properties (ppca_model.rs:73-121)

    @property
    def output_size(self) -> int:
        return int(self.transform.shape[0])

    @property
    def state_size(self) -> int:
        return int(self.transform.shape[1])

    @property
    def n_parameters(self) -> int:
        """1 + k*D + D (`ppca_model.rs:107-109`)."""
        return 1 + self.state_size * self.output_size + self.output_size

    @property
    def singular_values(self) -> torch.Tensor:
        """sqrt of each column norm — matches the reference exactly, which
        takes ``column.norm().sqrt()`` (`ppca_model.rs:113-121`)."""
        return torch.sqrt(torch.linalg.vector_norm(self.transform, dim=0))

    @property
    def device(self) -> torch.device:
        return self.transform.device

    def extra_repr(self) -> str:
        return (f"output_size={self.output_size}, state_size={self.state_size}, "
                f"isotropic_noise={float(self.isotropic_noise)}")

    # ------------------------------------------------------------------ #
    # serialization (src/python_bindings.rs:388-401,513-532)

    def dump(self) -> bytes:
        def host(t):
            return t.detach().cpu().to(torch.float64).numpy()

        return dump_bytes(
            "ppca_model",
            {
                "transform": host(self.transform),
                "mean": host(self.mean),
                "isotropic_noise": host(self.isotropic_noise),
            },
        )

    @staticmethod
    def load(data: bytes, *, device=None, dtype=None) -> "PPCAModel":
        arrays, _ = load_bytes(data, "ppca_model")
        return PPCAModel(
            isotropic_noise=float(arrays["isotropic_noise"]),
            transform=arrays["transform"],
            mean=arrays["mean"],
            device=device,
            dtype=dtype,
        )

    def __reduce__(self):
        return (PPCAModel.load, (self.dump(),))

    # ------------------------------------------------------------------ #
    # likelihood (ppca_model.rs:124-159)

    def _params(self):
        return self.transform, self.mean, self.isotropic_noise

    def _block_rows(self, dataset: Dataset) -> int:
        """Rows per block of the blocked loops over ``dataset``
        (``config.block_rows``: fewer at large k)."""
        itemsize = ml._compute_dtype(dataset.data, self.transform).itemsize
        return config.block_rows(self.state_size, itemsize)

    def llk(self, dataset: Dataset) -> float:
        """Weighted total log-likelihood (`ppca_model.rs:142-149`); of all
        ranks' rows for a sharded dataset."""
        if dataset.is_empty():
            return 0.0
        return float(place(dataset).row_sum(self.llks(dataset), dataset.weights_dev))

    def llks(self, dataset: Dataset) -> torch.Tensor:
        """Per-sample log-likelihoods, (N,) (`ppca_model.rs:152-159`)."""
        with span("ppca.readout"):
            return self._readout("llks", dataset)

    def _readout(self, verb: str, dataset: Dataset):
        """``verb`` ("llks", "states" or "infer") of the dataset's rows on
        their route."""
        where = place(dataset)
        C, mean = where.columns(self.transform, self.mean)
        return routes.readout(verb, routes.route(dataset), C, mean, self.isotropic_noise, dataset,
                              self._block_rows(dataset), where.group)

    # ------------------------------------------------------------------ #
    # sampling (ppca_model.rs:164-191)

    def sample(self, dataset_size: int, mask_prob: float,
               generator: Optional[torch.Generator] = None) -> Dataset:
        """Generative sampling with Bernoulli masking: each entry is masked
        with probability ``mask_prob``."""
        C, mean, sigma = self._params()
        gen = ensure_generator(generator, self.device)
        opts = dict(generator=gen, dtype=C.dtype, device=gen.device)
        n, D = int(dataset_size), self.output_size
        z = torch.randn((n, self.state_size), **opts).to(self.device)
        eps = torch.randn((n, D), **opts).to(self.device)
        observed = (torch.rand((n, D), **opts) < 1.0 - mask_prob).to(self.device)
        values = z @ C.T + mean + sigma * eps
        return Dataset.from_parts(torch.where(observed, values, torch.zeros_like(values)),
                                  observed)

    # ------------------------------------------------------------------ #
    # inference (ppca_model.rs:195-261)

    def uninferred(self, n: int = 1) -> "InferredMasked":
        """Posterior batch of ``n`` samples at the prior N(0, I), the
        posterior of an all-masked sample (`ppca_model.rs:98-104`)."""
        k, opts = self.state_size, dict(dtype=self.transform.dtype, device=self.device)
        return InferredMasked(self, torch.zeros((n, k), **opts),
                              torch.eye(k, **opts).expand(n, k, k))

    def inferred_one(self, state, covariance) -> "InferredMasked":
        """Posterior batch from raw values (`ppca_model.rs:211-217`): a
        single (k,)/(k, k) pair or stacked (n, k)/(n, k, k) arrays."""
        opts = dict(dtype=self.transform.dtype, device=self.device)
        state = torch.atleast_2d(torch.as_tensor(state, **opts))
        covariance = torch.as_tensor(covariance, **opts)
        if covariance.ndim == 2:
            covariance = covariance[None]
        return InferredMasked(self, state, covariance)

    def infer(self, dataset: Dataset) -> "InferredMasked":
        with span("ppca.readout"):
            return InferredMasked(self, *self._readout("infer", dataset))

    def _smoothed(self, dataset: Dataset, extrapolate: bool) -> Dataset:
        """The smoothed (or extrapolated) values, with the dataset's weights
        and place on its mesh: a sharded dataset's are this rank's rows and
        columns."""
        with span("ppca.readout"):
            C, mean = place(dataset).columns(self.transform, self.mean)
            out = self._readout("states", dataset) @ C.T + mean
            if extrapolate:
                out = torch.where(dataset.mask, dataset.data, out)
            new = Dataset.unmasked(out, dataset.weights_dev)
            new._shard = dataset._shard
            return new

    def smooth(self, dataset: Dataset) -> Dataset:
        """De-noise observed values and fill missing ones
        (`ppca_model.rs:231-244`); preserves dataset weights."""
        return self._smoothed(dataset, extrapolate=False)

    def extrapolate(self, dataset: Dataset) -> Dataset:
        """Fill missing values, keeping observed ones untouched
        (`ppca_model.rs:248-261`); preserves dataset weights."""
        return self._smoothed(dataset, extrapolate=True)

    # ------------------------------------------------------------------ #
    # EM (ppca_model.rs:263-393)

    def iterate(self, dataset: Dataset) -> "PPCAModel":
        """One EM iteration; the log-likelihood never decreases
        (`ppca_model.rs:263-269`)."""
        return self._em_step(dataset, None)[0]

    def iterate_with_prior(self, dataset: Dataset, prior: Prior) -> "PPCAModel":
        """One MAP-EM iteration with the supplied prior
        (`ppca_model.rs:271-393`)."""
        return self._em_step(dataset, prior)[0]

    def _em_step(self, dataset: Dataset, prior: Optional[Prior]) -> Tuple["PPCAModel", torch.Tensor]:
        """One EM step: (new model, weighted llk of *this* model as a 0-dim
        tensor), both from the same pass over the data."""
        if dataset.is_empty():
            # the reference panics with expect("non-empty dataset")
            # (ppca_model.rs:358); raise instead of returning a NaN model.
            raise ValueError("cannot iterate on an empty dataset")
        with span("ppca.em_step"):
            priors = device_priors(prior, self.transform)
            where = place(dataset)
            C, mean = where.columns(self.transform, self.mean)
            sigma = self.isotropic_noise
            way = routes.route(dataset)
            with span("ppca.em_stats"):
                stats = where.reduce(routes.em_stats(way, C, mean, sigma, dataset,
                                                     self._block_rows(dataset), where.group))
            with span("ppca.em_finalize"):
                C, mean, sigma = routes.em_finalize(way, C, mean, sigma, stats, priors, where.group)
                C, mean = where.gather(C, mean)
            return PPCAModel._from_params(C, mean, sigma), stats.llk

    def _iterate_with_llk(self, dataset: Dataset, prior: Optional[Prior]) -> Tuple["PPCAModel", float]:
        """EM step: (new model, llk of *this* model on the dataset)."""
        model, llk = self._em_step(dataset, prior)
        return model, float(llk)

    def iterate_n(self, dataset: Dataset, n_iters: int,
                  prior: Optional[Prior] = None) -> Tuple["PPCAModel", torch.Tensor]:
        """``n_iters`` (MAP-)EM iterations.  Returns ``(model, llks)`` with
        ``llks[i]`` the log-likelihood of the model *before* iteration ``i``;
        nothing is copied to the host between iterations."""
        if dataset.is_empty():
            raise ValueError("cannot iterate on an empty dataset")
        model, llks = self, []
        for _ in range(int(n_iters)):
            model, llk = model._em_step(dataset, prior)
            llks.append(llk)
        if not llks:
            return model, torch.zeros((0,), dtype=self.transform.dtype, device=self.device)
        return model, torch.stack(llks)

    # ------------------------------------------------------------------ #

    def to_canonical(self) -> "PPCAModel":
        """Canonical rotation of the latent space; does not alter the
        log-probability function (`ppca_model.rs:395-425`): SVD with V := I,
        columns sign-fixed by the sign of their sum."""
        if self.state_size == 0:
            return self
        if self.state_size > self.output_size:
            raise ValueError(
                "to_canonical requires state_size <= output_size "
                f"(got {self.state_size} > {self.output_size})"
            )
        U, svals, _ = torch.linalg.svd(self.transform, full_matrices=False)
        new_C = U * svals[None, :]
        signs = torch.where(new_C.sum(0) >= 0, 1.0, -1.0).to(new_C.dtype)
        return PPCAModel._from_params(new_C * signs[None, :], self.mean, self.isotropic_noise)


_FLAT_PRIOR = Prior()


def device_priors(prior: Optional[Prior], like: torch.Tensor) -> dict:
    """The M-step's prior arguments on ``like``'s device and dtype (no
    prior: the flat one, one instance, so its tensors are made once)."""
    tprec, noise_prior, mean_prior = (prior or _FLAT_PRIOR).device_pieces(like.dtype, like.device)
    return dict(transformation_precision=tprec, noise_prior=noise_prior, mean_prior=mean_prior)


def smoothed_cov_diag(model: PPCAModel, covs: torch.Tensor) -> torch.Tensor:
    """(N, D) diagonals of ``C Sigma_n C^T + sigma^2 I`` for posterior
    covariances ``covs`` (N, k, k): ``diag(C Sigma C^T)[d] = sum_kl C[d,k]
    Sigma[k,l] C[d,l] = (Sigma_flat @ CC_flat^T)[n, d]``, one matmul."""
    n, k, _ = covs.shape
    sigma = model.isotropic_noise
    return covs.reshape(n, k * k) @ ml.outer_flat(model.transform).T + sigma * sigma


def extrapolated_cov_diag(model: PPCAModel, covs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """:func:`smoothed_cov_diag`, zero at observed entries."""
    diag = smoothed_cov_diag(model, covs)
    return torch.where(mask, torch.zeros_like(diag), diag)


def smoothed_cov_full(model: PPCAModel, covs: torch.Tensor) -> torch.Tensor:
    """(N, D, D) smoothed output covariances ``C Sigma_n C^T + sigma^2 I``."""
    C, sigma = model.transform, model.isotropic_noise
    full = torch.einsum("dk,nkl,el->nde", C, covs, C)
    return full + (sigma * sigma) * torch.eye(C.shape[0], dtype=C.dtype, device=C.device)


class InferredMasked:
    """Batch of per-sample posterior distributions in state space
    (`src/python_bindings.rs:203-345` over `ppca_model.rs:428-593`)."""

    def __init__(self, model: PPCAModel, states: torch.Tensor, covariances: torch.Tensor):
        self._model = model
        self._states = states            # (N, k)
        self._covariances = covariances  # (N, k, k)

    def __len__(self) -> int:
        return int(self._states.shape[0])

    def states(self) -> torch.Tensor:
        return self._states

    def covariances(self) -> List[torch.Tensor]:
        """List of per-sample (k, k) posterior covariances."""
        return list(self._covariances)

    def covariances_array(self) -> torch.Tensor:
        """(N, k, k) stacked covariances."""
        return self._covariances

    def second_moments(self) -> List[torch.Tensor]:
        """Per-sample posterior second moments ``s s^T + Sigma``
        (`ppca_model.rs:437-439`)."""
        return list(self.second_moments_array())

    def second_moments_array(self) -> torch.Tensor:
        s = self._states
        return self._covariances + s[:, :, None] * s[:, None, :]

    def smoothed(self, model: PPCAModel) -> Dataset:
        """C s + mu per sample (`ppca_model.rs:454-457`)."""
        return Dataset.unmasked(self._states @ model.transform.T + model.mean)

    def extrapolated(self, model: PPCAModel, dataset: Dataset) -> Dataset:
        """Observed values kept, missing filled from the posterior
        (`ppca_model.rs:460-463`)."""
        smoothed = self._states @ model.transform.T + model.mean
        return Dataset.unmasked(torch.where(dataset.mask, dataset.data, smoothed))

    def smoothed_covariances(self, model: PPCAModel) -> List[torch.Tensor]:
        """Full (D, D) smoothed output covariances (`ppca_model.rs:471-477`)."""
        return list(smoothed_cov_full(model, self._covariances))

    def smoothed_covariances_diagonal(self, model: PPCAModel) -> Dataset:
        """Diagonal smoothed output covariances (`ppca_model.rs:485-508`)."""
        return Dataset.unmasked(smoothed_cov_diag(model, self._covariances))

    def extrapolated_covariances(self, model: PPCAModel, dataset: Dataset) -> List[torch.Tensor]:
        """Full (D, D) extrapolation covariances, zero at observed dims
        (`ppca_model.rs:517-534`)."""
        neg = (~dataset.mask).to(model.transform.dtype)
        return list(smoothed_cov_full(model, self._covariances) * neg[:, :, None] * neg[:, None, :])

    def extrapolated_covariances_diagonal(self, model: PPCAModel, dataset: Dataset) -> Dataset:
        """Diagonal extrapolation variances, zero at observed dims
        (`ppca_model.rs:542-577`)."""
        return Dataset.unmasked(extrapolated_cov_diag(model, self._covariances, dataset.mask))

    def posterior_sampler(self) -> "PosteriorSampler":
        """Cholesky-factor the posterior covariances for repeated sampling
        (`ppca_model.rs:581-592`), through :func:`ops.kernels.spd_chol`: the
        CUDA kernel on the card, its plain version on the CPU."""
        chol = kernels.spd_chol(self._covariances.contiguous())
        if not bool(torch.isfinite(chol).all()):
            raise ValueError("Cholesky decomposition failed: posterior covariance not PD")
        return PosteriorSampler(self._model, self._states, chol)


class PosteriorSampler:
    """Batch sampler from per-sample posteriors (`ppca_model.rs:595-626`).

    Each :meth:`sample` call returns a Dataset with one fresh draw per
    sample, ``y = sigma z2 + mu + C (s + L z1)`` with z1 (n, k) and then
    z2 (n, D) standard normal from one generator: the output noise term is
    included, as the reference code does (its doc comment says otherwise)."""

    def __init__(self, model: PPCAModel, states: torch.Tensor, chol: torch.Tensor):
        self._model = model
        self._states = states  # (N, k)
        self._chol = chol      # (N, k, k) lower factors of the covariances

    def sample(self, generator: Optional[torch.Generator] = None) -> Dataset:
        C, mean, sigma = self._model._params()
        n, k = self._states.shape
        gen = ensure_generator(generator, C.device)
        opts = dict(generator=gen, dtype=C.dtype, device=gen.device)
        z1 = torch.randn((n, k), **opts).to(C.device)
        z2 = torch.randn((n, C.shape[0]), **opts).to(C.device)
        s = self._states + (self._chol @ z1.unsqueeze(-1)).squeeze(-1)
        return Dataset.unmasked(sigma * z2 + mean + s @ C.T)
