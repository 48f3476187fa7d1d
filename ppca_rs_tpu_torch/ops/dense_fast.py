"""Fully-observed path, on torch tensors.

Port of ``ppca_rs_tpu/ops/dense_fast.py`` for one device.  When a dataset
has no missing entries every sample shares the posterior precision
``M = sigma^2 I + C^T C``, so the per-sample factorizations of the masked
path collapse to ONE k x k Cholesky (``torch.linalg.cholesky_ex``) and an EM
iteration is a few large matmuls:

    b      = (Y - mu) C                    posterior projections
    s      = b M^{-1}                      posterior states
    cross  = R^T (w s)                     (D, k)
    S      = s^T diag(w) s + (sum w) sigma^2 M^{-1}   ONE (k, k) matrix
             shared by every output row, so the M-step's D row solves
             become one solve with D right-hand sides

No kernel runs here (nor in the JAX package's dense path).  Semantically
identical to the masked path with an all-True mask.  Rows are processed in
blocks by a plain loop, so temporaries are O(block * D); zero-weight rows
are neutral in every reduction.  Each block is a ``ppca.block`` span, and
:data:`COUNTS` counts the work where it is done.  Nothing here waits for
the device: the factorization and the M-step's solves take the ``_ex``
forms, whose failure gives NaN factors rather than an exception, as the
JAX package's do.

With a model process ``group`` (``parallel/``), ``C``, the mean and the data
are this rank's block of the D columns, as in ``masked_linalg``: the
shared Gram ``C^T C``, each block's projections and |r|^2 are summed over
the group, ``cross`` and ``total_dev`` stay D_loc-local, and the M-step
returns this rank's rows.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

from ..utils.profiling import span
from .kernels import LN_2PI
from .masked_linalg import (_blocks, _cat, _compute_dtype, all_reduce_sum, gather_blocks,
                            group_size, sum_parts)


#: The route's work, counted where it is done: shared factorizations
#: (``posteriors``, one a :func:`dense_posterior` call) and row blocks with
#: their rows (``blocks``, ``rows``) in the EM statistics and every readout
#: verb.
COUNTS: Dict[str, int] = {"posteriors": 0, "blocks": 0, "rows": 0}


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def _row_blocks(n: int, block_size: int):
    """The row blocks of a pass over ``n`` rows, counted once a pass (the
    loop is the host's hot path), each block inside a ``ppca.block``
    span."""
    COUNTS["blocks"] += -(-n // block_size)
    COUNTS["rows"] += n
    for lo, hi in _blocks(n, block_size):
        with span("ppca.block"):
            yield lo, hi


def _solved(x: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """``x`` where its factorization or solve succeeded (``info == 0``),
    else NaN, without reading ``info`` on the host."""
    return torch.where(info == 0, x, torch.full_like(x, math.nan))


class DensePosterior(NamedTuple):
    M: torch.Tensor       # (k, k) shared posterior precision
    Minv: torch.Tensor    # (k, k)
    logdet: torch.Tensor  # scalar log det M
    Sigma: torch.Tensor   # (k, k) = sigma^2 M^{-1}


def dense_posterior(C, sigma, group=None) -> DensePosterior:
    """The one shared k x k factorization (the Gram summed over the model
    ``group`` if given)."""
    k = C.shape[1]
    sigma2 = sigma * sigma
    eye = torch.eye(k, dtype=C.dtype, device=C.device)
    (G,) = all_reduce_sum([C.T @ C], group)
    M = G + sigma2 * eye
    COUNTS["posteriors"] += 1
    L, info = torch.linalg.cholesky_ex(M)
    L = _solved(L, info)
    Minv = torch.cholesky_solve(eye, L)
    logdet = 2.0 * torch.log(torch.diagonal(L)).sum()
    return DensePosterior(M=M, Minv=Minv, logdet=logdet, Sigma=sigma2 * Minv)


def _centered_products(C, mean, datab, group=None):
    """``(R, b, |R|^2)`` with R = Y - mu, b = R C (b and |R|^2 summed over
    the model ``group`` if given), written against the centred values: the
    expanded |Y|^2 - 2 Y.mu + |mu|^2 form cancels in float32 whenever |mu|
    is large against the residual spread."""
    R = datab - mean
    b, rnorm = all_reduce_sum((R @ C, (R * R).sum(-1)), group)
    return R, b, rnorm


def _d_obs(data, C, group=None):
    """D (all the group's columns) in the compute dtype, never the storage
    dtype (a low-precision d_obs would drag LN_2PI * d_obs down with it);
    filled on the device, not copied from the host."""
    return torch.full((), data.shape[1] * group_size(group), dtype=_compute_dtype(data, C),
                      device=data.device)


def llks(C, mean, sigma, data, *, block_size: int, group=None) -> torch.Tensor:
    """Per-sample log-likelihood: one shared log-det and a quadratic form
    through the shared M^{-1}."""
    k = C.shape[1]
    dtype = _compute_dtype(data, C)
    post = dense_posterior(C, sigma, group)
    d_obs = _d_obs(data, C, group)
    logdet = post.logdet + 2.0 * torch.log(sigma) * (d_obs - k)
    out = []
    for lo, hi in _row_blocks(data.shape[0], block_size):
        _, b, rnorm = _centered_products(C, mean, data[lo:hi].to(dtype), group)
        quad = (rnorm - ((b @ post.Minv) * b).sum(-1)) / (sigma * sigma)
        out.append(-0.5 * (quad + logdet + LN_2PI * d_obs))
    return _cat(out, data, dtype)


def states(C, mean, sigma, data, *, block_size: int, group=None) -> torch.Tensor:
    """Posterior state means, (N, k)."""
    dtype = _compute_dtype(data, C)
    post = dense_posterior(C, sigma, group)
    out = [_centered_products(C, mean, data[lo:hi].to(dtype), group)[1] @ post.Minv
           for lo, hi in _row_blocks(data.shape[0], block_size)]
    return _cat(out, data, dtype, C.shape[1])


def infer(C, mean, sigma, data, *, block_size: int, group=None):
    """``(states (N, k), covs (N, k, k))``; the covariances are one shared
    matrix broadcast over the rows (a view, not contiguous)."""
    s = states(C, mean, sigma, data, block_size=block_size, group=group)
    Sigma = dense_posterior(C, sigma, group).Sigma
    return s, Sigma.expand(data.shape[0], *Sigma.shape)


class DenseEMStats(NamedTuple):
    """Dense-path sufficient statistics.  ``S_common`` is the one (k, k)
    second-moment matrix that every output row shares; the observation
    totals collapse to the weight sum."""

    cross: torch.Tensor         # (D, k)
    S_common: torch.Tensor      # (k, k)
    square_error: torch.Tensor  # scalar
    dev_sq: torch.Tensor        # scalar
    total_dev: torch.Tensor     # (D,)
    w_sum: torch.Tensor         # scalar
    llk: torch.Tensor           # scalar


def em_stats(C, mean, sigma, data, weights, *, block_size: int, group=None) -> DenseEMStats:
    """Dense EM statistics, blocked over N.  No residual (B, D) array:

        |dev|^2   = |R|^2 - b.s - sigma^2 |s|^2   (M s = b, G = M - sigma^2 I)
        total_dev = w @ dev = w R - C (sum w s)
    """
    D, k = C.shape
    dtype = _compute_dtype(data, C)
    sigma2 = sigma * sigma
    post = dense_posterior(C, sigma, group)
    d_obs = _d_obs(data, C, group)
    logdet_obs = post.logdet + 2.0 * torch.log(sigma) * (d_obs - k)
    G = post.M - sigma2 * torch.eye(k, dtype=dtype, device=C.device)   # C^T C
    cross = torch.zeros((D, k), dtype=dtype, device=data.device)
    S_part = torch.zeros((k, k), dtype=dtype, device=data.device)
    wR = torch.zeros(D, dtype=dtype, device=data.device)
    sw_sum = torch.zeros(k, dtype=dtype, device=data.device)
    # scalar statistics are kept per block and summed at the end: running
    # float32 sums put the llk of 10,485,760 rows in 1,280 blocks up to 7e-7
    # off float64, about as far as computing in TF32 does
    w_parts, dev_parts, llk_parts = [], [], []
    for lo, hi in _row_blocks(data.shape[0], block_size):
        w = weights[lo:hi].to(dtype)
        R, b, rnorm = _centered_products(C, mean, data[lo:hi].to(dtype), group)
        s = b @ post.Minv
        sw = s * w[:, None]
        cross += R.T @ sw
        S_part += s.T @ sw
        wR += w @ R
        sw_sum += sw.sum(0)
        w_parts.append(w.sum())
        bs = (b * s).sum(-1)
        # clamp: the cancellation can dip epsilon-negative in float32 when
        # the model explains the data almost exactly (|dev|^2 ~ 0); a
        # negative sum would make the sigma update NaN through sqrt.
        dev_parts.append((w * torch.clamp(rnorm - bs - sigma2 * (s * s).sum(-1), min=0.0)).sum())
        quad = (rnorm - bs) / sigma2
        llk_parts.append((w * -0.5 * (quad + logdet_obs + LN_2PI * d_obs)).sum())
    w_sum, dev_sq, llk = (sum_parts(parts, dtype, data.device)
                          for parts in (w_parts, dev_parts, llk_parts))
    return DenseEMStats(
        cross=cross,
        S_common=S_part + w_sum * post.Sigma,
        square_error=w_sum * (G * post.Sigma).sum(),
        dev_sq=dev_sq,
        total_dev=wR - C @ sw_sum,
        w_sum=w_sum,
        llk=llk,
    )


def em_finalize(C, mean, sigma, stats: DenseEMStats, *, transformation_precision,
                noise_prior=None, mean_prior=None, group=None):
    """Dense M-step: ONE (k, k) solve with D right-hand sides replaces the D
    per-row solves; the noise and mean updates use the scalar observation
    count.  Returns ``(new_C, new_mean, new_sigma)``; with a model
    ``group``, this rank's rows of the transform and the mean."""
    D, k = C.shape
    dtype = C.dtype
    A = stats.S_common + transformation_precision * torch.eye(k, dtype=dtype, device=C.device)
    sol, info = torch.linalg.solve_ex(A, stats.cross.T)
    sol = _solved(sol, info).T
    new_C = torch.where(torch.isfinite(sol).all(), sol, C)

    sq = stats.square_error + stats.dev_sq
    n_obs = stats.w_sum * (D * group_size(group))
    if noise_prior is not None:
        alpha, beta = noise_prior
        sigma2_new = (sq / 2.0 + beta) / (n_obs / 2.0 + alpha + 1.0)
    else:
        sigma2_new = sq / n_obs

    # the masked path's totals > 0 guard: an all-zero-weight dataset keeps
    # the old mean instead of a NaN one
    seen = stats.w_sum > 0
    new_mean = torch.where(seen, stats.total_dev / torch.where(seen, stats.w_sum, 1.0),
                           0.0) + mean
    if mean_prior is not None:
        prior_mean, prior_precision = mean_prior
        full_mean = new_mean if group is None else gather_blocks([(new_mean, 0)], group)[0]
        data_precision = stats.w_sum / sigma2_new
        total_precision = prior_precision + data_precision * torch.eye(
            prior_precision.shape[0], dtype=dtype, device=C.device)
        numerator = prior_precision @ prior_mean + data_precision * full_mean
        new_mean, info = torch.linalg.solve_ex(total_precision, numerator)
        new_mean = _solved(new_mean, info)
        if group is not None:
            new_mean = new_mean.narrow(0, torch.distributed.get_rank(group) * D, D)
    return new_C, new_mean, torch.sqrt(sigma2_new)
