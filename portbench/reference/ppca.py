"""Masked PPCA and PPCA mixtures, written out plainly.

Parameters are a dict: ``Cs`` (M, D, k), ``means`` (M, D), ``sigmas`` (M,)
and ``log_weights`` (M,), None for a single model (M = 1).  A row y with
observed 0/1 mask m under component (C, mu, sigma) has

    r = m (y - mu),  b = C^T r,  G = C^T diag(m) C,  M = sigma^2 I + G,
    s = M^{-1} b,  Sigma = sigma^2 M^{-1},
    llk = -(|r|^2 - b.s) / (2 sigma^2) - log|M| / 2
          - (d - k) log(sigma^2) / 2 - d log(2 pi) / 2,   d = sum m,

the Gaussian log-density of the observed entries under N(mu, C C^T +
sigma^2 I).  One EM step (the ppca_rs M-step, with row weights w = 1 for a
single model and the responsibilities for a mixture):

    C_new[d]  = (sum_n w m_nd (s s^T + Sigma))^{-1} sum_n w r_nd s_n,
    dev_n     = m (r - C s),
    mu_new    = mu + sum_n w dev_n / sum_n w m_n     (where observed),
    sigma_new = sqrt((sum_n w tr(G Sigma) + sum_n w |dev_n|^2) / sum_n w d_n),
    log_w_new = log sum_n w - logsumexp,

where a component whose largest responsibility is below the configuration
dtype's smallest normal number keeps its parameters.  The llk of a step is
that of the parameters it starts from.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from .linalg import Precision

LN_2PI = math.log(2.0 * math.pi)


def _lower(k: int, device):
    """Row and column indices of the lower triangle of a k x k matrix."""
    return torch.tril_indices(k, k, device=device).unbind(0)


def _outer(C: torch.Tensor) -> torch.Tensor:
    """(D, k(k+1)/2): row d is the lower triangle of c_d c_d^T."""
    rows, cols = _lower(C.shape[1], C.device)
    return C[:, rows] * C[:, cols]


def _symmetric(low: torch.Tensor, k: int) -> torch.Tensor:
    """(..., k, k) symmetric matrices from their lower triangles (..., k(k+1)/2)."""
    rows, cols = _lower(k, low.device)
    out = low.new_zeros(*low.shape[:-1], k, k)
    out[..., rows, cols] = low
    out[..., cols, rows] = low
    return out


def posterior(prec: Precision, C, CC, mean, sigma, y, m, cov: bool = True):
    """E-step of rows ``y`` with mask ``m`` (0/1, the compute dtype) under
    one component (``CC`` is :func:`_outer` of C): a dict of llk (B,), s
    (B, k), r (B, D), and with ``cov`` Sigma (B, k, k) and G (B, k, k).
    With W = L^{-1} for M = L L^T: s = W^T W b, Sigma = sigma^2 W^T W."""
    k = C.shape[1]
    r = m * (y - mean)
    b = prec.mm(r, C)
    G = _symmetric(prec.mm(m, CC), k)
    s2 = sigma * sigma
    eye = torch.eye(k, dtype=y.dtype, device=y.device)
    L = torch.linalg.cholesky(G + s2 * eye)
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    d = m.sum(-1)
    rnorm = (r * r).sum(-1)
    out = {"r": r}
    if cov:
        W = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
        Minv = W.mT @ W
        s = (Minv @ b.unsqueeze(-1)).squeeze(-1)
        out["Sigma"] = s2 * Minv
        out["G"] = G
    else:
        y1 = torch.linalg.solve_triangular(L, b.unsqueeze(-1), upper=False)
        s = torch.linalg.solve_triangular(L.mT, y1, upper=True).squeeze(-1)
    out["s"] = s
    out["llk"] = -0.5 * ((rnorm - (b * s).sum(-1)) / s2 + logdet + (d - k) * torch.log(s2)
                         + d * LN_2PI)
    return out


def _blocks(n: int, block: int):
    for lo in range(0, n, block):
        yield lo, min(lo + block, n)


def _cast(params: Dict, prec: Precision) -> Dict:
    return {key: (None if v is None else v.to(prec.dtype)) for key, v in params.items()}


def em_step(prec: Precision, params: Dict, data, mask, *, block: int = 8192,
            tiny: float = torch.finfo(torch.float32).tiny) -> Tuple[Dict, float]:
    """One EM step over all rows: (new params, total llk of ``params``)."""
    p = _cast(params, prec)
    Cs, means, sigmas, logw = p["Cs"], p["means"], p["sigmas"], p["log_weights"]
    M, D, k = Cs.shape
    dt, dev = prec.dtype, data.device
    CCs = [_outer(Cs[j]) for j in range(M)]
    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=dev)  # noqa: E731
    rows, cols = _lower(k, dev)
    cross, S = zeros(M, D, k), zeros(M, D, k * (k + 1) // 2)
    sq, dev_sq, resp_sum, resp_max = zeros(M), zeros(M), zeros(M), zeros(M)
    total_dev, totals = zeros(M, D), zeros(M, D)
    llk = torch.zeros((), dtype=torch.float64, device=dev)
    for lo, hi in _blocks(data.shape[0], block):
        y, m = data[lo:hi].to(dt), mask[lo:hi].to(dt)
        posts = [posterior(prec, Cs[j], CCs[j], means[j], sigmas[j], y, m) for j in range(M)]
        llks = torch.stack([q["llk"] for q in posts])
        if logw is None:
            resp = torch.ones_like(llks)
            llk += llks.double().sum()
        else:
            joint = llks + logw[:, None]
            lse = torch.logsumexp(joint, 0)
            resp = torch.exp(joint - lse)
            llk += lse.double().sum()
        for j, q in enumerate(posts):
            w = resp[j]
            s, Sig = q["s"], q["Sigma"]
            cross[j] += prec.mm(q["r"].T, s * w[:, None])
            SM = s[:, rows] * s[:, cols] + Sig[:, rows, cols]
            S[j] += prec.mm((m * w[:, None]).T, SM)
            sq[j] += (w * (q["G"] * Sig).sum((-1, -2))).sum()
            dv = m * (q["r"] - prec.mm(s, Cs[j].T))
            dev_sq[j] += (w * (dv * dv).sum(-1)).sum()
            total_dev[j] += (w[:, None] * dv).sum(0)
            totals[j] += (w[:, None] * m).sum(0)
            resp_sum[j] += w.sum()
            resp_max[j] = torch.maximum(resp_max[j], w.max())
    new_C = torch.linalg.solve(_symmetric(S, k), cross.unsqueeze(-1)).squeeze(-1)
    new_sigma = torch.sqrt((sq + dev_sq) / totals.sum(-1))
    seen = totals > 0
    new_mean = means + torch.where(seen, total_dev / torch.where(seen, totals, 1.0), 0.0)
    alive = resp_max >= tiny
    new = {
        "Cs": torch.where(alive[:, None, None], new_C, Cs),
        "means": torch.where(alive[:, None], new_mean, means),
        "sigmas": torch.where(alive, new_sigma, sigmas),
        "log_weights": None,
    }
    if logw is not None:
        lw = torch.log(resp_sum)
        new["log_weights"] = lw - torch.logsumexp(lw, 0)
    return new, float(llk)


def em(prec: Precision, params: Dict, data, mask, steps: int, **kw) -> Tuple[List[float], Dict]:
    """``steps`` EM steps: (the llk of each step's starting parameters, the
    parameters after the last)."""
    llks = []
    for _ in range(steps):
        params, llk = em_step(prec, params, data, mask, **kw)
        llks.append(llk)
    return llks, params


def readout(prec: Precision, params: Dict, y, m, *, block: int = 8192) -> Dict:
    """Scores and imputations of rows ``y`` with boolean mask ``m``: a
    single model's llk (N,), or a mixture's log-posteriors over its
    components (N, M); and the imputed rows (N, D): observed entries as
    given, missing ones the (posterior-weighted) C s + mu."""
    p = _cast(params, prec)
    Cs, means, sigmas, logw = p["Cs"], p["means"], p["sigmas"], p["log_weights"]
    M = Cs.shape[0]
    CCs = [_outer(Cs[j]) for j in range(M)]
    scores, imputed = [], []
    for lo, hi in _blocks(y.shape[0], block):
        yb, mb = y[lo:hi].to(prec.dtype), m[lo:hi]
        mf = mb.to(prec.dtype)
        posts = [posterior(prec, Cs[j], CCs[j], means[j], sigmas[j], yb, mf, cov=False)
                 for j in range(M)]
        fills = [prec.mm(q["s"], Cs[j].T) + means[j] for j, q in enumerate(posts)]
        if logw is None:
            scores.append(posts[0]["llk"])
            fill = fills[0]
        else:
            log_post = torch.log_softmax(torch.stack([q["llk"] for q in posts], -1) + logw, -1)
            scores.append(log_post)
            fill = sum(log_post[:, j, None].exp() * fills[j] for j in range(M))
        imputed.append(torch.where(mb, yb, fill))
    return {"score": torch.cat(scores), "impute": torch.cat(imputed)}


def canonical_gram(C: torch.Tensor) -> torch.Tensor:
    """C C^T: the model's covariance part, which no rotation of the latent
    space changes (``to_canonical`` rotates C)."""
    return C @ C.T

