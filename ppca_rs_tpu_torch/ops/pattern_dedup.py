"""Mask-pattern deduplication: factor P distinct patterns, not N samples.

Port of ``ppca_rs_tpu/ops/pattern_dedup.py`` for one device.  When the
missingness is structured (a few instruments, survey versions or join
shapes give P distinct mask patterns, P << N), every per-sample quantity
that depends on the sample only through its mask collapses to a P-sized
table:

* the masked Gram ``G_p = C^T diag(m_p) C``, its factorization, the
  posterior covariance ``Sigma_p = sigma^2 M_p^{-1}``, the log-determinant
  term of the llk and the noise-update trace ``tr(G_p Sigma_p)`` are
  computed once per pattern (:func:`compute_tables`, through the ``full``
  variant of the SPD kernel with ``b = 0``, ``rnorm = 0``);
* per-sample work shrinks to the projections ``b_n = C^T r_n`` and the
  mat-vec ``s_n = Sigma_{p(n)} b_n / sigma^2``: no per-sample factorization.

The EM statistics come in two exact regroupings of the masked path's sums:
:func:`em_stats_sorted` runs over the rows sorted by pattern
(``Dataset.pattern_order``), where each segment's mask is one constant row
and the per-sample work is plain dense matmuls; :func:`em_stats` runs over
the rows in their own order and groups the per-pattern sums with
``index_add_``, for data too large for the sorted copy.  Pattern detection
is ``Dataset.pattern_info``.  Rows are blocked by plain loops over row
slices, each block a ``ppca.block`` span (closed before a generator's
``yield``), the tables a ``ppca.pattern_tables`` span, and :data:`COUNTS`
counts the work where it is done.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch

from ..utils.profiling import span
from . import kernels
from . import masked_linalg as ml
from .masked_linalg import _blocks, _cat, _compute_dtype


#: The route's work, counted where it is done: pattern tables factored
#: (``tables``, one a call of :func:`compute_tables`), segments walked by
#: the per-segment EM (``segments``), and row blocks with their rows
#: (``blocks``, ``rows``) in every form and readout verb.
COUNTS: Dict[str, int] = {"tables": 0, "segments": 0, "blocks": 0, "rows": 0}


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def _count_blocks(rows: int, block_size: int) -> None:
    """Count a loop over ``rows`` rows in blocks of ``block_size`` (once a
    loop, not once a block: the loop is the host's hot path)."""
    COUNTS["blocks"] += -(-rows // block_size)
    COUNTS["rows"] += rows


class PatternTables(NamedTuple):
    """Per-pattern E-step quantities (leading axis P)."""

    Sigma: torch.Tensor    # (P, k*k) posterior covariance sigma^2 M_p^{-1}
    pat_llk: torch.Tensor  # (P,) the mask-only llk term:
                           #      -0.5 (logdet M_p + log sigma^2 (d_p - k) + LN_2PI d_p)
    sq: torch.Tensor       # (P,) tr(G_p Sigma_p), the noise-update term


def compute_tables(C, sigma, patterns_f) -> PatternTables:
    """Factor all P patterns at once.  ``patterns_f`` is the (P, D) 0/1
    pattern matrix in the compute dtype.  With b = 0 and rnorm = 0 the SPD
    kernel's second moment IS sigma^2 M^{-1}, its llk is the pattern term
    and its sq is tr(G Sigma)."""
    P = patterns_f.shape[0]
    k = C.shape[1]
    dtype, device = patterns_f.dtype, patterns_f.device
    with span("ppca.pattern_tables"):
        COUNTS["tables"] += 1
        G = (patterns_f @ ml.outer_flat(C).to(dtype)).reshape(P, k, k)
        zeros = torch.zeros(P, dtype=dtype, device=device)
        _, Sigma, pat_llk, sq = kernels.spd_estep(
            sigma, G, torch.zeros((P, k), dtype=dtype, device=device), zeros,
            patterns_f.sum(-1), want="full")
        return PatternTables(Sigma.reshape(P, k * k), pat_llk, sq)


class _BlockPosterior(NamedTuple):
    R: torch.Tensor      # (B, D) masked centred data
    b: torch.Tensor      # (B, k) = R @ C
    s: torch.Tensor      # (B, k) posterior states
    rnorm: torch.Tensor  # (B,) |R|^2
    llk: torch.Tensor    # (B,)


def _block_states_llk(C, mean, sigma, tables: PatternTables, datab, mask_f, pidx) -> _BlockPosterior:
    """States and llks of one block of rows from the pattern tables.

    With P <= k the states of every row under ALL patterns come from one
    (B, k) x (k, P k) matmul (Sigma_p is symmetric, so the right operand is
    the table re-laid out), and each row keeps its own pattern's k-vector:
    the (B, P, k) temporary is no larger than the (B, k, k) one of the
    other form, which gathers each row's Sigma_p for a batched mat-vec.  At
    P=32, k=64, B=8192 on an H100 the first form takes 0.24-0.25 ms a
    block, the gather 0.37-0.39 ms (PERF.md)."""
    k = C.shape[1]
    P = tables.Sigma.shape[0]
    sigma2 = sigma * sigma
    R = mask_f * (datab - mean)
    b = R @ C
    Sig = tables.Sigma.reshape(P, k, k)
    if P <= k:
        s_all = (b @ Sig.transpose(0, 1).reshape(k, P * k)).reshape(-1, P, k)
        s = s_all.gather(1, pidx[:, None, None].expand(-1, 1, k)).squeeze(1) / sigma2
    else:
        s = torch.bmm(Sig.index_select(0, pidx), b.unsqueeze(-1)).squeeze(-1) / sigma2
    rnorm = (R * R).sum(-1)
    quad = (rnorm - (b * s).sum(-1)) / sigma2
    return _BlockPosterior(R, b, s, rnorm, tables.pat_llk.index_select(0, pidx) - 0.5 * quad)


def _tables_for(C, sigma, data, patterns):
    dtype = _compute_dtype(data, C)
    return dtype, compute_tables(C, sigma, patterns.to(dtype))


def _posteriors(C, mean, sigma, data, mask, pidx, tables, dtype, block_size):
    _count_blocks(data.shape[0], block_size)
    for lo, hi in _blocks(data.shape[0], block_size):
        with span("ppca.block"):
            post = _block_states_llk(C, mean, sigma, tables, data[lo:hi].to(dtype),
                                     mask[lo:hi].to(dtype), pidx[lo:hi])
        yield lo, hi, post


def llks(C, mean, sigma, data, mask, pidx, patterns, *, block_size: int) -> torch.Tensor:
    """Per-sample log-likelihoods through the pattern tables, (N,)."""
    dtype, tables = _tables_for(C, sigma, data, patterns)
    out = [post.llk for _, _, post in
           _posteriors(C, mean, sigma, data, mask, pidx, tables, dtype, block_size)]
    return _cat(out, data, dtype)


def states(C, mean, sigma, data, mask, pidx, patterns, *, block_size: int) -> torch.Tensor:
    """Posterior state means, (N, k) (the smooth/extrapolate path)."""
    dtype, tables = _tables_for(C, sigma, data, patterns)
    out = [post.s for _, _, post in
           _posteriors(C, mean, sigma, data, mask, pidx, tables, dtype, block_size)]
    return _cat(out, data, dtype, C.shape[1])


def infer(C, mean, sigma, data, mask, pidx, patterns, *, block_size: int):
    """Posterior states and covariances ``(states (N, k), covs (N, k, k))``.
    The covariances come straight from the table, sigma^2 M_p^{-1}, with no
    round trip through second moments."""
    k = C.shape[1]
    dtype, tables = _tables_for(C, sigma, data, patterns)
    s = [post.s for _, _, post in
         _posteriors(C, mean, sigma, data, mask, pidx, tables, dtype, block_size)]
    P = tables.Sigma.shape[0]
    return _cat(s, data, dtype, k), tables.Sigma.reshape(P, k, k).index_select(0, pidx)


def _assemble(C, patterns_f, tables, cross, Souter, wsum, psw, wR, dev_sq, llk) -> ml.EMStats:
    """EMStats from the per-pattern sums: ``S[d] = sum_p m_pd (Souter_p +
    wsum_p Sigma_p)`` and ``mask^T (w s) = patterns^T psw``, one (D, P)
    contraction each."""
    pat_T = patterns_f.T
    return ml.EMStats(
        cross=cross,
        S=pat_T @ (Souter + wsum[:, None] * tables.Sigma),
        square_error=(wsum * tables.sq).sum(),
        dev_sq=dev_sq,
        total_dev=wR - (C * (pat_T @ psw)).sum(-1),
        totals=pat_T @ wsum,
        llk=llk,
    )


def em_stats(C, mean, sigma, data, mask, pidx, patterns, weights, *,
             block_size: int) -> ml.EMStats:
    """One pass over the rows in their own order, every EM statistic of
    ``masked_linalg.em_stats`` regrouped by pattern: the second-moment sums
    ``w s s^T``, the weight sums and the ``w s`` sums are added into P rows
    (``index_add_``), and the covariance half of S, the noise trace and the
    observation totals come from the tables."""
    D, k = C.shape
    dtype, tables = _tables_for(C, sigma, data, patterns)
    patterns_f = patterns.to(dtype)
    P = patterns_f.shape[0]
    sigma2 = sigma * sigma
    opts = dict(dtype=dtype, device=data.device)
    cross = torch.zeros((D, k), **opts)
    Souter = torch.zeros((P, k * k), **opts)
    wsum = torch.zeros(P, **opts)
    psw = torch.zeros((P, k), **opts)
    wR = torch.zeros(D, **opts)
    dev_sq = llk = torch.zeros((), **opts)
    _count_blocks(data.shape[0], block_size)
    for lo, hi in _blocks(data.shape[0], block_size):
        with span("ppca.block"):
            post = _block_states_llk(C, mean, sigma, tables, data[lo:hi].to(dtype),
                                     mask[lo:hi].to(dtype), pidx[lo:hi])
            w = weights[lo:hi].to(dtype)
            pb = pidx[lo:hi]
            s = post.s
            sw = s * w[:, None]
            cross += post.R.T @ sw
            Souter.index_add_(0, pb, (sw[:, :, None] * s[:, None, :]).reshape(hi - lo, k * k))
            wsum.index_add_(0, pb, w)
            psw.index_add_(0, pb, sw)
            wR += w @ post.R
            # the masked path's residual identity (masked_linalg.em_stats), clamped
            bs = (post.b * s).sum(-1)
            dev_sq = dev_sq + (w * torch.clamp(post.rnorm - bs - sigma2 * (s * s).sum(-1),
                                               min=0.0)).sum()
            llk = llk + (w * post.llk).sum()
    return _assemble(C, patterns_f, tables, cross, Souter, wsum, psw, wR, dev_sq, llk)


def em_stats_sorted(C, mean, sigma, data_sorted, weights_sorted, patterns,
                    counts: Sequence[int], *, block_size: int) -> ml.EMStats:
    """EM statistics over the rows sorted by pattern (``Dataset.pattern_order``).

    ``counts[p]`` is the number of rows of pattern p; segment p is rows
    ``[sum(counts[:p]), sum(counts[:p + 1]))``.  Inside a segment the mask
    is the constant row ``patterns[p]``, so no mask is read, the states are
    ``s = R (C Sigma_p / sigma^2)`` against the segment's one table entry,
    and the second-moment statistic is the plain segment Gram
    ``(w s)^T s``.  An exact regrouping of :func:`em_stats`'s sums.

    A row block is a dozen launches, so that the card, not the host's loop,
    sets the pace (``config.segment_rows`` makes a segment of the benchmark's
    size one block): the centred rows in one ``addcmul`` against the
    segment's ``-m_p * mean``; the projections ``b`` and the states in one
    product against ``[C | C Sigma_p / sigma^2]``, written beside a column of
    ones; the cross statistic and ``w R`` in one product ``R^T [w s | w]``;
    the segment's second moments, ``w s`` sums and weight sum in one
    ``[s | 1]^T [w s | w]``; and each row's ``|R|^2 - b.s`` and residual
    (clamped at 0 as ``masked_linalg.em_stats`` clamps it, the row's own
    difference taken before any sum) summed against the weights in one
    product.
    """
    D, k = C.shape
    n = data_sorted.shape[0]
    dtype, tables = _tables_for(C, sigma, data_sorted, patterns)
    patterns_f = patterns.to(dtype)
    P = patterns_f.shape[0]
    if len(counts) != P or sum(counts) != n:
        raise ValueError(f"counts {len(counts)}/{sum(counts)} do not partition "
                         f"{P} patterns x {n} rows")
    opts = dict(dtype=dtype, device=data_sorted.device)
    C, mean = C.to(dtype), mean.to(dtype)
    sigma2 = torch.as_tensor(sigma, **opts) ** 2
    neg_mean = patterns_f * -mean                                       # (P, D)
    Sig3 = tables.Sigma.reshape(P, k, k)
    bs_cols = torch.cat([C.expand(P, D, k), C @ (Sig3 / sigma2)], dim=2)  # (P, D, 2k)
    # each block's [b | s | 1], and its rows' (b.s - |R|^2, clamped residual)
    rows_max = min(block_size, max(counts, default=0))
    T = torch.empty((rows_max, 2 * k + 1), **opts)
    T[:, 2 * k] = 1.0
    E = torch.empty((rows_max, 2), **opts)
    acc = torch.zeros((D, k + 1), **opts)          # [cross | w R]
    seg = torch.zeros((P, k + 1, k + 1), **opts)   # per pattern [[w s s^T, w s], [w s^T, w]]
    sums = torch.zeros(2, **opts)                  # -sum w (|R|^2 - b.s), -dev_sq
    start = 0
    for p, c in enumerate(counts):
        COUNTS["segments"] += 1
        _count_blocks(c, block_size)
        for lo, hi in _blocks(c, block_size):
            with span("ppca.block"):
                rows = slice(start + lo, start + hi)
                w = weights_sorted[rows].to(dtype)
                R = torch.addcmul(neg_mean[p], data_sorted[rows].to(dtype), patterns_f[p])
                t, e = T[:hi - lo], E[:hi - lo]
                torch.mm(R, bs_cols[p], out=t[:, :2 * k])
                s1 = t[:, k:]
                sw1 = s1 * w[:, None]
                acc.addmm_(R.T, sw1)
                seg[p].addmm_(s1.T, sw1)
                dots = (t[:, :2 * k].unflatten(1, (2, k)) * t[:, None, k:2 * k]).sum(-1)
                r = torch.linalg.vector_norm(R, dim=-1)
                torch.addcmul(dots[:, 0], r, r, value=-1, out=e[:, 0])
                torch.addcmul(e[:, 0], dots[:, 1], sigma2, out=e[:, 1])
                e[:, 1].clamp_(max=0.0)
                sums.addmv_(e.T, w)
        start += c
    wsum = seg[:, k, k]
    llk = (wsum * tables.pat_llk).sum() + 0.5 * sums[0] / sigma2
    return _assemble(C, patterns_f, tables, acc[:, :k].contiguous(),
                     seg[:, :k, :k].reshape(P, k * k), wsum, seg[:, k, :k], acc[:, k],
                     -sums[1], llk)
