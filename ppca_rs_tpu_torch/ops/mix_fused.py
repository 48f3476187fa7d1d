"""Fused mixture EM and readouts: all M components in one pass over the data.

Port of ``ppca_rs_tpu/ops/mix_fused.py`` for one device.  The reference's
mixture EM (`ppca/src/mix.rs:281-337`) makes M llk passes for the
responsibilities and then M reweighted single-model EM passes.  Here one
blocked pass does it all:

* the per-sample masked Grams and projections of all M components are
  batched matmuls against the stacked ``Cs (M, D, k)``; on the general
  route the Grams are built as the kernel's slabs where it takes them
  (``masked_linalg.gram_operand``), in float32 on the card by the Gram
  kernel (``masked_linalg.masked_gram``: the bool mask times the columns'
  bf16 slices, written in place as (M, B, W)), and the S statistic is
  added block by block into one running (M, D, W) sum by
  ``kernels.mask_s`` and unpacked once (the JAX package's
  ``config.g_slab_inputs`` and ``s_slab_stats``); the table route keeps
  square tables;
* the SPD kernel is independent per sample, so the M components' blocks
  are stacked on its batch axis, component-major (sample ``m * B + n`` is
  row n under component m), with one sigma per sample
  (``sigmas.repeat_interleave(B)``): ONE launch factors M * B posteriors;
* the responsibilities come from those same per-sample llks, and the
  M-step statistics are summed responsibility-weighted in the same pass.

The reference scales each component's weights to max 1 before its inner EM
(`mix.rs:310-323`).  Without priors the updates do not see that scale; with
priors they do, so the pass tracks each component's largest responsibility
(``resp_max``) and :func:`mix_em_finalize` rescales the weight-linear
statistics by it.

Two routes, as in the JAX package: the general masked route
(:func:`mix_em_stats` and the readouts without ``pidx``) and the table route
(:func:`mix_em_stats_pat` and the readouts with ``pidx``/``patterns``), where
the P distinct mask patterns (one for fully observed data) reduce every
factorization to an M x P table (:func:`compute_mix_tables`, the ``full``
kernel variant).  On the table route the EM statistics have two forms:
table-grouped over rows in any order (:func:`mix_em_stats_pat`), and per
segment over the rows sorted by pattern (:func:`mix_em_stats_pat_sorted`,
``Dataset.pattern_order``), which gathers nothing per row.  Heterogeneous
state sizes arrive zero-padded to the largest k (``models/mix.py``); padded
latent dimensions are exactly inert.  Rows are blocked by plain loops over
row slices.

The general route takes an optional model process ``group`` (``parallel/``),
as ``masked_linalg`` does: the stacked transforms, means and data are this
rank's block of the D columns, each block's Grams, projections, |r|^2 and
observed counts are summed over the group before the kernel (one
all_reduce), and the D-indexed statistics and the M-step's rows stay
local.  The table route runs on the data axis only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..config import config
from ..utils.profiling import span
from . import kernels
from . import masked_linalg as ml
from .masked_linalg import _blocks, _cat, _compute_dtype, all_reduce_sum
from .pattern_dedup import PatternTables


class MixEMStats(NamedTuple):
    """Per-component EM sufficient statistics (leading axis M), plus the
    mixture llk and the new-log-weight numerators."""

    cross: torch.Tensor         # (M, D, k)
    S: torch.Tensor             # (M, D, k*k)
    square_error: torch.Tensor  # (M,)
    dev_sq: torch.Tensor        # (M,)
    total_dev: torch.Tensor     # (M, D)
    totals: torch.Tensor        # (M, D)
    resp_sum: torch.Tensor      # (M,) sum_n w_n post_nm (new log-weight numerators)
    resp_max: torch.Tensor      # (M,) max_n w_n post_nm (the max-1 weight scaling)
    llk: torch.Tensor           # scalar mixture llk of the current parameters


def _accumulate(acc: Optional[MixEMStats], new: MixEMStats) -> MixEMStats:
    """Sum two blocks' or chunks' statistics (resp_max by maximum).  A
    field that is one tensor on both sides is a running sum that the blocks
    add into in place (the general route's S), taken as it is."""
    if acc is None:
        return new
    return MixEMStats(*(b if a is b else a + b for a, b in zip(acc, new)))._replace(
        resp_max=torch.maximum(acc.resp_max, new.resp_max))


class _Center(NamedTuple):
    """Component centring relative to the average mean: each residual
    ``mask * (y - mu_m) = md0 - mask * dm_m`` with ``md0 = mask * (y -
    mean0)``, so no (M, B, D) residual is formed and the expanded |r|^2
    cancels only with the spread of the means, not with the data's size."""

    mean0: torch.Tensor  # (D,)
    dm: torch.Tensor     # (M, D) means - mean0
    Cdm: torch.Tensor    # (M, D, k) Cs * dm


def _center_prep(Cs, means) -> _Center:
    mean0 = means.mean(0)
    dm = means - mean0
    return _Center(mean0, dm, Cs * dm[:, :, None])


def _projections(Cs, center: _Center, datab, mask_f):
    """``(md0 (B, D), b (M, B, k), rnorm (M, B))`` without the (M, B, D)
    residual: ``b_m = C_m^T md0 - C_m^T (mask dm_m)`` as two batched
    matmuls, and ``|r_m|^2 = |md0|^2 - 2 md0.dm_m + mask.dm_m^2``."""
    mean0, dm, Cdm = center
    md0 = mask_f * (datab - mean0)
    b = torch.matmul(md0, Cs) - torch.matmul(mask_f, Cdm)
    rnorm = ((md0 * md0).sum(-1)[:, None] - 2.0 * (md0 @ dm.T) + mask_f @ (dm * dm).T).T
    return md0, b, rnorm


def _general_inputs(Cs, gram, center: _Center, datab, mask, group):
    """``(mask_f, md0, G (M, B, the columns' width), b, rnorm, d_obs)`` of
    one block of the general route from its bool ``mask``: the float mask,
    :func:`_projections`, the Gram ``mask @ CC_m`` (already in the kernel's
    component-major order; slabs or k*k as ``gram``, from
    ``masked_linalg.gram_operand``, is) and the observed counts, the last
    four summed over the model ``group`` in one all_reduce if given."""
    mask_f = mask.to(datab.dtype)
    md0, b, rnorm = _projections(Cs, center, datab, mask_f)
    G, b, rnorm, d_obs = all_reduce_sum(
        (ml.masked_gram(mask, mask_f, gram), b, rnorm, mask_f.sum(-1)), group)
    return mask_f, md0, G, b, rnorm, d_obs


def _residual(means, datab, mask_f):
    """The per-component masked residuals ``mask * (y - mu_m)``, (M, B, D)."""
    return mask_f * (datab - means[:, None, :])


def _estep(sigmas, G, b, rnorm, d_obs, want: str):
    """One :func:`kernels.spd_estep` launch over all components, stacked
    component-major on the batch axis with a sigma per sample.  ``G`` is
    (M, B, kernels.gram_width(k)) as ``masked_linalg.gram_columns`` builds
    it, or square (M, B, k, k) (``kernels.estep_gram``), ``b`` (M, B, k),
    ``rnorm`` (M, B), ``d_obs`` (B,).  Returns ``(llks (M, B), s
    (M, B, k), mat (M, B, k, k), sq (M, B))``, None where ``want`` gives no
    such output; ``mat`` is the second moment (fullt, full; fullt's as
    (M, B, slab_width(k)) slabs with slab G) or the covariance (infer)."""
    M, B, k = b.shape
    out = kernels.spd_estep(sigmas.repeat_interleave(B), kernels.estep_gram(G, M * B, k),
                            b.reshape(M * B, k), rnorm.reshape(M * B), d_obs.repeat(M),
                            want=want)
    if want == "llk":
        return out[0].view(M, B), None, None, None
    if want == "states":
        s, llk = out
        return llk.view(M, B), s.view(M, B, k), None, None
    s, mat, llk, sq = out
    return llk.view(M, B), s.view(M, B, k), mat.view(M, B, *mat.shape[1:]), sq.view(M, B)


def _responsibilities(llks, log_weights, w):
    """``(resp (M, B) = w * posterior, weighted mixture llk of the block)``
    (`mix.rs:289-295`)."""
    joint = llks + log_weights[:, None]
    lse = torch.logsumexp(joint, 0)
    return torch.exp(joint - lse) * w, (w * lse).sum()


def _add_S(S, mask, SM, resp):
    """``S[m] += mask^T (resp_m SM_m)`` into the running ``S`` (M, D, SM's
    width a sample: k*k, or slab_width(k) for slab SM), from the block's
    bool ``mask`` (``kernels.mask_s``); returns S."""
    M, B = resp.shape
    kernels.mask_s(mask, SM.view(M, B, -1), resp, S)
    return S


def _block_post(Cs, gram, means, sigmas, datab, mask, want: str, group=None):
    """Per-component posteriors of one block with the residual
    materialized, from its bool ``mask``: ``(mask_f, R (M, B, D), (llks,
    s, mat, sq))``."""
    mask_f = mask.to(datab.dtype)
    R = _residual(means, datab, mask_f)
    G, b, rnorm, d_obs = all_reduce_sum(
        (ml.masked_gram(mask, mask_f, gram), torch.bmm(R, Cs), (R * R).sum(-1), mask_f.sum(-1)),
        group)
    return mask_f, R, _estep(sigmas, G, b, rnorm, d_obs, want)


def _block_fields(llks, log_weights, w, S, mask, mask_f, SM, sq_b):
    """``(resp, fields)``: the block's responsibilities
    (:func:`_responsibilities`) and the :class:`MixEMStats` fields both EM
    block bodies make alike from them -- S added into the running ``S``,
    ``square_error``, ``totals``, ``resp_sum``, ``resp_max`` and ``llk``."""
    resp, llk = _responsibilities(llks, log_weights, w)
    return resp, dict(S=_add_S(S, mask, SM, resp), square_error=(resp * sq_b).sum(-1),
                      totals=resp @ mask_f, resp_sum=resp.sum(-1), resp_max=resp.amax(-1),
                      llk=llk)


def _block_mix_fast(Cs, gram, center: _Center, sigmas, log_weights, datab, mask, w, S,
                    group=None) -> MixEMStats:
    """One block of the fused EM with no (M, B, D) temporary: projections
    from :func:`_projections`, the Gram ``mask @ CC_m`` (M, B, k*k) as one
    batched matmul (already in the kernel's component-major order), and the
    residual statistics from ``s^T G s = b.s - sigma^2 |s|^2`` (M s = b).
    The block's S is added into the running ``S``, which its stats carry.

    Precision: ``rnorm`` is the expanded quadratic, whose float32
    cancellation relative to the residual grows with the spread of the
    component means against the noise (``config.mix_exact_rnorm`` selects
    :func:`_block_mix`, which is immune)."""
    M, D, _ = Cs.shape
    _, dm, _ = center
    mask_f, md0, G, b, rnorm, d_obs = _general_inputs(Cs, gram, center, datab, mask, group)
    llks, s, SM, sq_b = _estep(sigmas, G, b, rnorm, d_obs, "fullt")
    resp, fields = _block_fields(llks, log_weights, w, S, mask, mask_f, SM, sq_b)
    srw = s * resp[..., None]
    c2 = torch.bmm(mask_f.T.expand(M, -1, -1), srw)            # (M, D, k) mask^T (s resp)
    sigma2 = (sigmas * sigmas)[:, None]
    # clamp: epsilon-negative in float32 iff |dev|^2 ~ 0 (see dense_fast)
    dev = torch.clamp(rnorm - (b * s).sum(-1) - sigma2 * (s * s).sum(-1), min=0.0)
    return MixEMStats(
        cross=torch.bmm(md0.T.expand(M, -1, -1), srw) - dm[:, :, None] * c2,
        dev_sq=(resp * dev).sum(-1),
        total_dev=resp @ md0 - dm * fields["totals"] - (Cs * c2).sum(-1),
        **fields,
    )


def _block_mix(Cs, gram, means, sigmas, log_weights, datab, mask, w, S,
               group=None) -> MixEMStats:
    """One block of the fused EM with the (M, B, D) residual and deviation
    materialized (``config.mix_exact_rnorm``).  The deviation is this
    rank's columns, so its squared norm is summed over the model group.
    The block's S is added into the running ``S``, as in
    :func:`_block_mix_fast`."""
    mask_f, R, (llks, s, SM, sq_b) = _block_post(Cs, gram, means, sigmas, datab, mask, "fullt",
                                                 group)
    resp, fields = _block_fields(llks, log_weights, w, S, mask, mask_f, SM, sq_b)
    dev = mask_f * (datab - torch.bmm(s, Cs.mT) - means[:, None, :])   # (M, B, D)
    (dev_sq,) = all_reduce_sum([(resp * (dev * dev).sum(-1)).sum(-1)], group)
    return MixEMStats(
        cross=torch.bmm(R.mT, s * resp[..., None]),
        dev_sq=dev_sq,
        total_dev=torch.bmm(resp[:, None, :], dev).squeeze(1),
        **fields,
    )


def mix_em_stats(Cs, means, sigmas, log_weights, data, mask, weights, *,
                 block_size: int, pidx=None, patterns=None, order=None,
                 group=None) -> MixEMStats:
    """One fused pass over the data: every component's EM statistics, the
    responsibilities, the mixture llk and the new-weight numerators.
    ``block_size`` rows of data make M * block_size kernel samples.  With
    ``pidx``/``patterns``, the table route (:func:`mix_em_stats_pat`); with
    ``order`` as well, ``(data_sorted, weights_sorted, counts)`` of the same
    rows sorted by pattern (``Dataset.pattern_order``), its per-segment form
    (:func:`mix_em_stats_pat_sorted`).  No rows give zero statistics (a
    rank of a mesh may hold none)."""
    if order is not None:
        data_sorted, weights_sorted, counts = order
        return mix_em_stats_pat_sorted(Cs, means, sigmas, log_weights, data_sorted,
                                       weights_sorted, patterns, counts, block_size=block_size)
    if pidx is not None:
        return mix_em_stats_pat(Cs, means, sigmas, log_weights, data, mask, pidx, patterns,
                                weights, block_size=block_size)
    M, D, k = Cs.shape
    dtype = _compute_dtype(data, Cs)
    gram = ml.gram_operand(Cs, dtype)
    center = None if config.mix_exact_rnorm else _center_prep(Cs, means)
    S = torch.zeros((M, D, gram.cols.shape[-1]), dtype=dtype, device=data.device)
    acc = None
    for lo, hi in _blocks(data.shape[0], block_size):
        with span("ppca.block"):
            datab, w = data[lo:hi].to(dtype), weights[lo:hi].to(dtype)
            if center is None:
                new = _block_mix(Cs, gram, means, sigmas, log_weights, datab, mask[lo:hi], w, S,
                                 group)
            else:
                new = _block_mix_fast(Cs, gram, center, sigmas, log_weights, datab, mask[lo:hi],
                                      w, S, group)
            acc = _accumulate(acc, new)
    if acc is None:
        opts = dict(dtype=dtype, device=data.device)
        acc = MixEMStats(*(torch.zeros(shape, **opts) for shape in (
            (M, D, k), (M, D, k * k), (M,), (M,), (M, D), (M, D), (M,), (M,), ())))
    else:
        acc = acc._replace(S=kernels.unpack_stats(acc.S, k))
    return acc


# --------------------------------------------------------------------- #
# the table route


def compute_mix_tables(Cs, sigmas, patterns_f) -> PatternTables:
    """Per-(component, pattern) E-step tables, leading axes (M, P): the
    mixture twin of ``pattern_dedup.compute_tables``, all M * P problems in
    ONE ``full`` launch with b = 0 and rnorm = 0, whose second moment is
    then sigma^2 M^{-1}, its llk the mask-only term and its sq tr(G Sigma).
    Fully observed data is the P = 1 case."""
    M, _, k = Cs.shape
    P = patterns_f.shape[0]
    opts = dict(dtype=patterns_f.dtype, device=patterns_f.device)
    G = torch.matmul(patterns_f, ml.outer_flat(Cs).to(patterns_f.dtype)).reshape(M, P, k, k)
    pat_llk, _, Sigma, sq = _estep(sigmas, G, torch.zeros((M, P, k), **opts),
                                   torch.zeros((M, P), **opts), patterns_f.sum(-1), "full")
    return PatternTables(Sigma.reshape(M, P, k * k), pat_llk, sq)


def _block_post_pat(Cs, means, sigmas, tables: PatternTables, datab, mask_f, pidx,
                    center: Optional[_Center] = None):
    """Table-driven posteriors of one block, no per-sample factorization:
    ``(llks (M, B), s (M, B, k), Sig_b (M, B, k, k), sq_b (M, B), b, rnorm)``.
    Each row's covariance is gathered from the table (``Sig_b``) and its
    states are the batched mat-vec ``Sig_b b / sigma^2``.  With ``center``
    the projections come from :func:`_projections`; without it from the
    materialized residual (``config.mix_exact_rnorm``)."""
    M, _, k = Cs.shape
    B = datab.shape[0]
    if center is None:
        R = _residual(means, datab, mask_f)
        b, rnorm = torch.bmm(R, Cs), (R * R).sum(-1)
    else:
        _, b, rnorm = _projections(Cs, center, datab, mask_f)
    sigma2 = (sigmas * sigmas)[:, None]
    Sig_b = tables.Sigma.index_select(1, pidx).view(M, B, k, k)
    s = torch.matmul(Sig_b, b.unsqueeze(-1)).squeeze(-1) / sigma2[..., None]
    quad = (rnorm - (b * s).sum(-1)) / sigma2
    llks = tables.pat_llk.index_select(1, pidx) - 0.5 * quad
    return llks, s, Sig_b, tables.sq.index_select(1, pidx), b, rnorm


def mix_em_stats_pat(Cs, means, sigmas, log_weights, data, mask, pidx, patterns, weights, *,
                     block_size: int) -> MixEMStats:
    """:func:`mix_em_stats` through the M x P tables, for non-empty data
    with ``patterns[pidx] == mask``.  As ``pattern_dedup.em_stats`` does
    for one model, the second-moment sums ``w s s^T``, the weight sums and
    the ``w s`` sums are added into P rows per component (one-hot matmuls
    for P <= k, ``index_add_`` above), and the covariance half of S, the
    noise trace and the observation totals come from the tables in one
    (D, P) contraction each."""
    M, D, k = Cs.shape
    dtype = _compute_dtype(data, Cs)
    patterns_f = patterns.to(dtype)
    P = patterns_f.shape[0]
    tables = compute_mix_tables(Cs, sigmas, patterns_f)
    center = _center_prep(Cs, means)
    post_center = None if config.mix_exact_rnorm else center
    sigma2 = (sigmas * sigmas)[:, None]
    opts = dict(dtype=dtype, device=data.device)
    c1 = torch.zeros((M, D, k), **opts)           # md0^T (w s), the data half of cross
    Souter = torch.zeros((M, P, k * k), **opts)   # per pattern: sum w s s^T
    wsum = torch.zeros((M, P), **opts)            # per pattern: sum w
    psw = torch.zeros((M, P, k), **opts)          # per pattern: sum w s
    t1 = torch.zeros((M, D), **opts)              # w @ md0
    square_error, dev_sq = torch.zeros(M, **opts), torch.zeros(M, **opts)
    resp_max, llk = torch.zeros(M, **opts), torch.zeros((), **opts)
    for lo, hi in _blocks(data.shape[0], block_size):
        datab, mask_f, pb = data[lo:hi].to(dtype), mask[lo:hi].to(dtype), pidx[lo:hi]
        llks, s, _, sq_b, b, rnorm = _block_post_pat(Cs, means, sigmas, tables, datab, mask_f, pb,
                                                     post_center)
        resp, llk_b = _responsibilities(llks, log_weights, weights[lo:hi].to(dtype))
        md0 = mask_f * (datab - center.mean0)
        sw = s * resp[..., None]
        c1 += torch.bmm(md0.T.expand(M, -1, -1), sw)
        if P <= k:
            # few patterns (one for dense data): one-hot matmuls, Souter[m, p]
            # = (onehot_p sw_m)^T s_m, one (P k, B) x (B, k) product a
            # component and no (M, B, k*k) outer products.  On an H100
            # (80GB HBM3, 700 W) at M=8, B=8192, k=32: 0.18 ms at P=1, 0.52 ms
            # at P=32, against 0.68 ms for index_add_ (chip_smoke.py phase 8)
            onehot = torch.nn.functional.one_hot(pb, P).to(dtype)           # (B, P)
            A = (onehot[None, :, :, None] * sw[:, :, None, :]).view(M, -1, P * k)
            Souter += torch.bmm(A.mT, s).view(M, P, k * k)
            psw += torch.matmul(onehot.T, sw)
            wsum += resp @ onehot
        else:
            Souter.index_add_(1, pb, (sw[..., :, None] * s[..., None, :]).view(M, hi - lo, k * k))
            psw.index_add_(1, pb, sw)
            wsum.index_add_(1, pb, resp)
        t1 += resp @ md0
        dev = torch.clamp(rnorm - (b * s).sum(-1) - sigma2 * (s * s).sum(-1), min=0.0)
        dev_sq += (resp * dev).sum(-1)
        square_error += (resp * sq_b).sum(-1)
        resp_max = torch.maximum(resp_max, resp.amax(-1))
        llk = llk + llk_b
    # mask^T (w s) = patterns^T psw and resp @ mask = wsum @ patterns: the
    # mask of a row IS its pattern row
    c2 = torch.matmul(patterns_f.T, psw)                          # (M, D, k)
    totals = wsum @ patterns_f                                    # (M, D)
    return MixEMStats(
        cross=c1 - center.dm[:, :, None] * c2,
        S=torch.matmul(patterns_f.T, Souter + wsum[..., None] * tables.Sigma),
        square_error=square_error,
        dev_sq=dev_sq,
        total_dev=t1 - center.dm * totals - (Cs * c2).sum(-1),
        totals=totals,
        resp_sum=wsum.sum(-1),
        resp_max=resp_max,
        llk=llk,
    )


def mix_em_stats_pat_sorted(Cs, means, sigmas, log_weights, data_sorted, weights_sorted,
                            patterns, counts: Sequence[int], *, block_size: int) -> MixEMStats:
    """:func:`mix_em_stats_pat` over the rows sorted by pattern
    (``Dataset.pattern_order``; ``counts[p]`` rows of pattern p, segment p
    is rows ``[sum(counts[:p]), sum(counts[:p + 1]))``).

    Inside a segment the mask is the constant row ``patterns[p]``, so no
    mask is read and nothing is gathered per row: ``b = md0 @ Cflat -
    bcorr[p]`` is one (B, D) x (D, M k) product and a (M, k) table row,
    the states are one batched (M, B, k) x (M, k, k) product against the
    segment's table column, the second-moment statistic is the plain
    segment Gram ``(w s)^T s`` (2 k^2 operations a sample and component,
    where the one-hot sums take 2 P k^2), and the data half of the cross
    statistic is one (D, B) x (B, M k) product.  The mask halves and S are
    assembled from the P-row sums as :func:`mix_em_stats_pat` does: an
    exact regrouping of its sums.  A segment of no rows adds nothing."""
    M, D, k = Cs.shape
    n = data_sorted.shape[0]
    dtype = _compute_dtype(data_sorted, Cs)
    patterns_f = patterns.to(dtype)
    P = patterns_f.shape[0]
    if len(counts) != P or sum(counts) != n:
        raise ValueError(f"counts {len(counts)}/{sum(counts)} do not partition "
                         f"{P} patterns x {n} rows")
    tables = compute_mix_tables(Cs, sigmas, patterns_f)
    Sig4 = tables.Sigma.view(M, P, k, k)
    mean0, dm, Cdm = _center_prep(Cs, means)
    Cflat = Cs.permute(1, 0, 2).reshape(D, M * k)
    bcorr = torch.einsum("pd,mdk->pmk", patterns_f, Cdm)         # (P, M, k) mask dm_m C_m
    m2_tab = patterns_f @ (dm * dm).T                            # (P, M) mask . dm_m^2
    sigma2 = sigmas * sigmas
    exact_rnorm = config.mix_exact_rnorm
    opts = dict(dtype=dtype, device=data_sorted.device)
    c1 = torch.zeros((D, M * k), **opts)          # md0^T (w s), the data half of cross
    Souter = torch.zeros((M, P, k, k), **opts)    # per pattern: sum w s s^T
    wsum = torch.zeros((M, P), **opts)            # per pattern: sum w
    psw = torch.zeros((M, P, k), **opts)          # per pattern: sum w s
    t1 = torch.zeros((M, D), **opts)              # w @ md0
    dev_sq, resp_max = torch.zeros(M, **opts), torch.zeros(M, **opts)
    llk = torch.zeros((), **opts)
    start = 0
    for p, c in enumerate(counts):
        m_p, Sp, bc_p = patterns_f[p], Sig4[:, p], bcorr[p][:, None, :]
        for lo, hi in _blocks(c, block_size):
            rows = slice(start + lo, start + hi)
            B = hi - lo
            y = data_sorted[rows].to(dtype)
            md0 = m_p * (y - mean0)                                          # (B, D)
            b = (md0 @ Cflat).view(B, M, k).transpose(0, 1) - bc_p           # (M, B, k)
            s = torch.bmm(b, Sp) / sigma2[:, None, None]                     # Sp symmetric
            if exact_rnorm:
                R = m_p * (y - means[:, None, :])                            # (M, B, D)
                rnorm = (R * R).sum(-1)
            else:
                rnorm = ((md0 * md0).sum(-1) - 2.0 * (dm @ md0.T)) + m2_tab[p][:, None]
            bs = (b * s).sum(-1)                                             # (M, B)
            llks = tables.pat_llk[:, p, None] - 0.5 * (rnorm - bs) / sigma2[:, None]
            resp, llk_b = _responsibilities(llks, log_weights, weights_sorted[rows].to(dtype))
            sw = s * resp[..., None]                                         # (M, B, k)
            c1.addmm_(md0.T, sw.transpose(0, 1).reshape(B, M * k))
            Souter[:, p] += torch.bmm(sw.mT, s)
            psw[:, p] += sw.sum(1)
            wsum[:, p] += resp.sum(1)
            t1 += resp @ md0
            # clamp: epsilon-negative in float32 iff |dev|^2 ~ 0 (see dense_fast)
            dev = torch.clamp(rnorm - bs - sigma2[:, None] * (s * s).sum(-1), min=0.0)
            dev_sq += (resp * dev).sum(-1)
            resp_max = torch.maximum(resp_max, resp.amax(-1))
            llk = llk + llk_b
        start += c
    c2 = torch.matmul(patterns_f.T, psw)                          # (M, D, k) mask^T (w s)
    totals = wsum @ patterns_f                                    # (M, D)
    return MixEMStats(
        cross=c1.view(D, M, k).permute(1, 0, 2) - dm[:, :, None] * c2,
        S=torch.matmul(patterns_f.T, Souter.view(M, P, k * k) + wsum[..., None] * tables.Sigma),
        square_error=(wsum * tables.sq).sum(-1),
        dev_sq=dev_sq,
        total_dev=t1 - dm * totals - (Cs * c2).sum(-1),
        totals=totals,
        resp_sum=wsum.sum(-1),
        resp_max=resp_max,
        llk=llk,
    )


# --------------------------------------------------------------------- #
# M-step


def mix_em_finalize(Cs, means, sigmas, stats: MixEMStats, *, transformation_precision,
                    noise_prior=None, mean_prior=None, group=None):
    """Per-component M-step (``masked_linalg.em_finalize``) plus the new
    mixture log-weights (`mix.rs:324-335`).  Returns ``(new_Cs, new_means,
    new_sigmas, new_log_weights)``.

    The statistics are rescaled by 1 / resp_max (the reference's max-1
    weights, which set the priors' strength); the M * D row solves of all
    components run in ONE ``states`` launch on S rebuilt from its lower
    triangle, so a singular row (an empty dimension with lambda = 0) goes
    non-finite alone and keeps its old row.  A dead component keeps its
    parameters: resp_max below the dtype's smallest normal number, so every
    responsibility underflowed (log-weight -inf) or is subnormal (whose
    reciprocal overflows and whose few bits carry no update).  With a model
    ``group``, the new transforms and means are this rank's rows
    (``masked_linalg.em_finalize``)."""
    M, D, k = Cs.shape
    alive = stats.resp_max >= torch.finfo(stats.resp_max.dtype).tiny
    inv_scale = torch.where(alive, 1.0 / torch.where(alive, stats.resp_max, 1.0), 0.0)
    scaled = [x * inv_scale.view(-1, *([1] * (x.ndim - 1)))
              for x in stats[:6]]                  # cross, S, square_error, dev_sq, total_dev, totals
    S_sq = ml.symmetric_from_lower(scaled[1].reshape(M * D, k, k))
    rows = ml.rows_solve(S_sq, scaled[0].reshape(M * D, k), transformation_precision).view(M, D, k)
    zero = torch.zeros((), dtype=Cs.dtype, device=Cs.device)
    new = [ml.em_finalize(Cs[m], means[m], sigmas[m],
                          ml.EMStats(*(x[m] for x in scaled), llk=zero),
                          transformation_precision=transformation_precision,
                          noise_prior=noise_prior, mean_prior=mean_prior, transform_rows=rows[m],
                          group=group)
           for m in range(M)]
    new_Cs, new_means, new_sigmas = (torch.stack(parts) for parts in zip(*new))
    new_Cs = torch.where(alive[:, None, None], new_Cs, Cs)
    new_means = torch.where(alive[:, None], new_means, means)
    new_sigmas = torch.where(alive, new_sigmas, sigmas)
    log_w = torch.log(stats.resp_sum)
    return new_Cs, new_means, new_sigmas, log_w - torch.logsumexp(log_w, 0)


# --------------------------------------------------------------------- #
# readouts


def _block_llks_kernel(Cs, gram, center: _Center, sigmas, datab, mask, want: str, group=None):
    """llk / states / infer of one block of the general route: the Gram and
    the projections of all components, then one kernel launch.  Returns
    ``(llks (M, B), s (M, B, k), Sigma (M, B, k, k), sq)`` as :func:`_estep`."""
    _, _, G, b, rnorm, d_obs = _general_inputs(Cs, gram, center, datab, mask, group)
    return _estep(sigmas, G, b, rnorm, d_obs, want)


def _readout_blocks(Cs, means, sigmas, data, mask, want: str, block_size: int, pidx, patterns,
                    group=None):
    """Per block: ``(llks (M, B), s (M, B, k), Sigma (M, B, k, k))`` from the
    kernel's ``want`` variant (general route) or the tables (``pidx``)."""
    dtype = _compute_dtype(data, Cs)
    center = _center_prep(Cs, means)
    if pidx is None:
        gram = ml.gram_operand(Cs, dtype)
    else:
        tables = compute_mix_tables(Cs, sigmas, patterns.to(dtype))
    for lo, hi in _blocks(data.shape[0], block_size):
        # closed before the yield: no range stays open while the caller runs
        with span("ppca.block"):
            datab = data[lo:hi].to(dtype)
            if pidx is None:
                llks, s, Sig, _ = _block_llks_kernel(Cs, gram, center, sigmas, datab,
                                                     mask[lo:hi], want, group)
            else:
                llks, s, Sig, _, _, _ = _block_post_pat(Cs, means, sigmas, tables, datab,
                                                        mask[lo:hi].to(dtype), pidx[lo:hi],
                                                        center)
        yield datab, mask[lo:hi], llks, s, Sig


def mix_llks(Cs, means, sigmas, data, mask, *, block_size: int, pidx=None,
             patterns=None, group=None) -> torch.Tensor:
    """(N, M) per-component per-sample log-likelihoods in ONE pass (the
    reference makes M, `mix.rs:137-159`)."""
    out = [llks.T for _, _, llks, _, _ in
           _readout_blocks(Cs, means, sigmas, data, mask, "llk", block_size, pidx, patterns,
                           group)]
    return _cat(out, data, _compute_dtype(data, Cs), Cs.shape[0])


def mix_infer(Cs, means, sigmas, log_weights, data, mask, *, block_size: int, pidx=None,
              patterns=None, group=None):
    """``(log_post (N, M), states (M, N, k), covs (M, N, k, k))`` in ONE pass
    (the reference makes M llk and M infer passes, `mix.rs:205-236`).  The
    covariances come from the ``infer`` variant (sigma^2 M^{-1} directly)
    or straight from the tables."""
    M, _, k = Cs.shape
    dtype = _compute_dtype(data, Cs)
    llks, states, covs = [], [], []
    for _, _, l_b, s_b, c_b in _readout_blocks(Cs, means, sigmas, data, mask, "infer",
                                               block_size, pidx, patterns, group):
        llks.append(l_b.T)
        states.append(s_b)
        covs.append(c_b)
    if not llks:
        opts = dict(dtype=dtype, device=data.device)
        return (torch.empty((0, M), **opts), torch.empty((M, 0, k), **opts),
                torch.empty((M, 0, k, k), **opts))
    log_post = torch.log_softmax(torch.cat(llks) + log_weights, -1)
    return log_post, torch.cat(states, 1), torch.cat(covs, 1)


def mix_smooth(Cs, means, sigmas, log_weights, data, mask, *, block_size: int,
               extrapolate: bool = False, pidx=None, patterns=None, group=None) -> torch.Tensor:
    """Posterior-weighted smoothing (`mix.rs:239-251`), or with
    ``extrapolate=True`` extrapolation (`mix.rs:253-265`), in one pass: per
    block the posterior weights fold into the states, so the M-component
    combine is ONE (B, M k) x (M k, D) matmul; no (M, N, ...) tensor."""
    M, D, k = Cs.shape
    C_flat = Cs.mT.reshape(M * k, D)
    out = []
    for datab, maskb, llks, s, _ in _readout_blocks(Cs, means, sigmas, data, mask, "states",
                                                    block_size, pidx, patterns, group):
        post = torch.softmax(llks + log_weights[:, None], 0)                  # (M, B)
        ws = (post[..., None] * s).transpose(0, 1).reshape(datab.shape[0], M * k)
        sm = ws @ C_flat + post.T @ means
        out.append(torch.where(maskb, datab, sm) if extrapolate else sm)
    return _cat(out, data, _compute_dtype(data, Cs), D)
