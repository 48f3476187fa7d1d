"""Mask-weighted dense linear algebra for masked PPCA, on torch tensors.

Port of ``ppca_rs_tpu/ops/masked_linalg.py`` (the general masked path).
Every sample runs the same fixed-shape algebra instead of gathering its
observed rows of ``C``:

* the masked Gram ``G_n = C^T diag(m_n) C`` is linear in the 0/1 mask, so
  with the flattened per-row outer products ``CC in R^{D x k^2}`` the Grams
  of a whole block are ONE matmul ``mask @ CC``; where the kernel takes its
  G as slabs (``kernels.uses_slabs``, the JAX package's
  ``config.g_slab_inputs``), CC holds only the slab columns
  (:func:`outer_slab`, ``slab_width(k)`` of the k^2: 0.5625 at k=64), and
  the matmul builds only the lower wedge the kernel reads.  In float32 on
  the card that product is :func:`ops.kernels.mask_gram` (the bool mask
  times CC's exact three-way bf16 split on the tensor cores with float32
  sums; :func:`gram_operand` chooses); float64 and CPU tensors keep
  ``torch.matmul`` (:func:`masked_gram`);
* the per-sample factorization of ``M_n = sigma^2 I + G_n`` and everything
  derived from it (posterior state, covariance or second moment,
  log-likelihood, noise-update trace) is :func:`ops.kernels.spd_estep`: the
  CUDA kernel on the card, its plain version on the CPU;
* the M-step statistic ``S[d] = sum_n w_n m_nd (s_n s_n^T + Sigma_n)`` is
  the transposed product ``m^T (w * SM)`` (with slab G, over fullt's slab
  SM, accumulated as slabs and unpacked once: the JAX package's
  ``config.s_slab_stats``), added into S block by block by
  :func:`ops.kernels.mask_s` (in float32 on the card the bool mask against
  the scaled SM's exact three-way bf16 split on the tensor cores, float32
  sums; float64 and CPU tensors the plain product), and the M-step's row solves
  ``(S[d] + lambda I) c_d = cross[d]`` are the same kernel with
  ``sigma = sqrt(lambda)``.

Everything is blocked over N by a plain loop over row slices (the last block
is simply shorter), so peak memory is O(block * (D + k^2)).  An all-masked,
zero-weight row is neutral in every reduction.

On a mesh's model axis (``parallel/``) a rank holds a block of D_loc of
the D columns and the matching rows of ``C`` and the mean; the functions
then take that process ``group``.  Per block, the Gram, the projections,
|r|^2 and the observed counts are summed over the group in one all_reduce
before the kernel (the JAX package's ``_psum`` sites), so the kernel's
outputs, ``llk``, ``square_error`` and ``dev_sq`` come out the same on every
rank of the group; ``cross``, ``S``, ``total_dev`` and ``totals`` stay
D_loc-local.  Without a group nothing is reduced.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.profiling import span
from . import kernels


def all_reduce_sum(tensors: Sequence[torch.Tensor], group) -> list:
    """The tensors summed over the process ``group`` by ONE all_reduce of
    one flat buffer (they share a dtype and a device); the tensors
    themselves when ``group`` is None."""
    if group is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    parts = torch.split(flat, [t.numel() for t in tensors])
    return [part.view(t.shape) for part, t in zip(parts, tensors)]


def gather_blocks(parts: Sequence[Tuple[torch.Tensor, int]], group) -> list:
    """Full tensors from the blocks the ranks of ``group`` hold: for each
    ``(x, dim)`` pair, rank r holds block r of ``dim``.  Each rank writes
    its block into a zero-filled full buffer and one all_reduce sums them
    (exact: every entry has one non-zero term); gloo gathers no CUDA
    tensors, an all_reduce works on every backend."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    full = []
    for x, dim in parts:
        shape = list(x.shape)
        n = shape[dim]
        shape[dim] = n * size
        buf = x.new_zeros(shape)
        buf.narrow(dim, rank * n, n).copy_(x)
        full.append(buf)
    return all_reduce_sum(full, group)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def outer_flat(C: torch.Tensor) -> torch.Tensor:
    """Per-row flattened outer products: ``CC[d] = vec(c_d c_d^T)``, (D, k*k),
    or (M, D, k*k) for a stack of M transforms (M, D, k)."""
    k = C.shape[-1]
    return (C[..., :, None] * C[..., None, :]).reshape(*C.shape[:-1], k * k)


def outer_slab(C: torch.Tensor) -> torch.Tensor:
    """The slab columns of :func:`outer_flat` (``kernels.slab_pack``'s
    layout, the entries above the diagonal inside a diagonal block
    included): (D, slab_width(k)), or (M, D, slab_width(k)) for a stack."""
    rows, cols = kernels.slab_coords(C.shape[-1], C.device)
    return C[..., rows] * C[..., cols]


def gram_columns(C: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The columns ``mask @ CC`` contracts for the kernel's G at the compute
    ``dtype``: :func:`outer_slab` where the kernel takes slabs
    (``kernels.uses_slabs``), else :func:`outer_flat`:
    ``kernels.gram_width(k, dtype)`` columns."""
    return outer_slab(C) if kernels.uses_slabs(C.shape[-1], dtype) else outer_flat(C)


class GramOperand(NamedTuple):
    """What ``mask @ CC`` contracts: the columns, and their bf16 slices
    (``kernels.gram_slices``) where the Gram kernel serves the product."""

    cols: torch.Tensor              # (D, W) or (M, D, W), :func:`gram_columns`
    slices: Optional[torch.Tensor]  # (3, [M,] D, W8) bf16, or None


def gram_operand(C: torch.Tensor, dtype: torch.dtype) -> GramOperand:
    """:func:`gram_columns` and, for float32 columns on the card, their
    slices: the one place that chooses the Gram's path.  Float64 would
    need seven slices, and CPU tensors keep the plain product.  Built once
    per call, outside the block loop."""
    CC = gram_columns(C, dtype)
    on_kernel = CC.dtype == torch.float32 and CC.device.type == "cuda"
    return GramOperand(CC, kernels.gram_slices(CC) if on_kernel else None)


def masked_gram(mask, mask_f, gram: GramOperand) -> torch.Tensor:
    """``mask @ CC`` of one block: (B, W), or (M, B, W) for stacked
    columns.  With slices the Gram kernel (``kernels.mask_gram``) writes it
    from the bool ``mask``; without, ``torch.matmul`` of the float mask
    ``mask_f``.  ``kernels.GRAM_LAUNCHES`` counts the path."""
    CC, slices = gram
    if slices is None:
        kernels.GRAM_LAUNCHES["library"] += 1
        return torch.matmul(mask_f, CC)
    out = torch.empty((*CC.shape[:-2], mask.shape[0], CC.shape[-1]), dtype=CC.dtype,
                      device=CC.device)
    kernels.mask_gram(mask, slices, out)
    return out


class BlockPosterior(NamedTuple):
    """E-step quantities of one block of samples."""

    R: torch.Tensor        # (B, D) masked centered data
    b: torch.Tensor        # (B, k) = R @ C
    rnorm: torch.Tensor    # (B,) |R|^2
    d_obs: torch.Tensor    # (B,) observed-entry counts
    out: tuple             # spd_estep outputs for the requested want
    mask_f: torch.Tensor   # (B, D) the mask at the compute dtype


def block_posterior(C, gram: GramOperand, mean, sigma, data, mask, want: str,
                    group=None) -> BlockPosterior:
    """The E-step of one block (`ppca_model.rs:195-208`, batched): the
    matmul prep, summed over the model ``group`` if given, then the SPD
    kernel's ``want`` variant.  ``gram`` is :func:`gram_operand` at the
    compute dtype (``data``'s): G goes to the kernel as slabs where it
    takes them.  ``mask`` is the block's bool mask."""
    k = C.shape[1]
    n = data.shape[0]
    mask_f = mask.to(data.dtype)
    R = mask_f * (data - mean)
    b, G, rnorm, d_obs = all_reduce_sum((R @ C, masked_gram(mask, mask_f, gram),
                                         (R * R).sum(-1), mask_f.sum(-1)), group)
    out = kernels.spd_estep(sigma, kernels.estep_gram(G, n, k), b, rnorm, d_obs, want=want)
    return BlockPosterior(R, b, rnorm, d_obs, out, mask_f)


def _blocks(n: int, block_size: int):
    for start in range(0, n, block_size):
        yield start, min(start + block_size, n)


def _compute_dtype(data: torch.Tensor, C: torch.Tensor) -> torch.dtype:
    return torch.promote_types(torch.promote_types(data.dtype, torch.float32), C.dtype)


def llks(C, mean, sigma, data, mask, *, block_size: int, group=None) -> torch.Tensor:
    """Per-sample log-likelihoods, (N,) (`ppca_model.rs:152-159`)."""
    dtype = _compute_dtype(data, C)
    gram = gram_operand(C, dtype)
    out = []
    for lo, hi in _blocks(data.shape[0], block_size):
        with span("ppca.block"):
            post = block_posterior(C, gram, mean, sigma, data[lo:hi].to(dtype), mask[lo:hi],
                                   "llk", group)
            out.append(post.out[0])
    return _cat(out, data, dtype)


def infer(C, mean, sigma, data, mask, *, block_size: int, group=None):
    """Posterior states and covariances ``(states (N,k), covs (N,k,k))``
    (`ppca_model.rs:221-227`)."""
    dtype = _compute_dtype(data, C)
    gram = gram_operand(C, dtype)
    states_, covs = [], []
    for lo, hi in _blocks(data.shape[0], block_size):
        with span("ppca.block"):
            post = block_posterior(C, gram, mean, sigma, data[lo:hi].to(dtype), mask[lo:hi],
                                   "infer", group)
            states_.append(post.out[0])
            covs.append(post.out[1])
    k = C.shape[1]
    return _cat(states_, data, dtype, k), _cat(covs, data, dtype, k, k)


def states(C, mean, sigma, data, mask, *, block_size: int, group=None) -> torch.Tensor:
    """Posterior state means only, (N, k) — the path behind smooth and
    extrapolate (`ppca_model.rs:231-261`)."""
    dtype = _compute_dtype(data, C)
    gram = gram_operand(C, dtype)
    out = []
    for lo, hi in _blocks(data.shape[0], block_size):
        with span("ppca.block"):
            post = block_posterior(C, gram, mean, sigma, data[lo:hi].to(dtype), mask[lo:hi],
                                   "states", group)
            out.append(post.out[0])
    return _cat(out, data, dtype, C.shape[1])


def sum_parts(parts, dtype, device) -> torch.Tensor:
    """The sum of per-block scalars, taken once at the end of a pass (a
    running float32 sum would round at every block)."""
    if not parts:
        return torch.zeros((), dtype=dtype, device=device)
    return torch.stack(parts).sum()


def _cat(parts, data, dtype, *tail):
    """The per-block outputs as one (N, *tail) tensor (also for N = 0)."""
    if parts:
        return torch.cat(parts, dim=0)
    return torch.empty((0, *tail), dtype=dtype, device=data.device)


class EMStats(NamedTuple):
    """Sufficient statistics of one EM iteration."""

    cross: torch.Tensor         # (D, k)   sum w r s^T        (ppca_model.rs:281-293)
    S: torch.Tensor             # (D, k*k) sum w m_d (ss^T+Sigma), tril (ppca_model.rs:297-308)
    square_error: torch.Tensor  # scalar   sum w tr(G Sigma)  (ppca_model.rs:345)
    dev_sq: torch.Tensor        # scalar   sum w |dev|^2      (ppca_model.rs:346)
    total_dev: torch.Tensor     # (D,)     sum w dev          (ppca_model.rs:347)
    totals: torch.Tensor        # (D,)     sum w m            (ppca_model.rs:348)
    llk: torch.Tensor           # scalar   weighted llk of the *current* model


def em_stats(C, mean, sigma, data, mask, weights, *, block_size: int, group=None) -> EMStats:
    """One pass over the data: E-step posteriors and every M-step sufficient
    statistic (`ppca_model.rs:277-358`), plus the weighted log-likelihood of
    the current model.  Nothing is copied to the host.  With a model
    ``group`` the D-indexed statistics are those of this rank's columns;
    ``square_error``, ``dev_sq`` and ``llk`` come from the group-summed
    E-step inputs, so they are the whole rows' already."""
    D, k = C.shape
    dtype = _compute_dtype(data, C)
    gram = gram_operand(C, dtype)
    sigma2 = sigma * sigma
    cross = torch.zeros((D, k), dtype=dtype, device=data.device)
    # (D, k*k), or as slabs (D, slab_width(k)) where the kernel takes them
    S = torch.zeros((D, gram.cols.shape[-1]), dtype=dtype, device=data.device)
    total_dev = torch.zeros(D, dtype=dtype, device=data.device)
    totals = torch.zeros(D, dtype=dtype, device=data.device)
    # scalar statistics are kept per block and summed at the end
    sq_parts, dev_parts, llk_parts = [], [], []
    for lo, hi in _blocks(data.shape[0], block_size):
        with span("ppca.block"):
            w, maskb = weights[lo:hi].to(dtype), mask[lo:hi]
            post = block_posterior(C, gram, mean, sigma, data[lo:hi].to(dtype), maskb, "fullt",
                                   group)
            mask_f = post.mask_f
            s, SM, llk_b, sq_b = post.out
            sw = s * w[:, None]
            cross += post.R.T @ sw
            kernels.mask_s(maskb, SM.reshape(hi - lo, -1), w, S)
            sq_parts.append((w * sq_b).sum())
            # No residual materialization: with M s = b and G = M - sigma^2 I,
            # s^T G s = b.s - sigma^2 |s|^2, so the masked residual norm is
            # rnorm - b.s - sigma^2 |s|^2 (clamped: it can round below zero
            # when the residual is ~0), and w @ dev is w @ R minus a (D, k)
            # contraction.
            bs = (post.b * s).sum(-1)
            s2 = (s * s).sum(-1)
            dev_parts.append((w * torch.clamp(post.rnorm - bs - sigma2 * s2, min=0.0)).sum())
            msw = mask_f.T @ sw
            total_dev += w @ post.R - (C * msw).sum(-1)
            totals += w @ mask_f
            llk_parts.append((w * llk_b).sum())

    def total(parts):
        return sum_parts(parts, dtype, data.device)

    return EMStats(cross, kernels.unpack_stats(S, k), total(sq_parts), total(dev_parts), total_dev, totals,
                   total(llk_parts))


def rows_solve(S_sq, cross, lam) -> torch.Tensor:
    """Batched SPD row solve ``(S[d] + lam I) c_d = cross[d]`` through the
    SPD kernel's ``states`` variant with ``sigma = sqrt(lam)``.  A singular
    row (an empty dimension with ``lam = 0``) comes back non-finite; the
    other rows are unaffected."""
    D, k, _ = S_sq.shape
    lam = torch.as_tensor(lam, dtype=S_sq.dtype, device=S_sq.device)
    zeros = torch.zeros(D, dtype=S_sq.dtype, device=S_sq.device)
    sol, _ = kernels.spd_estep(torch.sqrt(lam), S_sq.contiguous(), cross.contiguous(),
                               zeros, zeros, want="states")
    return sol


def symmetric_from_lower(S_sq: torch.Tensor) -> torch.Tensor:
    """``tril(S) + tril(S, -1)^T`` over the last two axes: S is symmetric
    by construction, and rebuilding it from its lower triangle keeps the
    row solves exact for any producer that fills only that triangle."""
    return torch.tril(S_sq) + torch.tril(S_sq, -1).mT


def em_finalize(C, mean, sigma, stats: EMStats, *, transformation_precision,
                noise_prior: Optional[tuple] = None, mean_prior: Optional[tuple] = None,
                transform_rows: Optional[torch.Tensor] = None, group=None):
    """M-step parameter updates from the sufficient statistics
    (`ppca_model.rs:294-393`).  Returns ``(new_C, new_mean, new_sigma)``.

    ``transform_rows`` (D, k), when given, are the row solves already done
    by the caller (the mixture M-step solves every component's rows in one
    launch, ``mix_fused.mix_em_finalize``); they take the same
    keep-old-row fallback.

    With a model ``group``, ``C``, ``mean`` and the D-indexed statistics
    are this rank's block of rows, and so are the new transform and mean
    it returns; the observation count is summed over the group, and a mean
    prior sees the whole mean (gathered)."""
    D, k = C.shape

    # --- transform rows, keeping the old row where the solve is non-finite
    # (the QR-failure fallback at ppca_model.rs:313-321).
    if transform_rows is None:
        S_sq = symmetric_from_lower(stats.S.reshape(D, k, k))
        sol = rows_solve(S_sq, stats.cross, transformation_precision)
    else:
        sol = transform_rows
    ok = torch.isfinite(sol).all(dim=-1, keepdim=True)
    new_C = torch.where(ok, sol, C)

    # --- isotropic noise (ppca_model.rs:360-371)
    sq = stats.square_error + stats.dev_sq
    (n_obs,) = all_reduce_sum([stats.totals.sum()], group)
    if noise_prior is not None:
        alpha, beta = noise_prior
        # inverse-gamma MAP mode: (sq/2 + beta) / (n/2 + alpha + 1)
        sigma2_new = (sq / 2.0 + beta) / (n_obs / 2.0 + alpha + 1.0)
    else:
        sigma2_new = sq / n_obs

    # --- mean (ppca_model.rs:373-384)
    seen = stats.totals > 0
    new_mean = torch.where(
        seen, stats.total_dev / torch.where(seen, stats.totals, torch.ones_like(stats.totals)),
        torch.zeros_like(stats.totals),
    ) + mean
    if mean_prior is not None:
        prior_mean, prior_precision = mean_prior
        totals, full_mean = stats.totals, new_mean
        if group is not None:
            totals, full_mean = gather_blocks([(totals, 0), (new_mean, 0)], group)
        # precision-weighted combine solved directly (prior.rs:97-110)
        data_precision_diag = totals / sigma2_new
        total_precision = prior_precision + torch.diag(data_precision_diag)
        numerator = prior_precision @ prior_mean + data_precision_diag * full_mean
        new_mean = torch.linalg.solve(total_precision, numerator)
        if group is not None:
            new_mean = new_mean.narrow(0, dist.get_rank(group) * D, D)

    return new_C, new_mean, torch.sqrt(sigma2_new)
