"""Accuracy of the 3xTF32 split that the panel design's and the E-step
tile's products use, and the tile's blocked algorithm itself.

``csrc/spd_panel.cuh`` runs the products of each panel step (the trailing
update and the panel products) on the tensor cores, and so does the blocked
body of ``csrc/spd_estep_tile.cuh`` (k from 17 to 128 in float32): in float32
as three TF32 products (hi = tf32(a), lo = tf32(a - hi), hi*hi' + hi*lo' +
lo*hi').  This file emulates TF32 rounding in plain PyTorch (round to
nearest, ties away from zero, 10 mantissa bits, on the int32 view, as
``cvt.rna.tf32.f32`` rounds) and runs each design's two algorithms with
their products in 3xTF32 and in one TF32 product, against the float64
plain versions ``spd_chol_reference`` and ``spd_estep_reference``: the
panel's blocked right-looking Cholesky factor and blocked symmetric
Gauss-Jordan inverse at NB=32, and the tile's (``tile_estep``, a
transcription of the kernel's steps: the pivot block inverted by the
Gauss-Jordan sweep, Y = U P, the active lower triangle taking -Y U^T) at
its NB=16, as the block LDL^T solve of ``states``, the inverse of
``infer`` and the Cholesky factor of ``chol`` (spd_chol: the pivot block
factored by the column step into L11 and L11^{-1}, L21 = U L11^{-T}, the
active lower triangle taking -L21 L21^T).  The split must hold the
kernels' float32 tolerance (1e-4 relative to each output's largest
magnitude); one TF32 product alone must not be close to it.
``tile_estep`` with exact float64 products is also held against the plain
version at 1e-10 in every variant, and its ``chol`` against numpy's
Cholesky, failed samples included.
"""

import math

import numpy as np
import pytest
import torch

from ppca_rs_tpu_torch.ops import kernels as tk

NB = 32
TILE_NB = 16
TILE_SIZES = (8, 16, 32, 64, 128)
SIGMA = 0.7
TOL_F32 = 1e-4
TOL_F64 = 1e-10
N_SAMPLES = 2


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32: nearest, ties away from zero, 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a: torch.Tensor, bt: torch.Tensor, split) -> torch.Tensor:
    """a @ bt^T with TF32 operands and float32 sums: three products of the
    split operands (small terms first), or one of the rounded operands;
    ``split=None``: the plain product in the operands' dtype."""
    if split is None:
        return a @ bt.T
    a_hi, b_hi = tf32(a), tf32(bt)
    if not split:
        return a_hi @ b_hi.T
    a_lo, b_lo = tf32(a - a_hi), tf32(bt - b_hi)
    return a_lo @ b_hi.T + a_hi @ b_lo.T + a_hi @ b_hi.T


def pivot(S: torch.Tensor):
    """The pivot block's factor and its inverse, in float32 outside the
    tensor cores (one warp's work in the kernel)."""
    L11 = torch.linalg.cholesky(S)
    eye = torch.eye(S.shape[0], dtype=S.dtype)
    return L11, torch.linalg.solve_triangular(L11, eye, upper=False)


def blocked_cholesky(M: torch.Tensor, split: bool, nb: int = NB) -> torch.Tensor:
    """Right-looking blocked Cholesky: per step V = U L11^{-T}, then the
    trailing triangle takes -V V^T."""
    A = M.clone()
    k = A.shape[0]
    for j0 in range(0, k, nb):
        j1 = min(j0 + nb, k)
        L11, linv = pivot(A[j0:j1, j0:j1])
        A[j0:j1, j0:j1] = L11
        V = product(A[j1:, j0:j1], linv, split)
        A[j1:, j0:j1] = V
        A[j1:, j1:] -= product(V, V, split)
    return torch.tril(A)


def blocked_gauss_jordan(M: torch.Tensor, split: bool, nb: int = NB) -> torch.Tensor:
    """Blocked symmetric Gauss-Jordan sweep over every row but the pivot
    block's: V = U L11^{-T}, the rest takes -V V^T, the panel becomes
    V L11^{-1} and the pivot block -L11^{-T} L11^{-1}.  Returns M^{-1}."""
    A = M.clone()
    k = A.shape[0]
    for j0 in range(0, k, nb):
        j1 = min(j0 + nb, k)
        rest = torch.cat([torch.arange(j0), torch.arange(j1, k)])
        _, linv = pivot(A[j0:j1, j0:j1])
        V = product(A[rest][:, j0:j1], linv, split)
        A[rest[:, None], rest[None, :]] -= product(V, V, split)
        panel = product(V, linv.T, split)
        A[rest, j0:j1] = panel
        A[j0:j1, rest] = panel.T
        A[j0:j1, j0:j1] = -(linv.T @ linv)
    return -A


def gj_sweep(S: torch.Tensor, x: torch.Tensor):
    """The tile's Gauss-Jordan sweep of a symmetric block with a right-hand
    side (``gj_sweep`` in the kernel: lane r holds row r), in S's dtype:
    ``(-S^{-1}, S^{-1} x, pivots, z = L^{-1} x)``."""
    a, x = S.clone(), x.clone()
    n = a.shape[0]
    piv, z = torch.empty(n, dtype=a.dtype), torch.empty(n, dtype=a.dtype)
    for j in range(n):
        d = a[j, j].clone()
        rs = torch.rsqrt(d)
        inv_d = rs * rs
        xj = x[j].clone()
        w = a[:, j] * inv_d
        u = a[j, :].clone()
        a -= w[:, None] * u[None, :]
        x -= w * xj
        a[:, j] = w
        a[j, :] = u * inv_d
        a[j, j] = -inv_d
        x[j] = xj * inv_d
        piv[j], z[j] = d, xj * rs
    return a, x, piv, z


def chol_sweep(S: torch.Tensor):
    """The tile's Cholesky column step on a block S (lane r holds row r of
    its lower triangle, zeros above): d = A[j][j], column j becomes
    A[:,j] / sqrt(d) at rows >= j (0 above), every row r takes
    -u_r u_l at l > j.  ``(L with zeros above the diagonal, pivots,
    1 / sqrt(pivots))``."""
    n = S.shape[0]
    low = torch.ones(n, n, dtype=torch.bool).tril()
    a = torch.where(low, S, torch.zeros((), dtype=S.dtype))
    rows = torch.arange(n)
    piv, rs = torch.empty(n, dtype=S.dtype), torch.empty(n, dtype=S.dtype)
    for j in range(n):
        d = a[j, j].clone()
        r = torch.rsqrt(d)
        u = torch.where(rows >= j, a[:, j] * r, torch.zeros((), dtype=S.dtype))
        a[:, j] = u
        a[:, j + 1:] -= u[:, None] * u[None, j + 1:]
        piv[j], rs[j] = d, r
    return a, piv, rs


def forward_inverse(L11: torch.Tensor, rs: torch.Tensor) -> torch.Tensor:
    """L11^{-1} as the kernel forms it, lane c column c by forward
    substitution on e_c with the pivots' 1/sqrt(d): zeros above the
    diagonal."""
    X = torch.eye(L11.shape[0], dtype=L11.dtype)
    for i in range(L11.shape[0]):
        X[i] *= rs[i]
        X[i + 1:] -= L11[i + 1:, i:i + 1] * X[i:i + 1]
    return X


def tile_cholesky(M: torch.Tensor, split, nb: int = TILE_NB):
    """The tile's ``chol`` (spd_chol at k <= 128) on one sample, in M's
    dtype, on the kernel's storage: M's lower triangle only (NaN above it),
    padded with an identity block to KP.  Up to KP=16 one column sweep of
    the whole block; above, steps of nb columns: the pivot block's sweep
    gives L11 (written into block J) and L11^{-1}; the rows below block J
    stage U; L21 = U L11^{-T} becomes block column J; the active lower
    triangle takes -L21 L21^T.  A pivot <= 0 or NaN (log det not finite)
    makes L NaN on and below the diagonal; above it L is 0.
    Returns ``(L, log det M)``."""
    k = M.shape[0]
    KP = next(p for p in TILE_SIZES if p >= k)
    dtype = M.dtype
    low = torch.ones(KP, KP, dtype=torch.bool).tril()
    A = torch.eye(KP, dtype=dtype)
    A[:k, :k] = M
    A = torch.where(low, A, torch.full_like(A, math.nan))
    if KP <= 16:
        A, piv, _ = chol_sweep(A)
        logdet = torch.log(piv).sum()
    else:
        lnb = low[:nb, :nb]
        logdet = torch.zeros((), dtype=dtype)
        for j0 in range(0, KP, nb):
            j1 = j0 + nb
            blk = A[j0:j1, j0:j1]
            L11, piv, rs = chol_sweep(blk)
            logdet = logdet + torch.log(piv).sum()
            A[j0:j1, j0:j1] = torch.where(lnb, L11, blk)
            if j1 == KP:
                continue
            U = A[j1:, j0:j1].clone()
            Y = product(U, forward_inverse(L11, rs), split)   # U L11^{-T}
            A[j1:, j0:j1] = Y
            sub = A[j1:, j1:]
            lower = torch.ones(KP - j1, KP - j1, dtype=torch.bool).tril()
            A[j1:, j1:] = torch.where(lower, sub - product(Y, Y, split), sub)
    poison = 0.0 if bool(torch.isfinite(logdet)) else math.nan
    L = torch.where(low[:k, :k], A[:k, :k] + poison, torch.zeros((), dtype=dtype))
    return L, logdet


def tile_estep(M: torch.Tensor, b: torch.Tensor, want: str, split, nb: int = TILE_NB):
    """The E-step tile's algorithm on one sample, M = sigma^2 I + G (k, k),
    in M's dtype, with the kernel's storage: M padded with an identity block
    to the tile size KP, its lower triangle only (NaN above it, as shared
    memory holds garbage there).  Up to KP=16 one Gauss-Jordan sweep of the
    whole block; above, steps of nb columns: the pivot block's sweep gives
    P = S^{-1}; the active rows (below block J for llk and states, all but
    block J's for the inverse variants, those above it read as columns)
    stage U; Y = U P; x_i -= Y_i x_J; block column J becomes Y (inverse
    variants and states); the active lower triangle takes -Y_i U_l.
    Returns ``(s, M^{-1} or None, log det M, b^T M^{-1} b)``."""
    k = M.shape[0]
    KP = next(p for p in TILE_SIZES if p >= k)
    dtype = M.dtype
    inverse = want in ("fullt", "full", "infer")
    Mp = torch.eye(KP, dtype=dtype)
    Mp[:k, :k] = M
    x = torch.zeros(KP, dtype=dtype)
    x[:k] = b
    if KP <= 16:
        a, x, piv, z = gj_sweep(Mp, x)
        return x[:k], -a[:k, :k], torch.log(piv).sum(), (z * z).sum()
    low = torch.ones(KP, KP, dtype=torch.bool).tril()
    A = torch.where(low, Mp, torch.full_like(Mp, math.nan))
    logdet = quad = torch.zeros((), dtype=dtype)
    for j0 in range(0, KP, nb):
        above = j0 if inverse else 0
        m = KP - nb if inverse else KP - j0 - nb
        base = nb if inverse else j0 + nb
        blk = A[j0:j0 + nb, j0:j0 + nb]
        a, xv, piv, z = gj_sweep(torch.where(low[:nb, :nb], blk, blk.T), x[j0:j0 + nb])
        logdet = logdet + torch.log(piv).sum()
        quad = quad + (z * z).sum()
        xJ = x[j0:j0 + nb].clone()
        x[j0:j0 + nb] = xv
        if inverse:
            A[j0:j0 + nb, j0:j0 + nb] = torch.where(low[:nb, :nb], a, blk)
        if m == 0:
            continue
        real = torch.tensor([ci if ci < above else ci + base for ci in range(m)])
        U = torch.stack([A[j0:j0 + nb, ci] if ci < above else A[ci + base, j0:j0 + nb]
                         for ci in range(m)])
        Y = product(U, -a, split)                    # U P, P symmetric
        x[real] -= Y @ xJ
        if inverse or want == "states":
            for ci in range(m):
                if ci < above:
                    A[j0:j0 + nb, ci] = Y[ci]
                else:
                    A[ci + base, j0:j0 + nb] = Y[ci]
        sub = A[real[:, None], real[None, :]]
        lower = torch.ones(m, m, dtype=torch.bool).tril()
        A[real[:, None], real[None, :]] = torch.where(lower, sub - product(Y, U, split), sub)
    if want == "states":
        for i0 in range(KP - nb, 0, -nb):
            x[:i0] -= A[i0:i0 + nb, :i0].T @ x[i0:i0 + nb]
    minv = None
    if inverse:
        full = torch.where(low, A, A.T)
        minv = -full[:k, :k]
    return x[:k], minv, logdet, quad


def masked_spd(k: int, seed: int):
    """(M = sigma^2 I + G, G, b) in float64 for N_SAMPLES samples: Grams of a
    random C under a 50% mask, as chip_smoke.py's kernel inputs are made."""
    rng = np.random.default_rng(seed)
    D = max(64, 4 * k)
    C = rng.standard_normal((D, k))
    mask = (rng.random((N_SAMPLES, D)) < 0.5).astype(np.float64)
    G = np.einsum("nd,di,dj->nij", mask, C, C)
    R = rng.standard_normal((N_SAMPLES, D)) * mask
    M = G + SIGMA ** 2 * np.eye(k)
    return torch.from_numpy(M), torch.from_numpy(G), torch.from_numpy(R @ C), mask


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


# (NB, k): the panel design's NB=32 past the tile limit, the tile's NB=16
# (k=13 is one diagonal block of the tile, KP=16: no product is taken)
CASES = [pytest.param(NB, k, id=str(k)) for k in (131, 160, 256)] + [
    pytest.param(TILE_NB, k, id=f"tile-nb{TILE_NB}-{k}") for k in (13, 50, 64, 128)]
# ... and for the Cholesky factor also the tile's chol (spd_chol at k <= 128)
CHOL_CASES = [pytest.param(*case.values, False, id=case.id) for case in CASES] + [
    pytest.param(TILE_NB, k, True, id=f"tile-nb{TILE_NB}-chol-{k}") for k in (50, 64, 128)]


def check_split(errs, nb, k, what):
    """3xTF32 holds the tolerance; one TF32 product alone is at least ten
    times worse, wherever the algorithm takes a product at all."""
    msg = f"k={k} NB={nb}: {what} in 3xTF32 {errs[True]:.3e}, 1xTF32 {errs[False]:.3e} (tol {TOL_F32:g})"
    assert errs[True] <= TOL_F32, msg
    if nb == TILE_NB and k <= 16:
        assert errs[False] == errs[True], msg   # one block: no tensor-core product
    else:
        assert errs[False] > 10 * errs[True], msg


@pytest.mark.parametrize("nb,k,chol", CHOL_CASES)
def test_blocked_cholesky_in_3xtf32_holds_the_float32_tolerance(nb, k, chol):
    M, G, b, mask = masked_spd(k, seed=k)
    if chol:
        # the tile's chol: L of M itself
        ref = tk.spd_chol_reference(M)
        errs = {split: max(rel_err(tile_cholesky(M[n].float(), split, nb)[0], ref[n])
                           for n in range(N_SAMPLES))
                for split in (True, False)}
        check_split(errs, nb, k, "L")
        return
    if nb == NB:
        ref = tk.spd_chol_reference(M)
        errs = {split: max(rel_err(blocked_cholesky(M[n].float(), split, nb), ref[n])
                           for n in range(N_SAMPLES))
                for split in (True, False)}
        check_split(errs, nb, k, "L")
        return
    # the tile's factor variants: the block LDL^T solve of states
    rnorm = torch.zeros(N_SAMPLES, dtype=torch.float64)
    d_obs = torch.from_numpy(mask.sum(-1))
    s_ref, _ = tk.spd_estep_reference(SIGMA, G, b, rnorm, d_obs, want="states")
    errs = {split: max(rel_err(tile_estep(M[n].float(), b[n].float(), "states", split, nb)[0],
                               s_ref[n])
                       for n in range(N_SAMPLES))
            for split in (True, False)}
    check_split(errs, nb, k, "s")


@pytest.mark.parametrize("nb,k", CASES)
def test_blocked_gauss_jordan_in_3xtf32_holds_the_float32_tolerance(nb, k):
    _, G, b, mask = masked_spd(k, seed=1000 + k)
    rnorm = torch.zeros(N_SAMPLES, dtype=torch.float64)
    d_obs = torch.from_numpy(mask.sum(-1))
    _, cov, _, _ = tk.spd_estep_reference(SIGMA, G, b, rnorm, d_obs, want="infer")
    M = (G + SIGMA ** 2 * torch.eye(k, dtype=torch.float64)).float()
    if nb == NB:
        def sigma_of(n, split):
            return SIGMA ** 2 * blocked_gauss_jordan(M[n], split, nb)
    else:
        def sigma_of(n, split):
            return SIGMA ** 2 * tile_estep(M[n], b[n].float(), "infer", split, nb)[1]
    errs = {split: max(rel_err(sigma_of(n, split), cov[n]) for n in range(N_SAMPLES))
            for split in (True, False)}
    check_split(errs, nb, k, "Sigma")


@pytest.mark.parametrize("k", [2, 13, 24, 50, 64, 99, 128])
def test_tile_algorithm_matches_the_plain_version(k):
    """The tile's steps with exact float64 products give every variant's
    outputs of the plain version (1e-10), on the kernel's storage: the
    lower triangle only, padded with the identity, NaN above it."""
    _, G, b, mask = masked_spd(k, seed=2000 + k)
    rnorm = torch.from_numpy(np.random.default_rng(k).random(N_SAMPLES)) * 50.0
    d_obs = torch.from_numpy(mask.sum(-1))
    M = G + SIGMA ** 2 * torch.eye(k, dtype=torch.float64)
    s2 = SIGMA ** 2
    for want in tk.WANTS:
        ref = tk.spd_estep_reference(SIGMA, G, b, rnorm, d_obs, want)
        for n in range(N_SAMPLES):
            s, minv, logdet, quad = tile_estep(M[n], b[n], want, None)
            llk = -0.5 * ((rnorm[n] - quad) / s2 + logdet + math.log(s2) * (d_obs[n] - k)
                          + tk.LN_2PI * d_obs[n])
            got = {"llk": (llk,), "states": (s, llk)}.get(want)
            if got is None:
                cov = s2 * minv
                sq = s2 * (k - s2 * torch.diagonal(minv).sum())
                got = (s, cov if want == "infer" else torch.outer(s, s) + cov, llk, sq)
            for g, r in zip(got, ref):
                assert bool(torch.isfinite(g).all()), (want, k)
                assert rel_err(g.reshape(-1), r[n].reshape(-1)) <= TOL_F64, (want, k)


@pytest.mark.parametrize("k", [1, 2, 5, 13, 24, 50, 64, 99, 100, 128])
def test_tile_cholesky_matches_numpy(rng, k):
    """The tile's chol steps with exact float64 products factor SPD samples
    as numpy does (1e-10), reading M's lower triangle only (NaN stored
    above it); a negative-definite and an indefinite sample go NaN on and
    below the diagonal, alone, with zeros above it."""
    B = 6
    V = rng.normal(size=(B, k, 2 * k)) / np.sqrt(2 * k)
    M = V @ np.swapaxes(V, -1, -2) + 0.1 * np.eye(k)
    M[1] = -M[1]                                   # negative definite
    if k > 1:
        M[4, k - 1, k - 1] = -1.0                  # indefinite: fails at the last pivot
    else:
        M[4] = -1.0
    stored = np.where(np.triu(np.ones((k, k), bool), 1), np.nan, M)
    L = np.stack([tile_cholesky(torch.from_numpy(stored[n]), None)[0].numpy() for n in range(B)])
    good = [0, 2, 3, 5]
    np.testing.assert_allclose(L[good], np.linalg.cholesky(M[good]), rtol=TOL_F64, atol=TOL_F64)
    assert np.all(np.triu(L, 1) == 0)
    lower = np.tril_indices(k)
    for bad in (1, 4):
        assert np.isnan(L[bad][lower]).all()


def test_tf32_rounds_to_nearest_ties_away():
    """10 mantissa bits kept; halfway cases go away from zero, as
    cvt.rna.tf32.f32 rounds."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4, one + 3 * ulp / 4, 3.0],
                     dtype=torch.float32)
    assert tf32(x).tolist() == [one + ulp, -(one + ulp), one, one + ulp, 3.0]
