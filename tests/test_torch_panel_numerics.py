"""Accuracy of the 3xTF32 split that the panel design's products use.

``csrc/spd_panel.cuh`` runs the products of each panel step (the trailing
update and the panel products) on the tensor cores: in float32 as three
TF32 products (hi = tf32(a), lo = tf32(a - hi), hi*hi' + hi*lo' + lo*hi').
This file emulates TF32 rounding in plain PyTorch (round to nearest, ties
away from zero, 10 mantissa bits, on the int32 view, as ``cvt.rna.tf32.f32``
rounds) and runs the design's two algorithms at NB=32 -- the blocked
right-looking Cholesky factor and the blocked symmetric Gauss-Jordan
inverse -- with their products in 3xTF32 and in one TF32 product, against
the float64 plain versions ``spd_chol_reference`` and
``spd_estep_reference``.  The split must hold the kernels' float32
tolerance (1e-4 relative to each output's largest magnitude); one TF32
product alone must not be close to it.
"""

import numpy as np
import pytest
import torch

from ppca_rs_tpu_torch.ops import kernels as tk

NB = 32
SIGMA = 0.7
TOL_F32 = 1e-4
N_SAMPLES = 2


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32: nearest, ties away from zero, 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def product(a: torch.Tensor, bt: torch.Tensor, split: bool) -> torch.Tensor:
    """a @ bt^T with TF32 operands and float32 sums: three products of the
    split operands (small terms first), or one of the rounded operands."""
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


def blocked_cholesky(M: torch.Tensor, split: bool) -> torch.Tensor:
    """Right-looking blocked Cholesky: per step V = U L11^{-T}, then the
    trailing triangle takes -V V^T."""
    A = M.clone()
    k = A.shape[0]
    for j0 in range(0, k, NB):
        j1 = min(j0 + NB, k)
        L11, linv = pivot(A[j0:j1, j0:j1])
        A[j0:j1, j0:j1] = L11
        V = product(A[j1:, j0:j1], linv, split)
        A[j1:, j0:j1] = V
        A[j1:, j1:] -= product(V, V, split)
    return torch.tril(A)


def blocked_gauss_jordan(M: torch.Tensor, split: bool) -> torch.Tensor:
    """Blocked symmetric Gauss-Jordan sweep over every row but the pivot
    block's: V = U L11^{-T}, the rest takes -V V^T, the panel becomes
    V L11^{-1} and the pivot block -L11^{-T} L11^{-1}.  Returns M^{-1}."""
    A = M.clone()
    k = A.shape[0]
    for j0 in range(0, k, NB):
        j1 = min(j0 + NB, k)
        rest = torch.cat([torch.arange(j0), torch.arange(j1, k)])
        _, linv = pivot(A[j0:j1, j0:j1])
        V = product(A[rest][:, j0:j1], linv, split)
        A[rest[:, None], rest[None, :]] -= product(V, V, split)
        panel = product(V, linv.T, split)
        A[rest, j0:j1] = panel
        A[j0:j1, rest] = panel.T
        A[j0:j1, j0:j1] = -(linv.T @ linv)
    return -A


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


@pytest.mark.parametrize("k", [131, 160, 256])
def test_blocked_cholesky_in_3xtf32_holds_the_float32_tolerance(k):
    M, _, _, _ = masked_spd(k, seed=k)
    ref = tk.spd_chol_reference(M)
    errs = {split: max(rel_err(blocked_cholesky(M[n].float(), split), ref[n])
                       for n in range(N_SAMPLES))
            for split in (True, False)}
    msg = f"k={k}: 3xTF32 {errs[True]:.3e}, 1xTF32 {errs[False]:.3e} (tol {TOL_F32:g})"
    assert errs[True] <= TOL_F32, msg
    assert errs[False] > 10 * errs[True], msg


@pytest.mark.parametrize("k", [131, 160, 256])
def test_blocked_gauss_jordan_in_3xtf32_holds_the_float32_tolerance(k):
    _, G, b, mask = masked_spd(k, seed=1000 + k)
    rnorm = torch.zeros(N_SAMPLES, dtype=torch.float64)
    d_obs = torch.from_numpy(mask.sum(-1))
    _, cov, _, _ = tk.spd_estep_reference(SIGMA, G, b, rnorm, d_obs, want="infer")
    M = (G + SIGMA ** 2 * torch.eye(k, dtype=torch.float64)).float()
    errs = {split: max(rel_err(SIGMA ** 2 * blocked_gauss_jordan(M[n], split), cov[n])
                       for n in range(N_SAMPLES))
            for split in (True, False)}
    msg = f"k={k}: Sigma in 3xTF32 {errs[True]:.3e}, 1xTF32 {errs[False]:.3e} (tol {TOL_F32:g})"
    assert errs[True] <= TOL_F32, msg
    assert errs[False] > 10 * errs[True], msg


def test_tf32_rounds_to_nearest_ties_away():
    """10 mantissa bits kept; halfway cases go away from zero, as
    cvt.rna.tf32.f32 rounds."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4, one + 3 * ulp / 4, 3.0],
                     dtype=torch.float32)
    assert tf32(x).tolist() == [one + ulp, -(one + ulp), one, one + ulp, 3.0]
