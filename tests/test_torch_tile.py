"""The register-tile Cholesky's step formula (csrc/spd_chol_tile.cuh) and
the port's masked path at k=128, on the CPU.

The CUDA kernel cannot run here; its algorithm can.  ``tile_cholesky`` is a
numpy transcription of the kernel's step over the whole identity-padded
tile, which starts as M's lower triangle: d = A[j][j], u = A[:,j]/sqrt(d) at
rows >= j and 0 above, A -= u u^T over the whole tile, then column j = u.
It sweeps whole quads of four pivots and has the kernel's failure rule (a
pivot <= 0 or NaN makes the factor NaN on and below the diagonal, zeros
above it).  It is held against numpy's Cholesky at 1e-12 in float64.  The port's k=128
masked EM step is held against the JAX package's in float64 at the suite's
1e-9 (the kernel's plain version runs on the CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppca_rs_tpu as jp
from ppca_rs_tpu_torch import interop
from ppca_rs_tpu_torch.config import config as tconfig

torch.set_num_threads(1)

TILES = (8, 16, 32, 64, 128)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port builds on the card by default; these tests ask for the CPU."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))


def tile_cholesky(M, skip_done_rows=False):
    """The kernel's factorization of each M (B, k, k), reading its lower
    triangle only.  ``skip_done_rows`` also leaves out, per step, the row
    quads that lie wholly above the pivot, as the kernel does for the row
    quads finished in every lane of a warp."""
    B, k, _ = M.shape
    KP = next(t for t in TILES if k <= t)
    A = np.zeros((B, KP, KP))
    A[:, :k, :k] = np.tril(M)
    A[:, range(k, KP), range(k, KP)] = 1.0          # identity padding
    rows = np.arange(KP)
    ok = np.ones(B, bool)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        for j in range(-(-k // 4) * 4):             # whole quads of pivots below k
            col = A[:, :, j].copy()                 # the broadcast pivot column
            d = col[:, j]
            ok &= d > 0
            u = np.where(rows >= j, col * np.sqrt(1.0 / d)[:, None], 0.0)
            upd = u[:, :, None] * u[:, None, :]
            if skip_done_rows:
                upd[:, rows // 4 * 4 + 3 < j] = 0.0
            A -= upd
            A[:, :, j] = u
    L = np.tril(A[:, :k, :k]) + np.where(ok, 0.0, np.nan)[:, None, None]
    return np.where(np.tril(np.ones((k, k), bool)), L, 0.0)


def spd_batch(rng, B, k):
    V = rng.normal(size=(B, k, 2 * k)) / np.sqrt(2 * k)
    return V @ np.swapaxes(V, -1, -2) + 0.1 * np.eye(k)


@pytest.mark.parametrize("k", [1, 5, 13, 64, 100, 128])
def test_tile_cholesky_matches_numpy(rng, k):
    """SPD samples factor as numpy does; a negative-definite and an
    indefinite sample go NaN on and below the diagonal, alone, with zeros
    above it."""
    B = 6
    M = spd_batch(rng, B, k)
    M[1] = -M[1]                                   # negative definite
    if k > 1:
        M[4, k - 1, k - 1] = -1.0                  # indefinite: fails at the last pivot
    else:
        M[4] = -1.0
    L = tile_cholesky(M)
    good = [0, 2, 3, 5]
    np.testing.assert_allclose(L[good], np.linalg.cholesky(M[good]), rtol=1e-12, atol=1e-12)
    assert np.all(np.triu(L, 1) == 0)
    lower = np.tril_indices(k)
    for bad in (1, 4):
        assert np.isnan(L[bad][lower]).all()


@pytest.mark.parametrize("k", [3, 64, 99, 128])
def test_tile_cholesky_skips_change_nothing(rng, k):
    """Entries above the diagonal of M (here NaN) never reach the factor,
    and leaving out the finished row quads changes no bit of it."""
    M = spd_batch(rng, 4, k)
    want = tile_cholesky(M)
    garbage = np.where(np.triu(np.ones((k, k), bool), 1), np.nan, M)
    np.testing.assert_array_equal(tile_cholesky(garbage), want)
    np.testing.assert_array_equal(tile_cholesky(M, skip_done_rows=True), want)


def test_em_step_at_k128_matches_jax(rng):
    """One masked EM step, the llks and the posteriors at k=128 (the tile's
    widest), port against the JAX package in float64."""
    N, D, k = 256, 160, 128
    C = rng.normal(size=(D, k)) / np.sqrt(k)
    mean = rng.normal(size=D)
    data = rng.normal(size=(N, k)) @ C.T + mean + 0.5 * rng.normal(size=(N, D))
    mask = rng.random((N, D)) > 0.5
    data = np.where(mask, data, 0.0)
    C0 = C + 0.1 * rng.normal(size=(D, k))
    tds = interop.dataset_from_arrays(data, mask)
    assert tds.pattern_info() is None
    jds = jp.Dataset.from_parts(jnp.asarray(data), jnp.asarray(mask))
    tm = interop.model_from_arrays(C0, mean, 0.8)
    jm = jp.PPCAModel(isotropic_noise=0.8, transform=C0, mean=mean)

    def close(got, want):
        got, want = np.asarray(got), np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * max(1.0, np.abs(want).max()))

    tn, jn = tm.iterate(tds), jm.iterate(jds)
    close(tn.transform.numpy(), jn.transform)
    close(tn.mean.numpy(), jn.mean)
    assert float(tn.isotropic_noise) == pytest.approx(float(jn.isotropic_noise), rel=1e-9)
    close(tm.llks(tds).numpy(), jm.llks(jds))
    ti, ji = tm.infer(tds), jm.infer(jds)
    close(ti.states().numpy(), ji.states())
    close(ti.covariances_array().numpy(), ji.covariances_array())
