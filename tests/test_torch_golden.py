"""Golden-value anchors of tests/test_golden.py through the port, in float64
on the CPU.

The reference's two numeric anchors (`ppca/src/ppca_model.rs:628-681`), on
the toy output covariance with C = [[1,1,0],[1,0,1]]^T and sigma = 0.1:

    quadratic_form([1,1,1]) ~= 34.219288   (rtol 1e-6)
    covariance_log_det      ~= -3.49328    (rtol 1e-5)

through the port's ``masked_linalg.block_posterior`` (the ``infer``
variant of the E-step), the log determinant both from the posterior
covariance Sigma = sigma^2 M^-1 and from the Cholesky factor of M; and the
toy model's llk against ``reference_impl.llk_one`` (rtol 1e-10).
chip_smoke.py phase 14 holds the same anchors through the kernels.
"""

import numpy as np
import torch

import ppca_rs_tpu_torch as tp
from ppca_rs_tpu_torch.ops import kernels as tk
from ppca_rs_tpu_torch.ops import masked_linalg as ml

from reference_impl import llk_one

C = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])  # (D=3, k=2)
SIGMA = 0.1
MEAN = np.array([0.0, 1.0, 0.0])
F64 = torch.float64


def block_post(x):
    Ct = torch.as_tensor(C, dtype=F64)
    data = torch.as_tensor(x, dtype=F64)[None, :]
    return ml.block_posterior(Ct, ml.gram_operand(Ct, F64), torch.zeros(3, dtype=F64), SIGMA,
                              data, torch.ones_like(data, dtype=torch.bool), "infer")


def test_quadratic_form_golden():
    post = block_post([1.0, 1.0, 1.0])
    s = post.out[0]
    quad = float((post.rnorm - (post.b * s).sum(-1))[0]) / SIGMA**2
    assert np.isclose(quad, 34.219288, rtol=1e-6)


def test_covariance_log_det_golden():
    post = block_post([1.0, 1.0, 1.0])
    k, D = C.shape[1], C.shape[0]
    noise = 2.0 * np.log(SIGMA) * (D - k)
    # From the infer output: log det M = k log sigma^2 - log det Sigma.
    Sigma = post.out[1][0]
    logdet_m = k * 2.0 * np.log(SIGMA) - float(torch.logdet(Sigma))
    assert np.isclose(logdet_m + noise, -3.49328, rtol=1e-5)
    # From the Cholesky factor of M = sigma^2 I + C^T C.
    M = torch.as_tensor(SIGMA**2 * np.eye(k) + C.T @ C)[None]
    L = tk.spd_chol(M)[0]
    logdet_m = 2.0 * float(torch.log(torch.diagonal(L)).sum())
    assert np.isclose(logdet_m + noise, -3.49328, rtol=1e-5)


def test_llk_toy_model():
    """llk smoke value (`ppca_model.rs:673-680`) against the naive dense
    density."""
    model = tp.PPCAModel(isotropic_noise=SIGMA, transform=C, mean=MEAN, device="cpu", dtype=F64)
    ds = tp.Dataset(np.array([[1.0, 2.0, 3.0]]), device="cpu", dtype=F64)
    expected = llk_one(C, MEAN, SIGMA, np.array([1.0, 2.0, 3.0]), np.ones(3, dtype=bool))
    assert np.isclose(model.llk(ds), expected, rtol=1e-10)
