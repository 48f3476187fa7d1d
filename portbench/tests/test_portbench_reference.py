"""The plain reference against closed forms on tiny data."""

import pytest
import torch

from portbench.reference import linalg
from portbench.reference import ppca as ref

F64 = linalg.F64


def _params(C, mean, sigma, log_weights=None):
    return {"Cs": C[None] if C.ndim == 2 else C, "means": mean[None] if mean.ndim == 1 else mean,
            "sigmas": torch.as_tensor(sigma, dtype=torch.float64).reshape(-1),
            "log_weights": log_weights}


def _data(n=40, D=6, k=2, seed=0, missing=0.3):
    g = torch.Generator().manual_seed(seed)
    C = torch.randn(D, k, generator=g, dtype=torch.float64)
    mean = torch.randn(D, generator=g, dtype=torch.float64)
    y = torch.randn(n, k, generator=g, dtype=torch.float64) @ C.T + mean + 0.4 * torch.randn(
        n, D, generator=g, dtype=torch.float64)
    m = torch.rand(n, D, generator=g) >= missing
    m[0] = True
    return C, mean, torch.where(m, y, 0.0), m


def test_llk_is_the_gaussian_density_of_the_observed_entries():
    C, mean, y, m = _data()
    sigma = 0.7
    got = ref.readout(F64, _params(C, mean, sigma), y, m)["score"]
    for n in range(y.shape[0]):
        o = m[n]
        cov = C[o] @ C[o].T + sigma ** 2 * torch.eye(int(o.sum()), dtype=torch.float64)
        want = torch.distributions.MultivariateNormal(mean[o], cov).log_prob(y[n, o])
        assert float(got[n]) == pytest.approx(float(want), rel=1e-12, abs=1e-12)


def test_imputation_is_the_conditional_mean():
    C, mean, y, m = _data()
    sigma = 0.7
    got = ref.readout(F64, _params(C, mean, sigma), y, m)["impute"]
    for n in range(5):
        o, u = m[n], ~m[n]
        cov = C @ C.T + sigma ** 2 * torch.eye(C.shape[0], dtype=torch.float64)
        # E[y_u | y_o] of the Gaussian, against C E[z | y_o] + mu
        want_u = mean[u] + C[u] @ C[o].T @ torch.linalg.solve(cov[o][:, o], y[n, o] - mean[o])
        assert torch.allclose(got[n, u], want_u, rtol=1e-10, atol=1e-10)
        assert torch.equal(got[n, o], y[n, o])


def test_em_step_fully_observed_matches_the_textbook_update():
    """With every entry seen, the step is PPCA's EM (Tipping and Bishop):
    C' = (sum r s^T)(sum s s^T + N Sigma)^{-1}, with r centred on the old
    mean, and the llk is that of the start."""
    C, mean, y, _ = _data(missing=0.0)
    m = torch.ones_like(y, dtype=torch.bool)
    sigma = 0.9
    new, llk = ref.em_step(F64, _params(C, mean, sigma), y, m)
    k = C.shape[1]
    Minv = torch.linalg.inv(C.T @ C + sigma ** 2 * torch.eye(k, dtype=torch.float64))
    r = y - mean
    s = r @ C @ Minv
    A = s.T @ s + y.shape[0] * sigma ** 2 * Minv
    assert torch.allclose(new["Cs"][0], (r.T @ s) @ torch.linalg.inv(A), rtol=1e-10)
    cov = C @ C.T + sigma ** 2 * torch.eye(C.shape[0], dtype=torch.float64)
    want = torch.distributions.MultivariateNormal(mean, cov).log_prob(y).sum()
    assert llk == pytest.approx(float(want), rel=1e-12)


def test_one_component_mixture_is_the_single_model():
    C, mean, y, m = _data()
    single, llk1 = ref.em_step(F64, _params(C, mean, 0.8), y, m)
    mix, llk2 = ref.em_step(F64, _params(C, mean, 0.8, torch.zeros(1, dtype=torch.float64)),
                            y, m)
    assert llk1 == pytest.approx(llk2, rel=1e-13)
    for key in ("Cs", "means", "sigmas"):
        assert torch.allclose(single[key], mix[key], rtol=1e-12)
    assert float(mix["log_weights"][0]) == pytest.approx(0.0, abs=1e-14)


def test_mixture_posteriors_and_step_weights():
    C, mean, y, m = _data()
    C2 = torch.stack([C, -0.5 * C])
    means = torch.stack([mean, mean + 3.0])
    lw = torch.log(torch.tensor([0.3, 0.7], dtype=torch.float64))
    params = _params(C2, means, torch.tensor([0.8, 1.1]), lw)
    post = ref.readout(F64, params, y, m)["score"]
    assert torch.allclose(post.exp().sum(-1), torch.ones(y.shape[0], dtype=torch.float64))
    new, _ = ref.em_step(F64, params, y, m)
    assert torch.allclose(new["log_weights"].exp(), post.exp().mean(0), rtol=1e-12)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -10, -3.0],
                     dtype=torch.float32)
    got = linalg.round_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2.0 ** -9, 1.0 + 2.0 ** -10, -3.0]
    a = torch.randn(64, 64)
    err = (linalg.TF32.mm(a, a) - (a.double() @ a.double())).abs().max()
    assert 1e-4 < float(err) / float((a.double() @ a.double()).abs().max()) < 1e-2


def test_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path

    for path in Path(ref.__file__).parent.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0
                     else [])
            for name in names:
                assert name.split(".")[0] not in ("ppca_rs_tpu_torch", "ppca_rs_tpu", "jax",
                                                  "jaxlib", "flax"), (path, name)
