"""Bayesian MAP training on the PyTorch port: priors regularize what the
data can't pin down.  The port of ``examples/priors.py``
(``iterate_with_prior`` with an inverse-gamma noise prior and a normal mean
prior), as a contrast experiment: with only 25 heavily-masked samples,
maximum likelihood overfits the noise floor, while a MAP fit with a strong
inverse-gamma prior keeps sigma near its prior mode.

    PYTHONPATH=. python examples/torch_port/priors.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from ppca_rs_tpu_torch import PPCAModel, PPCATrainer, Prior

parser = argparse.ArgumentParser(description="Contrast maximum likelihood with a MAP fit.")
parser.add_argument("--device", default="cuda", help="where the models and the data live")
device = torch.device(parser.parse_args().device)

rng = np.random.default_rng(21)
D, K, N = 8, 3, 25
TRUE_SIGMA = 0.6

truth = PPCAModel(
    transform=rng.normal(size=(D, K)),
    isotropic_noise=TRUE_SIGMA,
    mean=np.zeros(D),
    device=device,
)
# tiny and 40% missing: deliberately under-determined
dataset = truth.sample(N, mask_prob=0.4, generator=torch.Generator(device).manual_seed(21))

ml_fit = PPCATrainer(dataset).train(
    state_size=K, n_iters=80, generator=torch.Generator(device).manual_seed(1), quiet=True
)

# Inverse-gamma(alpha, beta) over sigma^2 with mode beta/(alpha+1) at the true
# noise level, plus a normal prior anchoring the mean at zero and a ridge on
# the transform entries.
alpha = 50.0
beta = TRUE_SIGMA**2 * (alpha + 1.0)
prior = (
    Prior()
    .with_isotropic_noise_prior(alpha, beta)
    .with_mean_prior(np.zeros(D), 10.0 * np.eye(D))
    .with_transformation_precision(0.05)
)
map_fit = PPCATrainer(dataset).train(
    state_size=K, n_iters=80, prior=prior, generator=torch.Generator(device).manual_seed(1),
    quiet=True,
)

ml_mean_norm = float(torch.linalg.norm(ml_fit.mean))
map_mean_norm = float(torch.linalg.norm(map_fit.mean))
print(f"true sigma          : {TRUE_SIGMA:.3f}")
print(f"ML  fitted sigma    : {float(ml_fit.isotropic_noise):.3f}")
print(f"MAP fitted sigma    : {float(map_fit.isotropic_noise):.3f}")
print(f"ML  mean norm       : {ml_mean_norm:.3f}")
print(f"MAP mean norm       : {map_mean_norm:.3f}")

# The prior should pull sigma toward its mode and shrink the mean.
map_err = abs(float(map_fit.isotropic_noise) - TRUE_SIGMA)
ml_err = abs(float(ml_fit.isotropic_noise) - TRUE_SIGMA)
assert map_err <= ml_err + 1e-6, (map_err, ml_err)
assert map_mean_norm < ml_mean_norm + 1e-6
assert bool(torch.isfinite(map_fit.transform).all())
print("ok: MAP estimate is regularized toward the prior")
