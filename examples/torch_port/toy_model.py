"""Single-model walkthrough on the PyTorch port: fit a masked PPCA, then
quantify uncertainty.  The port of ``examples/toy_model.py`` (train ->
to_canonical -> singular values -> posterior CI readout).

    PYTHONPATH=. python examples/torch_port/toy_model.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from ppca_rs_tpu_torch import PPCAModel, PPCATrainer

parser = argparse.ArgumentParser(description="Fit a masked PPCA and read its uncertainty.")
parser.add_argument("--device", default="cuda", help="where the model and the data live")
device = torch.device(parser.parse_args().device)
rng = np.random.default_rng(7)

# Ground truth: 5 observed dimensions explained by a 2-dim latent factor.
D, K, N = 5, 2, 400
truth = PPCAModel(
    transform=rng.normal(size=(D, K)) * np.array([2.0, 0.5]),
    isotropic_noise=0.25,
    mean=np.linspace(-1.0, 1.0, D),
    device=device,
)

# Draw a synthetic dataset and knock out ~30% of the entries at random.
dataset = truth.sample(N, mask_prob=0.3, generator=torch.Generator(device).manual_seed(7))

# Train. The trainer logs llk/aic/bic each iteration and canonicalizes at
# the end (SVD-orthogonal columns, deterministic signs).
model = PPCATrainer(dataset).train(state_size=K, n_iters=60,
                                   generator=torch.Generator(device).manual_seed(11))

print(model)
print("spectral profile:", model.singular_values)

# EM must not decrease the llk; check the final fit is in the same league
# as the generating model.
final_llk = model.llk(dataset)
truth_llk = truth.llk(dataset)
print(f"fitted llk {final_llk:.2f} vs ground-truth llk {truth_llk:.2f}")
assert final_llk > truth_llk - 0.05 * abs(truth_llk), "fit should rival the truth"

# Uncertainty readout: posterior predictive standard deviations for the
# smoothed (denoised) reconstruction of every entry.
inferred = model.infer(dataset)
smoothed_sd = inferred.smoothed_covariances_diagonal(model).numpy() ** 0.5
print("smoothed posterior sd (first 3 rows):")
print(smoothed_sd[:3])
assert smoothed_sd.shape == (N, D)
assert (smoothed_sd > 0).all() and (smoothed_sd < 2.0).all()

# Missing entries carry more reconstruction uncertainty than observed ones.
extrap_sd = inferred.extrapolated_covariances_diagonal(model, dataset).numpy() ** 0.5
observed = np.isfinite(dataset.numpy())
assert np.allclose(extrap_sd[observed], 0.0), "observed entries are certain"
assert (extrap_sd[~observed] > 0).all(), "missing entries carry uncertainty"
print("ok: toy model trained, canonicalized, and uncertainty quantified")
