"""Mixture models on the PyTorch port: cluster while reducing dimension,
pick M by BIC.  The port of ``examples/ppca_mixture.py``: data come from
three well-separated low-rank clusters and BIC should prefer M=3.

    PYTHONPATH=. python examples/torch_port/ppca_mixture.py [--device cuda|cpu]
"""

import argparse

import numpy as np
import torch

from ppca_rs_tpu_torch import Dataset, PPCAMix, PPCAMixTrainer, PPCAModel

parser = argparse.ArgumentParser(description="Pick the number of mixture components by BIC.")
parser.add_argument("--device", default="cuda", help="where the models and the data live")
device = torch.device(parser.parse_args().device)

rng = np.random.default_rng(3)
D, K = 6, 2
centers = np.array(
    [
        [5.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [0.0, 0.0, 5.0, 0.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 0.0, 5.0, 0.0],
    ]
)

# 250 samples per cluster: enough that BIC's ln(N) penalty decisively
# rejects a spurious 4th component in float32 and float64 alike.
PER = 250
rows, labels = [], []
for c, center in enumerate(centers):
    loading = rng.normal(size=(D, K))
    z = rng.normal(size=(PER, K))
    rows.append(z @ loading.T + center + 0.3 * rng.normal(size=(PER, D)))
    labels.extend([c] * PER)
data = np.concatenate(rows)
labels = np.array(labels)

# Hide 15% of the entries; the mixture handles missing data natively.
data[rng.random(data.shape) < 0.15] = np.nan
dataset = Dataset(data, device=device)

# EM is a local optimizer, and the default init (every component mean at
# 0, reference parity with `mix.rs:76-83`) reliably traps mixtures whose
# clusters sit far from the origin.  Standard practice: seed component
# means from random data rows and take the best of a few restarts.
filled = np.where(np.isfinite(data), data, 0.0)


def seeded_start(m, seed):
    r = np.random.default_rng(seed)
    comps = [
        PPCAModel(
            isotropic_noise=1.0,
            transform=0.1 * r.normal(size=(D, K)),
            mean=filled[r.integers(0, len(filled))],
            device=device,
        )
        for _ in range(m)
    ]
    return PPCAMix(comps, np.zeros(m))


fits = {}
for m in (1, 2, 3, 4):
    print(f"--- fitting M={m} ---")
    best_fit, best_llk = None, -np.inf
    for restart in range(3):
        mix = PPCAMixTrainer(dataset).train(
            start=seeded_start(m, 1000 * m + restart),
            n_models=m, state_size=K, n_iters=40, metric="bic", quiet=True,
        )
        llk = mix.llk(dataset)
        if llk > best_llk:
            best_fit, best_llk = mix, llk
    bic = best_llk - best_fit.n_parameters * np.log(len(dataset))
    fits[m] = (best_fit, bic)
    print(f"M={m}: llk/sample={best_llk / len(dataset):.3f} "
          f"bic={bic / len(dataset):.3f}")

best_m = max(fits, key=lambda m: fits[m][1])
print(f"BIC selects M={best_m}")
assert best_m == 3, f"BIC should recover the 3 generating clusters, got {best_m}"

# The responsibilities should reproduce the generating partition almost
# perfectly (clusters are far apart).
best = fits[3][0]
hard = best.infer_cluster(dataset).argmax(1).cpu().numpy()
# map each predicted cluster to its majority true label
agree = 0
for c in range(3):
    if (hard == c).any():
        majority = np.bincount(labels[hard == c]).argmax()
        agree += int(((hard == c) & (labels == majority)).sum())
purity = agree / len(labels)
print(f"cluster purity: {purity:.3f}")
assert purity > 0.95

# The mixture verbs work batch-wide: denoise, fill the gaps, sample.
smoothed = best.smooth(dataset)
extrapolated = best.extrapolate(dataset)
assert np.isfinite(extrapolated.numpy()).all(), "extrapolate fills every NaN"
draw = best.infer(dataset).posterior_sampler().sample(
    generator=torch.Generator(device).manual_seed(0))
assert draw.numpy().shape == data.shape
print("ok: mixture clusters recovered and verbs ran end-to-end")
