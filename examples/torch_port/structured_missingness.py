"""Structured missingness on the PyTorch port: mask-pattern deduplication in
action.  The port of ``examples/structured_missingness.py``.

Real-world missing data is rarely random -- a handful of instrument
configurations, survey versions or join shapes produce P distinct mask
patterns with P << N.  The port detects this at first use
(``Dataset.pattern_info``) and switches every verb to a pattern-table
path: factorizations collapse from N per EM pass to P.  Mixtures use M x P
tables the same way, and their EM runs per pattern segment once the
segments are long enough (``Dataset.pattern_order``).

    PYTHONPATH=. python examples/torch_port/structured_missingness.py [--device cuda|cpu]

``PPCA_EXAMPLE_SMOKE=1`` cuts it to 6,000 rows of 64 channels.
"""

import argparse
import os
import time

import numpy as np
import torch

from ppca_rs_tpu_torch import Dataset, PPCAMixTrainer, PPCAModel, PPCATrainer, config

parser = argparse.ArgumentParser(description="Train on data with three mask patterns.")
parser.add_argument("--device", default="cuda", help="where the models and the data live")
device = torch.device(parser.parse_args().device)

rng = np.random.default_rng(99)
N, D, K = 100_000, 256, 16
if os.environ.get("PPCA_EXAMPLE_SMOKE"):  # smoke run (tests/test_torch_examples.py)
    N, D = 6_000, 64

# Three "instrument versions", each observing a different fixed subset of
# the D channels.
versions = np.ones((3, D), dtype=bool)
versions[0, 160:] = False         # v0 misses the channels from 160 on
versions[1, ::3] = False          # v1 misses every third channel
versions[2, :40] = False          # v2 misses the first 40

truth = PPCAModel(
    transform=rng.normal(size=(D, K)),
    isotropic_noise=0.3,
    mean=rng.normal(size=D),
    device=device,
)
full = truth.sample(N, mask_prob=0.0, generator=torch.Generator(device).manual_seed(99)).numpy()
version_of_row = rng.integers(0, 3, size=N)
values = np.where(versions[version_of_row], full, np.nan)
dataset = Dataset(values, device=device)

info = dataset.pattern_info()
assert info is not None, "three fixed masks => detection must trigger"
print(f"detected {info[1].shape[0]} distinct mask patterns across {N:,} rows")
assert info[1].shape[0] == 3


def timed_train(ds, label):
    # a first call so the timing leaves out the kernels' first use
    PPCATrainer(ds).train(state_size=K, n_iters=1, quiet=True,
                          generator=torch.Generator(device).manual_seed(1))
    t0 = time.perf_counter()
    model = PPCATrainer(ds).train(state_size=K, n_iters=15, quiet=True,
                                  generator=torch.Generator(device).manual_seed(1))
    print(f"{label}: {time.perf_counter() - t0:.2f}s "
          f"(llk/sample {model.llk(ds) / N:.3f})")
    return model


model = timed_train(dataset, "pattern-path training (15 iters)")

# The fast path must agree with the general path to float32 tolerance:
# retrain with dedup disabled and compare.
config.use_pattern_dedup = False
try:
    dataset_slow = Dataset(values, device=device)
    assert dataset_slow.pattern_info() is None
    model_slow = timed_train(dataset_slow, "general-path training (15 iters)")
finally:
    config.use_pattern_dedup = True

rel = abs(model.llk(dataset) - model_slow.llk(dataset)) / abs(model_slow.llk(dataset))
print(f"final llk relative difference: {rel:.2e}")
assert rel < 1e-4

# Mixtures share the machinery (M x P tables; dense data is the P=1 case).
mix = PPCAMixTrainer(dataset).train(
    n_models=2, state_size=K, n_iters=8, quiet=True,
    generator=torch.Generator(device).manual_seed(2),
)
assert np.isfinite(mix.llk(dataset))
filled = mix.extrapolate(dataset).numpy()
assert np.isfinite(filled).all(), "every missing channel is imputed"
print("ok: structured-missingness fast path verified end to end")
