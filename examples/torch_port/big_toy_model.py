"""Throughput workload on the PyTorch port: 100k samples x 200 dims, k=16,
24 EM iterations.  The port of ``examples/big_toy_model.py``, the shape of
the reference's de-facto perf workload (`ppca/src/lib.rs:65-99`), driven
through PPCATrainer with a timing callback.

    PYTHONPATH=. python examples/torch_port/big_toy_model.py [--device cuda|cpu]

``PPCA_EXAMPLE_SMOKE=1`` cuts it to 4,000 samples and 4 iterations.
"""

import argparse
import os
import time

import numpy as np
import torch

from ppca_rs_tpu_torch import PPCAModel, PPCATrainer, TrainMetrics

parser = argparse.ArgumentParser(description="Train a k=16 PPCA on 100k x 200 samples.")
parser.add_argument("--device", default="cuda", help="where the model and the data live")
device = torch.device(parser.parse_args().device)

D, K, N, ITERS = 200, 16, 100_000, 24
if os.environ.get("PPCA_EXAMPLE_SMOKE"):  # smoke run (tests/test_torch_examples.py)
    N, ITERS = 4_000, 4

rng = np.random.default_rng(42)
print(f"synthesizing a rank-{K} ground truth over {D} dims")
# Low-rank loading with decaying column scales, so the spectrum is
# interesting rather than flat.
scales = 3.0 * 0.8 ** np.arange(K)
truth = PPCAModel(
    transform=rng.normal(size=(D, K)) * scales,
    isotropic_noise=0.5,
    mean=rng.normal(size=D),
    device=device,
)

print(f"drawing {N:,} samples with 20% missing entries")
dataset = truth.sample(N, mask_prob=0.2, generator=torch.Generator(device).manual_seed(42))

llks: list[float] = []
times: list[float] = []


def record(iteration: int, metrics: TrainMetrics) -> None:
    llks.append(metrics.llk)
    times.append(time.perf_counter())


print(f"training for {ITERS} EM iterations")
t0 = time.perf_counter()
model = PPCATrainer(dataset).train(
    state_size=K, n_iters=ITERS, generator=torch.Generator(device).manual_seed(0),
    callback=record, quiet=True,
)
total = time.perf_counter() - t0

# The first iteration includes the kernels' first use; report the
# steady-state marginal too (the callback reads each llk, which waits for
# the device).
steady = (times[-1] - times[0]) / (len(times) - 1)
print(f"total wall time: {total:.2f}s ({steady * 1e3:.1f} ms/iter steady-state, "
      f"{N / steady / 1e6:.2f}M samples/s) on {device}")
print(f"llk/sample: first {llks[0]:.4f} -> last {llks[-1]:.4f}")

assert all(b >= a - 1e-3 for a, b in zip(llks, llks[1:])), "EM llk must not decrease"
assert bool(torch.isfinite(model.transform).all())
print("ok: scale workload converged with monotone llk")
