"""Out-of-core training on the PyTorch port: the dataset never sits on the
device at once.  The port of ``examples/streaming_out_of_core.py``: EM
sufficient statistics are additive, so host chunks stream through the
device one at a time (pinned chunks on a copy stream).

    PYTHONPATH=. python examples/torch_port/streaming_out_of_core.py [--device cuda|cpu]

``PPCA_EXAMPLE_SMOKE=1`` cuts it to three chunks of 2,000 rows.
"""

import argparse
import os

import numpy as np
import torch

import ppca_rs_tpu_torch
from ppca_rs_tpu_torch import Dataset, StreamingPPCATrainer

parser = argparse.ArgumentParser(description="Train on chunks loaded one at a time.")
parser.add_argument("--device", default="cuda", help="where the model lives")
device = torch.device(parser.parse_args().device)
# the streaming trainer builds its model on config.device
ppca_rs_tpu_torch.config.device = device

CHUNK, N_CHUNKS = 20_000, 5
if os.environ.get("PPCA_EXAMPLE_SMOKE"):  # smoke run (tests/test_torch_examples.py)
    CHUNK, N_CHUNKS = 2_000, 3

rng = np.random.default_rng(0)
C_true = rng.normal(size=(64, 4))


def make_chunk(seed):
    def load():
        r = np.random.default_rng(seed)
        z = r.normal(size=(CHUNK, 4))
        data = z @ C_true.T + 0.3 * r.normal(size=(CHUNK, 64))
        data[r.random(data.shape) < 0.2] = np.nan
        return Dataset(data, device="cpu")       # a host chunk

    return load


chunks = [make_chunk(s) for s in range(N_CHUNKS)]  # loaded lazily
model = StreamingPPCATrainer(chunks).train(state_size=4, n_iters=10)
print(model)
print("singular values:", model.singular_values)
assert model.transform.device.type == device.type
assert bool(torch.isfinite(model.transform).all())
