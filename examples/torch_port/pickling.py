"""Serialization on the PyTorch port: pickle, stable bytes (dump/load), and
llk preservation.  The port of ``examples/pickling.py``: a round trip
through pickle or through the versioned byte format (which the JAX package
reads too) reproduces the model exactly.

    PYTHONPATH=. python examples/torch_port/pickling.py [--device cuda|cpu]
"""

import argparse
import pickle

import numpy as np
import torch

import ppca_rs_tpu_torch
from ppca_rs_tpu_torch import PPCAMix, PPCAModel

parser = argparse.ArgumentParser(description="Round-trip models through pickle and bytes.")
parser.add_argument("--device", default="cuda", help="where the models and the data live")
device = torch.device(parser.parse_args().device)
# unpickled models land on config.device
ppca_rs_tpu_torch.config.device = device

rng = np.random.default_rng(5)
model = PPCAModel(
    transform=rng.normal(size=(6, 2)),
    isotropic_noise=0.35,
    mean=rng.normal(size=6),
    device=device,
)
dataset = model.sample(64, mask_prob=0.25, generator=torch.Generator(device).manual_seed(5))

# --- pickle round trip
clone = pickle.loads(pickle.dumps(model))
assert torch.equal(clone.transform, model.transform)
assert torch.equal(clone.mean, model.mean)
assert clone.llk(dataset) == model.llk(dataset)
print("pickle round trip: exact")

# --- stable-bytes round trip (the dump()/load() persistence verbs)
blob = model.dump()
restored = PPCAModel.load(blob, device=device)
assert restored.llk(dataset) == model.llk(dataset)
print(f"dump/load round trip: exact ({len(blob)} bytes)")

# --- mixtures serialize the same way
mix = PPCAMix([model, clone], log_weights=np.log([0.25, 0.75]))
mix_clone = pickle.loads(pickle.dumps(mix))
assert mix_clone.llk(dataset) == mix.llk(dataset)
assert torch.equal(mix_clone.log_weights, mix.log_weights)
print("mixture pickle round trip: exact")
print("ok: serialization preserves models bit-for-bit")
