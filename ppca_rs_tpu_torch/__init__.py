"""ppca_rs_tpu_torch — masked Probabilistic PCA and PPCA mixtures on PyTorch
and CUDA.

The PyTorch port of ``ppca_rs_tpu``: the same public API and array layouts,
on torch tensors.  The per-sample SPD factorization of the E-step, of the
pattern tables and of the M-step row solves (``csrc/spd_estep.cu``; a
mixture stacks its components on the batch axis) and the
posterior sampler's batched Cholesky factor (``csrc/spd_chol.cu``) are CUDA
kernels written for Hopper, built with ``nvcc`` at first use; on CPU tensors
their plain PyTorch versions run instead.  Datasets larger than the card
train out of core through the streaming trainers (``streaming.py``); long
DataFrames come in through the adapters (``adapters.py``); jobs of many
processes shard their data over a ``torch.distributed`` mesh
(``parallel/``).  This package imports neither JAX nor ``ppca_rs_tpu``.
"""

from .config import config
from .dataset import Dataset, DatasetChunks
from .prior import Prior
from .models.ppca import InferredMasked, PosteriorSampler, PPCAModel
from .models.mix import InferredMaskedMix, PosteriorSamplerMix, PPCAMix
from .trainer import PPCAMixTrainer, PPCATrainer, TrainMetrics
from .streaming import (StreamingPPCAMixTrainer, StreamingPPCATrainer,
                        iterate_mix_streamed, iterate_streamed)
from .adapters import DataFrameAdapter, DataFrameAdapterDescription
from .utils.rng import seed

__version__ = "0.1.0"

__all__ = [
    "Dataset",
    "DatasetChunks",
    "Prior",
    "PPCAModel",
    "InferredMasked",
    "PosteriorSampler",
    "PPCAMix",
    "InferredMaskedMix",
    "PosteriorSamplerMix",
    "PPCATrainer",
    "PPCAMixTrainer",
    "StreamingPPCAMixTrainer",
    "StreamingPPCATrainer",
    "iterate_mix_streamed",
    "iterate_streamed",
    "TrainMetrics",
    "DataFrameAdapter",
    "DataFrameAdapterDescription",
    "config",
    "seed",
    "__version__",
]
