"""ppca_rs_tpu_torch — masked Probabilistic PCA on PyTorch and CUDA.

The PyTorch port of ``ppca_rs_tpu``: the same public API and array layouts,
on torch tensors.  The per-sample SPD factorization of the E-step and of the
M-step row solves is a CUDA kernel written for Hopper
(``csrc/spd_estep.cu``), built with ``nvcc`` at first use; on CPU tensors
its plain PyTorch version runs instead.  This package imports neither JAX
nor ``ppca_rs_tpu``.
"""

from .config import config
from .dataset import Dataset
from .models.ppca import InferredMasked, PPCAModel
from .prior import Prior
from .trainer import PPCATrainer, TrainMetrics
from .utils.rng import seed

__version__ = "0.1.0"

__all__ = [
    "Dataset",
    "Prior",
    "PPCAModel",
    "InferredMasked",
    "PPCATrainer",
    "TrainMetrics",
    "config",
    "seed",
    "__version__",
]
