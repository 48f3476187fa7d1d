"""Global defaults for ppca_rs_tpu_torch.

Only three things are configured: the device and dtype that constructors
use when they are handed host arrays, and the number of samples processed
per block by the blocked E-step loops.  Tensors handed in keep their own
device; every computation runs where its dataset lives.

Float32 matrix products run in full float32: TF32 keeps about three decimal
digits, and the log-likelihood's quadratic form cancels near convergence.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Config:
    #: Device for datasets and models built from host arrays.
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cpu"))

    #: Floating dtype for datasets and models built from host arrays.
    dtype: torch.dtype = torch.float32

    #: Samples per block in the blocked E-step loops.  Bounds the (block, D)
    #: and (block, k, k) temporaries: at D=1024, k=64 in float32 the Gram and
    #: second-moment blocks are 128 MiB each.
    block_size: int = 8192


config = Config()

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
