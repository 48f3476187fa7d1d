"""Sharded training and readout on ``torch.distributed`` (see ``api.py``)."""

from .mesh import DATA_AXIS, MODEL_AXIS, dataset_mesh, make_mesh, shard_dataset
from . import api, distributed

__all__ = ["DATA_AXIS", "MODEL_AXIS", "dataset_mesh", "make_mesh", "shard_dataset", "api",
           "distributed"]
