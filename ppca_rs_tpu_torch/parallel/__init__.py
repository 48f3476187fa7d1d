"""Sharded training and readout on ``torch.distributed`` (see ``placement.py``)."""

from .mesh import DATA_AXIS, MODEL_AXIS, dataset_mesh, make_mesh, shard_dataset
from . import distributed, placement

__all__ = ["DATA_AXIS", "MODEL_AXIS", "dataset_mesh", "make_mesh", "shard_dataset",
           "distributed", "placement"]
