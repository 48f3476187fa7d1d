"""Multi-process jobs: one process per card, on ``torch.distributed``.

Port of ``ppca_rs_tpu/parallel/distributed.py``.  A job starts one process
per card (``torchrun --nproc-per-node=N script.py``, or any launcher that
sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``); each process then runs::

    from ppca_rs_tpu_torch.parallel import distributed, make_mesh

    distributed.initialize()                      # this rank, on cuda:LOCAL_RANK
    mesh = make_mesh()                            # every rank on the data axis
    dataset = distributed.shard_dataset_local(my_rows, mesh)
    model = PPCATrainer(dataset).train(state_size=..., n_iters=...)

Every rank ends with the same parameters.  Readouts (``llks``, ``infer``,
``smooth``, ...) on a sharded dataset give each rank its own rows.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..config import config
from ..dataset import Dataset
from .mesh import (DATA_AXIS, MODEL_AXIS, axis_group, axis_rank, check_columns, host_device,
                   sharded)


def initialize(backend: Optional[str] = None, *, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               local_rank: Optional[int] = None,
               timeout: Optional[datetime.timedelta] = None) -> None:
    """Start this process's rank of the job.

    Arguments not given come from the environment (``init_method`` "env://"
    reads ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``;
    ``local_rank`` reads ``LOCAL_RANK``, default 0).  ``backend`` defaults to
    "cpu:gloo,cuda:nccl" when ``config.device`` is the card, and to "gloo"
    on the CPU.  On the card, the rank's current device becomes
    ``cuda:local_rank``, so ``config.device`` ("cuda") means it from here on;
    without a card this raises (nothing falls back to the CPU)."""
    device = config.device
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"config.device is {device} but no CUDA device is available")
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local_rank)
    options = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank, **options)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def shard_dataset_local(dataset: Dataset, mesh) -> Dataset:
    """A sharded dataset from THIS rank's rows: the multi-process twin of
    :func:`parallel.shard_dataset`, where each rank loads only its own rows.

    ``dataset`` holds the rank's rows with all D columns; ranks of one model
    group (the same data-axis coordinate) pass the same rows, and each keeps
    its block of columns.  Ranks may pass different numbers of rows; nothing
    is padded.  A collective: one all_reduce over the data axis of the row
    counts, the incomplete-row counts and the per-column observed counts
    gives the global row count, ``all_observed()`` and
    ``empty_dimensions()`` for every rank at once."""
    n_local, d = int(dataset.data.shape[0]), int(dataset.data.shape[1])
    d_loc = check_columns(d, mesh)
    group = axis_group(mesh, DATA_AXIS)
    mask = dataset.mask
    counts = torch.cat([torch.tensor([n_local], device=mask.device),
                        (~mask.all(dim=1)).sum().reshape(1), mask.sum(dim=0)])
    counts = counts.to(device=host_device(group), dtype=torch.int64)
    dist.all_reduce(counts, group=group)
    n, incomplete, observed = int(counts[0]), int(counts[1]), counts[2:]
    c0 = axis_rank(mesh, MODEL_AXIS) * d_loc
    cols = slice(c0, c0 + d_loc)
    empty = torch.nonzero(observed == 0).flatten().tolist() if n else []
    return sharded(mesh, dataset.data[:, cols].clone(), mask[:, cols].clone(),
                   dataset.weights_dev.clone(), n, d, incomplete == 0, empty)
