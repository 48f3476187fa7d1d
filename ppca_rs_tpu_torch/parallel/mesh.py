"""The device mesh, sharded datasets and collective pattern detection.

Port of ``ppca_rs_tpu/parallel/mesh.py`` (and of the multi-process
``Dataset.detect_patterns``, ``ppca_rs_tpu/dataset.py:395-444``) on
``torch.distributed``.  One process per card (a rank); the mesh is a
``DeviceMesh`` of dims ``("data", "model")`` over every rank of the job:

* ``data`` -- samples (N) are split over its ranks; EM statistics are summed
  over it with ``all_reduce``;
* ``model`` -- optionally, the output dimension D is split over its ranks
  (tensor parallel); parameters stay whole on every rank, each rank computes
  with its block of rows of C and the mean.

Unlike the JAX package, nothing is padded: a rank holds its own rows, and
ranks may hold different numbers of them, since each runs its own program.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import config
from ..dataset import Dataset, Shard, _pack_mask, _unpack_mask

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(data: Optional[int] = None, model: int = 1) -> DeviceMesh:
    """A ``(data, model)`` mesh over every rank of the initialized job
    (``distributed.initialize``).  By default all ranks go on the data
    axis; ``model=M`` carves out a tensor-parallel axis over D.  Every rank
    calls it (it creates the axes' process groups)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group: "
                           "call ppca_rs_tpu_torch.parallel.distributed.initialize() first")
    n = dist.get_world_size()
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    if data * model < n:
        raise ValueError(f"mesh {data}x{model} leaves {n - data * model} of the {n} ranks "
                         "off the mesh: every rank of the job must be on it")
    return init_device_mesh(config.device.type, (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on ``axis``; also its rank in the axis's group."""
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(axis)


def host_device(group) -> torch.device:
    """Where the small bookkeeping collectives of ``group`` run: the CPU
    (gloo, also in "cpu:gloo,cuda:nccl"), or the card for an NCCL-only
    group, which takes no CPU tensors."""
    return torch.device("cpu") if "gloo" in str(dist.get_backend(group)) else torch.device(
        "cuda", torch.cuda.current_device())


def sharded(mesh: DeviceMesh, data, mask, weights, n: int, d: int, all_observed: bool,
            empty) -> Dataset:
    """The sharded dataset of this rank's ``data``, ``mask`` and ``weights``
    (own memory), with the global decisions made for all ranks."""
    new = Dataset.from_parts(data, mask, weights)
    new._all_observed = bool(all_observed)
    new._shard = Shard(mesh, int(n), int(d), tuple(int(i) for i in empty))
    return new


def check_columns(d: int, mesh: DeviceMesh) -> int:
    """D_loc, the columns of one rank's block; D must divide by the model
    axis size."""
    n_model = axis_size(mesh, MODEL_AXIS)
    if d % n_model != 0:
        raise ValueError(f"output_size {d} must be divisible by the model axis size {n_model}")
    return d // n_model


def shard_dataset(dataset: Dataset, mesh: DeviceMesh) -> Dataset:
    """This rank's shard of ``dataset``, which every rank passes whole: the
    contiguous rows of its data-axis coordinate (``ceil(N / data)`` rows a
    rank, the JAX package's layout without its padding rows; the last
    ranks may hold fewer, or none) and, on the model axis, its block of
    columns (D must divide by the model axis size).  Needs no collective:
    every rank sees all rows, so the global decisions agree."""
    n, d = int(dataset.data.shape[0]), int(dataset.data.shape[1])
    d_loc = check_columns(d, mesh)
    per = -(-n // axis_size(mesh, DATA_AXIS))
    lo = min(axis_rank(mesh, DATA_AXIS) * per, n)
    rows = slice(lo, min(lo + per, n))
    c0 = axis_rank(mesh, MODEL_AXIS) * d_loc
    cols = slice(c0, c0 + d_loc)
    return sharded(mesh, dataset.data[rows, cols].clone(),
                   dataset.mask[rows, cols].clone(), dataset.weights_dev[rows].clone(),
                   n, d, dataset.all_observed(), dataset.empty_dimensions())


def dataset_mesh(dataset: Dataset) -> Optional[DeviceMesh]:
    """The mesh a dataset is sharded over, or None."""
    return None if dataset._shard is None else dataset._shard.mesh


def detect_patterns(dataset: Dataset, include_dense: bool):
    """The collective behind ``Dataset.detect_patterns`` on a sharded
    dataset; the rules of ``Dataset.pattern_info`` on the global rows.

    Each rank packs its rows' masks (``_pack_mask``), finds its distinct
    ones on its device, and the ranks of the data axis exchange them on
    CPU tensors: one all_reduce of the largest local count (more than the
    cap demotes every rank at once), one all_gather of the local tables
    padded to it.  Each rank builds the union with ``torch.unique`` (sorted,
    as the single-process detection sorts) and maps its rows to it."""
    if not config.use_pattern_dedup:
        return None
    if dataset._patterns is not None:
        return dataset._patterns or None
    shard = dataset._shard
    mesh = shard.mesh
    n = shard.n
    if axis_size(mesh, MODEL_AXIS) > 1 or n == 0 or n < 2 * config.pattern_min_ratio:
        # a column block's masks are no table of whole rows
        dataset._patterns = False
        return None
    device = dataset.device
    if dataset.all_observed():
        if not include_dense:
            return None
        dataset._patterns = (torch.zeros(dataset.data.shape[0], dtype=torch.int64, device=device),
                             torch.ones((1, shard.d), dtype=torch.bool, device=device))
        return dataset._patterns
    group = axis_group(mesh, DATA_AXIS)
    host = host_device(group)
    p_cap = min(config.pattern_max, n // config.pattern_min_ratio)
    local, inverse = torch.unique(_pack_mask(dataset.mask), dim=0, return_inverse=True)
    local = local.to(host)
    count = torch.tensor([local.shape[0]], dtype=torch.int64, device=host)
    dist.all_reduce(count, op=dist.ReduceOp.MAX, group=group)
    p_max = int(count[0])
    if p_max > p_cap:
        dataset._patterns = False
        return None
    words = local.shape[1]
    table = torch.zeros((p_max, words + 1), dtype=torch.int64, device=host)
    table[:local.shape[0], :words] = local
    table[:local.shape[0], words] = 1       # a valid row
    tables = [torch.empty_like(table) for _ in range(dist.get_world_size(group))]
    dist.all_gather(tables, table, group=group)
    rows = torch.cat(tables)
    union = torch.unique(rows[rows[:, words] == 1, :words], dim=0)
    if union.shape[0] > p_cap:
        dataset._patterns = False
        return None
    # every local pattern is in the union, so uniquing both together keeps
    # the union's sorted order, and the local rows' inverse is their index
    _, where = torch.unique(torch.cat([union, local]), dim=0, return_inverse=True)
    pidx = where[union.shape[0]:].to(device)[inverse]
    dataset._patterns = (pidx, _unpack_mask(union, shard.d).to(device))
    return dataset._patterns
