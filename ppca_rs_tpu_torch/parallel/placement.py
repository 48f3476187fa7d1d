"""Where a dataset lives: one process, or a shard of a mesh.

Port of the collectives of ``ppca_rs_tpu/parallel/api.py`` on
``torch.distributed``.  The JAX package runs each verb as one SPMD program
(``shard_map``) over the mesh; here every verb of the models has one body
for a sharded and a local dataset, which asks :func:`place` where the
dataset lives and lets the :class:`Placement` do what the mesh needs:

* data axis -- readouts are rank-local: a rank gets its own rows.  The
  llk is a local weighted sum and one all_reduce (:meth:`Placement.row_sum`).
  An EM step computes the rank's statistics, sums them over the data axis in
  ONE all_reduce of one flat buffer (:meth:`Placement.reduce`; a mixture's
  ``resp_max`` by a second one taking the maximum), and runs the M-step on
  every rank: the same inputs give the same bits, so the parameters stay
  replicated.
* model axis -- parameters stay whole on every rank (a JAX model's
  ``transform`` is one global array too); a rank computes with its D_loc
  rows of C and the mean (:meth:`Placement.columns`), the ops sum each
  block's E-step inputs over the model group (``group=``), D-indexed
  statistics stay local, and after the M-step's row solve the new rows and
  mean are gathered over the model group (:meth:`Placement.gather`).

On one process every step is the identity and ``group`` is None.  Pattern
tables (``Dataset.detect_patterns``) serve the data axis only.

Not carried over: the JAX package pads the rows to equal shards, since one
SPMD program needs equal shapes on every device; torch ranks run their own
programs, so each holds its own rows and nothing is padded.  For the same
reason ``Dataset.pattern_order_sharded`` (a layout with equal per-pattern
counts on every shard) is not ported: each rank sorts its own rows
(``Dataset.pattern_order``) against the global table.  ``em_n`` is
``PPCAModel.iterate_n``'s loop of steps, not a scan.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

from ..dataset import Dataset
from ..ops import masked_linalg as ml
from .mesh import (DATA_AXIS, MODEL_AXIS, DeviceMesh, axis_group, axis_rank, axis_size,
                   dataset_mesh, host_device)

#: All_reduces of EM statistics over the data axis, and their bytes,
#: counted where they are issued (the statistics of an EM step or of a
#: streamed pass: one for a single model, two for a mixture).
STATS_REDUCES: Dict[str, int] = {"calls": 0, "bytes": 0}


def reset_counts() -> None:
    STATS_REDUCES.update(calls=0, bytes=0)


def _count(tensors) -> None:
    STATS_REDUCES["calls"] += 1
    STATS_REDUCES["bytes"] += sum(t.numel() * t.element_size() for t in tensors)


class Placement(NamedTuple):
    """A dataset's mesh (None: one process), the model axis's process group
    (None without a model axis) and this rank's block of columns on it."""

    mesh: Optional[DeviceMesh] = None
    group: object = None
    first: int = 0
    width: int = 0

    def columns(self, C, mean):
        """This rank's rows of the transform(s) ``C`` (..., D, k) and
        mean(s) (..., D) for its block of columns: the whole parameters
        without a model group."""
        if self.group is None:
            return C, mean
        return C.narrow(-2, self.first, self.width), mean.narrow(-1, self.first, self.width)

    def reduce(self, stats):
        """EM statistics (a NamedTuple of tensors of one dtype) of all
        ranks' rows: every field summed over the data axis in one
        all_reduce of one flat buffer, but a mixture's ``resp_max``, whose
        maximum a second all_reduce takes."""
        if self.mesh is None:
            return stats
        group = axis_group(self.mesh, DATA_AXIS)
        names = [n for n in stats._fields if n != "resp_max"]
        summed = [getattr(stats, n) for n in names]
        _count(summed)
        out = dict(zip(names, ml.all_reduce_sum(summed, group)))
        if "resp_max" in stats._fields:
            out["resp_max"] = stats.resp_max.clone()
            _count([out["resp_max"]])
            dist.all_reduce(out["resp_max"], op=dist.ReduceOp.MAX, group=group)
        return type(stats)(**out)

    def row_sum(self, per_row: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """The weighted sum of a per-row quantity over all ranks' rows: a
        local sum, and one all_reduce over the data axis."""
        total = (per_row * weights).sum()
        if self.mesh is not None:
            dist.all_reduce(total, group=axis_group(self.mesh, DATA_AXIS))
        return total

    def gather(self, C, mean):
        """The whole transform(s) and mean(s) from every rank's rows (one
        all_reduce); unchanged without a model group."""
        if self.group is None:
            return C, mean
        return tuple(ml.gather_blocks([(C, -2), (mean, -1)], self.group))

    def replicate(self, tensors) -> None:
        """Rank 0's ``tensors`` on every rank (:func:`replicate`), as a model
        initialized on each rank must start equal; nothing on one process."""
        if self.mesh is not None:
            replicate(tensors)


LOCAL = Placement()


def place(dataset: Dataset) -> Placement:
    """Where ``dataset`` lives: :data:`LOCAL` unless it is sharded."""
    mesh = dataset_mesh(dataset)
    if mesh is None:
        return LOCAL
    if axis_size(mesh, MODEL_AXIS) == 1:
        return Placement(mesh)
    width = int(dataset.data.shape[1])
    return Placement(mesh, axis_group(mesh, MODEL_AXIS), axis_rank(mesh, MODEL_AXIS) * width,
                     width)


def count_rows(n: int, mesh) -> int:
    """Rows over the data axis from this rank's ``n`` (one all_reduce)."""
    group = axis_group(mesh, DATA_AXIS)
    t = torch.tensor([n], dtype=torch.int64, device=host_device(group))
    dist.all_reduce(t, group=group)
    return int(t[0])


def replicate(tensors) -> None:
    """Overwrite ``tensors`` on every rank of the job with rank 0's (one
    broadcast)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.broadcast(flat, src=0)
    for t, part in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
        t.copy_(part.view(t.shape))
