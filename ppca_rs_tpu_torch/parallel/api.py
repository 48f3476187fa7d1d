"""The verbs on a sharded dataset: each rank computes on its own rows, and
``all_reduce`` joins what the EM needs.

Port of ``ppca_rs_tpu/parallel/api.py`` on ``torch.distributed``.  The JAX
package runs each verb as one SPMD program (``shard_map``) over the mesh;
here every rank runs the single-device code of the dataset's route
(``models/routes.py``) on its own rows, with the collectives between:

* data axis -- the readouts (:func:`readout`: ``llks``, ``infer``,
  ``states``; :func:`smooth`) are rank-local: a rank gets its own rows.  ``llk`` is a local weighted sum
  and one all_reduce.  An EM step computes the rank's statistics, sums them
  over the data axis in ONE all_reduce of one flat buffer
  (:func:`reduce_stats`), and runs the M-step on every rank: the same
  inputs give the same bits, so the parameters stay replicated.
* model axis -- parameters stay whole on every rank (a JAX model's
  ``transform`` is one global array too); a rank computes with its D_loc
  rows of C and the mean (:func:`local_params`), the ops sum each block's
  E-step inputs over the model group (``group=``), D-indexed statistics
  stay local, and after the M-step's row solve the new rows and mean are
  gathered over the model group (:func:`gather_params`).

Mixtures combine their statistics by a sum, and ``resp_max`` by a maximum
(:func:`combine_mix_stats`).  Pattern tables (``Dataset.detect_patterns``)
serve the data axis only.

Not carried over: the JAX package pads the rows to equal shards, since one
SPMD program needs equal shapes on every device; torch ranks run their own
programs, so each holds its own rows and nothing is padded.  For the same
reason ``Dataset.pattern_order_sharded`` (a layout with equal per-pattern
counts on every shard) is not ported: each rank sorts its own rows
(``Dataset.pattern_order``) against the global table.  ``em_n`` is
``PPCAModel.iterate_n``'s loop of sharded steps, not a scan.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from ..dataset import Dataset
from ..models import routes
from ..ops import masked_linalg as ml
from ..ops import mix_fused as mf
from .mesh import (DATA_AXIS, MODEL_AXIS, axis_group, axis_rank, axis_size, dataset_mesh,
                   host_device)

#: All_reduces of EM statistics over the data axis, and their bytes,
#: counted where they are issued (the statistics of an EM step or of a
#: streamed pass: one for a single model, two for a mixture).
STATS_REDUCES: Dict[str, int] = {"calls": 0, "bytes": 0}


def reset_counts() -> None:
    STATS_REDUCES.update(calls=0, bytes=0)


def local_params(C, mean, dataset: Dataset):
    """``(C, mean, group)``: this rank's rows of the transform(s) ``C``
    (..., D, k) and mean(s) (..., D) for its block of columns, and the model
    axis's process group (the whole parameters and None on a mesh without
    a model axis)."""
    mesh = dataset_mesh(dataset)
    if axis_size(mesh, MODEL_AXIS) == 1:
        return C, mean, None
    d_loc = int(dataset.data.shape[1])
    first = axis_rank(mesh, MODEL_AXIS) * d_loc
    return (C.narrow(-2, first, d_loc), mean.narrow(-1, first, d_loc),
            axis_group(mesh, MODEL_AXIS))


def gather_params(C, mean, group):
    """The whole transform(s) and mean(s) from every rank's rows (one
    all_reduce); unchanged without a model group."""
    if group is None:
        return C, mean
    return tuple(ml.gather_blocks([(C, -2), (mean, -1)], group))


def _count(tensors) -> None:
    STATS_REDUCES["calls"] += 1
    STATS_REDUCES["bytes"] += sum(t.numel() * t.element_size() for t in tensors)


def reduce_stats(stats, mesh):
    """EM statistics (a NamedTuple of tensors of one dtype) summed over the
    data axis: one all_reduce of one flat buffer."""
    _count(stats)
    return type(stats)(*ml.all_reduce_sum(list(stats), axis_group(mesh, DATA_AXIS)))


def combine_mix_stats(stats: mf.MixEMStats, mesh) -> mf.MixEMStats:
    """Mixture statistics over the data axis: one all_reduce summing every
    field but ``resp_max``, one taking the maximum of ``resp_max``."""
    group = axis_group(mesh, DATA_AXIS)
    names = [n for n in stats._fields if n != "resp_max"]
    summed = [getattr(stats, n) for n in names]
    _count(summed)
    resp_max = stats.resp_max.clone()
    _count([resp_max])
    out = dict(zip(names, ml.all_reduce_sum(summed, group)))
    dist.all_reduce(resp_max, op=dist.ReduceOp.MAX, group=group)
    return mf.MixEMStats(**out, resp_max=resp_max)


def count_rows(n: int, mesh) -> int:
    """Rows over the data axis from this rank's ``n`` (one all_reduce)."""
    group = axis_group(mesh, DATA_AXIS)
    t = torch.tensor([n], dtype=torch.int64, device=host_device(group))
    dist.all_reduce(t, group=group)
    return int(t[0])


def replicate(tensors) -> None:
    """Overwrite ``tensors`` on every rank of the job with rank 0's (one
    broadcast), as a model initialized on each rank must start equal."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.broadcast(flat, src=0)
    for t, part in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
        t.copy_(part.view(t.shape))


# --------------------------------------------------------------------- #
# single model


def readout(verb: str, C, mean, sigma, dataset: Dataset, *, block_size: int):
    """``verb`` ("llks", "states" or "infer") of this rank's rows."""
    C, mean, group = local_params(C, mean, dataset)
    return routes.readout(verb, routes.route(dataset), C, mean, sigma, dataset, block_size, group)


def llks(C, mean, sigma, dataset: Dataset, *, block_size: int) -> torch.Tensor:
    return readout("llks", C, mean, sigma, dataset, block_size=block_size)


def smooth(C, mean, sigma, dataset: Dataset, *, block_size: int,
           extrapolate: bool = False) -> torch.Tensor:
    """This rank's rows (and columns) smoothed, or with ``extrapolate``
    their missing entries filled."""
    states = readout("states", C, mean, sigma, dataset, block_size=block_size)
    C, mean, _ = local_params(C, mean, dataset)
    smoothed = states @ C.T + mean
    return torch.where(dataset.mask, dataset.data, smoothed) if extrapolate else smoothed


def row_sum(per_row: torch.Tensor, dataset: Dataset) -> torch.Tensor:
    """The weighted sum of a per-row quantity over all ranks' rows: a local
    sum, one all_reduce over the data axis."""
    total = (per_row * dataset.weights_dev).sum()
    dist.all_reduce(total, group=axis_group(dataset_mesh(dataset), DATA_AXIS))
    return total


def llk(C, mean, sigma, dataset: Dataset, *, block_size: int) -> torch.Tensor:
    """The weighted llk of all rows."""
    return row_sum(llks(C, mean, sigma, dataset, block_size=block_size), dataset)


def em_stats(C, mean, sigma, dataset: Dataset, *, block_size: int):
    """The EM statistics of all rows (this rank's columns), on every rank:
    the rank's statistics on its route, summed over the data axis."""
    Cl, meanl, group = local_params(C, mean, dataset)
    stats = routes.em_stats(routes.route(dataset), Cl, meanl, sigma, dataset, block_size, group)
    return reduce_stats(stats, dataset_mesh(dataset))


def em_step(C, mean, sigma, dataset: Dataset, priors: dict, *, block_size: int):
    """One EM step over all rows: ``((new_C, new_mean, new_sigma), llk)``,
    the same on every rank."""
    stats = em_stats(C, mean, sigma, dataset, block_size=block_size)
    Cl, meanl, group = local_params(C, mean, dataset)
    new_C, new_mean, new_sigma = routes.em_finalize(routes.route(dataset), Cl, meanl, sigma,
                                                    stats, priors, group)
    return (*gather_params(new_C, new_mean, group), new_sigma), stats.llk


# --------------------------------------------------------------------- #
# mixtures: stacked parameters Cs (M, D, k), means (M, D), sigmas (M,);
# ``pidx``/``patterns`` select the table route, as in ``ops/mix_fused``


def mix_llks(Cs, means, sigmas, dataset: Dataset, *, block_size: int, pidx=None,
             patterns=None) -> torch.Tensor:
    """(n_local, M) per-component llks of this rank's rows."""
    Cs, means, group = local_params(Cs, means, dataset)
    return mf.mix_llks(Cs, means, sigmas, dataset.data, dataset.mask, block_size=block_size,
                       pidx=pidx, patterns=patterns, group=group)


def mix_infer(Cs, means, sigmas, log_weights, dataset: Dataset, *, block_size: int, pidx=None,
              patterns=None):
    """``mix_fused.mix_infer`` of this rank's rows."""
    Cs, means, group = local_params(Cs, means, dataset)
    return mf.mix_infer(Cs, means, sigmas, log_weights, dataset.data, dataset.mask,
                        block_size=block_size, pidx=pidx, patterns=patterns, group=group)


def mix_smooth(Cs, means, sigmas, log_weights, dataset: Dataset, *, block_size: int,
               extrapolate: bool = False, pidx=None, patterns=None) -> torch.Tensor:
    """``mix_fused.mix_smooth`` of this rank's rows (and columns)."""
    Cs, means, group = local_params(Cs, means, dataset)
    return mf.mix_smooth(Cs, means, sigmas, log_weights, dataset.data, dataset.mask,
                         block_size=block_size, extrapolate=extrapolate, pidx=pidx,
                         patterns=patterns, group=group)


def mix_em_step(Cs, means, sigmas, log_weights, dataset: Dataset, priors: dict, *,
                block_size: int, pidx=None, patterns=None, order=None):
    """One fused mixture EM step over all rows: ``((new_Cs, new_means,
    new_sigmas, new_log_weights), llk)``, the same on every rank.  With
    ``order`` (``(data_sorted, weights_sorted, counts)`` of this rank's rows
    against the global table), the rank's statistics are summed per
    pattern segment."""
    Cl, meanl, group = local_params(Cs, means, dataset)
    stats = mf.mix_em_stats(Cl, meanl, sigmas, log_weights, dataset.data, dataset.mask,
                            dataset.weights_dev, block_size=block_size, pidx=pidx,
                            patterns=patterns, order=order, group=group)
    stats = combine_mix_stats(stats, dataset_mesh(dataset))
    new_Cs, new_means, new_sigmas, new_lw = mf.mix_em_finalize(Cl, meanl, sigmas, stats,
                                                               **priors, group=group)
    return (*gather_params(new_Cs, new_means, group), new_sigmas, new_lw), stats.llk
