"""How a dataset's computations run: the one place that picks a route.

Each dataset takes one of three routes (:func:`route`): fully observed data
the dense path (``ops/dense_fast``), structured missingness the pattern path
(``ops/pattern_dedup``; a mixture's table route in ``ops/mix_fused``),
everything else the general masked path (``ops/masked_linalg``)
(`ppca_rs_tpu/models/ppca.py:_impl_and_block`).  The same rules serve a
single model, a mixture and a streamed chunk.  The functions below call the
route's readouts, EM statistics and M-step with the parameters they are
given; where the dataset lives is not theirs to decide
(``parallel/placement.py``): a sharded dataset's rank passes its block of
columns and the model process group, which the pattern route never gets (a
sharded dataset finds patterns on the data axis only).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

from ..config import config
from ..dataset import Dataset
from ..ops import dense_fast as df
from ..ops import masked_linalg as ml
from ..ops import pattern_dedup as pd


class Route(NamedTuple):
    """``kind`` is "dense", "pattern" or "masked"; a pattern route carries
    ``(pidx, patterns)`` and, when the sorted copy is available,
    ``(data_sorted, perm, counts)``."""

    kind: str
    pattern: Optional[tuple] = None
    order: Optional[tuple] = None


def route(dataset: Dataset, *, mixture: bool = False, sort: bool = True) -> Route:
    """The route of ``dataset``'s rows.  A single model's: dense if every
    entry is observed; the pattern path if the masks repeat
    (``Dataset.pattern_info``); the masked path otherwise.  A mixture
    (``mixture``) has no dense route: fully observed data is the table
    route's single pattern (``pattern_info(include_dense=True)``).  The
    pattern route takes the rows sorted by pattern (``Dataset.pattern_order``)
    when they are available and the data is not fully observed, unless
    ``sort`` is off: a streamed chunk gets no sorted copy, nor does a
    mixture's readout."""
    if not mixture and dataset.all_observed():
        return Route("dense")
    pattern = dataset.pattern_info(include_dense=mixture)
    if pattern is None:
        return Route("masked")
    if not sort or dataset.all_observed():
        return Route("pattern", pattern)
    return Route("pattern", pattern, dataset.pattern_order())


def readout(verb: str, way: Route, C, mean, sigma, dataset: Dataset, block_size: int,
            group=None):
    """``verb`` ("llks", "states" or "infer") of the dataset's rows on route
    ``way``."""
    args = (C, mean, sigma, dataset.data)
    if way.kind == "dense":
        return getattr(df, verb)(*args, block_size=block_size, group=group)
    if way.kind == "pattern":
        return getattr(pd, verb)(*args, dataset.mask, *way.pattern, block_size=block_size)
    return getattr(ml, verb)(*args, dataset.mask, block_size=block_size, group=group)


def em_stats(way: Route, C, mean, sigma, dataset: Dataset, block_size: int, group=None):
    """The EM statistics of the dataset's rows on route ``way``
    (``DenseEMStats`` on the dense route, ``EMStats`` otherwise), in blocks
    of ``block_size`` rows; the dense route and the per-segment EM over the
    rows sorted by pattern, whose temporaries are (rows, D) and (rows, k)
    only, take their own larger blocks (``config.segment_rows``)."""
    weights = dataset.weights_dev
    if way.kind == "dense":
        data = dataset.data
        return df.em_stats(C, mean, sigma, data, weights, group=group,
                           block_size=config.segment_rows(
                               data.shape[1], ml._compute_dtype(data, C).itemsize))
    if way.kind == "masked":
        return ml.em_stats(C, mean, sigma, dataset.data, dataset.mask, weights,
                           block_size=block_size, group=group)
    if way.order is not None:
        data_sorted, perm, counts = way.order
        return pd.em_stats_sorted(C, mean, sigma, data_sorted, weights[perm], way.pattern[1],
                                  counts, block_size=config.segment_rows(
                                      data_sorted.shape[1],
                                      ml._compute_dtype(data_sorted, C).itemsize))
    return pd.em_stats(C, mean, sigma, dataset.data, dataset.mask, *way.pattern, weights,
                       block_size=block_size)


def em_finalize(way: Route, C, mean, sigma, stats, priors: dict, group=None):
    """The M-step of route ``way`` from its statistics: ``(new_C, new_mean,
    new_sigma)``, the rank's rows with a model ``group``."""
    finalize = df.em_finalize if way.kind == "dense" else ml.em_finalize
    return finalize(C, mean, sigma, stats, **priors, group=group)


def mix_keywords(way: Route, dataset: Dataset) -> dict:
    """``ops/mix_fused``'s keywords for a mixture's route ``way``: ``pidx``
    and ``patterns`` on the table route (None on the general route), and
    with the sorted copy ``order``, ``(data_sorted, weights_sorted,
    counts)`` for ``mix_em_stats``.  The weights are sorted on every call:
    ``with_weights`` twins share the sorted copy."""
    pidx, patterns = way.pattern or (None, None)
    if way.order is None:
        return dict(pidx=pidx, patterns=patterns)
    data_sorted, perm, counts = way.order
    return dict(pidx=pidx, patterns=patterns,
                order=(data_sorted, dataset.weights_dev[perm], counts))
