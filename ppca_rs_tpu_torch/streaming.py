"""Out-of-core (streaming) EM training — port of ``ppca_rs_tpu/streaming.py``
for one device.

The sufficient statistics of one EM iteration (``masked_linalg.EMStats``;
``mix_fused.MixEMStats`` for mixtures, whose ``resp_max`` combines by
maximum) are additive over samples, so a dataset larger than device memory
trains by streaming chunks through the statistics pass and summing the
small results: the streamed iteration equals one iteration over the
concatenated data, up to the order of summation.

    chunks = list(Dataset(table, device="cpu").chunks(8))   # host tensors
    model = StreamingPPCATrainer(chunks).train(state_size=16, n_iters=10)

A chunk is a :class:`Dataset` or a zero-argument callable returning one
(lazy loading).  Each chunk takes its own route, which
``models/routes.route`` picks by a resident dataset's rules but with no
sorted copy (``sort=False``): the pattern route's tables take the chunk's
rows in any order.  A fully observed chunk's dense statistics are converted
to the common form the pass sums.

Device rules.  Parameters and statistics live on the model's device, which
the trainers take from ``config.device`` (the card by default; without one
they raise unless the caller asks for the CPU).  A chunk elsewhere is
copied there before its statistics are computed: from pinned host memory
(``data.is_pinned()``) asynchronously on a copy stream of its own, so the
copy overlaps the statistics of the chunk before; from pageable memory by a
plain synchronous ``.to``.  The compute stream waits on an event recorded
after the copy, and the copied tensors are held for the compute stream
(``record_stream``) until its work on them is done.  A chunk's route is
decided on the device the first time and recorded on the host chunk, so a
chunk passed again is not examined again.  ``prefetch`` bounds how far the
host runs ahead of the device: after enqueueing the statistics of chunk i
it waits for those of chunk i - prefetch to finish (:func:`_accumulate`).

Across ranks: with a ``mesh``, each rank streams its own chunks -- plain
datasets, or data-axis-sharded ones, whose mesh is used when none is
given -- and computes their statistics locally; the pass's statistics and
row count are summed over the mesh's data axis once, after the rank's last
chunk (``parallel/placement.Placement.reduce``), so ranks may stream
different numbers of chunks.  Model-axis chunks are refused: their
D-indexed statistics would be column-local.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Union

import torch

from .config import config
from .dataset import Dataset
from .models import routes
from .models.mix import PPCAMix
from .models.ppca import PPCAModel, device_priors
from .ops import dense_fast as df
from .ops import masked_linalg as ml
from .ops import mix_fused as mf
from .parallel.mesh import MODEL_AXIS, DeviceMesh, axis_size, dataset_mesh
from .parallel.placement import Placement, count_rows, replicate
from .prior import Prior
from .trainer import Metric, MetricsCallback, _train

ChunkLike = Union[Dataset, Callable[[], Dataset]]


def _resolve(chunk: ChunkLike) -> Dataset:
    return chunk() if callable(chunk) else chunk


class _Transfer:
    """Brings chunks to ``device``: CUDA copies run on one copy stream, and
    the current (compute) stream waits for each before using it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def __call__(self, ds: Dataset) -> Dataset:
        """``ds`` on the device, with its route caches: ``ds`` itself if it
        is there already."""
        if ds.device == self.device:
            return ds
        if self.stream is None:
            return ds.to(self.device)
        patterns = ds._patterns or ()
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            moved = [t.to(self.device, non_blocking=t.is_pinned())
                     for t in (ds.data, ds.mask, ds.weights_dev, *patterns)]
            copied = torch.cuda.Event()
            copied.record(self.stream)
        compute.wait_event(copied)
        for t in moved:
            t.record_stream(compute)
        new = Dataset.from_parts(*moved[:3])
        new._shard = ds._shard
        new._all_observed = ds._all_observed
        new._patterns = tuple(moved[3:]) if patterns else ds._patterns
        return new

    def event(self) -> Optional[torch.cuda.Event]:
        """An event after the work enqueued so far on the compute stream
        (None on the CPU, where that work is done already)."""
        if self.stream is None:
            return None
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return done


def _keep_route(src: Dataset, ds: Dataset) -> None:
    """Record on the host chunk ``src`` the route its device copy ``ds``
    took (``all_observed``, the pattern table), so that the next pass copies
    the table along instead of deciding again.  The table keeps the host
    chunk's pinning."""
    if ds is src:
        return
    if src._all_observed is None:
        src._all_observed = ds._all_observed
    if src._patterns is None and ds._patterns is not None:
        pin = src.data.is_pinned()
        src._patterns = ds._patterns and tuple(
            t.to(src.device).pin_memory() if pin else t.to(src.device) for t in ds._patterns)


def _accumulate(chunks: Sequence[ChunkLike], device: torch.device, stats_fn, add_fn,
                prefetch: int):
    """The statistics of every chunk, computed on ``device`` one chunk at
    a time and summed by ``add_fn``.  Returns ``(total, n_samples)``, the
    rows of this rank's chunks.

    A chunk this loop brings in (a callable's result, or a dataset copied
    to the device) holds device memory until its statistics are computed.
    So after enqueueing chunk i's statistics the host waits for chunk
    i - ``prefetch``'s to finish: at most ``prefetch + 1`` such chunks are
    on the device at once (``prefetch=0``: one at a time), while the copy
    and the launches of the next chunk overlap the device's work on the
    ones before.  Chunks resident on the device already are not waited
    for.  ``prefetch`` changes when the host waits, never what is
    computed."""
    if not len(chunks):
        raise ValueError("need at least one chunk")
    if prefetch < 0:
        raise ValueError("prefetch must be >= 0")
    transfer = _Transfer(device)
    total, n_samples, pending = None, 0, []
    for chunk in chunks:
        src = _resolve(chunk)
        ds = transfer(src)
        n_samples += int(ds.data.shape[0])
        stats = stats_fn(ds)
        _keep_route(src, ds)
        total = stats if total is None else add_fn(total, stats)
        brought_in = callable(chunk) or ds is not src
        del src, ds   # the device copy may be freed once its work is done
        if brought_in:
            pending.append(transfer.event())
            if len(pending) > prefetch:
                done = pending.pop(0)
                if done is not None:
                    done.synchronize()
    return total, n_samples


def _dense_to_masked_stats(st: df.DenseEMStats) -> ml.EMStats:
    """The dense pass's statistics in the common form the accumulator sums:
    every output row's second moment is the one (k, k) ``S_common`` (all
    masks are 1), and the per-dimension observed-weight totals are the
    weight sum.  Lets fully observed chunks mix with the others."""
    D, k = st.cross.shape
    return ml.EMStats(st.cross, st.S_common.reshape(1, k * k).expand(D, k * k),
                      st.square_error, st.dev_sq, st.total_dev, st.w_sum.expand(D), st.llk)


def _data_axis_only(mesh):
    """``mesh``, refused when it has a model axis: the D-indexed statistics
    of a column block are no statistics of the whole rows."""
    if mesh is not None and axis_size(mesh, MODEL_AXIS) > 1:
        raise ValueError(
            "streaming chunks may be data-axis sharded only (model-axis "
            "sharding keeps D-indexed statistics device-local)"
        )
    return mesh


def _chunk_mesh(ds: Dataset, seen: list):
    """Record a sharded chunk's mesh in ``seen``; refuse model-axis chunks."""
    mesh = _data_axis_only(dataset_mesh(ds))
    if mesh is not None:
        seen.append(mesh)


def _pass_total(total, n: int, mesh, seen: list):
    """The pass's statistics and row count over the data axis of ``mesh``
    (or of the chunks' mesh): one statistics reduction after the last
    chunk, and one all_reduce of the row count."""
    mesh = mesh if mesh is not None else (seen[0] if seen else None)
    if mesh is None:
        return total, n
    return Placement(mesh).reduce(total), count_rows(n, mesh)


def _chunk_stats(model: PPCAModel, ds: Dataset) -> ml.EMStats:
    """EM statistics of one chunk's rows on its route (``routes.route``
    with no sorted copy), in the common form."""
    way = routes.route(ds, sort=False)
    stats = routes.em_stats(way, *model._params(), ds, model._block_rows(ds))
    return _dense_to_masked_stats(stats) if way.kind == "dense" else stats


def _stats_add(a: ml.EMStats, b: ml.EMStats) -> ml.EMStats:
    return ml.EMStats(*(x + y for x, y in zip(a, b)))


def _step(model: PPCAModel, chunks: Sequence[ChunkLike], prior: Optional[Prior],
          prefetch: int, mesh=None):
    """One streamed EM iteration: ``(new model, llk of model as a 0-dim
    tensor, number of samples)``, over all ranks with a mesh."""
    C, mean, sigma = model._params()
    priors = device_priors(prior, C)
    _data_axis_only(mesh)
    seen: list = []

    def stats(ds):
        _chunk_mesh(ds, seen)
        return _chunk_stats(model, ds)

    total, n = _accumulate(chunks, C.device, stats, _stats_add, prefetch)
    total, n = _pass_total(total, n, mesh, seen)
    new = ml.em_finalize(C, mean, sigma, total, **priors)
    return PPCAModel._from_params(*new), total.llk, n


def iterate_streamed(model: PPCAModel, chunks: Sequence[ChunkLike],
                     prior: Optional[Prior] = None, prefetch: int = 1, mesh=None):
    """One EM iteration over a stream of chunks.  Returns ``(new_model,
    llk)``, llk the total log-likelihood of ``model`` over all chunks: the
    values of ``model._iterate_with_llk`` on the concatenated dataset.
    ``prefetch`` bounds the chunks in flight (:func:`_accumulate`).  With
    ``mesh`` (or data-axis-sharded chunks), this rank's chunks are one part
    of the stream, and every rank of the mesh calls it."""
    new, llk, _ = _step(model, chunks, prior, prefetch, mesh)
    return new, float(llk)


def _mix_step(mix: PPCAMix, chunks: Sequence[ChunkLike], prior: Optional[Prior],
              prefetch: int, mesh=None):
    """One streamed fused mixture EM iteration: ``(new mixture, llk, number
    of samples)``."""
    params = mix._stacked_params()
    _data_axis_only(mesh)
    seen: list = []

    def stats(ds):
        _chunk_mesh(ds, seen)
        return mix._em_stats(ds, *params, **mix._route_args(ds, params[0]))

    total, n = _accumulate(chunks, mix.device, stats, mf._accumulate, prefetch)
    total, n = _pass_total(total, n, mesh, seen)
    return mix._finalize(*params, total, prior), total.llk, n


def iterate_mix_streamed(mix: PPCAMix, chunks: Sequence[ChunkLike],
                         prior: Optional[Prior] = None, prefetch: int = 1, mesh=None):
    """One fused mixture EM iteration over a stream of chunks: the values of
    ``mix._iterate_with_llk`` on the concatenated dataset.  Chunks may be
    resident or lazy callables, mixed freely; ``mesh`` as in
    :func:`iterate_streamed`."""
    new, llk, _ = _mix_step(mix, chunks, prior, prefetch, mesh)
    return new, float(llk)


def _first_chunk(chunks: List[ChunkLike]) -> Dataset:
    """The first chunk on ``config.device``, to initialize a model from."""
    return _resolve(chunks[0]).to(config.resolve_device())


def _initialized(make, chunks: List[ChunkLike], mesh):
    """A model or mixture from ``make(first chunk)``; with a mesh, every
    rank gets rank 0's (its chunks differ from the other ranks')."""
    first = _first_chunk(chunks)
    model = make(first)
    if mesh is not None and dataset_mesh(first) is None:
        models = model.models if isinstance(model, PPCAMix) else [model]
        replicate([m.transform for m in models])
    return model


def _train_streamed(model, step_fn, chunks, prior, n_iters, metric, quiet, callback, label,
                    profile_dir, checkpoint_path, checkpoint_every, prefetch, mesh):
    """The shared trainer loop (``trainer._train``) over streamed steps; the
    number of samples is counted by the first pass, with no extra I/O."""
    counted: List[int] = []

    def step(m):
        new, llk, n = step_fn(m, chunks, prior, prefetch, mesh)
        counted[:] = [n]
        return new, llk

    return _train(model, step, lambda: counted[0], n_iters, metric, quiet, callback,
                  checkpoint_path, checkpoint_every, label, profile_dir)


class StreamingPPCATrainer:
    """Train a PPCA model over chunks that need never be on the device
    together.  API of :class:`ppca_rs_tpu_torch.PPCATrainer`, plus
    ``prefetch``; with ``mesh``, ``chunks`` are this rank's part of the
    stream (:func:`iterate_streamed`)."""

    chunks: List[ChunkLike]
    mesh: Optional[DeviceMesh]

    def __init__(self, chunks: Sequence[ChunkLike], mesh=None):
        self.chunks = list(chunks)
        self.mesh = mesh
        if not self.chunks:
            raise ValueError("need at least one chunk")

    def train(
        self,
        *,
        start: Optional[PPCAModel] = None,
        prior: Optional[Prior] = None,
        state_size: int,
        n_iters: int = 10,
        metric: Metric = "aic",
        quiet: bool = False,
        callback: Optional[MetricsCallback] = None,
        generator: Optional[torch.Generator] = None,
        profile_dir: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 10,
        prefetch: int = 1,
    ) -> PPCAModel:
        """Without ``start``, the model is initialized from the first chunk
        on ``config.device``.  ``prefetch``: chunks the host may bring in
        ahead of the one the device computes (1: at most two on the device
        at once; 0: one)."""
        model = start if start is not None else _initialized(
            lambda ds: PPCAModel.init(state_size, ds, generator=generator), self.chunks, self.mesh)
        return _train_streamed(model, _step, self.chunks, prior, n_iters, metric, quiet,
                               callback, "Masked PPCA", profile_dir, checkpoint_path,
                               checkpoint_every, prefetch, self.mesh)


class StreamingPPCAMixTrainer:
    """Train a PPCA mixture over chunks that need never be on the device
    together.  API of :class:`ppca_rs_tpu_torch.PPCAMixTrainer`, plus
    ``prefetch`` and ``mesh`` (:class:`StreamingPPCATrainer`)."""

    chunks: List[ChunkLike]
    mesh: Optional[DeviceMesh]

    def __init__(self, chunks: Sequence[ChunkLike], mesh=None):
        self.chunks = list(chunks)
        self.mesh = mesh
        if not self.chunks:
            raise ValueError("need at least one chunk")

    def train(
        self,
        *,
        start: Optional[PPCAMix] = None,
        prior: Optional[Prior] = None,
        n_models: int,
        state_size: int,
        n_iters: int = 10,
        metric: Metric = "aic",
        quiet: bool = False,
        callback: Optional[MetricsCallback] = None,
        generator: Optional[torch.Generator] = None,
        profile_dir: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 10,
        prefetch: int = 1,
    ) -> PPCAMix:
        """See :meth:`StreamingPPCATrainer.train`."""
        mix = start if start is not None else _initialized(
            lambda ds: PPCAMix.init(n_models, state_size, ds, generator=generator), self.chunks,
            self.mesh)
        return _train_streamed(mix, _mix_step, self.chunks, prior, n_iters, metric, quiet,
                               callback, "Masked PPCA mix", profile_dir, checkpoint_path,
                               checkpoint_every, prefetch, self.mesh)
