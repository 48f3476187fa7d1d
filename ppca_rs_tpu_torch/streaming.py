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
(``data.is_pinned()``) asynchronously on the device's copy stream, so the
copy overlaps the statistics before it; from pageable memory by a plain
synchronous ``.to``.  The compute stream waits on an event recorded
after the copy, and the copied tensors are held for the compute stream
(``record_stream``) until its work on them is done.  A host chunk's route
is decided once, on a copy of its mask alone, and recorded on the chunk
(:meth:`_Transfer.decide_route`), so a chunk passed again is not examined
again.  Every host chunk is copied and reduced in slices of whole row
blocks that take its route, the copy of one slice overlapping the
statistics of the slices before (``COUNTS`` counts slices and routes
decided).  ``prefetch`` bounds how far the host runs ahead of the device:
after enqueueing the statistics of piece i it waits for those of piece
i - prefetch to finish (:func:`_accumulate`).

Across ranks: with a ``mesh``, each rank streams its own chunks -- plain
datasets, or data-axis-sharded ones, whose mesh is used when none is
given -- and computes their statistics locally; the pass's statistics and
row count are summed over the mesh's data axis once, after the rank's last
chunk (``parallel/placement.Placement.reduce``), so ranks may stream
different numbers of chunks.  Model-axis chunks are refused: their
D-indexed statistics would be column-local.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Union

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


#: Host chunks brought to the device in this process: ``slices`` copied
#: (:func:`_slices`) and ``routes`` decided (:meth:`_Transfer.decide_route`,
#: once a chunk).  Reset by :func:`reset_counts`.
COUNTS: Dict[str, int] = {"slices": 0, "routes": 0}


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


@functools.lru_cache(maxsize=None)
def _copy_stream(device: torch.device) -> torch.cuda.Stream:
    """The one copy stream of ``device``, for every pass: the caching
    allocator keeps freed blocks per stream, so a new stream a pass would
    find none of the last pass's copies' blocks to reuse."""
    return torch.cuda.Stream(device)


class _Transfer:
    """Brings chunks to ``device``: CUDA copies run on the device's copy
    stream, and the current (compute) stream waits for each (:meth:`wait`)
    just before using it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = _copy_stream(device) if device.type == "cuda" else None
        self.copied: Optional[torch.cuda.Event] = None

    def brings(self, ds: Dataset) -> bool:
        """Whether ``ds`` lives on another device, so that it is copied."""
        return ds.device != self.device

    def decide_route(self, src: Dataset) -> None:
        """Decide the route of the host chunk ``src`` unless it carries one
        (:func:`_route_known`): by the rules of ``routes.route`` (every
        entry observed, else the pattern table or its absence), on a copy
        of the mask alone on the copy stream, whose verdict the host waits
        for; then record it on ``src`` (:func:`_keep_route`).  Its slices
        take it and decide nothing."""
        if _route_known(src):
            return
        n, D = src.data.shape
        with torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext():
            probe = Dataset.from_parts(
                torch.zeros((), dtype=src.data.dtype, device=self.device).expand(n, D),
                src.mask.to(self.device, non_blocking=src.mask.is_pinned()))
            if not probe.all_observed():
                probe.pattern_info()
            _keep_route(src, probe)
        COUNTS["routes"] += 1

    def __call__(self, ds: Dataset) -> Dataset:
        """``ds`` on the device, with its route caches: ``ds`` itself if it
        is there already.  A copy on the copy stream leaves the event after
        it in ``copied`` (None otherwise), for :meth:`wait`."""
        self.copied = None
        if not self.brings(ds):
            return ds
        if self.stream is None:
            return ds.to(self.device)
        patterns = ds._patterns or ()
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            moved = [t.to(self.device, non_blocking=t.is_pinned())
                     for t in (ds.data, ds.mask, ds.weights_dev, *patterns)]
            self.copied = torch.cuda.Event()
            self.copied.record(self.stream)
        for t in moved:
            t.record_stream(compute)
        new = Dataset.from_parts(*moved[:3])
        new._shard = ds._shard
        new._all_observed = ds._all_observed
        new._patterns = tuple(moved[3:]) if patterns else ds._patterns
        return new

    def wait(self, copied: Optional[torch.cuda.Event]) -> None:
        """Make the compute stream wait for the copy that ``copied`` ends
        before the work enqueued next (nothing for None)."""
        if copied is not None:
            torch.cuda.current_stream(self.device).wait_event(copied)

    def event(self) -> Optional[torch.cuda.Event]:
        """An event after the work enqueued so far on the compute stream
        (None on the CPU, where that work is done already)."""
        if self.stream is None:
            return None
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return done


def _keep_route(src: Dataset, ds: Dataset) -> None:
    """Record on the host chunk ``src`` the route decided on ``ds``, a
    device copy of its mask (``all_observed``, the pattern table), so that
    its slices copy the table along.  The table keeps the host chunk's
    pinning."""
    if src._all_observed is None:
        src._all_observed = ds._all_observed
    if src._patterns is None and ds._patterns is not None:
        pin = src.data.is_pinned()
        src._patterns = ds._patterns and tuple(
            t.to(src.device).pin_memory() if pin else t.to(src.device) for t in ds._patterns)


def _route_known(ds: Dataset) -> bool:
    """Whether the host chunk ``ds`` carries its route (:func:`_keep_route`),
    so that its rows need no look to take it: fully observed, or its
    pattern table or the verdict that it has none (which pattern detection
    switched off leaves unwritten)."""
    if ds._all_observed is None:
        return False
    return ds._all_observed or ds._patterns is not None or not config.use_pattern_dedup


def _slices(src: Dataset) -> List[Dataset]:
    """The host chunk ``src`` as views of its rows, each carrying the
    chunk's route (``pidx`` cut to its rows).  A slice holds
    ``config.segment_rows`` rows (512 MiB of values) rounded down to whole
    blocks of ``config.block_size``, so a slice starts on a block of the
    routes' own rows (``config.block_rows``, ``mix_block_rows``: that size
    halved while it stays even) and its blocks are the chunk's.  A tail
    shorter than the pattern rules' minimum (``2 * pattern_min_ratio``
    rows) joins the slice before it, so that no slice of a fully observed
    chunk leaves a mixture's table route."""
    n, D = src.data.shape
    block = config.block_size
    step = max(block, config.segment_rows(D, src.data.element_size()) // block * block)
    starts = list(range(0, n, step)) or [0]
    if len(starts) > 1 and n - starts[-1] < 2 * config.pattern_min_ratio:
        starts.pop()
    pieces = []
    for lo, hi in zip(starts, starts[1:] + [n]):
        piece = Dataset.from_parts(src.data[lo:hi], src.mask[lo:hi], src.weights_dev[lo:hi])
        piece._shard = src._shard
        piece._all_observed = src._all_observed
        piece._patterns = src._patterns and (src._patterns[0][lo:hi], src._patterns[1])
        pieces.append(piece)
    return pieces


class _Piece(NamedTuple):
    """One unit of a pass: ``piece``, a chunk or one of a host chunk's
    slices, and how it comes to the device: "resident" (it is there),
    "loaded" (a callable made it there) or "slice" (copied)."""

    piece: Dataset
    how: str


def _pieces(chunks: Sequence[ChunkLike], transfer: _Transfer) -> Iterator[_Piece]:
    """The pass's pieces in order: a chunk elsewhere in slices
    (:func:`_slices`), its route decided first where it carries none; a
    chunk on the device whole.  Each chunk is resolved when its first piece
    is asked for."""
    for chunk in chunks:
        src = _resolve(chunk)
        if transfer.brings(src):
            transfer.decide_route(src)
            pieces, how = _slices(src), "slice"
            COUNTS["slices"] += len(pieces)
        else:
            pieces, how = [src], "loaded" if callable(chunk) else "resident"
        for piece in pieces:
            yield _Piece(piece, how)
        del src, pieces, piece   # a device chunk may be freed once its work is done


def _accumulate(chunks: Sequence[ChunkLike], device: torch.device, stats_fn, add_fn,
                prefetch: int):
    """The statistics of every chunk, computed on ``device`` piece by piece
    (:func:`_pieces`) and summed by ``add_fn`` in order.  Returns
    ``(total, n_samples)``, the rows of this rank's chunks.

    A piece is held on the device from when it is brought in (copied, or
    made by a callable) until its statistics are computed; a piece that
    was there already is not held.  After enqueueing the statistics of
    piece i the host waits for those of piece i - ``prefetch`` to finish:
    at most ``prefetch + 1`` pieces are held (``prefetch=0``: one at a
    time).  Slices go one further: with ``prefetch >= 1`` the host copies
    slice i + 1 before it enqueues slice i's statistics, which wait for
    slice i's copy alone, so that the copy runs under the statistics of
    the slices before while the host enqueues slice i's, and at most
    ``prefetch + 2`` slices are held.  A chunk made by a callable is made
    when the piece before it is reduced, or when a slice before it looks
    one ahead.  ``prefetch`` changes when the host waits, never what is
    computed."""
    if not len(chunks):
        raise ValueError("need at least one chunk")
    if prefetch < 0:
        raise ValueError("prefetch must be >= 0")
    transfer = _Transfer(device)
    pending: list = []   # events after the statistics of held pieces, oldest first
    ready: list = []     # (how, device dataset, its copy's event) brought in, not reduced
    items, nxt = _pieces(chunks, transfer), None
    total, n_samples = None, 0
    while True:
        while not ready or (prefetch and len(ready) < 2 and ready[-1][0] == "slice"):
            nxt = next(items, None) if nxt is None else nxt
            if nxt is None or (ready and nxt.how != "slice"):
                break
            ready.append((nxt.how, transfer(nxt.piece), transfer.copied))
            nxt = None
        if not ready:
            return total, n_samples
        how, ds, copied = ready.pop(0)
        n_samples += int(ds.data.shape[0])
        transfer.wait(copied)
        stats = stats_fn(ds)
        total = stats if total is None else add_fn(total, stats)
        del ds   # the device copy may be freed once its work is done
        if how != "resident":
            pending.append(transfer.event())
            while len(pending) > prefetch:
                done = pending.pop(0)
                if done is not None:
                    done.synchronize()


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
    ``prefetch`` bounds the pieces in flight (:func:`_accumulate`).  With
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
        on ``config.device``.  ``prefetch``: how far behind the host lets
        the device's work fall, in slices of host chunks or in chunks made
        on the device by callables (1: the next slice's copy overlapping
        the statistics of the ones before, at most three slices or two
        made chunks on the device at once; 0: one, with no overlap;
        :func:`_accumulate`)."""
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
