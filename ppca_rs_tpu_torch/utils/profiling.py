"""Profiling hooks — port of ``ppca_rs_tpu/utils/profiling.py``.

``trace`` captures a region with ``torch.profiler`` (the host's activity,
and the card's where there is one) into a Chrome trace file, which
TensorBoard's profiler plugin, Perfetto and ``chrome://tracing`` read; the
trainers take it as ``profile_dir``.  ``span`` names a region of the
program's own layers in whatever profiler is recording: ``ppca.em_step``,
``ppca.em_stats``, ``ppca.em_finalize``, ``ppca.block`` and
``ppca.readout`` (``models/``, ``ops/masked_linalg``, ``ops/mix_fused``,
``ops/pattern_dedup``, ``ops/dense_fast``); on the pattern route also
``ppca.pattern_tables`` (``ops/pattern_dedup.compute_tables``),
``ppca.pattern_detect`` and ``ppca.pattern_order`` (``Dataset.pattern_info``
and ``pattern_order``).
The JAX module's ``IterationTimer`` is not carried over: nothing uses it.
"""

from __future__ import annotations

import contextlib
from typing import ContextManager, Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

#: What :func:`span` returns while no profiler records: one shared object,
#: entered and left at no cost.
NO_SPAN: ContextManager[None] = contextlib.nullcontext()


def span(name: str) -> ContextManager:
    """A range named ``name`` in the profiler that is recording
    (``torch.profiler.record_function``), on the clock of its device
    intervals; :data:`NO_SPAN` while none is.  The switch is the profiler
    itself: ``trace``'s, or any ``torch.profiler.profile`` a caller opened
    (its ``start()`` sets the flag read here, ``stop()`` clears it)."""
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed region into a ``*.pt.trace.json`` file in
    ``logdir`` (created if needed); nothing at all when ``logdir`` is
    None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
