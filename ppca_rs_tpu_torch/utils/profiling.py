"""Profiling hooks — port of ``ppca_rs_tpu/utils/profiling.py``.

``trace`` captures a region with ``torch.profiler`` (the host's activity,
and the card's where there is one) into a Chrome trace file, which
TensorBoard's profiler plugin, Perfetto and ``chrome://tracing`` read; the
trainers take it as ``profile_dir``.  The JAX module's ``IterationTimer``
is not carried over: nothing uses it.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch


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

