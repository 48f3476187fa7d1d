"""What the per-layer readers in ``layer_metrics/`` share.  Each returns
None when the trace holds nothing to read, never 0 for a share."""

from __future__ import annotations

from typing import Optional

from . import peaks
from .tracing import TraceView, is_gemm, is_spd
from .work import spd_estep


def launches_per_unit(view: TraceView) -> Optional[float]:
    n = len(view.kernels())
    return n / view.units if n and view.units else None


def gemm_ms_per_unit(view: TraceView) -> Optional[float]:
    t = view.device_s(is_gemm)
    return t / view.units * 1e3 if t > 0 and view.units else None


def estep_roofline_pct(view: TraceView) -> Optional[float]:
    """The E-step work's least time (``work.spd_estep``, layout-independent
    counts) over the device time of the kernels named ``spd_``."""
    t = view.device_s(is_spd)
    if t <= 0:
        return None
    s = view.sizes
    bound = sum(peaks.bound_s(*spd_estep.launch(want, n, s["k"], s["itemsize"], per_sample))
                for want, n, per_sample in view.work.estep_launches(s, view.units, view.rows))
    return bound / t * 100.0


def mfu_pct(view: TraceView) -> Optional[float]:
    """Useful operations of the traced units over their time untraced
    (:meth:`TraceView.base_s`), as a share of the dense TF32 peak."""
    if view.busy_s() <= 0 or view.base_s() <= 0:
        return None
    flops = view.work.useful_flops(view.sizes, view.units, view.rows)
    return flops / view.base_s() / peaks.PEAK_TF32_FLOPS * 100.0


def idle_pct(view: TraceView) -> Optional[float]:
    """The share of the traced units' untraced time (:meth:`TraceView.base_s`)
    in which nothing ran on the card: the profiler's own host work stretches
    the traced window, not the device's busy time."""
    busy = view.busy_s()
    if busy <= 0 or view.base_s() <= 0:
        return None
    return (1.0 - busy / view.base_s()) * 100.0
