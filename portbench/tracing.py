"""The traced run: a torch.profiler window over whole iterations or whole
readout passes, the benchmark's own spans, and what the per-layer readers get.

Spans are ``torch.profiler.record_function`` ranges named ``portbench.*``
around each trainer call, each iteration, each pass and each verb call;
they cost nothing when the run is not traced.  After the window the trace
is reduced to device intervals (kernels, copies, sets) and host ranges in
one clock, a :class:`TraceView` for the readers in ``layer_metrics/``.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

#: Device activities: kernels, and the copies and sets that occupy the card.
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Interval:
    name: str
    start: int   # ns
    end: int     # ns
    kind: str = "kernel"


@dataclass
class TraceView:
    """What a per-layer reader reads: the device intervals and host ranges
    inside the traced window (ns, one clock), the units traced (iterations
    or passes) and their rows, and the cell's sizes and work module."""

    window: Tuple[int, int]
    device: List[Interval]
    host: List[Interval]
    units: int
    rows: int
    sizes: Dict[str, int]
    work: object
    untraced_unit_s: Optional[float] = None

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def base_s(self) -> float:
        """The traced units' time without the profiler's own host work: as
        many units at the mean time of the run's untraced units, where the
        run measured it; else the traced window."""
        if self.untraced_unit_s and self.units:
            return self.untraced_unit_s * self.units
        return self.window_s

    def kernels(self) -> List[Interval]:
        return [iv for iv in self.device if iv.kind == "kernel"]

    def device_s(self, pred) -> float:
        """Seconds of device time of the kernels whose name ``pred`` takes."""
        return sum(iv.end - iv.start for iv in self.kernels() if pred(iv.name)) / 1e9

    def busy(self) -> List[Tuple[int, int]]:
        """The union of the device intervals, clipped to the window."""
        lo, hi = self.window
        spans = sorted((max(iv.start, lo), min(iv.end, hi)) for iv in self.device
                       if iv.end > lo and iv.start < hi)
        merged: List[Tuple[int, int]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        lo, hi = self.window
        out, t = [], lo
        for a, b in self.busy():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if hi > t:
            out.append((t, hi))
        return out


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(w in low for w in ("gemm", "xmma", "cutlass", "sm90"))


def is_spd(name: str) -> bool:
    return "spd_" in name


class Tracer:
    """Profiles the window's units from :meth:`start` to :meth:`stop`; with
    ``on`` False every method does nothing."""

    def __init__(self, on: bool, device_type: str):
        self.on = on
        self.cuda = device_type == "cuda"
        self.prof = None
        self.done = not on
        self.units = 0
        self.rows = 0
        self._window = None
        self._open: Optional[object] = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def mark(self, name: Optional[str]) -> None:
        """Close the open unit span, and open one named ``name`` (None: none)."""
        if not self.on:
            return
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None
        if name is not None and self.prof is not None:
            self._open = self.span(name)
            self._open.__enter__()

    def _activities(self):
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])

    def warm(self) -> None:
        """Start and stop the profiler once in set-up: its first start
        initializes the device tracing."""
        if not self.on:
            return
        import torch
        from torch.profiler import profile

        with profile(activities=self._activities()):
            torch.zeros(1, device="cuda" if self.cuda else "cpu").add_(1)
            if self.cuda:
                torch.cuda.synchronize()

    def start(self) -> None:
        if not self.on or self.prof is not None or self.done:
            return
        from torch.profiler import profile

        self.prof = profile(activities=self._activities())
        self.prof.start()
        self._window = self.span("portbench.traced")
        self._window.__enter__()

    def stop(self, units: int, rows: int) -> None:
        if self.prof is None or self.done:
            return
        import torch

        self.mark(None)
        self._window.__exit__(None, None, None)
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        self.units, self.rows, self.done = units, rows, True

    def view(self, sizes: Dict[str, int], work) -> Optional[TraceView]:
        """The traced window as a :class:`TraceView`, or None when nothing
        was traced."""
        if self.prof is None or not self.done:
            return None
        device, host, window = [], [], None
        for e in self.prof.profiler.kineto_results.events():
            start = e.start_ns()
            end = start + e.duration_ns()
            kind = _activity(e)
            if kind in _DEVICE_KINDS:
                device.append(Interval(e.name(), start, end, kind))
            elif kind == "user_annotation" and e.name() == "portbench.traced":
                window = (start, end)
            elif kind in ("cpu_op", "user_annotation", "python_function"):
                host.append(Interval(e.name(), start, end, kind))
        if window is None:
            return None
        return TraceView(window, device, host, self.units, self.rows, sizes, work)


def _activity(e) -> str:
    """The kind of a profiler event: the profiler's own where it gives one,
    else from the device, the annotation flag and the name."""
    kind = e.activity_type() if hasattr(e, "activity_type") else None
    if kind:
        kind = str(kind).lower().rsplit(".", 1)[-1]
        return "kernel" if kind == "concurrent_kernel" else kind
    name = e.name()
    annotation = bool(e.is_user_annotation()) if hasattr(e, "is_user_annotation") else False
    if "cuda" in str(e.device_type()).lower():
        if annotation:
            return "gpu_user_annotation"
        low = name.lower()
        return ("gpu_memcpy" if low.startswith("memcpy") else
                "gpu_memset" if low.startswith("memset") else "kernel")
    if annotation:
        return "user_annotation"
    if name.startswith("cuda") or re.match(r"cu[A-Z]", name):
        return "cuda_runtime"
    return "cpu_op"


def breakdown(view: TraceView, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by what
    the host was doing (the innermost benchmark span and the innermost host
    operation at each gap's middle), each the ``top`` longest."""
    ops: Dict[str, int] = {}
    for iv in view.device:
        ops[iv.name] = ops.get(iv.name, 0) + iv.end - iv.start
    spans = [iv for iv in view.host if iv.name.startswith("portbench.")
             and iv.name != "portbench.traced"]
    host = sorted((iv for iv in view.host if not iv.name.startswith("portbench.")),
                  key=lambda iv: iv.start)
    starts = [iv.start for iv in host]
    idle: Dict[str, int] = {}
    for a, b in view.gaps():
        mid = (a + b) // 2
        inside = [iv for iv in spans if iv.start <= mid <= iv.end]
        span = max(inside, key=lambda iv: iv.start).name if inside else "outside spans"
        name = f"{span} > {_innermost(host, starts, mid) or 'host between ops'}"
        idle[name] = idle.get(name, 0) + b - a
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": [[name[:160], t / 1e9] for name, t in rank(ops)],
            "idle_gaps": [[name[:160], t / 1e9] for name, t in rank(idle)]}


def _innermost(host: List[Interval], starts: List[int], t: int, look: int = 2000):
    """The innermost host operation holding time ``t``: the latest-starting
    of the last ``look`` to start that still holds it."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look, -1), -1):
        if host[j].end >= t:
            return host[j].name
    return None
