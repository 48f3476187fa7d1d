"""The chunks' copies from the host to the card in a traced window, for the
``.stream`` readers in ``layer_metrics/``.

A copy is a device interval of kind ``gpu_memcpy`` whose name says host to
device (the profiler's ``Memcpy HtoD (Pinned -> Device)``, and ``Pageable``
for a plain ``.to``).  The readers return None where the window holds no
such copy: a CPU trace, or a resident table.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .tracing import TraceView

#: One direction of PCIe Gen5 x16: half the 128 GB/s of the H100 SXM data
#: sheet's interconnect row, which counts both directions.
PEAK_H2D_BYTES_PER_S = 64e9


def is_h2d(iv) -> bool:
    return iv.kind == "gpu_memcpy" and "htod" in iv.name.lower()


def _busy(view: TraceView, pred) -> List[Tuple[int, int]]:
    """:meth:`TraceView.busy` of the device intervals ``pred`` takes."""
    return dataclasses.replace(view, device=[iv for iv in view.device if pred(iv)]).busy()


def copies(view: TraceView) -> List[Tuple[int, int]]:
    """The union of the window's host-to-device copies."""
    return _busy(view, is_h2d)


def _overlap_ns(xs, ys) -> int:
    """Time two sorted, disjoint lists of spans share."""
    out = i = j = 0
    while i < len(xs) and j < len(ys):
        out += max(0, min(xs[i][1], ys[j][1]) - max(xs[i][0], ys[j][0]))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def exposed_ns(view: TraceView) -> int:
    """Copy time with no kernel running."""
    spans = copies(view)
    kernels = _busy(view, lambda iv: iv.kind == "kernel")
    return sum(b - a for a, b in spans) - _overlap_ns(spans, kernels)


def copy_exposed_pct(view: TraceView) -> Optional[float]:
    """Copy time with no kernel running, as a share of the traced units'
    untraced time (:meth:`TraceView.base_s`)."""
    if not copies(view) or view.base_s() <= 0:
        return None
    return exposed_ns(view) / 1e9 / view.base_s() * 100.0


def h2d_roofline_pct(view: TraceView) -> Optional[float]:
    """The traced rows' bytes (``work.h2d_bytes``) over the union of the
    copies' intervals, as a share of :data:`PEAK_H2D_BYTES_PER_S`."""
    spans = copies(view)
    if not spans:
        return None
    seconds = sum(b - a for a, b in spans) / 1e9
    return view.work.h2d_bytes(view.sizes, view.rows) / seconds / PEAK_H2D_BYTES_PER_S * 100.0
