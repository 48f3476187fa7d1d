"""The card's idle time split by the program's own span the host was in.

The program names its layers with ``torch.profiler.record_function``
ranges (``ppca_rs_tpu_torch/utils/profiling.span``): ``ppca.em_step``
holding ``ppca.em_stats`` and ``ppca.em_finalize``, ``ppca.readout``, and
``ppca.block`` inside either.  They land in the traced run's host ranges on
the clock of the device intervals, so every idle gap of the traced window
(:meth:`TraceView.gaps`) is split, instant by instant, by the ranges open
at that instant.  A part is scaled onto the untraced time base as
``idle_pct`` is: ``idle_pct`` x its traced idle ns over all traced idle ns.
A program without these ranges (an older one) gives None, as does a trace
with no device time.
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, FrozenSet, Optional

from . import readers
from .tracing import TraceView

PREFIX = "ppca."


def idle_ns(view: TraceView, part: Callable[[FrozenSet[str]], Optional[str]]) -> Dict[str, int]:
    """Traced idle ns by ``part(names)``, ``names`` being the program spans
    open at the instant; instants whose part is None are left out."""
    edges = sorted([(iv.start, 1, iv.name) for iv in view.host if iv.name.startswith(PREFIX)]
                   + [(iv.end, -1, iv.name) for iv in view.host if iv.name.startswith(PREFIX)])
    open_: Counter = Counter()
    out: Dict[str, int] = {}
    i = 0

    def add(a: int, b: int) -> None:
        if b > a:
            key = part(frozenset(n for n, c in open_.items() if c > 0))
            if key is not None:
                out[key] = out.get(key, 0) + b - a

    for a, b in view.gaps():
        while i < len(edges) and edges[i][0] <= a:
            open_[edges[i][2]] += edges[i][1]
            i += 1
        t = a
        while i < len(edges) and edges[i][0] < b:
            add(t, edges[i][0])
            t = edges[i][0]
            open_[edges[i][2]] += edges[i][1]
            i += 1
        add(t, b)
    return out


def idle_pct_by(view: TraceView, part, parts) -> Optional[Dict[str, float]]:
    """``readers.idle_pct`` split into ``parts`` by :func:`idle_ns`: None
    without device time or without program spans, 0.0 for a part with no
    idle time."""
    total = readers.idle_pct(view)
    if total is None or not any(iv.name.startswith(PREFIX) for iv in view.host):
        return None
    ns = idle_ns(view, part)
    gap_ns = sum(b - a for a, b in view.gaps())
    return {p: total * ns.get(p, 0) / gap_ns if gap_ns else 0.0 for p in parts}


def train_part(names: FrozenSet[str]) -> str:
    """The statistics pass, the M-step, or the loop: every other instant of
    an iteration (the trainer, the llk read, the route, the parameters'
    stack and unstack)."""
    if "ppca.em_stats" in names:
        return "stats"
    if "ppca.em_finalize" in names:
        return "mstep"
    return "loop"


def readout_part(names: FrozenSet[str]) -> Optional[str]:
    """A block of a readout verb, the verb's own entry work, or (None) the
    benchmark's code between verbs."""
    if "ppca.readout" not in names:
        return None
    return "blocks" if "ppca.block" in names else "entry"


def train_idle_pct(view: TraceView, part: str) -> Optional[float]:
    split = idle_pct_by(view, train_part, ("stats", "mstep", "loop"))
    return None if split is None else split[part]


def readout_idle_pct(view: TraceView, part: str) -> Optional[float]:
    split = idle_pct_by(view, readout_part, ("blocks", "entry"))
    return None if split is None else split[part]
