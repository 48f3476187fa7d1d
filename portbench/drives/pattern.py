"""Training traffic on the pattern route: resident EM of a single model
over rows whose masks come from a few patterns (a configuration of
``model`` ``structured``), through the program's trainer as users call it.

Set-up, the window, ``em_iter_s`` and the check are :mod:`.train`'s; the
set-up's first step also detects the patterns and builds the rows sorted
by pattern (``Dataset.pattern_info``, ``pattern_order``), so the timed
iterations run the per-segment EM (``pattern_dedup.em_stats_sorted``).
The program counts the route's work (``pattern_dedup.COUNTS``), and the
drive holds the set-up's steps and the window's iterations to it: one
table a step, and every segment where the route keeps the sorted copy.  A
program that does not count it cannot show which form its iterations take,
and the run stops at set-up.  Set-up prints the route taken; the window
prints the per-sample factorizations (``fullt``) launched so far, which
this route never launches.

Faults: ``unchanged`` and ``alter`` are :mod:`portbench.faults`' of
``train``.  ``half`` is this kind's own (``train``'s takes half of the
dataset's rows under the whole dataset's route, whose permutation of the
sorted copy then indexes past the half's weights): the per-segment EM
over the first half of each segment's rows, and the grouped form
(``pattern_dedup.em_stats``) over the first half of the rows, the sums
doubled.
"""

from __future__ import annotations

import contextlib
import sys

import torch

from .. import faults
from . import train
from .train import (CHECK_AFTER_WINDOW, NUMBERS, STARTS, check, compare_to,  # noqa: F401
                    forget, outputs, reference)

FAULTS = train.FAULTS


def _counted(steps: int, way) -> None:
    """Hold ``pattern_dedup.COUNTS``, counted from 0, to ``steps``
    statistics passes of route ``way``'s form (the rows they walked are
    printed: a planted fault may walk fewer)."""
    from ppca_rs_tpu_torch.ops import pattern_dedup as pd

    segments = steps * way.pattern[1].shape[0] if way.order is not None else 0
    want = {"tables": steps, "segments": segments}
    got = {name: pd.COUNTS[name] for name in want}
    sys.stderr.write(f"portbench: pattern route over {steps} steps: {pd.COUNTS}\n")
    if got != want:
        raise RuntimeError(f"the pattern route counted {got} over {steps} steps, not {want}")
    pd.reset_counts()


def setup(cell, inputs: dict, device, tracer, seed: int) -> dict:
    from ppca_rs_tpu_torch.models import routes
    from ppca_rs_tpu_torch.ops import pattern_dedup as pd

    if not hasattr(pd, "COUNTS"):
        raise RuntimeError("the program does not count its pattern route's work "
                           "(pattern_dedup.COUNTS), so the run cannot show which form "
                           "its iterations take")
    pd.reset_counts()
    session = train.setup(cell, inputs, device, tracer, seed)
    way = routes.route(session["trainer"].dataset)
    if way.kind != "pattern":
        raise RuntimeError(f"the rows took the {way.kind} route, not the pattern route")
    counts = way.order[2] if way.order is not None else ()
    sys.stderr.write(
        f"portbench: route {way.kind}, {way.pattern[1].shape[0]} patterns, "
        f"rows sorted by pattern: {way.order is not None}"
        + (f", segments of {min(counts)}-{max(counts)} rows" if counts else "") + "\n")
    _counted(cell.traffic["check_steps"], way)
    session["way"] = way
    return session


def window(cell, session: dict, seconds: float, tracer, device) -> dict:
    from ppca_rs_tpu_torch.ops import kernels

    out = train.window(cell, session, seconds, tracer, device)
    _counted(out["attempted"], session["way"])
    sys.stderr.write(f"portbench: per-sample factorizations (fullt) launched so far: "
                     f"{kernels.LAUNCHES['fullt']}\n")
    return out


def release(session: dict) -> None:
    train.release(session)
    session.pop("way", None)


def _first_halves(counts):
    """Rows of the first half of each segment, and the halves' counts."""
    halves, rows, start = [], [], 0
    for c in counts:
        h = max(c // 2, 1) if c else 0
        halves.append(h)
        rows.append(torch.arange(start, start + h))
        start += c
    return torch.cat(rows), halves


@contextlib.contextmanager
def plant(name: str):
    if name != "half":
        with faults._plant(name, "train"):
            yield
        return
    from ppca_rs_tpu_torch.ops import pattern_dedup as pd

    def half_sorted(orig):
        def em_stats_sorted(C, mean, sigma, data_sorted, weights_sorted, patterns, counts, *,
                            block_size):
            rows, halves = _first_halves(counts)
            rows = rows.to(data_sorted.device)
            stats = orig(C, mean, sigma, data_sorted.index_select(0, rows),
                         weights_sorted.index_select(0, rows), patterns, halves,
                         block_size=block_size)
            return faults._scaled(stats, sum(counts) / sum(halves), keep=())
        return em_stats_sorted

    def half_grouped(orig):
        def em_stats(C, mean, sigma, data, mask, pidx, patterns, weights, *, block_size):
            n = data.shape[0]
            h = max(n // 2, 1)
            return faults._scaled(orig(C, mean, sigma, data[:h], mask[:h], pidx[:h], patterns,
                                       weights[:h], block_size=block_size), n / h, keep=())
        return em_stats

    with faults._patched(pd, "em_stats_sorted", half_sorted), \
            faults._patched(pd, "em_stats", half_grouped):
        yield
