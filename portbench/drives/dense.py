"""Training traffic on the dense route: resident EM of a single model over
fully observed rows (a configuration of ``model`` ``dense``), through the
program's trainer as users call it: ``Dataset.unmasked(data)``, then
``PPCATrainer(dataset).train(...)``.

Set-up, the window, ``em_iter_s`` and the check are :mod:`.train`'s; the
reference is :mod:`portbench.reference.ppca`'s masked EM over an all-True
mask, which knows nothing of the route's one shared factorization.  The
program counts the route's work (``dense_fast.COUNTS``), and the drive
holds the set-up's steps and the window's iterations to it: one shared
factorization a step, and every row walked once a step, in blocks of
``config.segment_rows`` rows.  A program that does not count it cannot show
which form its iterations take, and the run stops at set-up, before any
step, as it does when the rows take another route.  Set-up prints the
route and the counts.

Faults: ``unchanged`` and ``alter`` are :mod:`portbench.faults`' of
``train``.  ``half`` is this kind's own, so that the counts still hold:
the first half of the rows weighted n / h (2 for an even n) and the rest
0, so every block is walked while half of the rows are left out and the
sums over the rest doubled (zero-weight rows are neutral in every sum of
the route).
"""

from __future__ import annotations

import contextlib
import sys

from .. import faults
from . import train
from .train import (CHECK_AFTER_WINDOW, NUMBERS, STARTS, check, compare_to,  # noqa: F401
                    forget, outputs, reference)

FAULTS = train.FAULTS


def _counted(cell, steps: int, rows: int) -> None:
    """Hold ``dense_fast.COUNTS``, counted from 0, to ``steps`` statistics
    passes over ``rows`` rows, and reset it."""
    from ppca_rs_tpu_torch.config import config
    from ppca_rs_tpu_torch.ops import dense_fast as df

    block = config.segment_rows(cell.config["output_size"], cell.sizes()["itemsize"])
    want = {"posteriors": steps, "blocks": steps * -(-rows // block), "rows": steps * rows}
    sys.stderr.write(f"portbench: dense route over {steps} steps: {df.COUNTS}\n")
    if df.COUNTS != want:
        raise RuntimeError(f"the dense route counted {df.COUNTS} over {steps} steps, not {want}")
    df.reset_counts()


def setup(cell, inputs: dict, device, tracer, seed: int) -> dict:
    from ppca_rs_tpu_torch.models import routes
    from ppca_rs_tpu_torch.ops import dense_fast as df

    if not hasattr(df, "COUNTS"):
        raise RuntimeError("the program does not count its dense route's work "
                           "(dense_fast.COUNTS), so the run cannot show which form "
                           "its iterations take")
    dataset = cell.system.dataset(inputs)
    way = routes.route(dataset)
    if way.kind != "dense":
        raise RuntimeError(f"the rows took the {way.kind} route, not the dense route")
    sys.stderr.write(f"portbench: route {way.kind}, {len(dataset)} rows\n")
    df.reset_counts()
    session = train.steps(cell, cell.system.trainer(dataset), len(dataset), inputs, device,
                          tracer)
    _counted(cell, cell.traffic["check_steps"], len(dataset))
    return session


def window(cell, session: dict, seconds: float, tracer, device) -> dict:
    out = train.window(cell, session, seconds, tracer, device)
    _counted(cell, out["attempted"], session["rows"])
    return out


release = train.release


@contextlib.contextmanager
def plant(name: str):
    if name != "half":
        with faults._plant(name, "train"):
            yield
        return
    from ppca_rs_tpu_torch.ops import dense_fast as df

    def half(orig):
        def em_stats(C, mean, sigma, data, weights, **kw):
            n = data.shape[0]
            h = max(n // 2, 1)
            w = weights.clone()
            w[:h] *= n / h
            w[h:] = 0
            return orig(C, mean, sigma, data, w, **kw)
        return em_stats

    with faults._patched(df, "em_stats", half):
        yield
