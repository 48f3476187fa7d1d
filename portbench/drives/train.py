"""Training traffic: resident EM through the program's trainer, as users
call it.

Set-up builds the trainer over the benchmark's rows and drives it from a
start made from the seed through ``check_steps`` iterations, in one
``trainer.train(start=..., callback=...)`` call: the window's own call on
the window's own data.  Those steps are what the reference follows.  The
window is one more ``train`` call from the model they gave, of as many
iterations as fill ``seconds`` at the set-up's pace; the llk reaches the
host every iteration through the callback.  ``em_iter_s`` is the window's
time over its iterations.  A traced run profiles whole iterations after the
window's first, for about ``trace_seconds``.
"""

from __future__ import annotations

import math

from .. import compare
from ..reference import ppca as ref
from ..reference.linalg import F64
from ..systems import common as sc
from . import common

#: The inputs carry a training start.
STARTS = True
#: The check compares the set-up's steps, not a pass of the window.
CHECK_AFTER_WINDOW = False
#: The numbers that decide ``correct`` (:func:`compare.train`).
NUMBERS = ("llk_rel", "param_rel")
#: The faults of :mod:`portbench.faults` this kind can have.
FAULTS = ("unchanged", "half", "alter")


def setup(cell, inputs: dict, device, tracer, seed: int) -> dict:
    dataset = sc.dataset(inputs)
    return steps(cell, cell.system.trainer(dataset), len(dataset), inputs, device, tracer)


def steps(cell, trainer, rows: int, inputs: dict, device, tracer) -> dict:
    """Drive ``trainer`` over its ``rows`` rows from the seed's start
    through ``check_steps`` iterations; the session the window takes."""
    prog, cfg, mix = cell.system, cell.config, cell.traffic
    start = prog.program_model(inputs["start"], cfg, device)
    llks, stamps = [], []

    def callback(it, metrics):
        stamps.append(common.now())
        llks.append(metrics.llk)

    common.sync(device)
    stamps.append(common.now())
    with tracer.span("portbench.train"):
        model = trainer.train(start=start, n_iters=mix["check_steps"], quiet=True,
                              callback=callback, **prog.train_options(cfg))
    common.sync(device)
    steps = [b - a for a, b in zip(stamps, stamps[1:])]
    pace = sum(steps[1:]) / len(steps[1:]) if len(steps) > 1 else steps[0]
    tracer.warm()
    return {"trainer": trainer, "model": model, "pace": pace, "checked_llks": llks,
            "checked_params": prog.program_params(model), "rows": rows}


def window(cell, session: dict, seconds: float, tracer, device) -> dict:
    pace = session["pace"]
    traced = max(1, round(cell.traffic["trace_seconds"] / pace)) if tracer.on else 0
    n = max(2, math.ceil(seconds / pace), traced + 2)
    prog, cfg = cell.system, cell.config
    llks, enter, leave = [], [], []

    def callback(it, metrics):
        enter.append(common.now())
        llks.append(metrics.llk)
        if tracer.on:
            if it == 1:
                tracer.start()
            elif it == 1 + traced:
                tracer.stop(units=traced, rows=traced * session["rows"])
            tracer.mark("portbench.iteration" if not tracer.done else None)
        leave.append(common.now())

    common.sync(device)
    t0 = common.now()
    leave.append(t0)
    with tracer.span("portbench.train"):
        model = session["trainer"].train(start=session["model"], n_iters=n, quiet=True,
                                         callback=callback, **prog.train_options(cfg))
    common.sync(device)
    t1 = common.now()
    del model
    steps = [b - a for a, b in zip(leave, enter)]   # each iteration, without the callback
    failed = sum(1 for v in llks if not math.isfinite(v))
    out = {"attempted": n, "failed": failed, "e2e": {"em_iter_s": (t1 - t0) / n}}
    if traced:
        inside = steps[1:1 + traced]
        outside = steps[1 + traced:]
        out["traced_vs_untraced"] = {
            "em_iter_s": (sum(inside) / len(inside), sum(outside) / max(len(outside), 1))}
        out["untraced_unit_s"] = sum(outside) / max(len(outside), 1)
    return out


def release(session: dict) -> None:
    for key in ("trainer", "model"):
        session.pop(key, None)


def forget(session: dict) -> None:
    """Nothing to free: a training cell's outputs are a few numbers."""


def outputs(session: dict) -> dict:
    """What the program's set-up steps produced: each step's llk per row and
    the parameters after the last."""
    return {"llks": session["checked_llks"], "params": session["checked_params"]}


def reference(cell, session: dict, inputs: dict, prec) -> dict:
    """The reference's steps from the same start on the same rows."""
    llks, params = ref.em(prec, inputs["start"], inputs["data"], inputs["mask"],
                          cell.traffic["check_steps"])
    n = inputs["data"].shape[0]
    return {"llks": [v / n for v in llks], "params": params}


def compare_to(cell, outs: dict, want: dict) -> dict:
    return compare.train(outs["llks"], outs["params"], want["llks"], want["params"])


def check(cell, session: dict, inputs: dict) -> dict:
    """The set-up's steps against the reference's in float64; see
    :func:`compare.train`."""
    return compare_to(cell, outputs(session), reference(cell, session, inputs, F64))
