"""Readout traffic: the fitted model read out over the whole resident table,
as the library documents its readout (``model.extrapolate(dataset)``,
``mix.infer_cluster(dataset)``, once over the fitted table).

The model is the one that generated the rows, built from the seed's
parameters.  A pass runs the mix's ``verbs`` once over every row of the
table's ``Dataset`` (for a single model ``llks`` then ``extrapolate``, for
a mixture ``infer_cluster`` then ``extrapolate``) and ends when its outputs
are synchronized on the card.  Set-up serves one pass, which warms every
shape and the device memory a pass holds.  The window serves whole passes
until ``seconds`` have passed; a pass's outputs are dropped as the next one
starts, as a client that has consumed them would.  ``readout_rows_per_s``
is the rows of the window's passes over its time on the host clock.

Every pass is checked.  One reduction on the card tells whether all its
outputs are finite (a pass whose outputs are not counts as failed), and
``check_rows`` rows drawn from the seed are gathered from its outputs to
the host.  The last pass's outputs stay whole.  After the window both are
compared with the reference: the sampled rows of every pass, and every row
of the last pass, block by block.  A traced run profiles whole passes after
the window's first, for about ``trace_seconds``.
"""

from __future__ import annotations

import statistics
import sys

import torch

from .. import compare
from ..reference import ppca as ref
from ..reference.linalg import F64
from ..systems import common as sc
from . import common

#: Rows a block of the check against the reference.
CHECK_BLOCK = 1 << 16

#: The inputs carry no training start: the model is the one that made the rows.
STARTS = False
#: The check compares the window's passes.
CHECK_AFTER_WINDOW = True
#: The numbers that decide ``correct`` (:class:`compare.ReadoutGap`).
NUMBERS = ("score_rel", "impute_rel")
#: The faults of :mod:`portbench.faults` this kind can have.
FAULTS = ("half", "alter")


def setup(cell, inputs: dict, device, tracer, seed: int) -> dict:
    prog = cell.system
    dataset = sc.dataset(inputs)
    model = prog.program_model(inputs["truth"], cell.config, device)
    verbs = [(name, prog.VERBS[name]) for name in cell.traffic["verbs"]]
    session = {"model": model, "verbs": verbs, "dataset": dataset, "rows": len(dataset),
               "gen": torch.Generator(device=device).manual_seed(seed)}
    common.sync(device)
    t0 = common.now()
    outs = serve(session, tracer)
    finite(outs).item()
    del outs
    common.sync(device)
    session["pass_s"] = common.now() - t0
    tracer.warm()
    return session


def serve(session: dict, tracer) -> dict:
    """One pass: each verb over the whole table."""
    outs = {}
    for name, verb in session["verbs"]:
        with tracer.span(f"portbench.readout.{name}"):
            outs[name] = verb(session["model"], session["dataset"])
    return outs


def finite(outs: dict) -> torch.Tensor:
    """Whether every output of a pass is finite, as a 0-dim tensor on the
    card: the sum of finite values of these sizes is finite, and a NaN or
    an infinity anywhere makes it not."""
    return torch.isfinite(torch.stack([o.sum() for o in outs.values()]).sum())


def window(cell, session: dict, seconds: float, tracer, device) -> dict:
    n_rows, mix = session["rows"], cell.traffic
    traced = max(1, round(mix["trace_seconds"] / session["pass_s"])) if tracer.on else 0
    flags, samples, times, raised, passes = [], [], [], 0, 0
    outs = None
    common.sync(device)
    t0 = last = common.now()
    while True:
        if tracer.on and passes == 1:
            tracer.start()
        tracer.mark("portbench.pass" if tracer.prof is not None and not tracer.done else None)
        outs = None   # the client is done with the last pass's outputs
        begin = common.now()
        try:
            outs = serve(session, tracer)
            idx = torch.randint(n_rows, (mix["check_rows"],), generator=session["gen"],
                                device=device)
            flags.append(finite(outs))
            samples.append((idx.cpu(), {k: v.index_select(0, idx).cpu()
                                        for k, v in outs.items()}))
        except RuntimeError:
            raised += 1
            outs = None
        common.sync(device)
        last = common.now()
        times.append(last - begin)   # the pass alone, without the profiler's start and stop
        passes += 1
        if tracer.on and passes == 1 + traced:
            tracer.stop(units=traced, rows=traced * n_rows)
        if last - t0 >= seconds and (tracer.done or not tracer.on):
            break
    per_pass = sorted(times)
    sys.stderr.write(f"portbench: {passes} passes of {n_rows} rows: seconds min {per_pass[0]:.4f}"
                     f" median {statistics.median(per_pass):.4f} max {per_pass[-1]:.4f}\n")
    not_finite = int((~torch.stack(flags)).sum()) if flags else 0
    session["kept"] = Served(samples, outs, n_rows)
    out = {"attempted": passes, "failed": raised + not_finite,
           "e2e": {"readout_rows_per_s": passes * n_rows / (last - t0)}}
    if traced:
        inside = times[1:1 + traced]
        outside = times[:1] + times[1 + traced:]
        out["traced_vs_untraced"] = {"pass_s": (statistics.fmean(inside),
                                                statistics.fmean(outside))}
        out["untraced_unit_s"] = statistics.fmean(outside)
    return out


class Served:
    """What the window's passes produced: the sampled rows of each pass
    (host tensors) and the last pass's outputs, whole."""

    def __init__(self, samples, last, n_rows: int):
        self.samples, self.last, self.n_rows = samples, last, n_rows

    def rows(self):
        return self.samples

    def block(self, lo: int, hi: int):
        return None if self.last is None else {k: v[lo:hi] for k, v in self.last.items()}


class Reference:
    """The same outputs computed by the reference at precision ``prec``, on
    the rows the program's passes were sampled at and on the whole table,
    one block at a time."""

    def __init__(self, prec, inputs: dict, served: Served):
        self.prec, self.inputs, self.served = prec, inputs, served
        self.n_rows = inputs["data"].shape[0]

    def _rows(self, rows):
        out = ref.readout(self.prec, self.inputs["truth"], self.inputs["data"][rows],
                          self.inputs["mask"][rows])
        return {"score": out["score"], "impute": out["impute"]}

    def rows(self):
        device = self.inputs["data"].device
        for idx, _ in self.served.samples:
            yield idx, self._rows(idx.to(device))

    def block(self, lo: int, hi: int):
        return self._rows(slice(lo, hi))


def release(session: dict) -> None:
    for key in ("model", "dataset", "verbs", "gen"):
        session.pop(key, None)


def forget(session: dict) -> None:
    """Free the last pass's whole outputs once they are judged (the sampled
    rows stay, for the comparisons that follow)."""
    session["kept"].last = None


def outputs(session: dict) -> Served:
    return session["kept"]


def reference(cell, session: dict, inputs: dict, prec) -> Reference:
    """The reference's outputs for every row the check compares."""
    return Reference(prec, inputs, session["kept"])


def compare_to(cell, outs, want) -> dict:
    """The sampled rows of every pass, then every row of the last pass, in
    blocks; see :class:`compare.ReadoutGap`."""
    gap = compare.ReadoutGap()
    got = list(outs.rows())
    if not got or len(got) != len(want.served.samples) or outs.block(0, 1) is None:
        return gap.failed()
    for (_, o), (_, w) in zip(got, want.rows()):
        gap.add(o, w)
    for lo in range(0, want.n_rows, CHECK_BLOCK):
        hi = min(lo + CHECK_BLOCK, want.n_rows)
        gap.add(outs.block(lo, hi), want.block(lo, hi))
    return gap.result()


def check(cell, session: dict, inputs: dict) -> dict:
    """Every pass's sampled rows and the last pass whole against the
    float64 reference."""
    return compare_to(cell, outputs(session), reference(cell, session, inputs, F64))

