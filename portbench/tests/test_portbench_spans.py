"""The readers that split the card's idle time by the program's spans
(``portbench/program_spans.py``), on made-up trace views and on the spans
a CPU run of the program records."""

import random

import numpy as np
import pytest
import torch

from portbench import program_spans, readers
from portbench.spec import Spec
from portbench.tracing import Interval, TraceView, Tracer

TRAIN = ("stats_idle_pct.train", "mstep_idle_pct.train", "loop_idle_pct.train")
READOUT = ("blocks_idle_pct.readout", "entry_idle_pct.readout")


def view(device, host, window=(0, 1000), untraced_unit_s=None):
    return TraceView(window, [Interval("k", a, b) for a, b in device],
                     [Interval(name, a, b, "user_annotation") for name, a, b in host],
                     units=1, rows=1, sizes={}, work=None, untraced_unit_s=untraced_unit_s)


def read_all(v, names):
    return {name: Spec().reader(name).read(v) for name in names}


# Window 0-1000 ns; every layout is busy 200 ns, so idle_pct reads 80 and a
# part reads 80 x its idle ns / 800.
LAYOUTS = {
    # gaps 0-100, 200-600, 700-1000; em_stats 50-400 and em_finalize
    # 400-650 each straddle a gap's edge: stats 50 + 200, M-step 200, loop
    # the other 350
    "train": ([(100, 200), (600, 700)],
              [("ppca.em_step", 0, 900), ("ppca.em_stats", 50, 400),
               ("ppca.block", 50, 150), ("ppca.block", 150, 300),
               ("ppca.em_finalize", 400, 650)],
              {"stats_idle_pct.train": 25.0, "mstep_idle_pct.train": 20.0,
               "loop_idle_pct.train": 35.0}),
    # the M-step (300-400) falls inside a busy interval: no idle time
    "train_busy_mstep": ([(250, 450)],
                         [("ppca.em_step", 0, 500), ("ppca.em_stats", 0, 300),
                          ("ppca.em_finalize", 300, 400)],
                         {"stats_idle_pct.train": 25.0, "mstep_idle_pct.train": 0.0,
                          "loop_idle_pct.train": 55.0}),
    # gaps 0-150, 250-350, 450-1000; blocks 100-300 and 300-500 inside the
    # verb 0-800: blocks 50 + 100 + 50, entry 100 + 300, and 800-1000 is
    # the benchmark's own, in neither
    "readout": ([(150, 250), (350, 450)],
                [("ppca.readout", 0, 800), ("ppca.block", 100, 300),
                 ("ppca.block", 300, 500)],
                {"blocks_idle_pct.readout": 20.0, "entry_idle_pct.readout": 40.0}),
}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_gaps_are_split_at_span_edges(layout):
    device, host, want = LAYOUTS[layout]
    v = view(device, host)
    assert readers.idle_pct(v) == pytest.approx(80.0)
    got = read_all(v, want)
    assert got == pytest.approx(want, abs=1e-12)


def random_view(seed):
    """An iteration-like timeline of made-up kernels and program spans, with
    an untraced base shorter than the window."""
    rnd = random.Random(seed)
    host, device, t = [], [], 0
    for _ in range(3):
        step = t
        t += rnd.randint(0, 50)
        stats = t
        for _ in range(rnd.randint(1, 6)):
            a = t
            t += rnd.randint(10, 200)
            host.append(("ppca.block", a, t))
        host.append(("ppca.em_stats", stats, t))
        final = t
        t += rnd.randint(10, 300)
        host += [("ppca.em_finalize", final, t), ("ppca.em_step", step, t)]
        t += rnd.randint(0, 100)
    for _ in range(40):
        a = rnd.randint(0, t)
        device.append((a, a + rnd.randint(1, 60)))
    return view(device, host, window=(0, t), untraced_unit_s=t * 0.97e-9)


@pytest.mark.parametrize("seed", range(6))
def test_train_parts_sum_to_idle_pct(seed):
    v = random_view(seed)
    parts = read_all(v, TRAIN)
    assert sum(parts.values()) == pytest.approx(readers.idle_pct(v), rel=1e-12, abs=1e-12)
    assert all(p >= 0 for p in parts.values())


@pytest.mark.parametrize("seed", range(6))
def test_readout_parts_at_most_idle_pct(seed):
    v = random_view(seed)
    v.host = [Interval("ppca.readout" if iv.name == "ppca.em_step" else iv.name, iv.start,
                       iv.end, iv.kind) for iv in v.host]
    parts = read_all(v, READOUT)
    assert 0 <= sum(parts.values()) <= readers.idle_pct(v) + 1e-12


@pytest.mark.parametrize("name", TRAIN + READOUT)
@pytest.mark.parametrize("missing", ["device", "spans"])
def test_nothing_to_read_is_none(name, missing):
    """No device interval (a CPU trace), or no program span (a program
    older than its spans): None, never 0."""
    device, host, _ = LAYOUTS["train" if name.endswith(".train") else "readout"]
    if missing == "device":
        device = []
    else:
        host = [("portbench.iteration", 0, 1000), ("aten::mm", 10, 20)]
    assert Spec().reader(name).read(view(device, host)) is None


def test_the_program_spans_reach_the_trace_view():
    """A CPU EM step of the program under the benchmark's tracer: its view's
    host ranges hold the program's spans, and with made-up device time the
    three training parts add up."""
    from ppca_rs_tpu_torch import interop
    from ppca_rs_tpu_torch.trainer import PPCATrainer

    rng = np.random.default_rng(4)
    mask = rng.random((64, 10)) > 0.3
    ds = interop.dataset_from_arrays(np.where(mask, rng.normal(size=(64, 10)), 0.0), mask)
    tracer = Tracer(True, "cpu")
    tracer.start()
    PPCATrainer(ds).train(state_size=2, n_iters=1, quiet=True,
                          generator=torch.Generator().manual_seed(1))
    tracer.stop(units=1, rows=64)
    v = tracer.view({}, None)
    names = {iv.name for iv in v.host}
    assert {"ppca.em_step", "ppca.em_stats", "ppca.em_finalize", "ppca.block"} <= names
    assert read_all(v, TRAIN) == dict.fromkeys(TRAIN)    # no device time
    lo, hi = v.window
    v.device = [Interval("k", lo + (hi - lo) // 3, lo + (hi - lo) // 2)]
    parts = read_all(v, TRAIN)
    assert sum(parts.values()) == pytest.approx(readers.idle_pct(v), rel=1e-12)
    assert parts["stats_idle_pct.train"] > 0


def test_part_of_an_instant():
    assert program_spans.train_part(frozenset({"ppca.em_step", "ppca.em_stats",
                                               "ppca.block"})) == "stats"
    assert program_spans.train_part(frozenset({"ppca.em_step"})) == "loop"
    assert program_spans.readout_part(frozenset({"ppca.block"})) is None
    assert program_spans.readout_part(frozenset({"ppca.readout", "ppca.block"})) == "blocks"
