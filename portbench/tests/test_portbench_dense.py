"""The dense route's cell (``dense_k64.train``) at CPU sizes: a sound run
on the dense route, its own ``half`` fault and ``train``'s ``alter``, the
stop at set-up of a program that does not count the route, the operation
and byte counts of ``work/dense.py`` by hand, and the two readers that
read the route's spans and work."""

import pytest

from portbench import faults, harness, peaks
from portbench.spec import Spec
from portbench.tests import small
from portbench.tracing import Interval, TraceView
from portbench.work import dense

CELL = "dense_k64.train"
SIZES = {"D": 1024, "k": 64, "M": 1, "rows": 10_485_760, "itemsize": 4}


def test_sound_run_on_the_dense_route(capfd):
    """The program against the plain reference at a small size, from a
    seeded random start: correct, on the dense route, every row walked
    once a step."""
    result = harness.execute(small.cell(CELL), 2 ** 33 + 17, 0.05, False, "cpu")
    assert result["correct"] is True
    err = capfd.readouterr().err
    assert "route dense, 2048 rows" in err
    assert "dense route over 2 steps: {'posteriors': 2, 'blocks': 2, 'rows': 4096}" in err


@pytest.mark.parametrize("fault", ["half", "alter"])
def test_faults_fail_the_limits(fault):
    """Half of the rows weighted 0 and the rest 2, or a step's llk altered
    by 1e-3: the counts still hold, and the run is not correct, by the
    limits."""
    cell = small.cell(CELL)
    with faults.plant(fault, "dense"):
        result = harness.execute(cell, 2 ** 33 + 19, 0.05, False, "cpu")
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_half_walks_every_block_with_half_the_weight(monkeypatch):
    """The ``half`` plant hands ``em_stats`` every row, the first half
    weighted n / h and the rest 0."""
    import torch

    from ppca_rs_tpu_torch.ops import dense_fast as df

    seen = []
    monkeypatch.setattr(df, "em_stats", lambda *a, **kw: seen.append(a[4]))
    with faults.plant("half", "dense"):
        df.em_stats(None, None, None, torch.zeros(5, 2), torch.ones(5), block_size=4)
    assert seen[0].tolist() == [2.5, 2.5, 0.0, 0.0, 0.0]


def test_a_program_that_does_not_count_the_route_stops_at_setup(monkeypatch):
    """Without ``dense_fast.COUNTS`` the run cannot show which form its
    iterations take: it stops at set-up, before any step."""
    from ppca_rs_tpu_torch.ops import dense_fast as df

    monkeypatch.delattr(df, "COUNTS")
    steps = []
    monkeypatch.setattr(df, "em_stats", lambda *a, **kw: steps.append(a))
    with pytest.raises(RuntimeError, match="does not count"):
        harness.execute(small.cell(CELL), 2 ** 33 + 23, 0.05, False, "cpu")
    assert steps == []


def test_rows_that_take_another_route_stop_at_setup(monkeypatch):
    """Rows with a missing entry in every other row take another route (two
    mask patterns: the pattern route): the run stops at set-up."""
    from portbench.systems import dense as system

    def masked(inputs):
        from ppca_rs_tpu_torch import Dataset

        mask = inputs["mask"].clone()
        mask[::2, 0] = False
        return Dataset.from_parts(inputs["data"] * mask, mask)

    monkeypatch.setattr(system, "dataset", masked)
    with pytest.raises(RuntimeError, match="the pattern route, not the dense route"):
        harness.execute(small.cell(CELL), 2 ** 33 + 29, 0.05, False, "cpu")


def test_work_counts_by_hand():
    """D=4, k=2: a row b = R C and R^T (w s) 16 each, s = b M^-1 8, the
    shared second moment 6, row sums 24; an iteration's solve with D
    right-hand sides 2 x 4 x 4; no E-step launch."""
    sizes = {"D": 4, "k": 2, "M": 1, "rows": 10, "itemsize": 4}
    per_row = 16 + 16 + 8 + 6 + 24
    assert dense.useful_flops(sizes, 2, 20) == 20 * per_row + 2 * 32
    assert dense.hbm_bytes(sizes, 2, 20) == 20 * 5 * 4
    assert dense.estep_launches(sizes, 2, 20) == []


def test_work_at_the_cell():
    """One iteration at the cell's sizes: 42,991,616,000 bytes read (about
    12.8 ms at 3.35 TB/s) and about 2.9 TFLOP (about 5.9 ms at 495
    TFLOP/s): the step's least time is the read of the values."""
    nbytes = dense.hbm_bytes(SIZES, 1, SIZES["rows"])
    flops = dense.useful_flops(SIZES, 1, SIZES["rows"])
    assert nbytes == 10_485_760 * 1025 * 4
    assert 2.8e12 < flops < 3.0e12
    assert peaks.bound_s(nbytes, flops) == pytest.approx(nbytes / peaks.PEAK_BYTES_PER_S)
    assert 0.0125 < nbytes / peaks.PEAK_BYTES_PER_S < 0.0130


def view(device, host, work=dense):
    return TraceView((0, 1000), [Interval("k", a, b) for a, b in device],
                     [Interval(name, a, b, "user_annotation") for name, a, b in host],
                     units=1, rows=1, sizes={"D": 4, "k": 2, "M": 1, "rows": 1, "itemsize": 4},
                     work=work, untraced_unit_s=500e-9)


def test_readers_by_hand():
    """Window 0-1000 ns, busy 100-200 and 600-700, an untraced base of 500
    ns: idle 60% of the base.  The statistics pass 0-500 holds blocks
    50-150 and 150-300: of the 800 idle ns, 50 + 100 are in a block, so
    ``blocks_idle_pct.dense`` = 60 x 150 / 800.  The roofline: 20 bytes
    over 500 ns, of 3.35 TB/s."""
    v = view([(100, 200), (600, 700)],
             [("ppca.em_step", 0, 900), ("ppca.em_stats", 0, 500),
              ("ppca.block", 50, 150), ("ppca.block", 150, 300),
              ("ppca.em_finalize", 500, 650)])
    got = {name: Spec().reader(name).read(v) for name in ("blocks_idle_pct.dense",
                                                          "hbm_roofline_pct.dense")}
    assert got["blocks_idle_pct.dense"] == pytest.approx(60.0 * 150 / 800)
    assert got["hbm_roofline_pct.dense"] == pytest.approx(
        20 / 500e-9 / peaks.PEAK_BYTES_PER_S * 100)


@pytest.mark.parametrize("name", ["blocks_idle_pct.dense", "hbm_roofline_pct.dense"])
@pytest.mark.parametrize("missing", ["device", "spans"])
def test_readers_read_none_without_their_spans(name, missing):
    """No device interval (a CPU trace): both None.  No block span (a
    program older than the route's spans): the idle share None; the
    roofline reads the step's bytes over its time whatever the spans."""
    device = [] if missing == "device" else [(100, 200)]
    host = ([("ppca.em_step", 0, 900), ("ppca.em_stats", 0, 500), ("ppca.block", 50, 150)]
            if missing == "device" else [("portbench.iteration", 0, 1000)])
    got = Spec().reader(name).read(view(device, host))
    if missing == "device" or name == "blocks_idle_pct.dense":
        assert got is None
    else:
        assert got > 0
