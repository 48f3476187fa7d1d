"""The pattern route's cell (``pattern_k64.train``) at CPU sizes: its own
``half`` fault on both forms of the route, its route, and the operation
and byte counts of ``work/pattern.py`` by hand."""

import pytest

from portbench import faults, harness, peaks
from portbench.tests import small
from portbench.work import pattern, spd_estep

CELL = "pattern_k64.train"
FORMS = ("sorted", "grouped")


def _form(form, monkeypatch):
    """At the CPU cut (64 rows a segment) the route is grouped; the sorted
    form with the segment gate lowered."""
    from ppca_rs_tpu_torch.config import config

    if form == "sorted":
        monkeypatch.setattr(config, "pat_sorted_min_rows", 16)


@pytest.mark.parametrize("form", FORMS)
def test_sound_run_on_both_forms(form, monkeypatch, capfd):
    _form(form, monkeypatch)
    result = harness.execute(small.cell(CELL), 2 ** 33 + 17, 0.05, False, "cpu")
    assert result["correct"] is True
    err = capfd.readouterr().err
    assert f"route pattern, 32 patterns, rows sorted by pattern: {form == 'sorted'}" in err
    assert "(fullt) launched so far: 0" in err


@pytest.mark.parametrize("form", FORMS)
def test_half_fails_the_limits_on_both_forms(form, monkeypatch):
    """Half of each segment's rows (the grouped form: half of the rows), the
    sums doubled: not correct, by the limits."""
    _form(form, monkeypatch)
    cell = small.cell(CELL)
    with faults.plant("half", "pattern"):
        result = harness.execute(cell, 2 ** 33 + 19, 0.05, False, "cpu")
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_first_halves_of_segments():
    from portbench.drives import pattern as drive

    rows, halves = drive._first_halves([4, 1, 0, 5])
    assert halves == [2, 1, 0, 2]
    assert rows.tolist() == [0, 1, 4, 5, 6]


def test_work_counts_by_hand():
    """D=4, k=2: a row b = R C and R^T (w s) 16 each, s = b Sigma_p 8, the
    segment Gram 6, row sums 24; an iteration's row solves 4 x (8/3 + 8);
    the per-pattern work left out."""
    sizes = {"D": 4, "k": 2, "M": 1, "rows": 10, "itemsize": 4}
    per_row = 16 + 16 + 8 + 6 + 24
    solves = 4 * (8 / 3 + 8)
    assert pattern.useful_flops(sizes, 2, 20) == 20 * per_row + 2 * solves
    assert pattern.hbm_bytes(sizes, 2, 20) == 20 * 5 * 4
    assert pattern.estep_launches(sizes, 2, 20) == [("states", 8, False)]


def test_left_out_work_at_the_cell():
    """What the counts leave out at the cell's 32 patterns, as their
    docstring gives it: the patterns' Grams and ``full`` factorizations
    0.05% of the operations, the ``full`` launch's least time 8% of the
    ``states`` launch's."""
    sizes = {"D": 1024, "k": 64, "M": 1, "rows": 1_000_000, "itemsize": 4}
    P, D, k = 32, 1024, 64
    left = P * (D * k * (k + 1) + spd_estep.ops("full", k))
    assert 1.3e8 < left < 1.5e8
    assert left / pattern.useful_flops(sizes, 1, 1_000_000) < 6e-4
    full = peaks.bound_s(*spd_estep.launch("full", P, k))
    states = peaks.bound_s(*spd_estep.launch("states", D, k))
    assert 0.07 < full / states < 0.095


def test_work_at_the_cell():
    """One iteration at the cell's sizes: 4,100,000,000 bytes read (about
    1.2 ms at 3.35 TB/s) and about 0.28 TFLOP (about 0.6 ms at 495
    TFLOP/s): the route's least time is the read of the sorted values."""
    sizes = {"D": 1024, "k": 64, "M": 1, "rows": 1_000_000, "itemsize": 4}
    nbytes = pattern.hbm_bytes(sizes, 1, 1_000_000)
    flops = pattern.useful_flops(sizes, 1, 1_000_000)
    assert nbytes == 4_100_000_000
    assert 2.7e11 < flops < 2.9e11
    assert peaks.bound_s(nbytes, flops) == pytest.approx(nbytes / peaks.PEAK_BYTES_PER_S)


def test_a_program_that_does_not_count_the_route_stops_at_setup(monkeypatch):
    """Without ``pattern_dedup.COUNTS`` the run cannot show which form its
    iterations take: it stops at set-up, before any step."""
    from ppca_rs_tpu_torch.ops import pattern_dedup as pd

    monkeypatch.delattr(pd, "COUNTS")
    steps = []
    monkeypatch.setattr(pd, "compute_tables", lambda *a, **kw: steps.append(a))
    with pytest.raises(RuntimeError, match="does not count"):
        harness.execute(small.cell(CELL), 2 ** 33 + 23, 0.05, False, "cpu")
    assert steps == []
