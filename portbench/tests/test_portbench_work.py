"""The operation and byte counts, and the per-layer readers on made-up traces."""

import pytest

from portbench import peaks, readers, tracing
from portbench.spec import Spec
from portbench.work import readout, spd_estep, train


def test_spd_estep_counts_by_hand():
    # k=2: G's lower triangle 3, b 2, rnorm and d_obs 2 read; fullt writes s 2,
    # SM's lower triangle 3, llk and sq 2
    assert spd_estep.launch("fullt", 1, 2, itemsize=1) == (7 + 1 + 7, 8 + 12)
    assert spd_estep.launch("llk", 10, 2, itemsize=4, sigma_per_sample=True) == (
        (70 + 10 + 10) * 4, 10 * (8 / 3 + 4))
    assert spd_estep.launch("states", 1, 3, itemsize=1)[0] == 11 + 1 + 4
    assert spd_estep.launch("infer", 1, 2, itemsize=1)[0] == 7 + 1 + 8


def test_fullt_bound_at_the_main_path():
    """k=64 fullt on 8,192 samples: 42.0 us at 3.35 TB/s (PERF.md's table)."""
    nbytes, flops = spd_estep.launch("fullt", 8192, 64)
    assert peaks.bound_s(nbytes, flops) * 1e6 == pytest.approx(42.0, abs=0.02)


def test_useful_flops_by_hand():
    sizes = {"D": 4, "k": 2, "M": 1}
    fullt, states = 8 + 12, 8 / 3 + 8
    per_row = 2 * 4 * 2 * 3 + 3 * 2 * 4 * 2 + fullt
    assert train.useful_flops(sizes, 2, 3) == 3 * per_row + 2 * 4 * states
    assert train.useful_flops(dict(sizes, M=3), 1, 3) == 3 * (3 * per_row + 4 * states)
    assert readout.useful_flops(sizes, 5, 3) == 3 * (4 * 2 * 3 + 2 * 2 * 4 * 2 + states)
    assert train.estep_launches(dict(sizes, M=3), 2, 10) == [("fullt", 30, True),
                                                             ("states", 24, False)]
    assert readout.estep_launches(sizes, 1, 7) == [("llk", 7, False), ("states", 7, False)]


def _view(kernels, window=(0, 1000), units=2, rows=100, work=train):
    device = [tracing.Interval(n, a, b, "kernel") for n, a, b in kernels]
    host = [tracing.Interval("portbench.iteration", 0, 500, "user_annotation"),
            tracing.Interval("aten::item", 450, 520, "cpu_op")]
    return tracing.TraceView(window, device, host, units, rows,
                             {"D": 4, "k": 2, "M": 1, "rows": rows, "itemsize": 4}, work)


def test_readers_on_a_made_up_trace():
    view = _view([("sm90_xmma_gemm", 0, 300), ("spd_estep_tile_kernel<float>", 250, 400),
                  ("elementwise", 600, 700)])
    assert view.busy() == [(0, 400), (600, 700)]
    assert readers.idle_pct(view) == pytest.approx(50.0)
    assert readers.launches_per_unit(view) == 1.5
    assert readers.gemm_ms_per_unit(view) == pytest.approx(300e-9 / 2 * 1e3)
    flops = train.useful_flops(view.sizes, 2, 100)
    assert readers.mfu_pct(view) == pytest.approx(flops / 1e-6 / peaks.PEAK_TF32_FLOPS * 100)
    bound = sum(peaks.bound_s(*spd_estep.launch(w, n, 2, 4, s))
                for w, n, s in train.estep_launches(view.sizes, 2, 100))
    assert readers.estep_roofline_pct(view) == pytest.approx(bound / 150e-9 * 100)
    gaps = tracing.breakdown(view)["idle_gaps"]
    assert gaps[0][0] == "outside spans > host between ops" or gaps[0][1] > 0
    assert sum(t for _, t in gaps) == pytest.approx(500e-9)


def test_idle_and_mfu_take_the_untraced_time_base():
    """The profiler stretches the traced window with its own host work:
    idle and MFU divide by the untraced units' time where the run has it."""
    view = _view([("sm90_xmma_gemm", 0, 300), ("elementwise", 600, 700)])
    assert readers.idle_pct(view) == pytest.approx(60.0)
    view.untraced_unit_s = 250e-9   # two units untraced: 500 ns of the 1000 traced
    assert view.base_s() == pytest.approx(500e-9)
    assert readers.idle_pct(view) == pytest.approx(20.0)
    flops = train.useful_flops(view.sizes, 2, 100)
    assert readers.mfu_pct(view) == pytest.approx(flops / 500e-9 / peaks.PEAK_TF32_FLOPS * 100)


def test_readers_read_nothing_from_an_empty_trace():
    view = _view([])
    for reader in (readers.idle_pct, readers.launches_per_unit, readers.gemm_ms_per_unit,
                   readers.estep_roofline_pct, readers.mfu_pct):
        assert reader(view) is None


@pytest.mark.parametrize("metric", [m["name"] for m in Spec().bench["per_layer"]])
def test_each_metric_reader_file(metric):
    view = _view([("sm90_xmma_gemm", 0, 300), ("spd_estep_tile_kernel", 300, 400)])
    value = Spec().reader(metric).read(view)
    assert value is not None and value > 0
