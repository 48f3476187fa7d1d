"""The operation and byte counts, and the per-layer readers on made-up traces."""

import pytest

from portbench import peaks, readers, tracing, transfer
from portbench.spec import Spec
from portbench.work import readout, spd_estep, stream, train


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


def _spans_view(work, untraced_unit_s=None):
    """Window 0-1000 ns: kernels 0-200 and 300-400, a host-to-device copy
    350-450 that the second kernel half hides, and a copy back that is no
    host-to-device copy; an EM step (statistics 0-250, M-step 250-500)
    and a readout verb 700-1000 with a block 700-850.  Busy (0, 200) and
    (300, 450); every program span has idle time in it."""
    device = [tracing.Interval("sm90_xmma_gemm", 0, 200, "kernel"),
              tracing.Interval("spd_estep_tile_kernel", 300, 400, "kernel"),
              tracing.Interval("Memcpy HtoD (Pinned -> Device)", 350, 450, "gpu_memcpy"),
              tracing.Interval("Memcpy DtoH (Device -> Pageable)", 950, 950, "gpu_memcpy")]
    host = [tracing.Interval(name, a, b, "user_annotation") for name, a, b in (
        ("ppca.em_step", 0, 700), ("ppca.em_stats", 0, 250), ("ppca.block", 0, 250),
        ("ppca.em_finalize", 250, 500), ("ppca.readout", 700, 1000), ("ppca.block", 700, 850))]
    return tracing.TraceView((0, 1000), device, host, 2, 100,
                             {"D": 4, "k": 2, "M": 1, "rows": 100, "itemsize": 4}, work,
                             untraced_unit_s)


@pytest.mark.parametrize("metric", [m["name"] for m in Spec().bench["per_layer"]])
def test_each_metric_reader_file(metric):
    """Every per-layer reader reads above 0 on a trace with the program's
    spans and a copy from the host, with the work of its first cell."""
    spec = Spec()
    entry = [m for m in spec.bench["per_layer"] if m["name"] == metric][0]
    cells = entry.get("workloads", [w["name"] for w in spec.bench["workloads"]])
    value = spec.reader(metric).read(_spans_view(spec.cell(cells[0]).work))
    assert value is not None and value > 0


def test_copy_readers_by_hand():
    """The copy 350-450 runs alone 400-450: 50 ns exposed of the 1000 ns
    window, or of the two units' untraced 2 x 250 ns.  Its 100 rows of D=4
    are 100 x (16 + 4 + 4) bytes in 100 ns, 24 GB/s of the link's 64."""
    view = _spans_view(stream)
    assert transfer.copies(view) == [(350, 450)]
    assert transfer.exposed_ns(view) == 50
    assert transfer.copy_exposed_pct(view) == pytest.approx(5.0)
    assert transfer.h2d_roofline_pct(view) == pytest.approx(37.5)
    assert stream.h2d_bytes({"D": 1024, "itemsize": 4}, 1) == 5124
    view.untraced_unit_s = 250e-9
    assert transfer.copy_exposed_pct(view) == pytest.approx(10.0)
    view.device[1].end = 460   # a kernel now covers the whole copy
    assert transfer.copy_exposed_pct(view) == 0.0
    view.device = [iv for iv in view.device if "HtoD" not in iv.name]
    assert transfer.copy_exposed_pct(view) is None and transfer.h2d_roofline_pct(view) is None
