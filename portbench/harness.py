"""One run of one cell: set-up, the timed window, the traced reading, the
check against the reference, and the result line.

``main`` is the command line; it refuses to run without a CUDA card (or
with fewer cards than the cell asks for) and never falls back to the CPU.
``execute`` is the run itself, which the CPU tests drive with small sizes.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, Optional

#: Modules that no process of the benchmark may hold: JAX and the JAX
#: package, compared by whole top-level names.
FOREIGN = ("jax", "jaxlib", "flax", "ppca_rs_tpu")


def foreign_modules() -> list:
    return sorted({name for name in list(sys.modules) if name.split(".")[0] in FOREIGN})


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, started: float) -> int:
    args = parse(argv)
    _cache_dirs()
    from .spec import Spec

    cell = Spec().cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        log("portbench: no CUDA device: this benchmark measures the card and does not run "
            "on the CPU")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"portbench: {cell.name} needs {cell.chips} cards, found "
            f"{torch.cuda.device_count()}")
        return 3
    try:
        result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", started)
    except Exception:  # noqa: BLE001 - any failure is a run with no result
        traceback.print_exc()
        return 1
    bad = foreign_modules()
    if bad:
        log(f"portbench: modules of JAX or the JAX package were loaded: {bad}")
        return 4
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


def _cache_dirs() -> None:
    """The program's build directory is ``ppca_rs_tpu_torch/_build`` in the
    checkout; keep every other cache a library may write inside the
    checkout's own ignored directory, at a fixed path."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cache = os.path.join(root, "portbench", "_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ.setdefault(var, os.path.join(cache, sub))
    os.environ.setdefault("USE_FLAX", "0")


def execute(cell, seed: int, seconds: float, trace: bool, device: str,
            started: Optional[float] = None) -> Dict:
    """Run the cell once on ``device`` and return its result line as a dict
    (``checks`` last).  ``started`` is the process's start on the host
    clock (set-up is timed from it)."""
    import torch

    from .tracing import Tracer, breakdown

    started = time.perf_counter() if started is None else started
    marks = [("start", started)]
    _cache_dirs()
    from ppca_rs_tpu_torch.config import config as program_config

    program_config.device = torch.device(device)
    marks.append(("imports", time.perf_counter()))
    if torch.device(device).type == "cuda":
        from ppca_rs_tpu_torch.ops import _build

        _build.load()
        torch.zeros(1, device=device)
    marks.append(("kernel library and context", time.perf_counter()))
    gen = torch.Generator(device=device).manual_seed(seed)
    inputs = cell.system.make_inputs(cell.config, gen, device, train=cell.drive.STARTS)
    from .drives import common

    common.sync(device)
    marks.append(("inputs", time.perf_counter()))
    tracer = Tracer(trace, torch.device(device).type)
    drive = cell.drive
    session = drive.setup(cell, inputs, device, tracer, seed)
    common.sync(device)
    # what set-up made lives to the end: keep the collector from walking it
    # again and again in the window
    gc.collect()
    gc.freeze()
    marks.append(("program set-up and warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - started
    log(f"portbench: {cell.name} seed {seed}: set-up {setup_s:.3f} s: " + ", ".join(
        f"{name} {b - a:.3f} s" for (_, a), (name, b) in zip(marks, marks[1:])))

    out = drive.window(cell, session, seconds, tracer, device)
    cuda = torch.device(device).type == "cuda"
    peak = _peak_bytes() if cuda else 0
    view = tracer.view(cell.sizes(), cell.work)
    if view is not None:
        view.untraced_unit_s = out.get("untraced_unit_s")
    drive.release(session)
    common.release(device)

    t0 = time.perf_counter()
    readings = drive.check(cell, session, inputs)
    log(f"portbench: reference check {time.perf_counter() - t0:.3f} s")
    checks = {}
    for name, value in readings.items():
        limit = cell.limits[name]["limit"]
        checks[name] = {"value": value, "limit": limit}
    correct = (all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                   for c in checks.values())
               and out["attempted"] > 0 and out["failed"] == 0)

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    metrics = {}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": device_info}
    if not trace:
        values = dict(out["e2e"], setup_s=setup_s, peak_mem_gib=peak / 2**30)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for name, (inside, outside) in out.get("traced_vs_untraced", {}).items():
            log(f"portbench: tracing overhead: {name} traced {inside!r}, untraced {outside!r} "
                f"({(inside / outside - 1) * 100 if outside else float('nan'):+.2f}%)")
        if view is not None:
            for m in cell.per_layer:
                value = cell.reader(m["name"]).read(view)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            device_info["busy_s"] = view.busy_s()
            device_info["window_s"] = view.window_s
            result["breakdown"] = breakdown(view)
            _print_context(view)
    result["checks"] = checks
    return result


def _peak_bytes() -> int:
    """The most device memory the run's tensors held at once, over set-up
    and the window: the caching allocator's peak of requested bytes (its
    peak of allocated blocks also counts the unsplit tails of reused
    blocks, which vary with the allocation history from run to run; both
    are printed)."""
    import torch

    stats = torch.cuda.memory_stats()
    requested = int(stats.get("requested_bytes.all.peak", 0))
    allocated = torch.cuda.max_memory_allocated()
    log(f"portbench: device memory peak: requested {requested} B, allocated {allocated} B, "
        f"reserved {torch.cuda.max_memory_reserved()} B")
    return requested or allocated


def _print_context(view) -> None:
    """Lines beside the per-layer metrics: the E-step kernels' share of the
    SIMT float32 peak, and the device time by group."""
    from . import peaks
    from .tracing import is_gemm, is_spd
    from .work import spd_estep

    s = view.sizes
    spd_s = view.device_s(is_spd)
    if spd_s > 0:
        flops = sum(spd_estep.launch(w, n, s["k"], s["itemsize"], sig)[1]
                    for w, n, sig in view.work.estep_launches(s, view.units, view.rows))
        log(f"portbench: E-step kernels {spd_s:.6f} s, {flops / spd_s / 1e12:.3f} TFLOP/s = "
            f"{flops / spd_s / peaks.PEAK_F32_SIMT_FLOPS * 100:.3f}% of the "
            f"{peaks.PEAK_F32_SIMT_FLOPS / 1e12:g} TFLOP/s SIMT float32 peak")
    busy = view.busy_s()
    log(f"portbench: traced {view.units} units, {view.rows} rows in {view.window_s:.6f} s: "
        f"device busy {busy:.6f} s, GEMM {view.device_s(is_gemm):.6f} s, "
        f"spd_ {spd_s:.6f} s, kernels {len(view.kernels())}")
    log(f"portbench: time base of idle_pct and mfu_pct: {view.base_s():.6f} s untraced against "
        f"{view.window_s:.6f} s traced; idle on the traced window "
        f"{(1 - busy / view.window_s) * 100:.4f}%, on the base {(1 - busy / view.base_s()) * 100:.4f}%")
