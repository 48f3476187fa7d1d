#!/usr/bin/env python3
"""The readings the limits in ``portbench/limits/<cell>.json`` are set from,
at the cell's own size, on a CUDA card:

    python3 portbench/control.py --workload masked_k64.train --seeds 1,2,3 \\
        --program-seeds 1,2,3,4,5,6,7,8,9,10,11,12 --out chiprun_out/readings.jsonl

For each seed it makes the cell's inputs and the float64 reference, then
reads the numbers that decide ``correct`` for: the program (``program``:
its set-up, and one pass of the window where the kind's check follows one
(``CHECK_AFTER_WINDOW``), through the timed path's own calls); the control,
the reference in TF32 put in the program's place (``control``); and the
program with each fault the kind's drive names planted (``fault:<name>``,
:func:`portbench.faults.plant`).  The benchmark's
own runs never run this; the tests call :func:`readings` on the CPU with
small sizes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed: int, device: str, control: bool, faults) -> dict:
    """{what: {number: reading}} for one seed."""
    import torch

    from portbench import faults as fault_mod
    from portbench.drives import common
    from portbench.reference.linalg import F64, TF32
    from portbench.tracing import Tracer
    from ppca_rs_tpu_torch.config import config as program_config

    program_config.device = torch.device(device)
    drive, kind = cell.drive, cell.traffic["kind"]
    gen = torch.Generator(device=device).manual_seed(seed)
    inputs = cell.system.make_inputs(cell.config, gen, device, train=drive.STARTS)
    off = Tracer(False, torch.device(device).type)

    def program():
        session = drive.setup(cell, inputs, device, off, seed)
        if drive.CHECK_AFTER_WINDOW:
            drive.window(cell, session, 0.0, off, device)
        drive.release(session)
        common.release(device)
        return session

    out = {}
    session = program()
    want = drive.reference(cell, session, inputs, F64)
    out["program"] = drive.compare_to(cell, drive.outputs(session), want)
    drive.forget(session)
    common.release(device)
    if control:
        out["control"] = drive.compare_to(cell, drive.reference(cell, session, inputs, TF32), want)
    for name in faults:
        with fault_mod.plant(name, kind):
            broken = program()
        out[f"fault:{name}"] = drive.compare_to(cell, drive.outputs(broken), want)
        drive.forget(broken)
        common.release(device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="", help="seeds that also read the control and faults")
    p.add_argument("--program-seeds", default="", help="seeds that read the program alone")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from portbench.harness import _cache_dirs
    from portbench.spec import Spec

    _cache_dirs()
    cell = Spec().cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 3
    from ppca_rs_tpu_torch.ops import _build

    _build.load()
    faults = cell.drive.FAULTS
    full = [int(s) for s in args.seeds.split(",") if s]
    alone = [int(s) for s in args.program_seeds.split(",") if s and int(s) not in full]
    rows = []
    for seed in full + alone:
        t0 = time.perf_counter()
        got = readings(cell, seed, "cuda", seed in full, faults if seed in full else ())
        row = {"workload": args.workload, "seed": seed, "readings": got,
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")
    summary = {}
    for row in rows:
        for what, nums in row["readings"].items():
            for num, v in nums.items():
                key = (what, num)
                summary.setdefault(key, []).append(v)
    for (what, num), vals in sorted(summary.items()):
        print(f"{args.workload} {what:16s} {num:10s} min {min(vals):.3e} max {max(vals):.3e} "
              f"over {len(vals)} seeds", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
