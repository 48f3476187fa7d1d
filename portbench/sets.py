#!/usr/bin/env python3
"""Run a cell several times, each run a process of its own, and report the
spread of each metric (how the bounds in ``BENCHMARK.json`` are set):

    python3 portbench/sets.py --workload masked_k64.train --seeds 11,12,13,14,15,16 \\
        --sets 2 --out chiprun_out/sets.jsonl

Each set runs every seed once, in order; the sets repeat the same seeds.
For each metric it prints the values, the median and the spread (the
distance between the first and third quartiles of
``statistics.quantiles(values, n=4)`` over the median) of each set.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spread(values):
    if len(values) < 2:
        return float("nan")
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def run_one(workload: str, seed: int, seconds: float, trace: int, timeout: float) -> dict:
    cmd = [sys.executable, os.path.join(ROOT, "portbench", "run.py"), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    result = None
    if proc.returncode == 0 and lines:
        try:
            result = json.loads(lines[-1])
        except json.JSONDecodeError:
            result = None
    return {"workload": workload, "seed": seed, "trace": trace, "seconds": seconds,
            "rc": proc.returncode, "wall_s": wall, "result": result,
            "stderr_tail": proc.stderr[-4000:]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=1)
    p.add_argument("--seconds", type=float, default=None,
                   help="default: BENCHMARK.json's run_seconds")
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--timeout", type=float, default=1200)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    seconds = args.seconds
    if seconds is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
            seconds = json.load(fh)["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    print(f"# {card()}", flush=True)
    runs = []
    for k in range(args.sets):
        for seed in seeds:
            row = run_one(args.workload, seed, seconds, args.trace, args.timeout)
            row["set"] = k
            runs.append(row)
            res = row["result"]
            brief = ("no result, rc %d: %s" % (row["rc"], row["stderr_tail"][-1500:])
                     if res is None else json.dumps({"correct": res["correct"],
                                                     "metrics": res["metrics"],
                                                     "checks": res.get("checks")}))
            print(f"set {k} seed {seed} wall {row['wall_s']:.1f} s: {brief}", flush=True)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "a") as fh:
                    fh.write(json.dumps(row) + "\n")
    names = sorted({m for r in runs if r["result"] for m in r["result"]["metrics"]})
    for name in names:
        for k in range(args.sets):
            vals = [r["result"]["metrics"][name]["value"] for r in runs
                    if r["set"] == k and r["result"] and name in r["result"]["metrics"]]
            if vals:
                print(f"{args.workload} set {k} {name}: median {statistics.median(vals)!r} "
                      f"spread {spread(vals):.5f} values {vals}", flush=True)
    bad = [r for r in runs if not (r["result"] and r["result"]["correct"])]
    print(f"{args.workload}: {len(runs) - len(bad)} of {len(runs)} runs correct", flush=True)
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
