#!/usr/bin/env python3
"""Check and time the panel design of ppca_rs_tpu_torch's SPD kernels on the
card, against its plain PyTorch version and against another version of the
kernel sources.

    python3 tools/torch_panel_ab.py check
    python3 tools/torch_panel_ab.py time --other DIR[:LABEL] [--other ...] [--cases ...]

``check`` launches every spd_estep variant and spd_chol through the
package's wrappers at state sizes served by the panel design (float32
k in {131, 160, 257, 512, 704}, float64 k in {65, 99, 160, 257, 704}; 704
takes the chunked staging) and holds each against its plain version in
float64 (1e-4 relative to each output's largest magnitude in float32,
1e-10 in float64).

``time`` builds the ``.cu`` sources of each DIR (another checkout's
``ppca_rs_tpu_torch/csrc``, or a changed copy of it, with the same C entry
points) into a library of its own and times the same launches through
every library into the same preallocated outputs, in turns (the others,
this checkout twice, the others in reverse order), CUDA events around 10
back-to-back launches after one: by default every variant at float32 k in
{160, 256, 512} (B 8192, 8192, 512), float64 fullt at k in {96, 128, 160}
(B 8192), and chol beside torch.linalg.cholesky_ex (which the port never
calls) at k in {131, 160, 256, 257, 512}.  Prints one ``[ab]`` line per
case and a JSON list.

It needs a CUDA card and nvcc; the library of this checkout is built by the
package itself.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from ppca_rs_tpu_torch.ops import _build, kernels  # noqa: E402

SIGMA = 0.7
CHECK_F32 = (131, 160, 257, 512, 704)
CHECK_F64 = (65, 99, 160, 257, 704)
TIME_F32 = ((160, 8192), (256, 8192), (512, 512))
TIME_F64 = ((96, 8192), (128, 8192), (160, 8192))
TIME_CHOL = ((131, 8192), (160, 8192), (256, 2048), (257, 1024), (512, 512))
REPS = 10
TOL = {torch.float32: 1e-4, torch.float64: 1e-10}


def inputs(B: int, k: int, seed: int):
    """float64 masked E-step inputs (as chip_smoke.kernel_inputs makes
    them): Grams of a random C under a 50% mask, three all-masked samples."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    D = max(64, 4 * k)
    f64 = dict(dtype=torch.float64, device="cuda")
    C = torch.randn(D, k, generator=gen, **f64)
    mask = (torch.rand(B, D, generator=gen, device="cuda") < 0.5).double()
    mask[[0, 17, B - 1]] = 0.0
    R = torch.randn(B, D, generator=gen, **f64) * mask
    G = torch.cat([(mask[i:i + 256, :, None] * C).mT @ C for i in range(0, B, 256)])
    return dict(G=G, b=R @ C, rnorm=(R * R).sum(-1), d_obs=mask.sum(-1))


def spd_inputs(B: int, k: int, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    V = torch.randn(B, k, 2 * k, generator=gen, dtype=torch.float64, device="cuda")
    return V @ V.mT / (2 * k) + 0.1 * torch.eye(k, dtype=torch.float64, device="cuda")


def rel_err(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-300)


def check() -> bool:
    ok = True
    for dtype, ks in ((torch.float32, CHECK_F32), (torch.float64, CHECK_F64)):
        tol = TOL[dtype]
        for k in ks:
            B = 64 if k > 512 else 256
            x64 = inputs(B, k, k)
            x = {n: t.to(dtype).contiguous() for n, t in x64.items()}
            xr = {n: t.double() for n, t in x.items()}
            for want in kernels.WANTS:
                outs = tuple(torch.full(sh, math.nan, dtype=dtype, device="cuda")
                             for sh in kernels.output_shapes(want, B, k))
                kernels.launch(want, SIGMA, x["G"], x["b"], x["rnorm"], x["d_obs"], outs)
                torch.cuda.synchronize()
                ref = kernels.spd_estep_reference(SIGMA, xr["G"], xr["b"], xr["rnorm"],
                                                  xr["d_obs"], want)
                errs = [rel_err(o, r) for o, r in zip(outs, ref)]
                finite = all(bool(torch.isfinite(o).all()) for o in outs)
                good = finite and max(errs) <= tol
                ok &= good
                print(f"[check] {want} k={k} B={B} {str(dtype)[6:]} "
                      f"({kernels.design(k, 'estep', dtype)}): max rel err {max(errs):.3e} "
                      f"finite {finite} {'ok' if good else 'FAILED'}", flush=True)
            M = spd_inputs(B, k, k + 1).to(dtype)
            L = torch.full_like(M, math.nan)
            kernels.launch_chol(M, L)
            torch.cuda.synchronize()
            err = rel_err(L, kernels.spd_chol_reference(M.double()))
            good = (bool(torch.isfinite(L).all()) and err <= tol
                    and bool((torch.triu(L, 1) == 0).all()))
            ok &= good
            print(f"[check] chol k={k} B={B} {str(dtype)[6:]} "
                  f"({kernels.design(k, 'chol', dtype)}): max rel err {err:.3e} "
                  f"{'ok' if good else 'FAILED'}", flush=True)
            del x64, x, xr, M, L
            torch.cuda.empty_cache()
    return ok


def build_other(csrc: Path, out: Path, label: str) -> ctypes.CDLL:
    """Compile another version's kernel sources into ``out`` and load it
    with this package's entry-point types.  Its panel kernels are compiled
    under another namespace than this checkout's, so that both libraries'
    kernels keep their own attributes in one process."""
    cu = sorted(csrc.glob("*.cu"))
    objs = [out / f"{p.stem}.o" for p in cu]
    nvcc = _build.nvcc_path()
    _build._run_all([[nvcc, *_build.COMPILE_FLAGS, f"-Dpanel=panel_{label}", f"-I{csrc}", "-c",
                      "-o", str(o), str(p)] for p, o in zip(cu, objs)])
    lib_path = out / f"{label}.so"
    _build._run_all([[nvcc, *_build.LINK_FLAGS, "-o", str(lib_path), *map(str, objs)]])
    lib = ctypes.CDLL(str(lib_path))
    this = _build.load()
    for name in ("spd_estep_f32", "spd_estep_f64", "spd_chol_f32", "spd_chol_f64"):
        getattr(lib, name).argtypes = getattr(this, name).argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib


def estep_call(lib, want, sig, x, outs, scratch):
    """A launch of spd_estep through ``lib`` into ``outs``."""
    G = x["G"]
    B, k, _ = G.shape
    s = m = sq = None
    if want == "llk":
        (llk,) = outs
    elif want == "states":
        s, llk = outs
    else:
        s, m, llk, sq = outs
    fn = lib.spd_estep_f32 if G.dtype == torch.float32 else lib.spd_estep_f64
    stream = torch.cuda.current_stream().cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    def run():
        err = fn(kernels._WANT_CODE[want], torch.cuda.current_device(), ptr(sig), 0, ptr(G),
                 ptr(x["b"]), ptr(x["rnorm"]), ptr(x["d_obs"]), ptr(s), ptr(m), ptr(llk),
                 ptr(sq), ptr(scratch), B, k, stream)
        if err != 0:
            raise RuntimeError(f"launch failed: {err}")
    return run


def chol_call(lib, M, L):
    fn = lib.spd_chol_f32 if M.dtype == torch.float32 else lib.spd_chol_f64
    stream = torch.cuda.current_stream().cuda_stream
    B, k, _ = M.shape

    def run():
        err = fn(torch.cuda.current_device(), M.data_ptr(), L.data_ptr(), B, k, stream)
        if err != 0:
            raise RuntimeError(f"launch failed: {err}")
    return run


def events_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def default_cases():
    cases = [(want, k, B, torch.float32) for k, B in TIME_F32 for want in kernels.WANTS]
    cases += [("fullt", k, B, torch.float64) for k, B in TIME_F64]
    return cases + [("chol", k, B, torch.float32) for k, B in TIME_CHOL]


def parse_cases(text: str):
    """want:k:B:f32|f64,... -> cases."""
    out = []
    for item in text.split(","):
        want, k, B, dt = item.split(":")
        out.append((want, int(k), int(B), torch.float32 if dt == "f32" else torch.float64))
    return out


def time_ab(others, cases) -> list:
    """Each case through every library in turns: the others in order, this
    checkout twice, the others in reverse order; two readings each."""
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for csrc, label in others:
            t0 = time.perf_counter()
            (Path(tmp) / label).mkdir()
            libs[label] = build_other(csrc, Path(tmp) / label, label)
            print(f"[ab] built {label} from {csrc} in {time.perf_counter() - t0:.1f} s", flush=True)
        libs["this"] = _build.load()
        order = [label for _, label in others]
        order = order + ["this", "this"] + order[::-1]
        rows = []
        for want, k, B, dtype in cases:
            if want == "chol":
                M = spd_inputs(B, k, k + 1).to(dtype).contiguous()
                L = torch.empty_like(M)
                runs = {name: chol_call(lib, M, L) for name, lib in libs.items()}
            else:
                x = {n: t.to(dtype).contiguous() for n, t in inputs(B, k, k).items()}
                sig = torch.full((1,), SIGMA, dtype=dtype, device="cuda")
                outs = kernels.empty_outputs(want, B, k, x["G"])
                scratch = kernels.empty_scratch(want, B, k, x["G"])
                runs = {name: estep_call(lib, want, sig, x, outs, scratch)
                        for name, lib in libs.items()}
            ms = {name: [] for name in libs}
            for name in order:
                ms[name].append(events_ms(runs[name], REPS))
            row = dict(kernel=want, dtype=str(dtype)[6:], k=k, B=B, ms=ms)
            line = ", ".join(f"{name} {'/'.join(f'{t:.4f}' for t in v)} ms"
                             for name, v in ms.items())
            if want == "chol":
                fn = lambda: torch.linalg.cholesky_ex(M)  # noqa: E731
                row["library_ms"] = [events_ms(fn, REPS), events_ms(fn, REPS)]
                line += (", torch.linalg.cholesky_ex "
                         + "/".join(f"{t:.4f}" for t in row["library_ms"]) + " ms")
            rows.append(row)
            print(f"[ab] {want} k={k} B={B} {str(dtype)[6:]}: {line}", flush=True)
            del runs
            torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("check", "time"))
    ap.add_argument("--other", action="append", default=[], metavar="DIR[:LABEL]",
                    help="another version's csrc directory (time; repeatable)")
    ap.add_argument("--cases", help="want:k:B:f32|f64,... (time; default: the list above)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    _build.load()
    print(f"[ab] this checkout's library loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.mode == "check":
        return 0 if check() else 1
    if not args.other:
        ap.error("time needs --other")
    others = []
    for i, spec in enumerate(args.other):
        path, _, label = spec.partition(":")
        others.append((Path(path), label or f"other{i}"))
    cases = parse_cases(args.cases) if args.cases else default_cases()
    print(json.dumps(time_ab(others, cases)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
