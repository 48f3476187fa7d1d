#!/usr/bin/env python3
"""Check and time the E-step tile and the panel design of ppca_rs_tpu_torch's
SPD kernels on the card, against their plain PyTorch versions and against
another version of the kernel sources.

    python3 tools/torch_panel_ab.py check
    python3 tools/torch_panel_ab.py time --other DIR[:LABEL] [--other ...] [--cases ...]
    python3 tools/torch_panel_ab.py sampler --other DIR[:LABEL] [--other ...]

``check`` launches every spd_estep variant and spd_chol through the
package's wrappers at state sizes served by the tile design (float32 k in
{2, 8, 13, 16, 24, 50, 64, 99, 128}, float64 k in {2, 8, 13, 16, 24, 50,
64}, and spd_chol also at float64 k in {65, 99, 128}: each padded size,
ragged and not) and by the panel design (float32 k in {131, 160, 257, 512,
704}, float64 k in {65, 99, 128, 160, 257, 704} for spd_estep, {160, 257,
704} for spd_chol; 704 takes the chunked staging), on inputs with three all-masked samples and one negative-definite
sample, into NaN-prefilled outputs, and holds each against its plain
version in float64 (1e-4 relative to each output's largest magnitude in
float32, 1e-10 in float64): the negative-definite sample must come back
non-finite in every written element and the others finite; of fullt's SM
only the lower triangle is compared, and the NaN above the diagonal must
still be there (the kernels write nothing above it).

``time`` builds the ``.cu`` sources of each DIR (another checkout's
``ppca_rs_tpu_torch/csrc``, or a changed copy of it, with the same C entry
points; a DIR whose ``spd_estep.cu`` predates G's layout argument is
called without it, on square G) into a library of its own and times the
same launches through
every library into the same preallocated outputs, in turns (the others,
this checkout twice, the others in reverse order), CUDA events around 10
back-to-back launches after one (30 for the tile's shapes); the cases at
launch scale (k <= 16, B <= 4096, or chol at k <= 32: the mixture's
sampler) are also timed as those launches
captured in a CUDA graph and replayed, the device's time without the
host's cost of each launch between them.  By default the
tile's shapes -- every variant at float32 k in {50, 64, 128} (B=8192) and
k=32 at B=65,536 with a sigma per sample (the mixtures' blocks), float64
k=64 (B=8192), the launch-bound rows the main path also gives (full at
k=64 B=32, and k=64 B=256 and k=32 B=8 with a sigma per sample (the
mixture tables), states at k=64 B=1024
and k=32 B=4096), and every variant at k in {8, 16} (the one-block
sizes) -- then every variant at float32 k in {160, 256, 512} (B 8192,
8192, 512), float64 fullt at k in {96, 128, 160} (B 8192), and chol beside
torch.linalg.cholesky_ex (which the port never calls) and its bound
(chip_smoke.py's): the tile's float32 k
in {8, 16, 32, 50, 64, 99, 128} and float64 k in {64, 99, 128} (B 8192),
then the panel design's float32 k in {131, 160, 256, 257, 512}.  Prints
one ``[ab]`` line per case and a JSON list.

``sampler`` times the posterior sampler end to end through each library in
the same turns (the package's loaded library swapped, host clock around
calls ending in a device sync, three calls a turn): chip_smoke.py's
``[k128]`` readout -- ``infer`` + ``posterior_sampler`` + one draw of
8,192 rows at D=1024, k=128, 50% missing -- and ``posterior_sampler``
alone, and the mixture's sampler readout of ``mix_readouts`` --
``posterior_sampler`` (one spd_chol launch a component) and one draw of
8,192 rows at D=512, k=32, M=8, 80% observed -- with models from one
seeded init (chip_smoke.py trains them first; the factor's work does not
depend on it).

It needs a CUDA card and nvcc; the library of this checkout is built by the
package itself.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
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
#: Noise levels cycled over the batch where a case takes a sigma per sample.
SIGMA_LEVELS = (0.4, 0.7, 1.0, 1.3)
CHECK_F32 = (2, 8, 13, 16, 24, 50, 64, 99, 128, 131, 160, 257, 512, 704)
CHECK_F64 = (2, 8, 13, 16, 24, 50, 64, 65, 99, 128, 160, 257, 704)
#: The sample made negative definite in the check.
NOT_PD = 5
TIME_F32 = ((160, 8192), (256, 8192), (512, 512))
TIME_F64 = ((96, 8192), (128, 8192), (160, 8192))
#: spd_chol: (k, B, dtype name), the tile's shapes, then the panel design's.
TIME_CHOL = ([(k, 8192, "f32") for k in (8, 16, 32, 50, 64, 99, 128)]
             + [(k, 8192, "f64") for k in (64, 99, 128)]
             + [(131, 8192, "f32"), (160, 8192, "f32"), (256, 2048, "f32"), (257, 1024, "f32"),
                (512, 512, "f32")])
#: The tile's shapes: (want, k, B, dtype name, sigma per sample).
TIME_TILE = ([(w, k, 8192, "f32", False) for k in (50, 64, 128) for w in kernels.WANTS]
             + [(w, 32, 65536, "f32", True) for w in kernels.WANTS]
             + [(w, 64, 8192, "f64", False) for w in kernels.WANTS]
             + [("full", 64, 32, "f32", False), ("full", 64, 256, "f32", True),
                ("full", 32, 8, "f32", True),
                ("states", 64, 1024, "f32", False), ("states", 32, 4096, "f32", False)]
             + [(w, k, 8192, "f32", False) for k in (8, 16) for w in kernels.WANTS])
REPS = 10
TILE_REPS = 30
TOL = {torch.float32: 1e-4, torch.float64: 1e-10}


def inputs(B: int, k: int, seed: int):
    """float64 masked E-step inputs (as chip_smoke.kernel_inputs makes
    them): Grams of a random C under a 50% mask, three all-masked samples."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    D = max(64, 4 * k)
    f64 = dict(dtype=torch.float64, device="cuda")
    C = torch.randn(D, k, generator=gen, **f64)
    mask = (torch.rand(B, D, generator=gen, device="cuda") < 0.5).double()
    mask[sorted({0, min(17, B - 1), B - 1})] = 0.0
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


def written(want: str, outs, refs):
    """The output elements the kernel writes, beside the plain version's,
    and whether the NaN prefill above fullt's diagonal survived: fullt's SM
    is compared on and below the diagonal only."""
    got, want_ = [], []
    untouched = True
    for i, (o, r) in enumerate(zip(outs, refs)):
        if want == "fullt" and i == 1:
            k = o.shape[-1]
            low = torch.ones(k, k, dtype=torch.bool, device=o.device).tril()
            untouched = bool(torch.isnan(o[:, ~low]).all())
            o, r = o[:, low], r[:, low]
        got.append(o)
        want_.append(r)
    return got, want_, untouched


def check() -> bool:
    ok = True
    for dtype, ks in ((torch.float32, CHECK_F32), (torch.float64, CHECK_F64)):
        tol = TOL[dtype]
        for k in ks:
            B = 64 if k > 512 else 256
            x64 = inputs(B, k, k)
            x64["G"][NOT_PD] = -(2.0 + SIGMA ** 2) * torch.eye(k, dtype=torch.float64, device="cuda")
            x = {n: t.to(dtype).contiguous() for n, t in x64.items()}
            xr = {n: t.double() for n, t in x.items()}
            good_rows = torch.ones(B, dtype=torch.bool, device="cuda")
            good_rows[NOT_PD] = False
            if kernels.design(k, "estep", dtype) == "tile":
                ctas, warps, samples = kernels.tile_occupancy(k, dtype)
                print(f"[check] tile k={k} {str(dtype)[6:]}: {ctas} CTAs of {warps} warps a "
                      f"multiprocessor ({ctas * warps} warps, {ctas * samples} samples in flight)",
                      flush=True)
            for want in kernels.WANTS:
                outs = tuple(torch.full(sh, math.nan, dtype=dtype, device="cuda")
                             for sh in kernels.output_shapes(want, B, k))
                kernels.launch(want, SIGMA, x["G"], x["b"], x["rnorm"], x["d_obs"], outs)
                torch.cuda.synchronize()
                ref = kernels.spd_estep_reference(SIGMA, xr["G"], xr["b"], xr["rnorm"],
                                                  xr["d_obs"], want)
                got, ref, untouched = written(want, outs, ref)
                errs = [rel_err(o[good_rows], r[good_rows]) for o, r in zip(got, ref)]
                finite = all(bool(torch.isfinite(o[good_rows]).all()) for o in got)
                poisoned = all(not bool(torch.isfinite(o[NOT_PD]).any()) for o in got)
                good = finite and poisoned and untouched and max(errs) <= tol
                ok &= good
                print(f"[check] {want} k={k} B={B} {str(dtype)[6:]} "
                      f"({kernels.design(k, 'estep', dtype)}): max rel err {max(errs):.3e} "
                      f"finite {finite}, not-PD sample non-finite {poisoned}"
                      f"{f', above the diagonal untouched {untouched}' if want == 'fullt' else ''} "
                      f"{'ok' if good else 'FAILED'}", flush=True)
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


def takes_layout(csrc: Path) -> bool:
    """Whether a version's spd_estep entry points take G's layout."""
    return "int layout" in (csrc / "spd_estep.cu").read_text()


def build_other(csrc: Path, out: Path, label: str) -> ctypes.CDLL:
    """Compile another version's kernel sources into ``out`` and load it
    with this package's entry-point types (without the layout argument
    where its sources predate it).  Its panel and tile kernels are
    compiled under other namespaces than this checkout's, so that both
    libraries' kernels keep their own attributes (and cached launch
    shapes) in one process."""
    cu = sorted(csrc.glob("*.cu"))
    objs = [out / f"{p.stem}.o" for p in cu]
    nvcc = _build.nvcc_path()
    _build._run_all([[nvcc, *_build.COMPILE_FLAGS, f"-Dpanel=panel_{label}",
                      f"-Dtile=tile_{label}", f"-I{csrc}", "-c", "-o", str(o), str(p)]
                     for p, o in zip(cu, objs)])
    lib_path = out / f"{label}.so"
    _build._run_all([[nvcc, *_build.LINK_FLAGS, "-o", str(lib_path), *map(str, objs)]])
    lib = ctypes.CDLL(str(lib_path))
    this = _build.load()
    layout = takes_layout(csrc)
    for name in ("spd_estep_f32", "spd_estep_f64", "spd_chol_f32", "spd_chol_f64"):
        types = list(getattr(this, name).argtypes)
        if name.startswith("spd_estep") and not layout:
            del types[-2]
        getattr(lib, name).argtypes = types
        getattr(lib, name).restype = ctypes.c_int
    lib.takes_layout = layout
    return lib


def estep_call(lib, want, sig, x, outs, scratch):
    """A launch of spd_estep through ``lib`` into ``outs``; ``sig`` holds one
    sigma or one per sample; G square, or (2-D) slabs."""
    G = x["G"]
    B, k = x["b"].shape
    layout = (kernels.LAYOUT_SLABS if G.ndim == 2 else kernels.LAYOUT_SQUARE,)
    if not getattr(lib, "takes_layout", True):
        layout = ()
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
        err = fn(kernels._WANT_CODE[want], torch.cuda.current_device(), ptr(sig),
                 0 if sig.numel() == 1 else 1, ptr(G),
                 ptr(x["b"]), ptr(x["rnorm"]), ptr(x["d_obs"]), ptr(s), ptr(m), ptr(llk),
                 ptr(sq), ptr(scratch), B, k, *layout, stream)
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


def graph_ms(make, reps: int) -> float:
    """ms a launch of ``reps`` launches of ``make()`` captured in one CUDA
    graph and replayed after one replay."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn = make()  # launches on the capturing stream
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


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


DTYPES = {"f32": torch.float32, "f64": torch.float64}


def default_cases():
    """(want, k, B, dtype, sigma per sample, slab G): the tile's shapes,
    then the panel design's, all on square G."""
    cases = [(want, k, B, DTYPES[dt], ps, False) for want, k, B, dt, ps in TIME_TILE]
    cases += [(want, k, B, torch.float32, False, False)
              for k, B in TIME_F32 for want in kernels.WANTS]
    cases += [("fullt", k, B, torch.float64, False, False) for k, B in TIME_F64]
    return cases + [("chol", k, B, DTYPES[dt], False, False) for k, B, dt in TIME_CHOL]


def parse_cases(text: str):
    """want:k:B:f32|f64[:ps][:slab],... -> cases (``ps``: a sigma per
    sample; ``slab``: G as slabs, through this checkout alone, beside its
    square G)."""
    out = []
    for item in text.split(","):
        want, k, B, dt, *rest = item.split(":")
        out.append((want, int(k), int(B), DTYPES[dt], "ps" in rest, "slab" in rest))
    return out


def time_ab(others, cases) -> list:
    """Each case through every library in turns: the others in order, this
    checkout twice, the others in reverse order; two readings each."""
    import chip_smoke as cs

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
        for want, k, B, dtype, per_sample, slab in cases:
            reps = TILE_REPS if k <= 128 else REPS
            graphed = k <= 16 or B <= 4096 or (want == "chol" and k <= 32)
            if want == "chol":
                M = spd_inputs(B, k, k + 1).to(dtype).contiguous()
                L = torch.empty_like(M)
                makes = {name: functools.partial(chol_call, lib, M, L)
                         for name, lib in libs.items()}
            else:
                x = {n: t.to(dtype).contiguous() for n, t in inputs(B, k, k).items()}
                if per_sample:
                    levels = torch.tensor(SIGMA_LEVELS, dtype=dtype, device="cuda")
                    sig = levels[torch.arange(B, device="cuda") % len(SIGMA_LEVELS)].contiguous()
                else:
                    sig = torch.full((1,), SIGMA, dtype=dtype, device="cuda")
                outs = kernels.empty_outputs(want, B, k, x["G"])
                scratch = kernels.empty_scratch(want, B, k, x["G"])
                makes = {name: functools.partial(estep_call, lib, want, sig, x, outs, scratch)
                         for name, lib in libs.items()}
                if slab:
                    xs = dict(x, G=cs.slab_of(x["G"]))
                    makes["this, slab G"] = functools.partial(
                        estep_call, libs["this"], want, sig, xs,
                        kernels.empty_outputs(want, B, k, xs["G"], slab=True), None)
            runs = {name: make() for name, make in makes.items()}
            turns = order + (["this, slab G", "this, slab G"] if slab else [])
            ms = {name: [] for name in makes}
            graph = {name: [] for name in makes}
            for name in turns:
                ms[name].append(events_ms(runs[name], reps))
                if graphed:
                    graph[name].append(graph_ms(makes[name], reps))
            row = dict(kernel=want, dtype=str(dtype)[6:], k=k, B=B, sigma_per_sample=per_sample,
                       slab=slab, ms=ms)
            line = ", ".join(f"{name} {'/'.join(f'{t:.4f}' for t in v)} ms"
                             for name, v in ms.items())
            if graphed:
                row["graph_ms"] = graph
                line += "; graph replay: " + ", ".join(
                    f"{name} {'/'.join(f'{t:.4f}' for t in v)} ms" for name, v in graph.items())
            if want == "chol":
                fn = lambda: torch.linalg.cholesky_ex(M)  # noqa: E731
                row["library_ms"] = [events_ms(fn, reps), events_ms(fn, reps)]
                line += (", torch.linalg.cholesky_ex "
                         + "/".join(f"{t:.4f}" for t in row["library_ms"]) + " ms")
                # chip_smoke.time_chol's bound: M's lower triangle in, L out whole
                peak = cs.peak_flops(k, "chol", dtype)
                row["bound_ms"], row["bound_by"] = cs.bound(
                    B * (k * (k + 1) // 2 + k * k) * dtype.itemsize, B * k ** 3 / 3, peak)
                line += "; " + cs.bound_note(row["bound_ms"], row["bound_by"], peak)
            rows.append(row)
            print(f"[ab] {want} k={k} B={B} {str(dtype)[6:]}"
                  f"{', sigma per sample' if per_sample else ''}: {line}", flush=True)
            del runs, makes
            torch.cuda.empty_cache()
    return rows


def time_sampler(others) -> list:
    """The sampler readouts through every library in turns (the others,
    this checkout twice, the others in reverse order)."""
    import chip_smoke as cs
    from ppca_rs_tpu_torch import PPCAMix, PPCAModel

    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for csrc, label in others:
            if not takes_layout(csrc):
                raise SystemExit(f"sampler: {csrc} predates G's layout argument, which the "
                                 "package's readouts pass")
            (Path(tmp) / label).mkdir()
            libs[label] = build_other(csrc, Path(tmp) / label, label)
        libs["this"] = _build.load()
        order = [label for _, label in others]
        order = order + ["this", "this"] + order[::-1]
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
        rows = cs.make_main_dataset(cs.N_WIDE_SAMPLER, cs.WIDE_K, cs.SEED + 10)
        model = PPCAModel.init(cs.WIDE_K, rows, generator=gen)
        mix_rows = cs.make_mix_dataset(n=cs.N_MIX_READOUT)
        mix = PPCAMix.init(cs.M_MIX, cs.K_MIX, mix_rows, generator=gen)
        mix_inferred = mix.infer(mix_rows)
        draw_gen = torch.Generator(device="cuda")

        def k128():
            inferred = model.infer(rows)
            inferred.posterior_sampler().sample(generator=draw_gen.manual_seed(1))

        def k128_sampler():
            return model.infer(rows)

        cases = {
            f"[k128] infer + posterior_sampler + one draw of {len(rows)} rows": (k128, None),
            "[k128] posterior_sampler alone": (lambda inf: inf.posterior_sampler(), k128_sampler),
            f"[mix] posterior_sampler of {len(mix_rows)} rows": (
                lambda inf: inf.posterior_sampler(), lambda: mix_inferred),
            f"[mix] posterior_sampler + one draw of {len(mix_rows)} rows": (
                lambda inf: inf.posterior_sampler().sample(generator=draw_gen.manual_seed(2)),
                lambda: mix_inferred),
        }
        out = []
        for name, (fn, setup) in cases.items():
            secs = {label: [] for label in libs}
            for label in order:
                _build._lib = libs[label]
                arg = setup() if setup else None
                for _ in range(4):   # one warm-up call, three timed
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn(arg) if setup else fn()
                    torch.cuda.synchronize()
                    secs[label].append(time.perf_counter() - t0)
                secs[label] = secs[label][:-4] + secs[label][-3:]
            _build._lib = libs["this"]
            print(f"[ab] {name}: " + ", ".join(
                f"{label} {'/'.join(f'{t * 1e3:.2f}' for t in v)} ms" for label, v in secs.items()),
                flush=True)
            out.append(dict(case=name, seconds=secs))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("check", "time", "sampler"))
    ap.add_argument("--other", action="append", default=[], metavar="DIR[:LABEL]",
                    help="another version's csrc directory (time, sampler; repeatable)")
    ap.add_argument("--cases", help="want:k:B:f32|f64[:ps],... (time; default: the list above)")
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
        ap.error(f"{args.mode} needs --other")
    others = []
    for i, spec in enumerate(args.other):
        path, _, label = spec.partition(":")
        others.append((Path(path), label or f"other{i}"))
    if args.mode == "sampler":
        print(json.dumps(time_sampler(others)))
        return 0
    cases = parse_cases(args.cases) if args.cases else default_cases()
    print(json.dumps(time_ab(others, cases)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
