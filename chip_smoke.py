#!/usr/bin/env python3
"""On-card smoke test of ppca_rs_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from the sources in the checkout and runs four
phases; any failed check raises and the script exits non-zero:

1. card: name and power limit, torch and CUDA versions, kernel build time;
2. every spd_estep kernel variant against its plain PyTorch version at
   B=8192, k in {2, 13, 64, 128}, in float64 and float32, on inputs with
   all-masked samples and NaN-prefilled outputs; the M-step row solve at
   lambda=0 with a singular row; requests above the shared-memory ceiling
   must raise; kernel and plain times side by side;
3. the main path at full width: masked PPCA EM at D=1024, k=64, 50% missing,
   N=1,048,576 float32 rows made on the card from a seed, five trainer
   iterations, then the llk, infer, covariance-diagonal, smooth and
   extrapolate readouts, with the kernel launch counts of that run;
4. one EM step and the per-sample llks of a 16,384-row slice on the card in
   float32 against the port's plain path on the CPU in float64.

The line before the last is the JSON kernel summary; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

SOURCE = "ppca_rs_tpu_torch/csrc/spd_estep.cu"
REPLACES = "ppca_rs_tpu/ops/kernels.py:501"  # spd_estep -> pl.pallas_call, body _make_kernel :176

BATCH = 8192
KS = (2, 13, 64, 128)
TIMED_K = 64
#: float64 kernel vs plain float64: only rounding-order differences.
TOL_F64 = 1e-10
#: float32 kernel vs plain float64 on the same inputs, relative to each
#: output's largest magnitude: ~1600 float32 ulps, room for the k-step
#: elimination chain times the condition number of these test matrices.
TOL_F32 = 1e-4
#: card float32 vs CPU float64 after one EM step and for the llks, relative
#: to each quantity's largest magnitude: float32 sums over D=1024 and over
#: 16,384 rows, and the llk quadratic form cancels by ~20x at this noise.
TOL_CARD_VS_CPU = 1e-3
#: EM never decreases the llk; float32 evaluation of it may wobble by this
#: much relative to its magnitude.
LLK_SLACK = 1e-5

N_MAIN = 1 << 20
D_MAIN = 1024
K_MAIN = 64
N_ITERS = 5
N_READOUT = 65536
N_CPU = 16384
SEED = 20261016


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def rel_err(got, want) -> float:
    """max |got - want| / max |want| in float64."""
    got, want = got.double(), want.double()
    scale = float(want.abs().max()) if want.numel() else 0.0
    return float((got - want).abs().max()) / max(scale, 1e-300) if want.numel() else 0.0


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------- #
# phase 1


def phase_card():
    from ppca_rs_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[card] {torch.cuda.get_device_name(0)}; python {sys.version.split()[0]}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    built = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load()
    print(f"[card] kernel library {_build.library_path().name}: "
          f"{'loaded' if built else 'built and loaded'} in {time.perf_counter() - t0:.2f} s")
    return smi


# --------------------------------------------------------------------- #
# phase 2


def kernel_inputs(B: int, k: int, gen):
    """float64 masked-PPCA E-step inputs: Grams of a random C under a 50%
    mask, with three all-masked samples."""
    D = max(64, 4 * k)
    f64 = dict(dtype=torch.float64, device="cuda")
    C = torch.randn(D, k, generator=gen, **f64)
    mask = (torch.rand(B, D, generator=gen, device="cuda") < 0.5).double()
    empty = [0, 17, B - 1]
    mask[empty] = 0.0
    R = torch.randn(B, D, generator=gen, **f64) * mask
    CC = (C[:, :, None] * C[:, None, :]).reshape(D, k * k)
    G = (mask @ CC).reshape(B, k, k)
    return dict(G=G, b=R @ C, rnorm=(R * R).sum(-1), d_obs=mask.sum(-1)), empty


def phase_kernels():
    from ppca_rs_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sigma = 0.7
    summary = {}
    for k in KS:
        inputs64, empty = kernel_inputs(BATCH, k, gen)
        for dtype, tol in ((torch.float64, TOL_F64), (torch.float32, TOL_F32)):
            x = {n: t.to(dtype).contiguous() for n, t in inputs64.items()}
            # the plain version in float64 on exactly the kernel's inputs
            x64 = {n: t.double() for n, t in x.items()}
            for want in kernels.WANTS:
                tag = f"{want} k={k} {str(dtype).replace('torch.', '')}"
                if k > kernels.max_k(want, dtype):
                    try:
                        kernels.spd_estep(sigma, x["G"], x["b"], x["rnorm"], x["d_obs"], want=want)
                    except ValueError as e:
                        print(f"[kernels] {tag}: refused above the ceiling "
                              f"(max k {kernels.max_k(want, dtype)}): {e}")
                        continue
                    raise RuntimeError(f"{tag}: launched above the shared-memory ceiling")
                outs = tuple(torch.full(sh, math.nan, dtype=dtype, device="cuda")
                             for sh in kernels.output_shapes(want, BATCH, k))
                kernels.launch(want, sigma, x["G"], x["b"], x["rnorm"], x["d_obs"], outs)
                torch.cuda.synchronize()
                ref = kernels.spd_estep_reference(sigma, x64["G"], x64["b"], x64["rnorm"],
                                                  x64["d_obs"], want)
                errs = [rel_err(o, r) for o, r in zip(outs, ref)]
                abs_err = max(float((o.double() - r).abs().max()) for o, r in zip(outs, ref))
                check(all(bool(torch.isfinite(o).all()) for o in outs),
                      f"{tag}: an output element was left unwritten or is non-finite")
                check(max(errs) <= tol, f"{tag}: relative errors {errs} above {tol}")
                # all-masked samples are neutral
                if want != "llk":
                    check(bool((outs[0][empty] == 0).all()),
                          f"{tag}: all-masked samples have nonzero states")
                llk = outs[-1] if want in ("states", "llk") else outs[2]
                check(float(llk[empty].abs().max()) <= 1e-3, f"{tag}: all-masked llk != 0")
                if want == "infer":
                    eye = torch.eye(k, dtype=dtype, device="cuda")
                    check(float((outs[1][empty] - eye).abs().max()) <= 1e-5,
                          f"{tag}: all-masked covariance != I")
                line = f"[kernels] {tag}: max rel err {max(errs):.3e} (tol {tol:g}), max abs err {abs_err:.3e}"
                if dtype == torch.float32:
                    G, b, rn, do = x["G"], x["b"], x["rnorm"], x["d_obs"]
                    plain = lambda: kernels.spd_estep_reference(sigma, G, b, rn, do, want)  # noqa: E731
                    kern = lambda: kernels.spd_estep(sigma, G, b, rn, do, want=want)  # noqa: E731
                    p1, k1, k2, p2 = (cuda_ms(plain, 5), cuda_ms(kern, 20),
                                      cuda_ms(kern, 20), cuda_ms(plain, 5))
                    line += (f"; kernel {k1:.3f}/{k2:.3f} ms, plain {p1:.3f}/{p2:.3f} ms "
                             f"(B={BATCH})")
                    if k == TIMED_K:
                        summary[want] = dict(max_abs_err=abs_err, ms=(k1 + k2) / 2,
                                             plain_ms=(p1 + p2) / 2)
                print(line)
            del x, x64
        del inputs64
        torch.cuda.empty_cache()

    # M-step row solve (S[d] + lambda I) c_d = cross[d] at lambda = 0, k = 13,
    # with one singular row (an empty dimension): that row alone goes
    # non-finite, for the keep-old-row fallback.
    D, k, bad = 1024, 13, 5
    for dtype, tol in ((torch.float64, TOL_F64), (torch.float32, TOL_F32)):
        V = torch.randn(D, k, 2 * k, generator=gen, dtype=torch.float64, device="cuda")
        S = V @ V.mT / (2 * k) + 0.05 * torch.eye(k, dtype=torch.float64, device="cuda")
        cross = torch.randn(D, k, generator=gen, dtype=torch.float64, device="cuda")
        S[bad] = 0.0
        cross[bad] = 0.0
        zeros = torch.zeros(D, dtype=dtype, device="cuda")
        S, cross = S.to(dtype), cross.to(dtype)
        outs = tuple(torch.full(sh, math.nan, dtype=dtype, device="cuda")
                     for sh in kernels.output_shapes("states", D, k))
        kernels.launch("states", 0.0, S, cross, zeros, zeros, outs)
        torch.cuda.synchronize()
        sol = outs[0]
        good = torch.ones(D, dtype=torch.bool, device="cuda")
        good[bad] = False
        want = torch.linalg.solve(S[good].double(), cross[good].double().unsqueeze(-1)).squeeze(-1)
        check(not bool(torch.isfinite(sol[bad]).all()), "row solve: singular row came back finite")
        check(bool(torch.isfinite(sol[good]).all()), "row solve: a regular row is non-finite")
        err = rel_err(sol[good], want)
        check(err <= tol, f"row solve {dtype}: relative error {err:.3e} above {tol}")
        print(f"[kernels] row solve lambda=0 k={k} D={D} {str(dtype).replace('torch.', '')}: "
              f"singular row non-finite only; max rel err {err:.3e} (tol {tol:g})")

    for dtype in (torch.float32, torch.float64):
        for want in kernels.WANTS:
            k = kernels.max_k(want, dtype) + 1
            G = torch.zeros(1, k, k, dtype=dtype, device="cuda")
            z = torch.zeros(1, dtype=dtype, device="cuda")
            try:
                kernels.spd_estep(1.0, G, torch.zeros(1, k, dtype=dtype, device="cuda"), z, z, want=want)
            except ValueError:
                continue
            raise RuntimeError(f"{want} {dtype}: k={k} above the ceiling was not refused")
    print("[kernels] every variant refuses k above its shared-memory ceiling "
          + ", ".join(f"{w}: f32 {kernels.max_k(w, torch.float32)}, f64 {kernels.max_k(w, torch.float64)}"
                      for w in kernels.WANTS))
    return summary


# --------------------------------------------------------------------- #
# phase 3


def make_main_dataset():
    """N_MAIN x D_MAIN float32 rows of a rank-K_MAIN PPCA model plus noise,
    50% of the entries missing at random, generated on the card."""
    from ppca_rs_tpu_torch import Dataset

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    opts = dict(generator=gen, device="cuda", dtype=torch.float32)
    C = torch.randn(D_MAIN, K_MAIN, **opts) * (2.0 / math.sqrt(K_MAIN))
    mean = torch.randn(D_MAIN, **opts)
    data = torch.empty(N_MAIN, D_MAIN, device="cuda", dtype=torch.float32)
    mask = torch.empty(N_MAIN, D_MAIN, device="cuda", dtype=torch.bool)
    step = 1 << 16
    for lo in range(0, N_MAIN, step):
        z = torch.randn(step, K_MAIN, **opts)
        y = z @ C.T + mean + 0.5 * torch.randn(step, D_MAIN, **opts)
        m = torch.rand(step, D_MAIN, generator=gen, device="cuda") >= 0.5
        data[lo:lo + step] = torch.where(m, y, torch.zeros_like(y))
        mask[lo:lo + step] = m
    return Dataset.from_parts(data, mask)


def phase_main(smi: str):
    from ppca_rs_tpu_torch import PPCATrainer
    from ppca_rs_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    dataset = make_main_dataset()
    torch.cuda.synchronize()
    print(f"[main] dataset N={len(dataset)} D={dataset.output_size()} k={K_MAIN} "
          f"{dataset.dtype}, observed share {float(dataset.mask.float().mean()):.4f}, "
          f"made in {time.perf_counter() - t0:.2f} s")

    llks, stamps = [], []

    def callback(it, metrics):
        stamps.append(time.perf_counter())
        llks.append(metrics.llk)
        print(f"[main] iteration {it}: llk/sample {metrics.llk:.6f}, "
              f"{stamps[-1] - stamps[-2]:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    model = PPCATrainer(dataset).train(
        state_size=K_MAIN, n_iters=N_ITERS, quiet=True, callback=callback,
        generator=torch.Generator(device="cuda").manual_seed(SEED + 2),
    )
    torch.cuda.synchronize()
    train_launches = dict(kernels.LAUNCHES)
    per_iter = [b - a for a, b in zip(stamps, stamps[1:])]
    check(all(math.isfinite(v) for v in llks), f"non-finite llk in {llks}")
    for a, b in zip(llks, llks[1:]):
        check(b >= a - LLK_SLACK * abs(a), f"llk decreased: {a} -> {b}")
    n_blocks = -(-N_MAIN // 8192)
    check(train_launches["fullt"] >= N_ITERS * n_blocks,
          f"fullt launches {train_launches['fullt']} < {N_ITERS * n_blocks}")
    check(train_launches["states"] >= N_ITERS,
          f"states launches {train_launches['states']} < {N_ITERS}")
    print(f"[main] launches during training: {train_launches}")
    print(f"[main] seconds per EM iteration at N={N_MAIN}: "
          + ", ".join(f"{s:.3f}" for s in per_iter)
          + f"; mean of iterations 2-{N_ITERS}: {sum(per_iter[1:]) / (N_ITERS - 1):.3f} s "
          f"({smi}); peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    t0 = time.perf_counter()
    total = model.llk(dataset)
    print(f"[main] model.llk: {total:.6e} ({total / N_MAIN:.6f} per sample), "
          f"{time.perf_counter() - t0:.3f} s")
    check(math.isfinite(total), "final llk is not finite")
    check(total / N_MAIN >= llks[-1] - LLK_SLACK * abs(llks[-1]),
          f"final llk/sample {total / N_MAIN} below the last iteration's {llks[-1]}")

    sub = dataset.slice(0, N_READOUT)
    inferred = model.infer(sub)
    states, covs = inferred.states(), inferred.covariances_array()
    sd = inferred.smoothed_covariances_diagonal(model).data
    ed = inferred.extrapolated_covariances_diagonal(model, sub).data
    smoothed = model.smooth(sub).data
    extrapolated = model.extrapolate(sub).data
    torch.cuda.synchronize()
    shapes = {"states": (states, (N_READOUT, K_MAIN)), "covariances": (covs, (N_READOUT, K_MAIN, K_MAIN)),
              "smoothed_cov_diag": (sd, (N_READOUT, D_MAIN)), "extrapolated_cov_diag": (ed, (N_READOUT, D_MAIN)),
              "smooth": (smoothed, (N_READOUT, D_MAIN)), "extrapolate": (extrapolated, (N_READOUT, D_MAIN))}
    for name, (t, shape) in shapes.items():
        check(tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != {shape}")
        check(bool(torch.isfinite(t).all()), f"{name} has non-finite values")
    check(bool((ed[sub.mask] == 0).all()), "extrapolation variance is nonzero at observed entries")
    check(bool((ed[~sub.mask] > 0).all()), "extrapolation variance is not positive at missing entries")
    check(bool((sd > 0).all()), "smoothed variance is not positive")
    check(bool((extrapolated[sub.mask] == sub.data[sub.mask]).all()),
          "extrapolate changed observed entries")
    print(f"[main] readouts on {N_READOUT} rows: shapes and finiteness ok, extrapolation "
          f"variance 0 at observed entries; mean smoothed sd {float(sd.sqrt().mean()):.4f}")
    return model, dataset, dict(kernels.LAUNCHES)


# --------------------------------------------------------------------- #
# phase 4


def phase_card_vs_cpu(model, dataset):
    from ppca_rs_tpu_torch import Dataset, PPCAModel
    from ppca_rs_tpu_torch.ops import kernels

    sub = dataset.slice(0, N_CPU)
    before = dict(kernels.LAUNCHES)
    card = model.iterate(sub)
    card_llks = model.llks(sub)
    torch.cuda.synchronize()
    check(kernels.LAUNCHES["fullt"] > before["fullt"] and kernels.LAUNCHES["llk"] > before["llk"],
          "the card run did not go through the kernels")

    host = PPCAModel._from_params(model.transform.cpu().double(), model.mean.cpu().double(),
                                  model.isotropic_noise.cpu().double())
    sub_cpu = Dataset.from_parts(sub.data.cpu().double(), sub.mask.cpu(), sub.weights_dev.cpu().double())
    t0 = time.perf_counter()
    cpu = host.iterate(sub_cpu)
    cpu_llks = host.llks(sub_cpu)
    secs = time.perf_counter() - t0
    diffs = {
        "transform": rel_err(card.transform.cpu(), cpu.transform),
        "mean": rel_err(card.mean.cpu(), cpu.mean),
        "isotropic_noise": rel_err(card.isotropic_noise.cpu().reshape(1), cpu.isotropic_noise.reshape(1)),
        "llks": rel_err(card_llks.cpu(), cpu_llks),
    }
    print(f"[card-vs-cpu] {N_CPU} rows, one EM step + llks, card float32 vs CPU float64 "
          f"plain path ({secs:.1f} s on the CPU): "
          + ", ".join(f"{n} {v:.3e}" for n, v in diffs.items())
          + f" (max rel diff, tol {TOL_CARD_VS_CPU:g})")
    for name, v in diffs.items():
        check(v <= TOL_CARD_VS_CPU, f"card vs CPU {name}: {v:.3e} above {TOL_CARD_VS_CPU}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if not (ROOT / "ppca_rs_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the ppca_rs_tpu_torch package is not beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import ppca_rs_tpu_torch  # noqa: F401  (sets full-float32 matmuls)

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are enabled")
    t_start = time.perf_counter()
    smi = phase_card()
    summary = phase_kernels()
    model, dataset, launches = phase_main(smi)
    phase_card_vs_cpu(model, dataset)
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")

    kernels_line = {"kernels": [
        {"name": f"spd_estep_{want}", "route": "cuda", "source": SOURCE, "replaces": REPLACES,
         "launches": launches[want], **summary[want]}
        for want in ("fullt", "states", "llk", "infer")
    ]}
    for entry in kernels_line["kernels"]:
        check(entry["launches"] > 0, f"{entry['name']} was not launched by the main path")
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
