#!/usr/bin/env python3
"""On-card smoke test of ppca_rs_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from the sources in the checkout and runs
fourteen phases; any failed check raises and the script exits non-zero:

1. card: name and power limit, torch and CUDA versions, kernel build time;
2. every spd_estep kernel variant and spd_chol against its plain PyTorch
   version at k in {2, 13, 24, 50, 64, 99, 128, 131, 160, 192, 256, 257,
   384, 512, 704} (B=8192 up to k=256, one single-model block's rows
   above: 1024 at 257, 512 at 384 and 512, 256 at 704), the
   tile designs up to the tile limits the library reports, the panel
   design above them (each k prints which design serves each kernel, the
   panel design's CTAs per multiprocessor and the tile's residency, the
   E-step's and spd_chol's),
   in float64 and float32, on inputs with all-masked (spd_estep) or non-SPD
   and identity (spd_chol) samples and NaN-prefilled outputs (fullt's SM
   compared on and below the diagonal, where alone it is written, and the
   NaN above it checked to be still there); a negative-definite sample
   that goes non-finite alone; a sigma per sample against scalar-sigma
   launches; the M-step row solve at lambda=0 with a singular row at k=13
   and k=256.  Each float32 kernel is timed by launches into preallocated
   outputs (CUDA events around 30 back-to-back launches, in turns with the
   plain version) and by its device time read by name from a torch.profiler
   window, beside its bound; spd_chol also beside torch.linalg.cholesky_ex,
   which the port never calls, and in float64 too at k=64, 99 and 128;
   ``full`` also at B=32 and ``states`` at
   B=1024, the pattern tables' and the row solve's shapes; fullt also at
   k=50 (rows not 16-byte aligned, beside k=64) and in float64 at k in
   {96, 128, 160}, and states and llk at k=96 (phase 11c's); G as slabs
   (the layout the masked and general mixture routes build,
   ``kernels.uses_slabs``): every variant at float32 k in {24, 32, 40, 64,
   72, 104, 128} and float64 k in {32, 40, 64}, with NaN in the slab
   entries above the diagonal (never read) and every output element
   NaN-prefilled and checked, against the plain version and bit for bit
   against square G, slab G refused at k=16 and above the tile, and
   fullt, llk, states and infer on slab G timed in turns with square G at
   k=32 (B=65,536, a sigma per sample), 64 and 128;
2b. the masked Gram kernel (``[gram]`` lines; ``kernels.mask_gram``, the
   bool mask times the Gram columns' three bf16 slices on the tensor cores,
   promoted into float32 sums): at the main path's shapes (B=8192, D=1024,
   slab k=64 and k=128: W=2304 and 8704; the mixture's D=512, 8 x 640) and
   ragged ones (B=131, D=80 and 257, k=24 and 40, k=13 square), its
   NaN-prefilled output against float64 (and the split kernel's slices bit
   for bit against its plain version), with the max relative error and
   the signed mean relative error of the Grams' diagonals beside the SIMT
   float32 product's and beside a library bf16 product of the K-stacked
   slices (``torch.mm(..., out_dtype=torch.float32)``, which the port never
   calls), each bounded (``TOL_GRAM``, ``TOL_GRAM_DIAG``: a lower-precision
   sum fails) and at the main path's shapes held to at most 1.5x the SIMT
   product's; the kernel timed at the main shapes and at k=256 (W=65,536,
   B=2048, the panel path's) beside its bound, the plain version, the
   library bf16 product (``library_ms``) and the SIMT product;
2c. the S kernel (``[S]`` lines; ``kernels.mask_s``, the M-step statistic
   mask^T (scale * SM) added into S: the bool mask against the scaled
   second moments' three bf16 slices, cut on chip, promoted into float32
   sums): at the main path's shapes (B=8192, D=1024, slab k=64 and 128;
   the mixture's D=512, 8 x 640; k=256's square columns at B=2048) and at
   a model-axis block's D=520 and ragged ones, on SM, weights and
   responsibilities from the port's own E-step, against float64, with the
   max relative error and the diagonal's signed mean relative error beside
   those of the SIMT float32 product the route ran, each bounded
   (``TOL_S``, ``TOL_S_DIAG``) and at the main path's shapes held to at
   most ``S_ERR_RATIO`` times the SIMT product's; the kernel timed at the
   main shapes beside its bound, the plain version and the SIMT product
   (``library_ms``); phases 3, 7 and 8 count its launches
   (``kernels.S_LAUNCHES``) and no library S;
3. the masked path at full width: masked PPCA EM at D=1024, k=64, 50%
   missing at random, N=1,048,576 float32 rows made on the card from a
   seed (pattern detection must demote them), five trainer iterations,
   then the llk, infer, covariance-diagonal, smooth and extrapolate
   readouts, with the kernel launch counts of that run (and of them those
   on slab G: every E-step; the M-step's row solves are square), and a
   profile of one more EM iteration (spd_estep, matmuls, the rest, device
   idle share);
4. one EM step and the per-sample llks of a 16,384-row slice on the card in
   float32 against the port's plain path on the CPU in float64;
5. the pattern path at full width: N=1,000,000, D=1024, k=64, rows drawn
   from P=32 Bernoulli(0.5) mask patterns (bench_suite.py's structured
   missingness), detection, five trainer iterations through the pattern
   tables (the ``full`` kernel, no per-sample factorization), the
   readouts, the posterior sampler (``spd_chol``) with a check of its
   draws' moments, two iterations on the pattern and on the general path
   from one start, and the phase-4 check on 16,384 structured rows;
6. the dense path: N=1,048,576 fully observed rows, five trainer
   iterations with no per-sample kernel, and one EM step of the dense path
   against the masked path on a 16,384-row slice;
7. the masked path at k=128 (bench_suite.py's "k128" configuration):
   D=1024, N=262,144 float32 rows, 50% missing at random, five trainer
   iterations, ``model.llk``, the posterior sampler on 8,192 rows with a
   check of its draws' moments, the launch counts of that run (every
   spd_estep variant but ``full``, and spd_chol, each checked to be served
   by the tile design), a profile of one more EM iteration, and
   the phase-4 check on 4,096 rows;
8. PPCA mixtures at bench_suite.py's mixture configuration: N=200,000,
   D=512, k=32, M=8 components, 80% observed at random, made on the card;
   five ``PPCAMixTrainer`` iterations (the general masked route: ``fullt``
   on M x 8,192 samples a launch, one sigma per sample, and one ``states``
   row solve over M x D rows an iteration), the llk, infer_cluster, infer,
   smooth, extrapolate and posterior-sampler readouts on 8,192 rows with
   the sampler's moment check, exact launch counts, a profile of one EM
   iteration, one EM step on 4,096 rows on the card in float32 against the
   CPU in float64 and against the per-component loop, a fully observed copy
   that takes the table route (``full``, no ``fullt``), and every kernel at
   the shapes this phase gave it against its plain version, with the
   components' sigmas stacked per sample checked against scalar launches;
9. out-of-core streaming (``[stream]`` lines): (a) phase 3's data as eight
   pinned host chunks of 131,072 rows passed as callables, three
   ``StreamingPPCATrainer`` iterations and the llk over the chunks (exact
   launch counts), one ``iterate_streamed`` at prefetch 0, 1 and 2 (timed,
   bit-identical, peak device memory, the prefetch=1 peak within two
   chunks plus 1 GiB), pageable chunks and the copy rates, and the same
   iteration on the data resident on the card (within 1e-4); (b) a fully
   observed, a pattern and a randomly masked chunk streamed against
   ``_em_step`` on their ``Dataset.concat`` (exact launch counts, 1e-4);
   (e) the resident data stored in bfloat16 against float32, and a
   streamed training traced through ``profile_dir``; (c) phase 8's mixture
   from four host chunks, ``StreamingPPCAMixTrainer`` and
   ``iterate_mix_streamed`` against ``PPCAMix._em_step`` (1e-4); (d) host
   packing: the native pass of ``Dataset()`` (``native/packing.py``)
   against its plain numpy version on a float64 array with NaN holes, in
   turns and bit for bit, the copy of its output to the card and
   ``Dataset()`` whole; the adapters' native scatter against numpy fancy
   assignment on a shuffled long frame, bit for bit, and
   ``DataFrameAdapter.from_pandas`` whole;
10. the sharded path (``[parallel]`` lines), in child processes of this
   script (``--parallel-child``) on this card, each held against a
   single-process run here from the same start (1e-4), the ranks against
   each other bit for bit, with exact per-rank launch counts: one job of
   two gloo ranks (NCCL takes no two ranks on one device) runs (a) phase
   3's rows split 524,289 + 524,287 by ``shard_dataset_local``, three
   ``PPCATrainer`` iterations, ``model.llk``, infer and the sampler on
   8,192 local rows, and the statistics all_reduce timed alone; (c) D on a
   1x2 model axis over 65,536 rows: two iterations, llks and extrapolate
   on each rank's columns, the per-block all_reduce timed alone; (d) phase
   5's data, 500,000 rows a rank: collective ``detect_patterns`` (the
   single-process table), the sorted EM on each rank, two iterations; (e)
   phase 8's mixture, two ``PPCAMixTrainer`` iterations, ``infer_cluster``;
   (f) 4 of 9a's pinned chunks streamed on each rank, one statistics
   all_reduce per pass.  A job of one NCCL rank through ``initialize()``'s
   default backend runs (b): ``iterate`` on a 1x1 mesh equals ``_em_step``
   bit for bit;
11. state sizes past the register tiles (``[large-k]`` lines), each with
   exact launch counts and the design serving each kernel: (a)
   bench_suite.py's k=256 row, D=1024, N=131,072 float32 rows 50% missing
   at random, three ``PPCATrainer`` iterations (2,048-row blocks),
   ``model.llk``, infer, smooth and extrapolate on 8,192 rows, the sampler
   on 2,048 rows with the moment check, a profile of one more iteration,
   and card vs CPU float64 on 256 rows; (e) the pattern route at k=256
   (``full`` on 8 tables) against the general route on 32,768 rows; (b)
   the k=512 row, N=32,768 (512-row blocks): two iterations,
   ``model.llk``, the sampler on 512 rows, card vs CPU on 64 rows; (c)
   float64 on the card at k=96 over 4,096 rows, one EM step against the
   CPU in float64 within 1e-8; (d) a mixture of state sizes (192, 160) at
   D=512 over 16,384 rows, two ``PPCAMixTrainer`` iterations, one fused EM
   step against the per-component loop (1e-4), ``infer_cluster``'s
   posteriors against the components' own llks (1e-3), and one EM step,
   the llks and ``infer_cluster`` on 256 rows, card vs CPU float64 (1e-3);
12. a structured mixture (``[patmix]`` lines), the JAX package's
   pattern-mixture measurement: M=8 components, k=64, D=1024, N=262,144
   float32 rows from P=32 mask patterns (N / P = 8,192, the sorted EM's
   gate): detection and the sorted copy, four ``PPCAMixTrainer``
   iterations on the default route, the per-segment EM (``full`` on the
   M x P tables and ``states`` in the M-step, counted exactly), a profile
   of one more iteration, the per-segment EM against the table-grouped EM
   on the same parameters at 8,192, 4,096, 2,048, 1,024 and 256 rows a segment
   (times in turns; statistics and the EM step from them within 1e-4 at
   the gate), the per-segment statistics of 512 sorted rows on the card in
   float32 against the CPU in float64 (1e-3), and ``full`` and ``states``
   at this phase's shapes against their plain versions, timed;
13. the nine examples of ``examples/torch_port/`` on the card with
   ``--device cuda`` in smoke mode, started together; each must exit 0;
14. the reference's test themes through the kernels (``[themes]`` lines):
   (a) state size 0 (a noise-only model) on the masked, pattern and dense
   routes over 65,536 rows at D=1024, with its sampler, mixtures of (0, 0)
   and (0, 8) components and two streamed chunks: one EM step, the llks
   and infer on the card in float32 against the CPU in float64, with no
   launch at k=0; (b) the reference's golden anchors (quadratic form
   34.219288, log det -3.49328, the toy llk) in float64 through the
   ``infer`` and ``llk`` kernels at k=2; (c) near-noiseless float32: exact
   low-rank data with the model at the truth and sigma=1e-4, three EM
   steps each on the masked route at k=64 (262,144 rows) and k=256
   (32,768 rows, the panel design), the pattern and dense routes at k=64,
   a general mixture (M=8, k=32, D=512) and phase 12's structured
   mixture, sigma finite, >= 0 and < 1e-2 after every step; the dense
   route with a mean offset of 1e3 against the CPU in float64; (d)
   recovery of a planted model (D=1024, k=64, sigma=1, signal eigenvalues
   40 down to 4) from 1,048,576 rows drawn 50% missing on the card, 30
   iterations, its largest principal angle and sigma; (e) 24 seeded draws
   (k from 0 to 257, N from 1 to 20,000, D up to 1024, 0-90% missing,
   all-masked rows, empty dimensions, zero weights, random priors), one
   EM step, the llks, infer, smooth and the sampler's factor on the card
   against the CPU in float64.

The line before the last is the JSON kernel summary (the tile's kernels
on the main path, with phase 12's ``full`` and ``states`` under
``at_patmix`` and spd_chol's float64 times under ``at_f64``, then the panel
design's kernels on phase 11's path; fullt, llk, states and infer, which
the routes launch on slab G, carry ``slab_launches``, ``layout`` and the
same launches' times on square G under ``square``); the
last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent

#: spd_estep's and spd_chol's sources by design (``kernels.design``): the
#: tile (spd_chol is its sixth variant) and the panel design above it.
ESTEP_SOURCE = {"tile": "ppca_rs_tpu_torch/csrc/spd_estep_tile.cuh",
                "panel": "ppca_rs_tpu_torch/csrc/spd_panel.cuh"}
ESTEP_REPLACES = "ppca_rs_tpu/ops/kernels.py:502"  # spd_estep -> pl.pallas_call, body _make_kernel :176
CHOL_SOURCE = {"tile": "ppca_rs_tpu_torch/csrc/spd_estep_tile.cuh",
               "panel": "ppca_rs_tpu_torch/csrc/spd_panel.cuh"}
CHOL_REPLACES = "ppca_rs_tpu/ops/kernels.py:664"   # spd_chol -> pl.pallas_call :727

BATCH = 8192
#: State sizes of the kernel checks: every register tile (8, 16, 32, 64,
#: 128), k a multiple of 4 (16-byte accesses) and not, and the panel design
#: above the tile limits (float64 E-step: above 64), ragged and not, up to
#: bench_suite.py's largest state size: 131 and 257 end in a ragged panel
#: and a ragged tensor-core tile (not multiples of 32, 16 or 8) in float32
#: and float64, and 704 stages its panel in chunks (more active rows than
#: the panel design keeps in shared memory at once).
KS = (2, 13, 24, 50, 64, 99, 128, 131, 160, 192, 256, 257, 384, 512, 704)
#: Up to this k the checks take BATCH samples; above it the rows of one
#: single-model block (``config.block_rows``), so the plain version fits.
FULL_BATCH_MAX_K = 256
#: The state sizes whose times go into the kernels line: the main path's,
#: phase 7's, and the panel design's; fullt is also timed at RAGGED_K, whose
#: rows are not 16-byte aligned, beside TIMED_K.
TIMED_K = 64
RAGGED_K = 50
WIDE_K = 128
PANEL_KS = (160, 256, 512)
#: float64 state sizes at which fullt is also timed (the panel design
#: serves float64 above k=64).
F64_TIMED_KS = (96, 128, 160)
#: spd_chol's float64 timings in phase 2: the tile's widest rows (KP=64, 128).
CHOL_F64_TIMED_KS = (64, 99, 128)
SIGMA = 0.7
#: Noise levels cycled over the batch in the per-sample sigma check.
SIGMA_LEVELS = (0.4, 0.7, 1.0, 1.3)
#: The sample made negative definite in the spd_estep not-PD check.
NOT_PD = 5
#: Kernel launches per CUDA-event window; the slower plain versions take
#: fewer, and so do kernels above WIDE_K, which take milliseconds each.
KERNEL_REPS = 30
PANEL_REPS = 10
PLAIN_REPS = 5
#: Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): device
#: memory bytes/s; float32 FLOP/s outside the tensor cores, and float32 work
#: on them as three TF32 products (3xTF32, float32 accuracy: a third of the
#: 495 TFLOP/s TF32 peak), the rate of the kernels whose products run there;
#: float64 FLOP/s on the tensor cores (FP64 MMA, full IEEE float64; twice the
#: 34 TFLOP/s outside them), the fastest the card does float64.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F32_3XTF32_FLOPS = 495e12 / 3
PEAK_F64_FLOPS = 67e12
#: The largest k the E-step tile serves with its one-block body, which runs
#: outside the tensor cores; its blocked body above runs its products on them
#: (csrc/spd_estep_tile.cuh).
TILE_SMALL_MAX_K = 16
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

#: Pattern path and general path trained from one start agree on the final
#: llk to this relative bound (examples/structured_missingness.py).
TOL_PATH_LLK = 1e-4
#: Posterior draws: their mean lies within this many standard errors of
#: the smoothed values on every entry, and their mean variance within this
#: relative distance of the mean smoothed covariance diagonal.
SAMPLER_SE = 6.0
SAMPLER_VAR = 0.1

N_MAIN = 1 << 20
D_MAIN = 1024
K_MAIN = 64
N_ITERS = 5
N_READOUT = 65536
N_CPU = 16384
N_PATTERN = 1_000_000
P_PATTERN = 32
N_COMPARE_ITERS = 2
N_SAMPLER_ROWS = 1024
N_DRAWS = 64
#: Phase 7: bench_suite.py's k128 configuration (D=1024, k=128, N=262,144,
#: 50% missing at random); the sampler's rows and the phase-4 check's rows.
N_WIDE = 262_144
N_WIDE_SAMPLER = 8192
N_WIDE_CPU = 4096
#: Phase 8: bench_suite.py's mixture configuration (row 4: N=200,000,
#: D=512, k=32, M=8, 80% observed at random, noise 0.3, means 3 N(0, 1));
#: the readout rows, the rows of the card-vs-CPU and fused-vs-loop checks,
#: and the EM iterations of the fully observed copy.
N_MIX = 200_000
D_MIX = 512
K_MIX = 32
M_MIX = 8
MIX_OBSERVED = 0.8
N_MIX_READOUT = 8192
N_MIX_CPU = 4096
N_DENSE_ITERS = 2
#: Phase 9: streaming.  9a streams phase 3's data from this many host chunks
#: (131,072 rows each) for this many trainer iterations, then times one
#: streamed iteration at each prefetch level; 9b streams one chunk of each
#: kind (fully observed, pattern, random masks) of this many rows; 9c
#: streams phase 8's mixture data from this many chunks (50,000 rows each)
#: for N_DENSE_ITERS trainer iterations; 9d packs a float64 array of
#: N_PACK x D_MAIN and a long frame of PACK_SAMPLES x PACK_DIMS rows.
N_STREAM_CHUNKS = 8
STREAM_ITERS = 3
STREAM_PREFETCH = (0, 1, 2)
N_STREAM_KIND = 131_072
N_STREAM_MIX_CHUNKS = 4
N_PACK = 131_072
PACK_SAMPLES, PACK_DIMS = 8192, 128
#: Streamed vs resident iteration, float32 on the card: only the order of
#: summation differs (per chunk, then across chunks).
TOL_STREAM = 1e-4
#: bfloat16 vs float32 storage, llk relative difference: bfloat16 rounds
#: each stored value by up to 2^-9 of it; the llk moves far less.
TOL_BF16 = 1e-2
#: Phase 10: the sharded path in child processes on this card, two gloo
#: ranks (NCCL takes no two ranks on one device) and one NCCL rank.  10a
#: splits phase 3's rows unevenly between the two ranks and trains
#: PAR_ITERS iterations, then reads N_PAR_ROWS_READ rows of each rank; 10c
#: puts D on a 1x2 model axis over the first N_MODEL_AXIS rows; 10e trains
#: phase 8's mixture for N_DENSE_ITERS iterations; 10f streams 4 of 9a's
#: chunks on each rank.  Sharded vs single-process results: TOL_STREAM
#: (only the order of summation differs).  Each job is killed after
#: PAR_TIMEOUT seconds.
PAR_ROWS = (524_289, 524_287)
PAR_ITERS = 3
N_PAR_ROWS_READ = 8192
N_MODEL_AXIS = 65_536
PAR_REDUCE_REPS = 5
PAR_TIMEOUT = 600
#: Phase 11: bench_suite.py's masked rows past the register tiles (D=1024,
#: 50% missing at random): k=256 on N_LK256 rows (readouts on
#: N_LK_READOUT, the sampler on N_LK_SAMPLER, card vs CPU on N_LK_CPU) and
#: k=512 on N_LK512 rows (sampler N_LK512_SAMPLER, card vs CPU
#: N_LK512_CPU); float64 on the card at K_LK64 over N_LK64 rows, against
#: the CPU in float64 within TOL_F64_CARD_VS_CPU (the two sum in other
#: orders); the pattern route at k=256 over N_LK_PATTERN rows of
#: P_LK_PATTERN masks; a mixture of state sizes K_HMIX at D_HMIX over
#: N_HMIX rows (card vs CPU on N_HMIX_CPU).
N_LK256 = 131_072
N_LK_READOUT = 8192
N_LK_SAMPLER = 2048
N_LK_CPU = 256
N_LK512 = 32_768
N_LK512_SAMPLER = 512
N_LK512_CPU = 64
K_LK64 = 96
N_LK64 = 4096
TOL_F64_CARD_VS_CPU = 1e-8
N_LK_PATTERN = 32_768
P_LK_PATTERN = 8
K_HMIX = (192, 160)
D_HMIX = 512
N_HMIX = 16_384
N_HMIX_CPU = 256
#: 11d's posterior probabilities, fused vs from the components' own float32
#: llks: row llks of 10^3-10^4 carry 10^-4-10^-3 of float32 rounding into
#: the log-odds, which a posterior passes on at up to a quarter of it.
TOL_POSTERIOR = 1e-3
#: Phase 12: a structured mixture, the JAX package's pattern-mixture
#: measurement (tools/em_microbench.py:49-63 --path patmix_sorted;
#: ppca_rs_tpu/config.py:117-121): M_PATMIX components, P_PATMIX mask
#: patterns (each observes each dimension with probability 0.5, rows pick
#: one uniformly), D_PATMIX x K_PATMIX, N_PATMIX float32 rows: N / P =
#: 8,192 rows a segment, exactly config.pat_sorted_min_rows.  PATMIX_ITERS
#: trainer iterations; the two table-route EM forms timed against each
#: other at PATMIX_SEGMENT_ROWS rows a segment (prefixes of the data),
#: PATMIX_REPS calls each, in turns; card vs CPU float64 on N_PATMIX_CPU
#: rows.  Sorted vs table-grouped statistics: TOL_STREAM (only the order of
#: summation differs).
N_PATMIX = 262_144
D_PATMIX = 1024
K_PATMIX = 64
M_PATMIX = 8
P_PATMIX = 32
PATMIX_ITERS = 4
PATMIX_SEGMENT_ROWS = (8192, 4096, 2048, 1024, 256)
PATMIX_REPS = 3
N_PATMIX_CPU = 512
#: Phase 13: each example of examples/torch_port/ is killed after this.
EXAMPLE_TIMEOUT = 300
#: Phase 14: the reference's test themes (tests/test_golden.py,
#: test_small_sigma.py, test_statistical.py, test_fuzz_parity.py) on the
#: card.  (a) state size 0 on N_ZERO rows at D_MAIN (the pattern route
#: over P_ZERO masks) and mixtures of the state sizes K_ZERO_MIX; (c)
#: near-noiseless float32: exact low-rank data, the model at the truth
#: with sigma SIGMA_NOISELESS, NOISELESS_ITERS EM steps, sigma below
#: NOISELESS_SIGMA_MAX (tests/test_small_sigma.py's bound), on the masked
#: route at k=64 (N_NOISELESS rows, the register tile) and at
#: K_NOISELESS_PANEL (N_NOISELESS_PANEL rows, the panel design), the
#: pattern and dense routes at k=64, a general mixture and phase 12's
#: structured mixture; the dense route's mean offset of 1e3 on N_OFFSET
#: rows; (d) recovery of a planted model from N_RECOVERY rows in at most
#: RECOVERY_ITERS iterations, within RECOVERY_ANGLE_MAX radians and
#: RECOVERY_SIGMA_TOL of sigma = 1 (bounds set before the first run: the
#: sampling error of the weakest direction is ~0.03 rad); (e) FUZZ_DRAWS
#: seeded draws at the state sizes FUZZ_KS, float64 on the card against
#: the CPU within TOL_FUZZ_F64.
N_ZERO = 65_536
P_ZERO = 32
K_ZERO_MIX = ((0, 0), (0, 8))
SIGMA_NOISELESS = 1e-4
NOISELESS_ITERS = 3
NOISELESS_SIGMA_MAX = 1e-2
N_NOISELESS = 262_144
K_NOISELESS_PANEL = 256
N_NOISELESS_PANEL = 32_768
N_NOISELESS_MIX = 65_536
D_NOISELESS_MIX = 512
K_NOISELESS_MIX = 32
M_NOISELESS_MIX = 8
N_OFFSET = 65_536
N_RECOVERY = 1 << 20
RECOVERY_ITERS = 30
RECOVERY_ANGLE_MAX = 0.1
RECOVERY_SIGMA_TOL = 0.01
FUZZ_DRAWS = 24
FUZZ_KS = (0, 1, 2, 3, 13, 50, 64, 65, 127, 129, 131, 200, 257)
FUZZ_N_MAX = 20_000
FUZZ_WORK = 1e9
TOL_FUZZ_F64 = 1e-8
SEED = 20261016

#: Phase 2's checks of G as slabs (``kernels.uses_slabs``): the float32 and
#: float64 state sizes, 40, 72 and 104 ragged on the tensor-core tiles
#: (multiples of 8, of neither 16 nor 32), each variant on B=SLAB_BATCH
#: samples; and the state sizes refused slabs: the one-block body (16) and
#: the panel design (float32 136, float64 72).
SLAB_KS = {torch.float32: (24, 32, 40, 64, 72, 104, 128), torch.float64: (32, 40, 64)}
SLAB_BATCH = 2048
SLAB_REFUSED = ((16, torch.float32), (136, torch.float32), (72, torch.float64))
#: The variants the masked and mixture routes launch on slab G, and the
#: shapes at which they are timed on slab G in turns with square G: phase
#: 8's (k=32, M_MIX x 8,192 samples, a sigma per sample), phase 3's and
#: phase 7's (B=BATCH).
SLAB_WANTS = ("fullt", "llk", "states", "infer")
SLAB_TIMED = ((K_MIX, M_MIX * 8192, True), (TIMED_K, BATCH, False), (WIDE_K, BATCH, False))
#: Slab launches of the main runs of phases 3, 7 and 8 (kernels.SLAB_LAUNCHES).
SLAB_COUNTS: dict = {}
#: The Gram kernel's cases (phase 2b): (B, D, k, M, square G, timed).  The
#: main path's: k=64 and 128 slabs at B=8192, D=1024 (phases 3 and 7), the
#: mixture's 8 components of k=32 at D=512 (phase 8), k=256's square
#: columns at B=2048 (phase 11a, the panel path); ragged B, D and W.
GRAM_CASES = ((8192, 1024, 64, 1, False, True), (8192, 1024, 128, 1, False, True),
              (8192, 512, 32, 8, False, True), (2048, 1024, 256, 1, True, True),
              (131, 80, 24, 1, False, False), (131, 257, 40, 1, False, False),
              (131, 257, 24, 1, False, False), (131, 80, 13, 1, True, False))
#: The main path's cases, where the kernel's errors are held to the SIMT
#: float32 product's (at most GRAM_ERR_RATIO times each).
GRAM_MAIN = 3
GRAM_ERR_RATIO = 1.5
#: Any case fails above these: the max relative error (the kernel reads up
#: to 4.3e-7 on an H100, a bf16 product summed whole on the tensor cores
#: 2.8e-6 and more at the main shapes) and the diagonal's signed mean
#: relative error (the kernel up to 9.5e-9 in size; its sums left to the
#: tensor cores' adder, unpromoted, -1.95e-7 at D=1024).
TOL_GRAM = 1.5e-6
TOL_GRAM_DIAG = 5e-8
GRAM_REPS = 20
PEAK_BF16_FLOPS = 989e12
#: The Gram launches of the training runs (kernels.GRAM_LAUNCHES), by tag.
GRAM_COUNTS: dict = {}
#: The S kernel's cases (phase 2c): (B, D, k, M, timed), S's columns as the
#: routes build them (slabs where ``kernels.uses_slabs`` holds, else k^2).
#: The main path's: k=64 and 128 slabs at B=8192, D=1024 (phases 3 and 7),
#: the mixture's 8 components of k=32 at D=512 (phase 8), k=256's square
#: columns at B=2048 (phase 11a); a model-axis block's D=520 (not a multiple
#: of 16: the converters read the mask themselves), ragged B, D and odd W.
S_CASES = ((8192, 1024, 64, 1, True), (8192, 1024, 128, 1, True), (8192, 512, 32, 8, True),
           (2048, 1024, 256, 1, True), (8192, 520, 64, 1, False), (131, 257, 40, 1, False),
           (131, 80, 13, 1, False), (17, 40, 13, 3, False))
#: The main path's cases, where the kernel's errors are held to the SIMT
#: float32 product's of the route it replaces, read in the same phase (at
#: most S_ERR_RATIO times each): its max relative error, whose float32 sum
#: promotes 256 runs a tile row (an H100: 2.37x the SIMT product's at k=64,
#: 1.18x at k=128, under it at the mixture's and k=256's shapes), and its
#: diagonal's signed mean relative error (1.3x the SIMT product's at k=64,
#: under it elsewhere).
S_MAIN = 4
S_ERR_RATIO = 2.5
#: Any case fails above these: the max relative error and the diagonal's
#: signed mean relative error (the kernel up to 9.6e-7 and 7.9e-9; S cut to
#: one bf16 slice reads 1.6e-4, a TF32 product 3.4e-5).
TOL_S = 2e-6
TOL_S_DIAG = 5e-8
#: The S launches of the training runs (kernels.S_LAUNCHES), by tag.
S_COUNTS: dict = {}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def rel_err(got, want) -> float:
    """max |got - want| / max |want| in float64, on ``want``'s device."""
    got, want = got.detach().double().to(want.device), want.detach().double()
    scale = float(want.abs().max()) if want.numel() else 0.0
    return float((got - want).abs().max()) / max(scale, 1e-300) if want.numel() else 0.0


def cuda_ms(fn, reps: int) -> float:
    """Mean time of ``reps`` back-to-back calls between two CUDA events,
    after one warm-up call."""
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
# phase 2b


def gram_case(B: int, D: int, k: int, M: int, square: bool, gen):
    """(bool mask, float32 columns (D, W) or (M, D, W), diagonal column
    indices) for one case: C ~ N(0,1) 2/sqrt(k) as the benchmark draws it,
    the columns as the routes build them, the mask 50% observed (80% for a
    mixture, as phase 8's data)."""
    from ppca_rs_tpu_torch.ops import kernels
    from ppca_rs_tpu_torch.ops import masked_linalg as ml

    C = torch.randn((M, D, k) if M > 1 else (D, k), generator=gen, device="cuda") * 2 / k ** 0.5
    CC = ml.outer_flat(C) if square else ml.outer_slab(C)
    if square:
        diag = torch.arange(k, device="cuda") * (k + 1)
    else:
        rows, cols = kernels.slab_coords(k, "cuda")
        diag = torch.nonzero(rows == cols).flatten()
    p = MIX_OBSERVED if M > 1 else 0.5
    mask = torch.rand((B, D), generator=gen, device="cuda") < p
    return mask, CC.contiguous(), diag


def gram_errors(G, exact, diag) -> tuple:
    """(max |G - exact| / max |exact|, the signed mean of (G - exact) /
    exact over the Grams' diagonal entries with exact > 0)."""
    d_got, d_exact = G[..., diag].double(), exact[..., diag]
    pos = d_exact > 0
    signed = float(((d_got - d_exact)[pos] / d_exact[pos]).mean())
    return rel_err(G, exact), signed


def phase_mask_gram(smi: str) -> dict:
    """The Gram kernel against float64 at the main path's and at ragged
    shapes, beside the SIMT float32 product and a library bf16 product of
    the K-stacked slices, and timed at the timed cases.  Returns the k=64
    case's row for the kernels line, with the others under ``at_<case>``."""
    from ppca_rs_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(SEED + 70)
    rows = {}
    for i, (B, D, k, M, square, timed) in enumerate(GRAM_CASES):
        mask, CC, diag = gram_case(B, D, k, M, square, gen)
        W = CC.shape[-1]
        tag = f"B={B} D={D} k={k}{' square' if square else ''}{f' M={M}' if M > 1 else ''} W={W}"
        kernels.reset_launch_counts()
        slices = kernels.gram_slices(CC)
        check(kernels.SPLIT_LAUNCHES["kernel"] == 1
              and torch.equal(slices, kernels.gram_slices_reference(CC)),
              f"gram {tag}: the split kernel differs from its plain version")
        out = torch.full((M, B, W) if M > 1 else (B, W), float("nan"), device="cuda")
        kernels.mask_gram(mask, slices, out)
        torch.cuda.synchronize()
        check(kernels.GRAM_LAUNCHES == {"kernel": 1, "library": 0}, f"gram {tag}: not launched")
        check(bool(torch.isfinite(out).all()), f"gram {tag}: an output was left unwritten")
        mask_f = mask.float()
        exact = torch.matmul(mask.double(), CC.double())
        simt = torch.matmul(mask_f, CC)
        # the library yardstick: [m m m] (B, 3D) x [hi; mid; lo] (3D, M W) in
        # bf16 with float32 output, one product
        stacked = slices[..., :W].reshape(3, M, D, W).permute(0, 2, 1, 3).reshape(3 * D, M * W)
        a3 = mask.to(torch.bfloat16).repeat(1, 3)
        lib = torch.mm(a3, stacked, out_dtype=torch.float32)
        lib = lib.view(B, M, W).permute(1, 0, 2) if M > 1 else lib
        err, signed = gram_errors(out, exact, diag)
        err_simt, signed_simt = gram_errors(simt, exact, diag)
        err_lib, signed_lib = gram_errors(lib, exact, diag)
        check(err <= TOL_GRAM, f"gram {tag}: max rel err {err:.3e} above {TOL_GRAM}")
        check(abs(signed) <= TOL_GRAM_DIAG,
              f"gram {tag}: the diagonal's signed mean rel err {signed:+.3e} above "
              f"{TOL_GRAM_DIAG} in size")
        row = dict(B=B, D=D, k=k, M=M, W=W, max_rel_err=err, diag_signed_rel=signed,
                   simt_max_rel_err=err_simt, simt_diag_signed_rel=signed_simt,
                   lib_max_rel_err=err_lib, lib_diag_signed_rel=signed_lib)
        held = (err <= GRAM_ERR_RATIO * err_simt
                and abs(signed) <= GRAM_ERR_RATIO * abs(signed_simt))
        note = (f"; within {GRAM_ERR_RATIO}x the SIMT product's: {'held' if held else 'MISSED'}"
                if i < GRAM_MAIN else "")
        print(f"[gram] {tag}: max rel err kernel {err:.3e} / SIMT f32 {err_simt:.3e} / library "
              f"bf16 {err_lib:.3e}; diagonal signed mean rel err kernel {signed:+.3e} / SIMT "
              f"{signed_simt:+.3e} / library {signed_lib:+.3e}{note}")
        check(held or i >= GRAM_MAIN, f"gram {tag}: the kernel's errors are not within "
              f"{GRAM_ERR_RATIO}x the SIMT float32 product's")
        if timed:
            flops = 3 * 2 * B * D * W * M
            nbytes = B * D + 4 * M * B * W + 3 * 2 * M * D * W
            b_ms, by = bound(nbytes, flops, PEAK_BF16_FLOPS)
            reps = GRAM_REPS if B * W * M <= 8192 * 8704 else GRAM_REPS // 2
            ms = cuda_ms(lambda: kernels.mask_gram(mask, slices, out), reps)
            plain_out = torch.empty_like(out)
            plain_ms = cuda_ms(lambda: plain_out.copy_(kernels.mask_gram_reference(mask, slices, W)),
                               max(2, reps // 4))
            simt_out = torch.empty_like(simt)
            simt_ms = cuda_ms(lambda: torch.matmul(mask_f, CC, out=simt_out), reps)
            library_ms = cuda_ms(lambda: torch.mm(a3, stacked, out_dtype=torch.float32), reps)
            row.update(ms=ms, bound_ms=b_ms, bound_by=by, plain_ms=plain_ms,
                       library_ms=library_ms, simt_ms=simt_ms,
                       tflops=flops / ms / 1e9, peak_share=b_ms / ms if by == "operations" else None)
            print(f"[time] mask_gram {tag}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s of "
                  f"slice work, {100 * flops / ms / 1e9 / (PEAK_BF16_FLOPS / 1e12):.1f}% of the bf16 "
                  f"peak), {bound_note(b_ms, by, PEAK_BF16_FLOPS)}; plain {plain_ms:.4f} ms; "
                  f"library bf16 {library_ms:.4f} ms; SIMT f32 product {simt_ms:.4f} ms ({smi})")
        rows[tag] = row
        del mask, CC, slices, out, exact, simt, lib, stacked, a3
        torch.cuda.empty_cache()
    # the kernel's name as the profiler shows it: the benchmark counts it as a
    # product (a name with "gemm", none with "spd_")
    from torch.profiler import ProfilerActivity, profile

    mask, CC, _ = gram_case(BATCH, D_MAIN, K_MAIN, 1, False, gen)
    slices, out = kernels.gram_slices(CC), torch.empty(BATCH, CC.shape[-1], device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(KERNEL_REPS):
            kernels.mask_gram(mask, slices, out)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if "mask_gram" in e.key
             and getattr(e, "device_time_total", 0) > 0]
    check(bool(names) and all("gemm" in n and "spd_" not in n for n in names),
          f"gram: the profiler shows the kernel as {names}")
    print(f"[gram] the profiler names the kernel {names[0]!r}")
    keys = list(rows)
    main = dict(rows[keys[0]])
    main.update({f"at_{key.replace(' ', '_')}": rows[key] for key in keys[1:]})
    return main


# --------------------------------------------------------------------- #
# phase 2c


def s_case(B: int, D: int, k: int, M: int, gen):
    """(bool mask, SM, scale, the SIMT float32 product the route ran, the
    diagonal's column indices) of one block from the port's own E-step:
    ``fullt``'s second moments of rows drawn as the benchmark draws them
    (C ~ N(0,1) 2/sqrt(k); 50% observed, or 80% and 8 components' real
    responsibilities for a mixture), non-unit weights with a zero-weight
    and an all-masked row; square SM's entries above the diagonal, which
    the kernel leaves unwritten and the M-step never reads, zeroed."""
    from ppca_rs_tpu_torch.ops import kernels
    from ppca_rs_tpu_torch.ops import masked_linalg as ml
    from ppca_rs_tpu_torch.ops import mix_fused as mf

    opts = dict(generator=gen, device="cuda")
    p = MIX_OBSERVED if M > 1 else 0.5
    mask = torch.rand((B, D), **opts) < p
    mask[1] = False
    w = torch.rand(B, **opts) + 0.5
    w[2] = 0.0
    if M == 1:
        C = torch.randn((D, k), **opts) * 2 / k ** 0.5
        mean = torch.randn(D, **opts)
        data = torch.where(mask, torch.randn((B, k), **opts) @ C.T + mean
                           + 0.5 * torch.randn((B, D), **opts), 0.0)
        gram = ml.gram_operand(C, torch.float32)
        _, SM, _, _ = ml.block_posterior(C, gram, mean, 0.5, data, mask, "fullt").out
        SM = SM.reshape(B, -1)
        scale = w
        simt = lambda: torch.matmul((mask.float() * w[:, None]).T, SM)   # noqa: E731
    else:
        Cs = torch.randn((M, D, k), **opts)
        means = 3 * torch.randn((M, D), **opts)
        sigmas = torch.full((M,), 0.3, device="cuda")
        pick = torch.randint(0, M, (B,), **opts)
        z = torch.randn((B, k), **opts)
        data = torch.where(mask, torch.einsum("bk,bdk->bd", z, Cs[pick]) + means[pick]
                           + 0.3 * torch.randn((B, D), **opts), 0.0)
        gram = ml.gram_operand(Cs, torch.float32)
        _, _, G, b, rnorm, d_obs = mf._general_inputs(Cs, gram, mf._center_prep(Cs, means), data,
                                                      mask, None)
        llks, _, SM, _ = mf._estep(sigmas, G, b, rnorm, d_obs, "fullt")
        scale, _ = mf._responsibilities(llks, torch.full((M,), -math.log(M), device="cuda"), w)
        SM = SM.reshape(M, B, -1)
        simt = lambda: torch.bmm(mask.float().T.expand(M, -1, -1), SM * scale[..., None])  # noqa: E731
    if not kernels.uses_slabs(k, torch.float32):
        SM = torch.tril(SM.view(*SM.shape[:-1], k, k)).reshape(SM.shape)
        diag = torch.arange(k, device="cuda") * (k + 1)
    else:
        rows, cols = kernels.slab_coords(k, "cuda")
        diag = torch.nonzero(rows == cols).flatten()
    return mask, SM.contiguous(), scale.contiguous(), simt, diag


def phase_mask_s(smi: str) -> dict:
    """The S kernel against float64 at the main path's and at ragged shapes,
    beside the SIMT float32 product of the route it replaces, and timed at
    the timed cases.  Returns the k=64 case's row for the kernels line,
    with the others under ``at_<case>``."""
    from ppca_rs_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(SEED + 71)
    rows = {}
    for i, (B, D, k, M, timed) in enumerate(S_CASES):
        mask, SM, scale, simt_fn, diag = s_case(B, D, k, M, gen)
        W = SM.shape[-1]
        width = kernels.mask_s_tile_width(D, W, M)
        tag = f"B={B} D={D} k={k}{f' M={M}' if M > 1 else ''} W={W} (tiles of {width})"
        S = torch.zeros((M, D, W) if M > 1 else (D, W), device="cuda")
        kernels.reset_launch_counts()
        kernels.mask_s(mask, SM, scale, S)
        torch.cuda.synchronize()
        check(kernels.S_LAUNCHES == {"kernel": 1, "library": 0}, f"S {tag}: not launched")
        check(bool(torch.isfinite(S).all()), f"S {tag}: a non-finite entry")
        exact = torch.matmul(mask.T.double(), scale.double()[..., None] * SM.double())
        simt = simt_fn()
        err, signed = gram_errors(S, exact, diag)
        err_simt, signed_simt = gram_errors(simt, exact, diag)
        check(err <= TOL_S, f"S {tag}: max rel err {err:.3e} above {TOL_S}")
        check(abs(signed) <= TOL_S_DIAG,
              f"S {tag}: the diagonal's signed mean rel err {signed:+.3e} above {TOL_S_DIAG} in size")
        row = dict(B=B, D=D, k=k, M=M, W=W, tile_width=width, max_rel_err=err,
                   diag_signed_rel=signed, simt_max_rel_err=err_simt,
                   simt_diag_signed_rel=signed_simt)
        held = err <= S_ERR_RATIO * err_simt and abs(signed) <= S_ERR_RATIO * abs(signed_simt)
        note = (f"; within {S_ERR_RATIO}x the SIMT product's: {'held' if held else 'MISSED'}"
                if i < S_MAIN else "")
        print(f"[S] {tag}: max rel err kernel {err:.3e} / SIMT f32 {err_simt:.3e}; diagonal signed "
              f"mean rel err kernel {signed:+.3e} / SIMT {signed_simt:+.3e}{note}")
        check(held or i >= S_MAIN, f"S {tag}: the kernel's errors are not within {S_ERR_RATIO}x "
              "the SIMT float32 product's")
        if timed:
            flops = 3 * 2 * B * D * W * M
            nbytes = B * D + 4 * M * B * W + 4 * M * B + 2 * 4 * M * D * W
            b_ms, by = bound(nbytes, flops, PEAK_BF16_FLOPS)
            reps = GRAM_REPS if B * W * M <= 8192 * 8704 else GRAM_REPS // 2
            ms = cuda_ms(lambda: kernels.mask_s(mask, SM, scale, S), reps)
            plain_out = torch.empty_like(S)
            plain_ms = cuda_ms(lambda: plain_out.copy_(kernels.mask_s_reference(mask, SM, scale)),
                               max(2, reps // 4))
            library_ms = cuda_ms(simt_fn, reps)
            row.update(ms=ms, bound_ms=b_ms, bound_by=by, plain_ms=plain_ms,
                       library_ms=library_ms, tflops=flops / ms / 1e9,
                       peak_share=b_ms / ms if by == "operations" else None)
            print(f"[time] mask_s {tag}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s of "
                  f"slice work, {100 * flops / ms / 1e9 / (PEAK_BF16_FLOPS / 1e12):.1f}% of the bf16 "
                  f"peak), {bound_note(b_ms, by, PEAK_BF16_FLOPS)}; plain {plain_ms:.4f} ms; "
                  f"library (the SIMT f32 product it replaces) {library_ms:.4f} ms ({smi})")
        rows[tag] = row
        del mask, SM, scale, S, exact, simt, simt_fn
        torch.cuda.empty_cache()
    # the kernel's name as the profiler shows it: the benchmark counts it as a
    # product (a name with "gemm", none with "spd_")
    from torch.profiler import ProfilerActivity, profile

    mask, SM, scale, _, _ = s_case(BATCH, D_MAIN, K_MAIN, 1, gen)
    S = torch.zeros(D_MAIN, SM.shape[-1], device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(KERNEL_REPS):
            kernels.mask_s(mask, SM, scale, S)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if "mask_s" in e.key
             and getattr(e, "device_time_total", 0) > 0]
    check(bool(names) and all("gemm" in n and "spd_" not in n for n in names),
          f"S: the profiler shows the kernel as {names}")
    print(f"[S] the profiler names the kernel {names[0]!r}")
    keys = list(rows)
    main = dict(rows[keys[0]])
    main.update({f"at_{key.replace(' ', '_')}": rows[key] for key in keys[1:]})
    return main


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


#: torch.profiler kernel names -> the kernel they time and its element
#: type: by the ``want`` template argument of the tile's kernels (the
#: blocked body's third, before its layout; the one-block body's last) and
#: the panel design's: 0-4 an spd_estep variant, 5 spd_chol.
_KERNEL_NAME = re.compile(
    r"spd_(?:estep_(?:tile|small)_kernel<(float|double), \d+, (\d)(?:, (?:true|false))?>"
    r"|panel_kernel<(float|double), (\d)>)")


def kernel_of(name: str):
    """(kernel, "float" or "double") of a device kernel's name, or None."""
    from ppca_rs_tpu_torch.ops import kernels

    m = _KERNEL_NAME.search(name)
    if m is None:
        return None
    ctype, code = (m.group(1), int(m.group(2))) if m.group(1) else (m.group(3), int(m.group(4)))
    return ("chol" if code == 5 else kernels.WANTS[code]), ctype


def profiled_ms(launchers: dict, reps: int, dtype=torch.float32) -> dict:
    """Device time per launch of each kernel, read by name from one
    torch.profiler window in which each launcher runs ``reps`` times; None
    for a kernel that the profiler shows no device time for."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in launchers.values():
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    ctype = "float" if dtype == torch.float32 else "double"
    found = {}
    for evt in prof.key_averages():
        which = kernel_of(evt.key)
        total_us = getattr(evt, "device_time_total", 0)
        if which and which[1] == ctype and total_us > 0 and evt.count > 0:
            found[which[0]] = total_us / evt.count / 1e3
    return {name: found.get(name) for name in launchers}


def bound(nbytes: float, flops: float, peak: float):
    """(ms, "bytes" or "operations"): the least time the card could take
    for this work at its published peaks, ``peak`` FLOP/s for the
    operations."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def peak_flops(k: int, kernel: str, dtype) -> float:
    """The peak FLOP/s for the operations of the design serving k for
    ``kernel`` ("estep" or "chol"): float64 on FP64 MMA; float32 at 3xTF32's
    rate where that design runs its products on the tensor cores (the panel
    design, the tile's blocked body above k=16, spd_chol's as the E-step's),
    else outside them."""
    from ppca_rs_tpu_torch.ops import kernels

    if dtype != torch.float32:
        return PEAK_F64_FLOPS
    tensor = kernels.design(k, kernel, dtype) == "panel" or k > TILE_SMALL_MAX_K
    return PEAK_F32_3XTF32_FLOPS if tensor else PEAK_F32_FLOPS


def bound_note(b_ms: float, by: str, peak: float) -> str:
    """The bound as the [time] lines print it, with the rate of an
    operations bound."""
    return f"bound {b_ms * 1e3:.2f} us ({by}{f' at {peak / 1e12:g} TFLOP/s' if by == 'operations' else ''})"


def estep_work(want: str, B: int, k: int, itemsize: int, n_sigma: int = 1, slab: bool = False):
    """(bytes, FLOPs) of one spd_estep launch.  Bytes: each input (G, b,
    rnorm, d_obs, ``n_sigma`` sigmas) read once and each output written
    once, where of the symmetric G only the lower triangle need be read,
    k(k+1)/2 elements a sample, and of fullt's square SM only the lower
    triangle need be written, since its consumers (masked_linalg.em_stats
    and mix_fused.mix_em_stats, through their M-steps) rebuild S from it;
    fullt's slab SM (``slab``) is written whole, slab_width(k) elements a
    sample.  FLOPs: the Cholesky factor k^3/3, M^{-1} from it 2k^3/3 more,
    k^2 for each triangular solve and for s s^T."""
    from ppca_rs_tpu_torch.ops import kernels

    tri = k * (k + 1) // 2
    elems = B * tri + B * k + 2 * B + n_sigma
    for i, sh in enumerate(kernels.output_shapes(want, B, k, slab)):
        elems += B * tri if want == "fullt" and i == 1 and not slab else math.prod(sh)
    if want == "llk":
        flops = k ** 3 / 3 + k * k
    elif want == "states":
        flops = k ** 3 / 3 + 2 * k * k
    else:
        flops = k ** 3 + 3 * k * k
    return elems * itemsize, B * flops


def design_note(k: int, kernel: str, dtype) -> str:
    """The design serving k, with the panel design's CTAs per
    multiprocessor, or the tile's residency for ``kernel`` (the occupancy
    calculator's CTAs a multiprocessor, warps a CTA, samples in flight)."""
    from ppca_rs_tpu_torch.ops import kernels

    if kernels.design(k, kernel, dtype) == "panel":
        return f"panel design, {kernels.PANEL_CTAS_PER_SM} CTAs per SM"
    ctas, warps, samples = kernels.tile_occupancy(k, dtype, kernel)
    return (f"tile design, {ctas} CTAs x {warps} warps per SM = {ctas * warps} warps, "
            f"{ctas * samples} samples in flight")


def defined(want: str, outs) -> list:
    """The output elements a kernel defines: fullt's square SM (its second
    output) on and below the diagonal, as (B, k(k+1)/2); every other output,
    and fullt's slab SM, whole."""
    if want != "fullt" or outs[1].ndim == 2:
        return list(outs)
    sm = outs[1]
    k = sm.shape[-1]
    low = torch.ones(k, k, dtype=torch.bool, device=sm.device).tril()
    return [outs[0], sm[:, low], *outs[2:]]


def check_above_untouched(tag: str, want: str, outs) -> None:
    """fullt writes nothing above square SM's diagonal: the NaN it was
    prefilled with is still there; slab SM is written 0 above it."""
    from ppca_rs_tpu_torch.ops import kernels

    if want != "fullt":
        return
    sm = outs[1]
    if sm.ndim == 2:
        rows, cols = kernels.slab_coords(outs[0].shape[-1], sm.device)
        check(bool((sm[:, cols > rows] == 0).all()),
              f"{tag}: fullt's slab SM is not 0 above the diagonal")
        return
    k = sm.shape[-1]
    up = torch.ones(k, k, dtype=torch.bool, device=sm.device).triu(1)
    check(bool(torch.isnan(sm[:, up]).all()), f"{tag}: fullt wrote above the diagonal of SM")


def kernel_reps(k: int) -> int:
    return KERNEL_REPS if k <= WIDE_K else PANEL_REPS


def time_estep(k: int, x, wants, sigma=None) -> dict:
    """Times of the spd_estep variants ``wants`` on the inputs ``x`` (in
    their dtype): kernel launches into preallocated outputs (and scratch)
    with sigma already on the card (``sigma``: one for the batch or one per
    sample; SIGMA if not given), kernel_reps(k) back to back between CUDA
    events, in turns with the plain version (plain, kernel, kernel, plain);
    then each kernel's device time by name from one profiler window; beside
    them the bound."""
    from ppca_rs_tpu_torch.ops import kernels

    G, b, rn, do = x["G"], x["b"], x["rnorm"], x["d_obs"]
    B, dtype, slab = G.shape[0], G.dtype, G.ndim == 2
    reps = kernel_reps(k)
    sig = torch.full((1,), SIGMA, dtype=dtype, device="cuda") if sigma is None else sigma
    rows, launchers = {}, {}
    for want in wants:
        outs = kernels.empty_outputs(want, B, k, G, slab=slab)
        scratch = kernels.empty_scratch(want, B, k, G)
        kern = functools.partial(kernels.launch, want, sig, G, b, rn, do, outs, scratch)
        plain = functools.partial(kernels.spd_estep_reference, sig, G, b, rn, do, want)
        p1, k1, k2, p2 = (cuda_ms(plain, PLAIN_REPS), cuda_ms(kern, reps),
                          cuda_ms(kern, reps), cuda_ms(plain, PLAIN_REPS))
        launchers[want] = kern
        rows[want] = dict(events=(k1, k2), plains=(p1, p2))
    device = profiled_ms(launchers, reps, dtype)
    out = {}
    for want, r in rows.items():
        (k1, k2), (p1, p2) = r["events"], r["plains"]
        peak = peak_flops(k, "estep", dtype)
        b_ms, by = bound(*estep_work(want, B, k, dtype.itemsize, sig.numel(), slab), peak)
        dev = device[want]
        print(f"[time] {want} k={k} B={B} {str(dtype)[6:]}"
              f"{', sigma per sample' if sig.numel() > 1 else ''}{', slab G' if slab else ''}, "
              f"{design_note(k, 'estep', dtype)}: kernel "
              f"{k1:.4f}/{k2:.4f} ms (events, {reps} launches), "
              f"{'not measured' if dev is None else f'{dev:.4f} ms'} device time (profiler); "
              f"plain {p1:.4f}/{p2:.4f} ms; {bound_note(b_ms, by, peak)}")
        out[want] = dict(ms=(k1 + k2) / 2, device_ms=dev, plain_ms=(p1 + p2) / 2,
                         bound_ms=b_ms, bound_us=b_ms * 1e3, bound_by=by, library_ms=None,
                         design=kernels.design(k, "estep", dtype), B=B, k=k,
                         layout="slabs" if slab else "square")
    return out


def check_not_pd(k: int, dtype, tol: float, gen) -> None:
    """A sample whose M is negative definite goes non-finite in every
    output element; the samples beside it (in its block, warp or tile)
    stay finite and agree with the plain version."""
    from ppca_rs_tpu_torch.ops import kernels

    B = 256
    inputs64, _ = kernel_inputs(B, k, gen)
    inputs64["G"][NOT_PD] = -(2.0 + SIGMA ** 2) * torch.eye(k, dtype=torch.float64, device="cuda")
    x = {n: t.to(dtype).contiguous() for n, t in inputs64.items()}
    x64 = {n: t.double() for n, t in x.items()}
    good = torch.ones(B, dtype=torch.bool, device="cuda")
    good[NOT_PD] = False
    for want in kernels.WANTS:
        outs = tuple(torch.full(sh, math.nan, dtype=dtype, device="cuda")
                     for sh in kernels.output_shapes(want, B, k))
        kernels.launch(want, SIGMA, x["G"], x["b"], x["rnorm"], x["d_obs"], outs)
        torch.cuda.synchronize()
        ref = kernels.spd_estep_reference(SIGMA, x64["G"], x64["b"], x64["rnorm"], x64["d_obs"], want)
        check_above_untouched(f"not-PD {want} k={k} {dtype}", want, outs)
        for o, r in zip(defined(want, outs), defined(want, ref)):
            check(not bool(torch.isfinite(o[NOT_PD]).any()),
                  f"not-PD {want} k={k} {dtype}: the sample has a finite output element")
            check(bool(torch.isfinite(o[good]).all()),
                  f"not-PD {want} k={k} {dtype}: a neighbouring sample is non-finite")
            err = rel_err(o[good], r[good])
            check(err <= tol, f"not-PD {want} k={k} {dtype}: neighbours' relative error {err:.3e}")
    print(f"[kernels] k={k} {str(dtype).replace('torch.', '')}: a negative-definite sample goes "
          f"non-finite in every output element, its {B - 1} neighbours agree with the plain version")


def check_per_sample_sigma(k: int, dtype, x) -> None:
    """One launch with a sigma per sample gives every sample exactly what
    a launch with that sample's sigma for the whole batch gives."""
    from ppca_rs_tpu_torch.ops import kernels

    G, b, rn, do = x["G"], x["b"], x["rnorm"], x["d_obs"]
    B = G.shape[0]
    levels = torch.tensor(SIGMA_LEVELS, dtype=dtype, device="cuda")
    which = torch.arange(B, device="cuda") % len(SIGMA_LEVELS)
    per_sample = levels[which].contiguous()
    for want in kernels.WANTS:
        got = kernels.spd_estep(per_sample, G, b, rn, do, want=want)
        for i in range(len(SIGMA_LEVELS)):
            scalar = kernels.spd_estep(levels[i:i + 1], G, b, rn, do, want=want)
            rows = which == i
            for g, s in zip(defined(want, got), defined(want, scalar)):
                check(torch.equal(g[rows], s[rows]),
                      f"per-sample sigma {want} k={k} {dtype}: differs from the scalar launch")
            del scalar
        del got
    print(f"[kernels] k={k} {str(dtype).replace('torch.', '')}: per-sample sigma "
          f"({len(SIGMA_LEVELS)} levels over B={B}) equals the scalar-sigma launches bit for bit")


def batch_for(k: int) -> int:
    """Samples of the kernel checks at state size k: BATCH up to
    FULL_BATCH_MAX_K, above it the rows of one single-model block."""
    from ppca_rs_tpu_torch import config

    return BATCH if k <= FULL_BATCH_MAX_K else config.block_rows(k, 4)


def check_row_solve(gen, k: int) -> None:
    """M-step row solve (S[d] + lambda I) c_d = cross[d] at lambda = 0 over
    D=1024 rows, with one singular row (an empty dimension): that row alone
    goes non-finite, for the keep-old-row fallback."""
    from ppca_rs_tpu_torch.ops import kernels

    D, bad = 1024, 5
    for dtype, tol in ((torch.float64, TOL_F64), (torch.float32, TOL_F32)):
        V = torch.randn(D, k, 2 * k, generator=gen, dtype=torch.float64, device="cuda")
        S = V @ V.mT / (2 * k) + 0.05 * torch.eye(k, dtype=torch.float64, device="cuda")
        del V
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
        check(err <= tol, f"row solve k={k} {dtype}: relative error {err:.3e} above {tol}")
        print(f"[kernels] row solve lambda=0 k={k} D={D} {str(dtype).replace('torch.', '')}, "
              f"{kernels.design(k, 'estep', dtype)} design: singular row non-finite only; "
              f"max rel err {err:.3e} (tol {tol:g})")
        del S, cross, outs, want


def slab_of(G, poison_above: bool = False):
    """Square G (B, k, k) as the kernel's slabs (B, slab_width(k)): what the
    routes' slab Gram holds, the entries above the diagonal inside a
    diagonal block included; with ``poison_above`` those are NaN, which the
    kernel must never read."""
    from ppca_rs_tpu_torch.ops import kernels

    rows, cols = kernels.slab_coords(G.shape[-1], G.device)
    slabs = G[:, rows, cols]
    if poison_above:
        slabs[:, cols > rows] = math.nan
    return slabs.contiguous()


def check_same_as_square(tag: str, want: str, outs, square) -> None:
    """A launch on slab G equals the same launch on square G bit for bit
    (fullt's SM as the slabs of the square SM's lower triangle)."""
    if want == "fullt":
        square = (square[0], slab_of(torch.tril(square[1].nan_to_num())), *square[2:])
    check(all(torch.equal(a, b) for a, b in zip(outs, square)),
          f"{tag}: differs from the same launch on square G")


def check_slabs(gen) -> None:
    """Every spd_estep variant on slab G (NaN above the diagonal inside the
    diagonal blocks) into NaN-prefilled outputs, at SLAB_KS: against its
    plain version in float64 (fullt's slab SM entry by entry, 0 above the
    diagonal), with no NaN left in any output element, and equal bit for
    bit to the same launch on square G; then slab G refused at
    SLAB_REFUSED by the library and by the wrapper."""
    from ppca_rs_tpu_torch.ops import kernels

    for dtype, ks in SLAB_KS.items():
        tol = TOL_F32 if dtype == torch.float32 else TOL_F64
        for k in ks:
            check(kernels.uses_slabs(k, dtype) and kernels.design(k, "estep", dtype) == "tile",
                  f"slab k={k} {dtype}: not taken as slabs by the tile")
            inputs64, empty = kernel_inputs(SLAB_BATCH, k, gen)
            x = {n: t.to(dtype).contiguous() for n, t in inputs64.items()}
            x64 = {n: t.double() for n, t in x.items()}
            slabs = slab_of(x["G"], poison_above=True)
            worst = 0.0
            for want in kernels.WANTS:
                tag = f"slab {want} k={k} {str(dtype)[6:]}"
                outs = tuple(torch.full(sh, math.nan, dtype=dtype, device="cuda")
                             for sh in kernels.output_shapes(want, SLAB_BATCH, k, slab=True))
                kernels.launch(want, SIGMA, slabs, x["b"], x["rnorm"], x["d_obs"], outs)
                square = tuple(torch.full(sh, math.nan, dtype=dtype, device="cuda")
                               for sh in kernels.output_shapes(want, SLAB_BATCH, k))
                kernels.launch(want, SIGMA, x["G"], x["b"], x["rnorm"], x["d_obs"], square)
                torch.cuda.synchronize()
                ref = kernels.spd_estep_reference(SIGMA, slab_of(x64["G"]), x64["b"],
                                                  x64["rnorm"], x64["d_obs"], want)
                check_above_untouched(tag, want, outs)
                check(all(bool(torch.isfinite(o).all()) for o in outs),
                      f"{tag}: an output element was left unwritten or is non-finite")
                errs = [rel_err(o, r) for o, r in zip(outs, ref)]
                check(max(errs) <= tol, f"{tag}: relative errors {errs} above {tol}")
                if want != "llk":
                    check(bool((outs[0][empty] == 0).all()), f"{tag}: all-masked samples' states")
                check_same_as_square(tag, want, outs, square)
                worst = max(worst, max(errs))
                del outs, square, ref
            print(f"[kernels] slab G k={k} B={SLAB_BATCH} {str(dtype)[6:]} "
                  f"({kernels.slab_width(k)} elements a sample, {kernels.slab_width(k) / k ** 2:.4f}"
                  f" of k^2; NaN above the diagonal in its diagonal blocks): every variant, every "
                  f"output element written, max rel err {worst:.3e} (tol {tol:g}); fullt's slab "
                  "SM 0 above the diagonal; equal bit for bit to square G")
            del inputs64, x, x64, slabs
    for k, dtype in SLAB_REFUSED:
        B = 4
        z = dict(G=torch.zeros(B, kernels.slab_width(k), dtype=dtype, device="cuda"),
                 b=torch.zeros(B, k, dtype=dtype, device="cuda"),
                 rnorm=torch.ones(B, dtype=dtype, device="cuda"),
                 d_obs=torch.ones(B, dtype=dtype, device="cuda"))
        outs = kernels.empty_outputs("fullt", B, k, z["G"], slab=True)
        refused = []
        for fn, err in ((functools.partial(kernels.launch, "fullt", SIGMA, *z.values(), outs),
                         RuntimeError),
                        (functools.partial(kernels.spd_estep, SIGMA, *z.values()), ValueError)):
            try:
                fn()
            except err as e:
                refused.append(str(e).split(":")[-1].strip())
        torch.cuda.synchronize()
        check(len(refused) == 2, f"slab G at k={k} {dtype} was not refused: {refused}")
        print(f"[kernels] slab G at k={k} {str(dtype)[6:]} ({kernels.design(k, 'estep', dtype)} "
              f"design) refused: library {refused[0]!r}; wrapper {refused[1]!r}")


def time_layouts(k: int, x, sigma, empty) -> dict:
    """fullt, llk, states and infer on slab G at a shape the routes give
    them.  First each is checked there: launched into NaN-prefilled outputs
    on slab G and on square G, against its plain version in float64 on the
    same slab inputs (relative error within TOL_F32, no output element left
    NaN, fullt's slab SM 0 above the diagonal, the all-masked samples
    ``empty`` with states 0), and bit for bit against the square launch.
    Then it is timed in turns with square G (slab, square, square, slab:
    CUDA events around kernel_reps(k) launches into those outputs), each
    layout's device time from a profiler window of its own, beside the plain
    version on slab G and the bound of slab G.  Returns the slab rows, with
    this check's largest absolute error, each with the square layout's times
    under ``square``."""
    from ppca_rs_tpu_torch.ops import kernels

    G, b, rn, do = x["G"], x["b"], x["rnorm"], x["d_obs"]
    slabs = slab_of(G)
    B, dtype = G.shape[0], G.dtype
    reps = kernel_reps(k)
    sig = torch.full((1,), SIGMA, dtype=dtype, device="cuda") if sigma is None else sigma
    launchers = {"slab": {}, "square": {}}
    out = {}
    for want in SLAB_WANTS:
        tag = f"slab {want} k={k} B={B} {str(dtype)[6:]}"
        outs = {}
        for layout, g in (("slab", slabs), ("square", G)):
            outs[layout] = tuple(torch.full(sh, math.nan, dtype=dtype, device="cuda") for sh in
                                 kernels.output_shapes(want, B, k, slab=layout == "slab"))
            launchers[layout][want] = functools.partial(kernels.launch, want, sig, g, b, rn, do,
                                                        outs[layout])
            launchers[layout][want]()
        torch.cuda.synchronize()
        got = outs["slab"]
        ref = kernels.spd_estep_reference(sig.double(), slabs.double(), b.double(), rn.double(),
                                          do.double(), want)
        check_above_untouched(tag, want, got)
        check(all(bool(torch.isfinite(o).all()) for o in got),
              f"{tag}: an output element was left unwritten or is non-finite")
        errs = [rel_err(o, r) for o, r in zip(got, ref)]
        abs_err = max(float((o.double() - r).abs().max()) for o, r in zip(got, ref))
        check(max(errs) <= TOL_F32, f"{tag}: relative errors {errs} above {TOL_F32}")
        if want != "llk":
            check(bool((got[0][empty] == 0).all()), f"{tag}: all-masked samples' states")
        check_same_as_square(tag, want, got, outs["square"])
        print(f"[kernels] {tag}{', sigma per sample' if sig.numel() > 1 else ''}: every output "
              f"element written, max rel err {max(errs):.3e} (tol {TOL_F32:g}), max abs err "
              f"{abs_err:.3e}; equal bit for bit to square G")
        del ref, got
        plain = functools.partial(kernels.spd_estep_reference, sig, slabs, b, rn, do, want)
        a1, s1, s2, a2 = (cuda_ms(launchers["slab"][want], reps),
                          cuda_ms(launchers["square"][want], reps),
                          cuda_ms(launchers["square"][want], reps),
                          cuda_ms(launchers["slab"][want], reps))
        p1, p2 = cuda_ms(plain, PLAIN_REPS), cuda_ms(plain, PLAIN_REPS)
        out[want] = dict(ms=(a1 + a2) / 2, plain_ms=(p1 + p2) / 2, events=(a1, a2),
                         max_abs_err=abs_err, square=dict(ms=(s1 + s2) / 2, events=(s1, s2)))
    device = {layout: profiled_ms(fns, reps, dtype) for layout, fns in launchers.items()}
    peak = peak_flops(k, "estep", dtype)
    for want, row in out.items():
        b_ms, by = bound(*estep_work(want, B, k, dtype.itemsize, sig.numel(), slab=True), peak)
        sq_ms, sq_by = bound(*estep_work(want, B, k, dtype.itemsize, sig.numel()), peak)
        (a1, a2), (s1, s2) = row.pop("events"), row["square"].pop("events")
        dev, dev_sq = device["slab"][want], device["square"][want]
        print(f"[time] {want} k={k} B={B} {str(dtype)[6:]}"
              f"{', sigma per sample' if sig.numel() > 1 else ''}, slab G in turns with square G "
              f"(events, {reps} launches): slab {a1:.4f}/{a2:.4f} ms, square {s1:.4f}/{s2:.4f} ms "
              f"(slab/square {(a1 + a2) / (s1 + s2):.4f}); device time slab "
              f"{'not measured' if dev is None else f'{dev:.4f} ms'}, square "
              f"{'not measured' if dev_sq is None else f'{dev_sq:.4f} ms'} (profiler); plain on "
              f"slab G {row['plain_ms']:.4f} ms; slab {bound_note(b_ms, by, peak)}, square "
              f"{bound_note(sq_ms, sq_by, peak)}")
        row.update(device_ms=dev, bound_ms=b_ms, bound_us=b_ms * 1e3, bound_by=by,
                   library_ms=None, design=kernels.design(k, "estep", dtype), B=B, k=k,
                   layout="slabs")
        row["square"].update(device_ms=dev_sq, bound_ms=sq_ms, bound_by=sq_by)
    return out


def phase_kernels():
    """Phase 2.  Returns the float32 kernel rows at TIMED_K (summary), at
    WIDE_K (wide), at each of PANEL_KS (panel), and the float64 fullt rows
    at F64_TIMED_KS (keyed by k) with the states and llk rows at K_LK64
    (keyed by (want, k)); at TIMED_K and WIDE_K the SLAB_WANTS rows are
    those on slab G (time_layouts)."""
    from ppca_rs_tpu_torch.ops import kernels

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    summary, errors, wide, panel = {}, {}, {}, {}
    for k in KS:
        B = batch_for(k)
        print(f"[kernels] k={k} B={B}: served by the "
              + ", ".join(f"{design_note(k, kern, dt)} "
                          f"({name} {str(dt)[6:]})"
                          for kern, name in (("estep", "spd_estep"), ("chol", "spd_chol"))
                          for dt in (torch.float32, torch.float64)))
        inputs64, empty = kernel_inputs(B, k, gen)
        for dtype, tol in ((torch.float64, TOL_F64), (torch.float32, TOL_F32)):
            x = {n: t.to(dtype).contiguous() for n, t in inputs64.items()}
            # the plain version in float64 on exactly the kernel's inputs
            x64 = {n: t.double() for n, t in x.items()}
            for want in kernels.WANTS:
                tag = f"{want} k={k} {str(dtype).replace('torch.', '')}"
                outs = tuple(torch.full(sh, math.nan, dtype=dtype, device="cuda")
                             for sh in kernels.output_shapes(want, B, k))
                kernels.launch(want, SIGMA, x["G"], x["b"], x["rnorm"], x["d_obs"], outs)
                torch.cuda.synchronize()
                ref = kernels.spd_estep_reference(SIGMA, x64["G"], x64["b"], x64["rnorm"],
                                                  x64["d_obs"], want)
                check_above_untouched(tag, want, outs)
                got, exp = defined(want, outs), defined(want, ref)
                errs = [rel_err(o, r) for o, r in zip(got, exp)]
                abs_err = max(float((o.double() - r).abs().max()) for o, r in zip(got, exp))
                check(all(bool(torch.isfinite(o).all()) for o in got),
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
                print(f"[kernels] {tag}: max rel err {max(errs):.3e} (tol {tol:g}), "
                      f"max abs err {abs_err:.3e}")
                if dtype == torch.float32 and k in (TIMED_K, WIDE_K) + PANEL_KS:
                    errors[want, k] = abs_err
                del outs, ref
            check_not_pd(k, dtype, tol, gen)
            check_per_sample_sigma(k, dtype, x)
            if dtype == torch.float32:
                timed = time_estep(k, x, kernels.WANTS)
                if k == RAGGED_K:
                    ragged = timed["fullt"]
                if k == WIDE_K:
                    wide.update(timed)
                if k in PANEL_KS:
                    panel[k] = timed
                if k == TIMED_K:
                    summary.update(timed)
                    # the shapes the main path also gives: the pattern
                    # tables (full, B=P=32) and the M-step row solve
                    # (states, B=D=1024)
                    for want, n in (("full", P_PATTERN), ("states", D_MAIN)):
                        sub = {name: t[:n].contiguous() for name, t in x.items()}
                        timed = time_estep(k, sub, (want,))
                        if want == "full":
                            summary["full"] = timed["full"]
            del x, x64
        del inputs64
        torch.cuda.empty_cache()

    # G as slabs: every variant checked; fullt, llk, states and infer timed
    # in turns with square G at the routes' shapes; the slab rows stand for
    # the main path's in the kernels line (phase 8 times its own shapes)
    check_slabs(gen)
    for k, B, per_sample in SLAB_TIMED:
        inputs64, empty = kernel_inputs(B, k, gen)
        x = {n: t.float().contiguous() for n, t in inputs64.items()}
        del inputs64
        sig = None
        if per_sample:
            levels = torch.tensor(SIGMA_LEVELS, device="cuda")
            sig = levels[torch.arange(B, device="cuda") % len(SIGMA_LEVELS)].contiguous()
        rows = time_layouts(k, x, sig, empty)
        if k == TIMED_K:
            summary.update(rows)
        if k == WIDE_K:
            wide.update(rows)
        del x
        torch.cuda.empty_cache()

    f64 = {}
    for k in F64_TIMED_KS:
        inputs64, _ = kernel_inputs(BATCH, k, gen)
        # at phase 11c's k also the variants that path launches
        timed = time_estep(k, inputs64, ("fullt", "states", "llk") if k == K_LK64 else ("fullt",))
        f64[k] = timed.pop("fullt")
        f64.update({(want, k): row for want, row in timed.items()})
        del inputs64
        torch.cuda.empty_cache()
    for k in (13, 256):
        check_row_solve(gen, k)
    check_chol(gen, summary, wide, panel, f64)
    for k, rows in [(WIDE_K, wide)] + [(k, panel[k]) for k in PANEL_KS]:
        chol, fullt = rows["chol"], rows["fullt"]
        print(f"[kernels] k={k} B={fullt['B']} float32 ({fullt['design']} design): chol "
              f"{chol['ms']:.4f} ms vs torch.linalg.cholesky_ex {chol['library_ms']:.4f} ms "
              f"({'faster' if chol['ms'] < chol['library_ms'] else 'NOT faster'}); fullt "
              f"{fullt['ms']:.4f} ms vs its plain version {fullt['plain_ms']:.4f} ms "
              f"({'faster' if fullt['ms'] < fullt['plain_ms'] else 'NOT faster'}) (CUDA events)")
    square = summary["fullt"]["square"]
    print(f"[kernels] fullt float32 B={BATCH}, square G: k={RAGGED_K} {ragged['ms']:.4f} ms beside "
          f"k={TIMED_K} {square['ms']:.4f} ms (CUDA events; device time "
          f"{ragged['device_ms']} / {square['device_ms']} ms): rows of {RAGGED_K} "
          "elements are staged by element copies where they start unaligned, rows of "
          f"{TIMED_K} by 16-byte copies")
    for want in kernels.WANTS:
        if want not in SLAB_WANTS:
            summary[want]["max_abs_err"] = errors[want, TIMED_K]
            wide[want]["max_abs_err"] = errors[want, WIDE_K]
        for k in PANEL_KS:
            panel[k][want]["max_abs_err"] = errors[want, k]
    return summary, wide, panel, f64


#: spd_chol inputs: this sample is made negative definite, this one the identity.
NOT_SPD, IDENTITY = 5, 9


def time_chol(M, L) -> dict:
    """Times of spd_chol on ``M`` into ``L`` in their dtype (CUDA events in
    turns with the plain version, device time from the profiler) beside
    torch.linalg.cholesky_ex alone, which the port never calls, and the
    bound: M's lower triangle read, L written whole."""
    from ppca_rs_tpu_torch.ops import kernels

    B, k, _ = M.shape
    reps = kernel_reps(k)
    kern = functools.partial(kernels.launch_chol, M, L)
    plain = functools.partial(kernels.spd_chol_reference, M)
    library = functools.partial(torch.linalg.cholesky_ex, M)
    p1, k1, k2, p2 = (cuda_ms(plain, PLAIN_REPS), cuda_ms(kern, reps),
                      cuda_ms(kern, reps), cuda_ms(plain, PLAIN_REPS))
    l1, l2 = cuda_ms(library, PLAIN_REPS), cuda_ms(library, PLAIN_REPS)
    dev = profiled_ms({"chol": kern}, reps, M.dtype)["chol"]
    peak = peak_flops(k, "chol", M.dtype)
    b_ms, by = bound(B * (k * (k + 1) // 2 + k * k) * M.dtype.itemsize, B * k ** 3 / 3, peak)
    design = kernels.design(k, "chol", M.dtype)
    print(f"[time] chol k={k} B={B} {str(M.dtype)[6:]}, {design_note(k, 'chol', M.dtype)}: kernel "
          f"{k1:.4f}/{k2:.4f} ms (events, {reps} launches), "
          f"{'not measured' if dev is None else f'{dev:.4f} ms'} device time (profiler); "
          f"plain {p1:.4f}/{p2:.4f} ms; torch.linalg.cholesky_ex {l1:.4f}/{l2:.4f} ms; "
          f"{bound_note(b_ms, by, peak)}")
    return dict(ms=(k1 + k2) / 2, device_ms=dev, plain_ms=(p1 + p2) / 2, bound_ms=b_ms,
                bound_us=b_ms * 1e3, bound_by=by, library_ms=(l1 + l2) / 2, design=design,
                B=B, k=k)


def check_chol(gen, summary, wide, panel, f64) -> None:
    """spd_chol against its plain version: a non-SPD sample goes non-finite
    alone, the identity factors to itself, and every element above the
    diagonal is written as 0.  Timed beside its plain version and beside
    torch.linalg.cholesky_ex alone, which the port never calls: in float32,
    and in float64 at CHOL_F64_TIMED_KS (into ``f64`` by ("chol", k))."""
    from ppca_rs_tpu_torch.ops import kernels

    for k in KS:
        B = batch_for(k)
        opts = dict(dtype=torch.float64, device="cuda")
        V = torch.randn(B, k, 2 * k, generator=gen, **opts)
        eye = torch.eye(k, **opts)
        M64 = V @ V.mT / (2 * k) + 0.1 * eye
        del V
        M64[NOT_SPD] = -M64[NOT_SPD]
        M64[IDENTITY] = eye
        good = torch.ones(B, dtype=torch.bool, device="cuda")
        good[NOT_SPD] = False
        for dtype, tol in ((torch.float64, TOL_F64), (torch.float32, TOL_F32)):
            tag = f"chol k={k} B={B} {str(dtype).replace('torch.', '')}, {kernels.design(k, 'chol', dtype)} design"
            M = M64.to(dtype).contiguous()
            L = torch.full_like(M, math.nan)
            kernels.launch_chol(M, L)
            torch.cuda.synchronize()
            ref = kernels.spd_chol_reference(M.double())
            check(bool(torch.isfinite(L[good]).all()), f"{tag}: an SPD sample's factor is non-finite")
            check(not bool(torch.isfinite(L[NOT_SPD]).all()), f"{tag}: the non-SPD sample factored")
            check(bool((torch.triu(L, 1) == 0).all()), f"{tag}: an element above the diagonal is not 0")
            check(float((L[IDENTITY].double() - eye).abs().max()) <= 1e-6,
                  f"{tag}: the identity does not factor to itself")
            err = rel_err(L[good], ref[good])
            abs_err = float((L[good].double() - ref[good]).abs().max())
            check(err <= tol, f"{tag}: relative error {err:.3e} above {tol}")
            print(f"[kernels] {tag}: max rel err {err:.3e} (tol {tol:g}), max abs err {abs_err:.3e}; "
                  "non-SPD sample non-finite alone, identity exact, zeros above the diagonal")
            if dtype == torch.float64 and k in CHOL_F64_TIMED_KS:
                Mt = M.clone()   # M is M64 itself, which the float32 pass reads
                Mt[NOT_SPD] = eye
                f64["chol", k] = dict(time_chol(Mt, L), max_abs_err=abs_err)
                del Mt
            if dtype == torch.float32:
                M[NOT_SPD] = eye.to(dtype)
                row = dict(time_chol(M, L), max_abs_err=abs_err)
                if k == TIMED_K:
                    summary["chol"] = row
                if k == WIDE_K:
                    wide["chol"] = row
                if k in PANEL_KS:
                    panel[k]["chol"] = row
            del M, L, ref
        del M64
        torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# phase 3


def make_main_dataset(n: int = N_MAIN, k: int = K_MAIN, seed: int = SEED + 1):
    """n x D_MAIN float32 rows of a rank-k PPCA model plus noise, 50% of
    the entries missing at random, generated on the card (n a multiple of
    65,536, or a power of two below it)."""
    from ppca_rs_tpu_torch import Dataset

    gen = torch.Generator(device="cuda").manual_seed(seed)
    opts = dict(generator=gen, device="cuda", dtype=torch.float32)
    C = torch.randn(D_MAIN, k, **opts) * (2.0 / math.sqrt(k))
    mean = torch.randn(D_MAIN, **opts)
    data = torch.empty(n, D_MAIN, device="cuda", dtype=torch.float32)
    mask = torch.empty(n, D_MAIN, device="cuda", dtype=torch.bool)
    step = min(1 << 16, n)
    for lo in range(0, n, step):
        z = torch.randn(step, k, **opts)
        y = z @ C.T + mean + 0.5 * torch.randn(step, D_MAIN, **opts)
        m = torch.rand(step, D_MAIN, generator=gen, device="cuda") >= 0.5
        data[lo:lo + step] = torch.where(m, y, torch.zeros_like(y))
        mask[lo:lo + step] = m
    return Dataset.from_parts(data, mask)


def train(tag: str, dataset, seed: int, smi: str, k: int = K_MAIN, n_models=None,
          n_iters: int = N_ITERS, start=None):
    """``n_iters`` trainer iterations from a seeded init (or from
    ``start``), timed per iteration, of a PPCA model or, with ``n_models``,
    of a mixture of that many; the llk must never decrease.  Returns
    (model, launches during it)."""
    from ppca_rs_tpu_torch import PPCAMixTrainer, PPCATrainer
    from ppca_rs_tpu_torch.ops import kernels

    llks, stamps = [], []

    def callback(it, metrics):
        stamps.append(time.perf_counter())
        llks.append(metrics.llk)
        print(f"[{tag}] iteration {it}: llk/sample {metrics.llk:.6f}, "
              f"{stamps[-1] - stamps[-2]:.3f} s")

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    options = dict(state_size=k, n_iters=n_iters, quiet=True, callback=callback, start=start,
                   generator=torch.Generator(device="cuda").manual_seed(seed))
    if n_models is None:
        model = PPCATrainer(dataset).train(**options)
    else:
        model = PPCAMixTrainer(dataset).train(n_models=n_models, **options)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    GRAM_COUNTS[tag] = dict(kernels.GRAM_LAUNCHES)
    check(kernels.GRAM_LAUNCHES["library"] == 0,
          f"{tag}: {kernels.GRAM_LAUNCHES['library']} masked Grams left the Gram kernel")
    S_COUNTS[tag] = dict(kernels.S_LAUNCHES)
    check(kernels.S_LAUNCHES["library"] == 0,
          f"{tag}: {kernels.S_LAUNCHES['library']} M-step statistics left the S kernel")
    per_iter = [b - a for a, b in zip(stamps, stamps[1:])]
    check(all(math.isfinite(v) for v in llks), f"{tag}: non-finite llk in {llks}")
    for a, b in zip(llks, llks[1:]):
        check(b >= a - LLK_SLACK * abs(a), f"{tag}: llk decreased: {a} -> {b}")
    print(f"[{tag}] launches during training: {launches}, of them on slab G "
          f"{dict(kernels.SLAB_LAUNCHES)}; masked Grams {GRAM_COUNTS[tag]}; S {S_COUNTS[tag]}")
    print(f"[{tag}] seconds per EM iteration at N={len(dataset)}: "
          + ", ".join(f"{s:.4f}" for s in per_iter)
          + f"; mean of iterations 2-{n_iters}: {sum(per_iter[1:]) / (n_iters - 1):.4f} s "
          f"({smi}); peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    t0 = time.perf_counter()
    total = model.llk(dataset)
    print(f"[{tag}] model.llk: {total:.6e} ({total / len(dataset):.6f} per sample), "
          f"{time.perf_counter() - t0:.3f} s")
    check(math.isfinite(total), f"{tag}: final llk is not finite")
    check(total / len(dataset) >= llks[-1] - LLK_SLACK * abs(llks[-1]),
          f"{tag}: final llk/sample {total / len(dataset)} below the last iteration's {llks[-1]}")
    return model, launches


def check_readouts(tag: str, model, sub, k: int = K_MAIN):
    """infer, the covariance diagonals, smooth and extrapolate on ``sub``:
    shapes, finiteness, and observed entries left alone.  Returns the
    InferredMasked."""
    n = len(sub)
    inferred = model.infer(sub)
    states, covs = inferred.states(), inferred.covariances_array()
    sd = inferred.smoothed_covariances_diagonal(model).data
    ed = inferred.extrapolated_covariances_diagonal(model, sub).data
    smoothed = model.smooth(sub).data
    extrapolated = model.extrapolate(sub).data
    torch.cuda.synchronize()
    shapes = {"states": (states, (n, k)), "covariances": (covs, (n, k, k)),
              "smoothed_cov_diag": (sd, (n, D_MAIN)), "extrapolated_cov_diag": (ed, (n, D_MAIN)),
              "smooth": (smoothed, (n, D_MAIN)), "extrapolate": (extrapolated, (n, D_MAIN))}
    for name, (t, shape) in shapes.items():
        check(tuple(t.shape) == shape, f"{tag}: {name} shape {tuple(t.shape)} != {shape}")
        check(bool(torch.isfinite(t).all()), f"{tag}: {name} has non-finite values")
    check(bool((ed[sub.mask] == 0).all()), f"{tag}: extrapolation variance is nonzero at observed entries")
    check(bool((ed[~sub.mask] > 0).all()), f"{tag}: extrapolation variance is not positive at missing entries")
    check(bool((sd > 0).all()), f"{tag}: smoothed variance is not positive")
    check(bool((extrapolated[sub.mask] == sub.data[sub.mask]).all()),
          f"{tag}: extrapolate changed observed entries")
    print(f"[{tag}] readouts on {n} rows: shapes and finiteness ok, extrapolation "
          f"variance 0 at observed entries; mean smoothed sd {float(sd.sqrt().mean()):.4f}")
    return inferred


def gram_note(model) -> str:
    """The Gram's columns a sample on the masked and general mixture routes
    at the model's (largest) state size."""
    from ppca_rs_tpu_torch.ops import kernels

    k = max(model.state_sizes) if hasattr(model, "state_sizes") else model.state_size
    if not kernels.uses_slabs(k, torch.float32):
        return f"; Gram and S square, {k * k} columns"
    return (f"; Gram and S as slabs, {kernels.slab_width(k)} columns of {k * k} "
            f"({kernels.slab_width(k) / k ** 2:.4f})")


def profile_iteration(tag: str, model, dataset, top: int = 0, gram: bool = False) -> None:
    """One EM step over ``dataset`` under torch.profiler: device time of the
    SPD kernels (spd_estep's and spd_chol's designs), of the matmuls and of
    everything else, and the device's idle share of the window (one stream,
    so kernels do not overlap); with ``top``, also the ``top`` device
    kernels by time; with ``gram`` (the masked and general mixture routes),
    the Gram's columns a sample."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.iterate(dataset)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups = {"spd kernels": 0.0, "matmul": 0.0, "other": 0.0}
    kernels_by_time = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = evt.key.lower()
        group = ("spd kernels" if "spd_" in name else
                 "matmul" if any(w in name for w in ("gemm", "xmma", "cutlass")) else "other")
        groups[group] += evt.self_device_time_total / 1e6
        kernels_by_time.append((evt.self_device_time_total / 1e6, evt.count, evt.key))
    busy = sum(groups.values())
    if busy == 0:
        print(f"[{tag}] profile of one EM iteration: the profiler shows no device time "
              f"({wall:.4f} s of wall time)")
        return
    print(f"[{tag}] profile of one EM iteration ({wall:.4f} s of wall time under the profiler"
          f"{gram_note(model) if gram else ''}): "
          + ", ".join(f"{g} {t:.4f} s ({t / wall:.1%})" for g, t in groups.items())
          + f"; device idle {max(0.0, 1 - busy / wall):.1%}")
    for t, count, name in sorted(kernels_by_time, reverse=True)[:top]:
        print(f"[{tag}]   {t:.4f} s in {count} launches: {name[:150]}")


def check_slab_launches(tag: str, want: dict) -> None:
    """The launches on slab G since the counts were last set to 0 are
    exactly ``want`` (the variants not named: none), and are kept in
    SLAB_COUNTS under ``tag``."""
    from ppca_rs_tpu_torch.ops import kernels

    want = {name: want.get(name, 0) for name in kernels.WANTS}
    got = dict(kernels.SLAB_LAUNCHES)
    check(got == want, f"{tag}: launches on slab G {got} != {want}")
    SLAB_COUNTS[tag] = got
    print(f"[{tag}] launches on slab G (Gram built as slabs, "
          f"{'S summed as slabs, ' if got['fullt'] else ''}the rest square): {got}")


def phase_main(smi: str):
    from ppca_rs_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    dataset = make_main_dataset()
    torch.cuda.synchronize()
    print(f"[main] dataset N={len(dataset)} D={dataset.output_size()} k={K_MAIN} "
          f"{dataset.dtype}, observed share {float(dataset.mask.float().mean()):.4f}, "
          f"made in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    check(dataset.pattern_info() is None, "random masks were taken for structured missingness")
    print(f"[main] pattern detection demoted the random masks in {time.perf_counter() - t0:.3f} s")

    model, train_launches = train("main", dataset, SEED + 2, smi)
    n_blocks = -(-N_MAIN // 8192)
    check(train_launches["fullt"] >= N_ITERS * n_blocks,
          f"fullt launches {train_launches['fullt']} < {N_ITERS * n_blocks}")
    check(train_launches["states"] >= N_ITERS,
          f"states launches {train_launches['states']} < {N_ITERS}")

    check_readouts("main", model, dataset.slice(0, N_READOUT))
    launches = dict(kernels.LAUNCHES)
    n_sub = -(-N_READOUT // 8192)
    want = {"fullt": N_ITERS * n_blocks, "states": N_ITERS + 2 * n_sub, "llk": n_blocks,
            "infer": n_sub, "full": 0, "chol": 0}
    check(launches == want, f"masked path launches {launches} != {want}")
    # every E-step on slab G; the M-step's row solves (states, B=D) square
    check_slab_launches("main", dict(want, states=2 * n_sub))
    profile_iteration("main", model, dataset, gram=True)
    return model, dataset, launches


# --------------------------------------------------------------------- #
# phase 4


def model_cpu64(model):
    """The model's parameters in float64 on the CPU."""
    from ppca_rs_tpu_torch import PPCAModel

    return PPCAModel._from_params(model.transform.cpu().double(), model.mean.cpu().double(),
                                  model.isotropic_noise.cpu().double())


def card_vs_cpu(tag: str, model, sub, used, unused=(), tol: float = TOL_CARD_VS_CPU):
    """One EM step and the per-sample llks of ``sub`` on the card (in the
    model's dtype) against the port on the CPU in float64, which takes the
    same route, within ``tol``.  The card run must launch the kernels in
    ``used`` and none in ``unused``."""
    from ppca_rs_tpu_torch import Dataset
    from ppca_rs_tpu_torch.ops import kernels

    before = dict(kernels.LAUNCHES)
    card = model.iterate(sub)
    card_llks = model.llks(sub)
    torch.cuda.synchronize()
    for name in used:
        check(kernels.LAUNCHES[name] > before[name], f"{tag}: the card run did not launch {name}")
    for name in unused:
        check(kernels.LAUNCHES[name] == before[name], f"{tag}: the card run launched {name}")

    host = model_cpu64(model)
    sub_cpu = Dataset.from_parts(sub.data.cpu().double(), sub.mask.cpu(), sub.weights_dev.cpu().double())
    check((sub_cpu.pattern_info() is None) == (sub.pattern_info() is None),
          f"{tag}: the CPU copy takes another route")
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
    print(f"[{tag}] {len(sub)} rows, one EM step + llks, card {str(model.transform.dtype)[6:]} "
          f"vs CPU float64 ({secs:.1f} s on the CPU): "
          + ", ".join(f"{n} {v:.3e}" for n, v in diffs.items())
          + f" (max rel diff, tol {tol:g})")
    for name, v in diffs.items():
        check(v <= tol, f"{tag} {name}: {v:.3e} above {tol}")


# --------------------------------------------------------------------- #
# phase 5


def make_pattern_dataset():
    """N_PATTERN x D_MAIN float32 rows of a rank-K_MAIN model plus noise,
    each row's mask one of P_PATTERN Bernoulli(0.5) patterns, rows assigned
    uniformly (bench_suite.py's structured-missingness configuration),
    generated on the card.  Returns (dataset, the patterns drawn)."""
    from ppca_rs_tpu_torch import Dataset

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    opts = dict(generator=gen, device="cuda", dtype=torch.float32)
    patterns = torch.rand(P_PATTERN, D_MAIN, generator=gen, device="cuda") < 0.5
    mask = patterns[torch.randint(0, P_PATTERN, (N_PATTERN,), generator=gen, device="cuda")]
    C = torch.randn(D_MAIN, K_MAIN, **opts)
    data = torch.empty(N_PATTERN, D_MAIN, device="cuda", dtype=torch.float32)
    step = 1 << 16
    for lo in range(0, N_PATTERN, step):
        hi = min(lo + step, N_PATTERN)
        y = torch.randn(hi - lo, K_MAIN, **opts) @ C.T + 0.4 * torch.randn(hi - lo, D_MAIN, **opts)
        data[lo:hi] = torch.where(mask[lo:hi], y, torch.zeros_like(y))
    return Dataset.from_parts(data, mask), patterns


def check_sampler_moments(tag: str, model, rows):
    """N_DRAWS posterior draws of ``rows``: their mean within SAMPLER_SE
    standard errors of ``smooth`` on every entry, their mean variance within
    SAMPLER_VAR of the mean smoothed covariance diagonal."""
    inferred = model.infer(rows)
    sampler = inferred.posterior_sampler()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    total = torch.zeros(len(rows), rows.output_size(), dtype=torch.float64, device="cuda")
    total_sq = torch.zeros_like(total)
    for _ in range(N_DRAWS):
        y = sampler.sample(generator=gen).data.double()
        total += y
        total_sq += y * y
    mean = total / N_DRAWS
    var = (total_sq - N_DRAWS * mean * mean) / (N_DRAWS - 1)
    smooth = model.smooth(rows).data.double()
    sdiag = inferred.smoothed_covariances_diagonal(model).data.double()
    z = float(((mean - smooth).abs() / (sdiag / N_DRAWS).sqrt()).max())
    ratio = float(var.mean() / sdiag.mean())
    print(f"[{tag}] sampler: {N_DRAWS} draws of {len(rows)} rows: max |mean - smooth| "
          f"{z:.2f} standard errors (bound {SAMPLER_SE:g}); mean variance / mean smoothed "
          f"covariance diagonal {ratio:.4f} (bound 1 +- {SAMPLER_VAR:g})")
    check(z <= SAMPLER_SE, f"sampler mean {z:.2f} standard errors from smooth")
    check(abs(ratio - 1.0) <= SAMPLER_VAR, f"sampler variance ratio {ratio:.4f}")


def phase_pattern(smi: str):
    from ppca_rs_tpu_torch import PPCAModel, config
    from ppca_rs_tpu_torch.ops import kernels
    from ppca_rs_tpu_torch.ops import masked_linalg as ml
    from ppca_rs_tpu_torch.ops import pattern_dedup as pd

    t0 = time.perf_counter()
    dataset, drawn = make_pattern_dataset()
    torch.cuda.synchronize()
    print(f"[pattern] dataset N={len(dataset)} D={D_MAIN} k={K_MAIN} {dataset.dtype}, "
          f"{P_PATTERN} mask patterns, observed share {float(dataset.mask.float().mean()):.4f}, "
          f"made in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    info = dataset.pattern_info()
    torch.cuda.synchronize()
    t_detect = time.perf_counter() - t0
    check(info is not None and info[1].shape[0] == P_PATTERN, "the mask patterns were not detected")
    pidx, patterns = info
    check(bool((patterns[pidx] == dataset.mask).all()), "the detected patterns do not rebuild the mask")
    check(bool((patterns[:, None, :] == drawn[None]).all(-1).any(0).all()),
          "a drawn pattern is missing from the detected ones")
    t0 = time.perf_counter()
    order = dataset.pattern_order()
    torch.cuda.synchronize()
    check(order is not None, "the rows sorted by pattern were not built")
    print(f"[pattern] detection {t_detect:.3f} s ({P_PATTERN} patterns, they rebuild the mask), "
          f"sorted copy {time.perf_counter() - t0:.3f} s, segments of "
          f"{min(order[2])}-{max(order[2])} rows")

    pd.reset_counts()
    model, train_launches = train("pattern", dataset, SEED + 4, smi)
    counts = dict(pd.COUNTS)
    check(train_launches["fullt"] == 0, f"the pattern path factored per sample: {train_launches}")
    check(train_launches["full"] >= N_ITERS, f"full launches {train_launches['full']} < {N_ITERS}")
    # N_ITERS statistics passes, each over every segment, then train()'s one model.llk
    check(counts["tables"] == N_ITERS + 1 and counts["segments"] == N_ITERS * P_PATTERN
          and counts["rows"] == (N_ITERS + 1) * N_PATTERN,
          f"the iterations did not all take the per-segment EM: {counts}")
    print(f"[pattern] the route's work during training and its llk (pattern_dedup.COUNTS): "
          f"{counts}")

    sub = dataset.slice(0, N_READOUT)
    check(sub.pattern_info() is not None, "the readout rows were not taken as structured")
    inferred = check_readouts("pattern", model, sub)
    draw = inferred.posterior_sampler().sample(
        generator=torch.Generator(device="cuda").manual_seed(SEED + 5)).data
    torch.cuda.synchronize()
    check(kernels.LAUNCHES["chol"] >= 1, "the posterior sampler did not launch spd_chol")
    check(tuple(draw.shape) == (N_READOUT, D_MAIN) and bool(torch.isfinite(draw).all()),
          "posterior draws are not finite or have the wrong shape")
    check_sampler_moments("pattern", model, sub.slice(0, N_SAMPLER_ROWS))
    launches = dict(kernels.LAUNCHES)
    for name in ("fullt", "llk", "infer"):
        check(launches[name] == 0, f"the pattern path launched {name}: {launches}")
    print(f"[pattern] launches of the pattern path (training, readouts, sampler): {launches}")

    # both kernels again at the shapes this path gave them, against their
    # plain versions (these launches are not counted above)
    C, mean, sigma = model.transform, model.mean, model.isotropic_noise
    G = (patterns.float() @ ml.outer_flat(C)).reshape(P_PATTERN, K_MAIN, K_MAIN)
    zb, zr = torch.zeros(P_PATTERN, K_MAIN, device="cuda"), torch.zeros(P_PATTERN, device="cuda")
    d_obs = patterns.float().sum(-1)
    got = kernels.spd_estep(sigma, G, zb, zr, d_obs, want="full")
    ref = kernels.spd_estep_reference(sigma.double(), G.double(), zb.double(), zr.double(),
                                      d_obs.double(), "full")
    err_full = max(rel_err(g, r) for g, r in zip(got[1:], ref[1:]))
    covs = inferred.covariances_array().contiguous()
    err_chol = rel_err(kernels.spd_chol(covs), kernels.spd_chol_reference(covs.double()))
    print(f"[pattern] at this path's shapes: full (B={P_PATTERN}) max rel err {err_full:.3e}, "
          f"chol (B={N_READOUT}) max rel err {err_chol:.3e} (tol {TOL_F32:g})")
    check(err_full <= TOL_F32 and err_chol <= TOL_F32, "a kernel disagrees at the path's shapes")
    del inferred, covs, draw

    start = PPCAModel.init(K_MAIN, dataset, generator=torch.Generator(device="cuda").manual_seed(SEED + 7))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pat_model, pat_llks = start.iterate_n(dataset, N_COMPARE_ITERS)
    torch.cuda.synchronize()
    t_pat = (time.perf_counter() - t0) / N_COMPARE_ITERS
    config.use_pattern_dedup = False
    try:
        check(dataset.pattern_info() is None, "use_pattern_dedup=False was not honoured")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        gen_model, gen_llks = start.iterate_n(dataset, N_COMPARE_ITERS)
        torch.cuda.synchronize()
        t_gen = (time.perf_counter() - t0) / N_COMPARE_ITERS
        check(kernels.LAUNCHES["fullt"] > 0, "the general path did not run")
    finally:
        config.use_pattern_dedup = True
    llk_pat, llk_gen = pat_model.llk(dataset), gen_model.llk(dataset)
    rel = abs(llk_pat - llk_gen) / abs(llk_gen)
    print(f"[pattern] {N_COMPARE_ITERS} iterations from one start: pattern path {t_pat:.4f} s per "
          f"iteration, general path {t_gen:.4f} s per iteration ({smi}); final llk "
          f"{llk_pat:.9e} vs {llk_gen:.9e}, relative difference {rel:.2e} (tol {TOL_PATH_LLK:g}); "
          f"llks before each iteration {pat_llks.tolist()} vs {gen_llks.tolist()}")
    check(rel <= TOL_PATH_LLK, f"pattern and general paths disagree: {rel:.2e}")

    card_vs_cpu("pattern", model, dataset.slice(0, N_CPU), used=("full",), unused=("fullt",))
    return launches


# --------------------------------------------------------------------- #
# phase 6


def phase_dense(smi: str):
    from ppca_rs_tpu_torch import Dataset, Prior, config
    from ppca_rs_tpu_torch.ops import dense_fast as df
    from ppca_rs_tpu_torch.ops import kernels
    from ppca_rs_tpu_torch.ops import masked_linalg as ml

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    opts = dict(generator=gen, device="cuda", dtype=torch.float32)
    C = torch.randn(D_MAIN, K_MAIN, **opts) * (2.0 / math.sqrt(K_MAIN))
    mean = torch.randn(D_MAIN, **opts)
    data = torch.empty(N_MAIN, D_MAIN, device="cuda", dtype=torch.float32)
    step = 1 << 16
    for lo in range(0, N_MAIN, step):
        data[lo:lo + step] = (torch.randn(step, K_MAIN, **opts) @ C.T + mean
                              + 0.5 * torch.randn(step, D_MAIN, **opts))
    dataset = Dataset.unmasked(data)
    t0 = time.perf_counter()
    check(dataset.all_observed() and dataset.pattern_info() is None,
          "fully observed data did not take the dense route")
    print(f"[dense] dataset N={len(dataset)} D={D_MAIN} k={K_MAIN} fully observed, routed in "
          f"{time.perf_counter() - t0:.3f} s")

    model, train_launches = train("dense", dataset, SEED + 9, smi)
    check(all(v == 0 for v in train_launches.values()),
          f"the dense path launched a per-sample kernel: {train_launches}")

    sub = dataset.slice(0, N_CPU)
    Cm, mu, sigma = model.transform, model.mean, model.isotropic_noise
    tprec, _, _ = Prior().device_pieces(Cm.dtype, Cm.device)
    stats_d = df.em_stats(Cm, mu, sigma, sub.data, sub.weights_dev, block_size=config.block_size)
    dense = df.em_finalize(Cm, mu, sigma, stats_d, transformation_precision=tprec)
    stats_m = ml.em_stats(Cm, mu, sigma, sub.data, sub.mask, sub.weights_dev,
                          block_size=config.block_size)
    masked = ml.em_finalize(Cm, mu, sigma, stats_m, transformation_precision=tprec)
    diffs = {name: rel_err(a.reshape(-1), b.reshape(-1)) for name, a, b in
             zip(("transform", "mean", "isotropic_noise"), dense, masked)}
    diffs["llk"] = rel_err(stats_d.llk.reshape(1), stats_m.llk.reshape(1))
    print(f"[dense] {N_CPU} rows, one EM step, dense path vs masked path on the card: "
          + ", ".join(f"{n} {v:.3e}" for n, v in diffs.items())
          + f" (max rel diff, tol {TOL_CARD_VS_CPU:g})")
    for name, v in diffs.items():
        check(v <= TOL_CARD_VS_CPU, f"dense vs masked {name}: {v:.3e} above {TOL_CARD_VS_CPU}")

    # one whole step of the route, under set_sync_debug_mode("error"): any
    # call that waits for the device (a factorization or solve that checks
    # its result on the host, a scalar copied from pageable memory) raises
    def step():
        stats = df.em_stats(Cm, mu, sigma, dataset.data, dataset.weights_dev,
                            block_size=config.block_size)
        return stats.llk, *df.em_finalize(Cm, mu, sigma, stats, transformation_precision=tprec)

    torch.cuda.synchronize()
    df.reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        guarded = step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = dict(df.COUNTS)
    free = step()
    n_blocks = -(-len(dataset) // config.block_size)
    check(counts == {"posteriors": 1, "blocks": n_blocks, "rows": len(dataset)},
          f"dense: one step counted {counts}")
    gaps = {name: rel_err(a.reshape(-1), b.reshape(-1)) for name, a, b in
            zip(("llk", "transform", "mean", "isotropic_noise"), guarded, free)}
    check(all(v <= 1e-6 for v in gaps.values()), f"dense: the guarded step differs: {gaps}")
    print(f"[dense] one em_stats + em_finalize over {len(dataset)} rows under "
          f"set_sync_debug_mode('error'): no synchronization; {counts}")


# --------------------------------------------------------------------- #
# phase 7


def phase_wide(smi: str):
    """The masked path at k=WIDE_K, bench_suite.py's k128 configuration:
    training, ``model.llk``, the sampler, launch counts with the design
    that served each kernel, a profile, and card vs CPU.  Returns the
    launch counts of that run."""
    from ppca_rs_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    dataset = make_main_dataset(N_WIDE, WIDE_K, SEED + 10)
    torch.cuda.synchronize()
    print(f"[k128] dataset N={len(dataset)} D={dataset.output_size()} k={WIDE_K} "
          f"{dataset.dtype}, observed share {float(dataset.mask.float().mean()):.4f}, "
          f"made in {time.perf_counter() - t0:.2f} s")
    check(dataset.pattern_info() is None, "k128: random masks were taken for structured missingness")

    model, train_launches = train("k128", dataset, SEED + 11, smi, k=WIDE_K)
    n_blocks = -(-N_WIDE // 8192)
    n_sub = -(-N_WIDE_SAMPLER // 8192)
    check(train_launches["fullt"] == N_ITERS * n_blocks,
          f"k128: fullt launches {train_launches['fullt']} != {N_ITERS * n_blocks}")
    rows = dataset.slice(0, N_WIDE_SAMPLER)
    t0 = time.perf_counter()
    inferred = model.infer(rows)
    sampler = inferred.posterior_sampler()
    draw = sampler.sample(generator=torch.Generator(device="cuda").manual_seed(SEED + 12)).data
    torch.cuda.synchronize()
    print(f"[k128] infer + posterior_sampler + one draw of {len(rows)} rows: "
          f"{time.perf_counter() - t0:.3f} s")
    check(tuple(draw.shape) == (N_WIDE_SAMPLER, D_MAIN) and bool(torch.isfinite(draw).all()),
          "k128: posterior draws are not finite or have the wrong shape")
    check_sampler_moments("k128", model, rows)
    launches = dict(kernels.LAUNCHES)
    # training: fullt per block and a states row solve per iteration, then
    # model.llk; infer + sampler here and in check_sampler_moments, whose
    # smooth runs states
    want = {"fullt": N_ITERS * n_blocks, "states": N_ITERS + n_sub, "llk": n_blocks,
            "infer": 2 * n_sub, "full": 0, "chol": 2}
    check(launches == want, f"k128: launches {launches} != {want}")
    check_slab_launches("k128", dict(want, states=n_sub))
    served = {"fullt": "estep", "states": "estep", "llk": "estep", "infer": "estep", "chol": "chol"}
    designs = {name: kernels.design(WIDE_K, kern) for name, kern in served.items()}
    check(all(d == "tile" for d in designs.values()), f"k128: not all served by the tile: {designs}")
    print(f"[k128] launches of the k={WIDE_K} path (training, llk, infer, sampler): {launches}; "
          + ", ".join(f"{name} by the {d} design" for name, d in designs.items()))
    del inferred, sampler, draw
    profile_iteration("k128", model, dataset, gram=True)
    card_vs_cpu("k128", model, dataset.slice(0, N_WIDE_CPU), used=("fullt", "llk"))
    return launches


# --------------------------------------------------------------------- #
# phase 8


def make_mix_dataset(observed: float = MIX_OBSERVED, seed: int = SEED + 13, n: int = N_MIX,
                     d: int = D_MIX, k: int = K_MIX, m_comp: int = M_MIX, patterns=None):
    """bench_suite.py's mixture data (row 4), made on the card: n rows,
    each from one of ``m_comp`` components drawn uniformly, y = C_m z + mu_m
    + 0.3 eps with C_m ~ N(0, 1) (d x k) and mu_m ~ 3 N(0, 1), each entry
    observed with probability ``observed`` (1 gives a fully observed copy
    of the same values), or, with ``patterns`` (P, d), each row observed
    as one of the P patterns drawn uniformly."""
    from ppca_rs_tpu_torch import Dataset

    gen = torch.Generator(device="cuda").manual_seed(seed)
    opts = dict(generator=gen, device="cuda", dtype=torch.float32)
    Cs = torch.randn(m_comp, d, k, **opts)
    means = 3.0 * torch.randn(m_comp, d, **opts)
    comp = torch.randint(0, m_comp, (n,), generator=gen, device="cuda")
    data = torch.empty(n, d, device="cuda", dtype=torch.float32)
    mask = torch.empty(n, d, device="cuda", dtype=torch.bool)
    step = 1 << 16
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        c = comp[lo:hi]
        z = torch.randn(hi - lo, k, **opts)
        y = means[c] + 0.3 * torch.randn(hi - lo, d, **opts)
        for m in range(m_comp):
            rows = (c == m).nonzero().squeeze(1)
            y.index_add_(0, rows, z[rows] @ Cs[m].T)
        if patterns is None:
            seen = torch.rand(hi - lo, d, generator=gen, device="cuda") < observed
        else:
            seen = patterns[torch.randint(0, patterns.shape[0], (hi - lo,), generator=gen,
                                          device="cuda")]
        data[lo:hi] = torch.where(seen, y, torch.zeros_like(y))
        mask[lo:hi] = seen
    return Dataset.from_parts(data, mask)


def mix_on_cpu64(mix):
    """The mixture's parameters in float64 on the CPU."""
    from ppca_rs_tpu_torch import PPCAMix

    return PPCAMix([model_cpu64(m) for m in mix.models], mix.log_weights.cpu().double())


def mix_diffs(a, b) -> dict:
    """Max relative differences of two mixtures' parameters (weights, not
    log-weights: a dead component's log-weight is -inf)."""
    pa, pb = a._stacked_params(), b._stacked_params()
    diffs = {name: rel_err(x.cpu(), y.cpu()) for name, x, y in
             zip(("transforms", "means", "noises"), pa, pb)}
    diffs["weights"] = rel_err(a.weights.cpu(), b.weights.cpu())
    return diffs


def report_diffs(tag: str, what: str, diffs: dict, tol: float) -> None:
    print(f"[{tag}] {what}: " + ", ".join(f"{n} {v:.3e}" for n, v in diffs.items())
          + f" (max rel diff, tol {tol:g})")
    for name, v in diffs.items():
        check(v <= tol, f"{tag} {what} {name}: {v:.3e} above {tol}")


def mix_readouts(mix, sub) -> None:
    """llk, infer_cluster, infer, smooth, extrapolate and the posterior
    sampler on ``sub``, each timed (host clock, ending in a device sync),
    with shape, finiteness and consistency checks."""
    n, times = len(sub), {}

    def run(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    llk = run("llk", lambda: mix.llk(sub))
    cluster = run("infer_cluster", lambda: mix.infer_cluster(sub))
    inferred = run("infer", lambda: mix.infer(sub))
    smoothed = run("smooth", lambda: mix.smooth(sub).data)
    extrapolated = run("extrapolate", lambda: mix.extrapolate(sub).data)
    sampler = run("posterior_sampler", inferred.posterior_sampler)
    draw = run("sample", lambda: sampler.sample(
        generator=torch.Generator(device="cuda").manual_seed(SEED + 15)).data)
    check(math.isfinite(llk), "mix: llk is not finite")
    check(tuple(cluster.shape) == (n, M_MIX) and bool(torch.isfinite(cluster).all()),
          "mix: infer_cluster has the wrong shape or non-finite values")
    check(float((cluster.exp().sum(-1) - 1).abs().max()) <= 1e-4,
          "mix: infer_cluster rows are not log-probabilities")
    gap = float((inferred.log_posteriors().exp() - cluster.exp()).abs().max())
    check(gap <= 1e-3, f"mix: infer's and infer_cluster's posteriors differ by {gap:.3e}")
    states = inferred.states()
    covs = torch.stack(inferred.covariances())
    shapes = {"states": (states, (n, K_MIX)), "covariances": (covs, (n, K_MIX, K_MIX)),
              "smooth": (smoothed, (n, D_MIX)), "extrapolate": (extrapolated, (n, D_MIX)),
              "sample": (draw, (n, D_MIX))}
    for name, (t, shape) in shapes.items():
        check(tuple(t.shape) == shape, f"mix: {name} shape {tuple(t.shape)} != {shape}")
        check(bool(torch.isfinite(t).all()), f"mix: {name} has non-finite values")
    check(bool((extrapolated[sub.mask] == sub.data[sub.mask]).all()),
          "mix: extrapolate changed observed entries")
    share = cluster.exp().mean(0)
    print(f"[mix] readouts on {n} rows: llk/sample {llk / n:.6f}; "
          + ", ".join(f"{name} {t:.4f} s" for name, t in times.items())
          + f"; mean responsibility per component {[round(float(v), 4) for v in share]}")


def phase_mix(smi: str):
    """PPCA mixtures at bench_suite.py's mixture configuration: training,
    readouts, sampler moments, exact launch counts, a profile, card vs CPU,
    fused vs loop, the dense copy on the table route, and every kernel at
    this phase's shapes.  Returns (launches of the main run, kernel rows
    at this phase's shapes)."""
    from ppca_rs_tpu_torch import Dataset, Prior, config
    from ppca_rs_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    dataset = make_mix_dataset()
    torch.cuda.synchronize()
    print(f"[mix] dataset N={len(dataset)} D={D_MIX} k={K_MIX} M={M_MIX} {dataset.dtype}, "
          f"observed share {float(dataset.mask.float().mean()):.4f}, made in "
          f"{time.perf_counter() - t0:.2f} s")
    check(dataset.pattern_info(include_dense=True) is None,
          "mix: random masks were taken for structured missingness")
    rows = config.mix_block_rows(M_MIX, K_MIX, 4)
    n_blocks, n_sub = -(-N_MIX // rows), -(-N_MIX_READOUT // rows)
    print(f"[mix] {rows} data rows a block: {M_MIX * rows} kernel samples a launch, "
          f"{n_blocks} blocks")

    mix, train_launches = train("mix", dataset, SEED + 14, smi, k=K_MIX, n_models=M_MIX)
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(fullt=N_ITERS * n_blocks, states=N_ITERS)
    check(train_launches == want, f"mix: training launches {train_launches} != {want}")

    sub = dataset.slice(0, N_MIX_READOUT)
    mix_readouts(mix, sub)
    check_sampler_moments("mix", mix, sub)
    launches = dict(kernels.LAUNCHES)
    # training; model.llk over all rows; on the readout rows llk and
    # infer_cluster (llk), infer twice (infer), smooth, extrapolate and the
    # moment check's smooth (states), two posterior samplers of M factors
    want.update(states=N_ITERS + 3 * n_sub, llk=n_blocks + 2 * n_sub, infer=2 * n_sub,
                chol=2 * M_MIX)
    check(launches == want, f"mix: launches {launches} != {want}")
    print(f"[mix] launches of the mixture path (training, llk, readouts, sampler): {launches}")
    check_slab_launches("mix", dict(want, states=3 * n_sub))

    profile_iteration("mix", mix, dataset, top=8, gram=True)
    width = kernels.slab_width(K_MIX) if kernels.uses_slabs(K_MIX, torch.float32) else K_MIX ** 2
    flops = 2 * 2 * N_MIX * D_MIX * M_MIX * width
    print(f"[mix] the Gram and S matmuls over {width} columns a sample ({width / K_MIX ** 2:.4f} of "
          f"k^2) do {flops / 1e12:.3f} TFLOP per iteration: at least "
          f"{flops / PEAK_F32_FLOPS * 1e3:.1f} ms at {PEAK_F32_FLOPS / 1e12:g} TFLOP/s float32")

    rows_cpu = dataset.slice(0, N_MIX_CPU)
    before = dict(kernels.LAUNCHES)
    card, card_llk = mix._iterate_with_llk(rows_cpu, Prior())
    card_llks = mix.llks(rows_cpu)
    torch.cuda.synchronize()
    check(kernels.LAUNCHES["fullt"] > before["fullt"] and kernels.LAUNCHES["llk"] > before["llk"],
          "mix card-vs-cpu: the card run did not launch fullt and llk")
    host = mix_on_cpu64(mix)
    rows_host = Dataset.from_parts(rows_cpu.data.cpu().double(), rows_cpu.mask.cpu(),
                                   rows_cpu.weights_dev.cpu().double())
    t0 = time.perf_counter()
    cpu, cpu_llk = host._iterate_with_llk(rows_host, Prior())
    cpu_llks = host.llks(rows_host)
    diffs = mix_diffs(card, cpu)
    diffs["llk"] = abs(card_llk - cpu_llk) / abs(cpu_llk)
    diffs["llks"] = rel_err(card_llks.cpu(), cpu_llks)
    report_diffs("mix", f"{N_MIX_CPU} rows, one EM step + llks, card float32 vs CPU float64 "
                 f"({time.perf_counter() - t0:.1f} s on the CPU)", diffs, TOL_CARD_VS_CPU)

    rnorm_envelope(mix, rows_cpu, rows_host)

    loop, loop_llk = mix._iterate_loop(rows_cpu, Prior())
    diffs = mix_diffs(card, loop)
    diffs["llk"] = abs(card_llk - loop_llk) / abs(loop_llk)
    report_diffs("mix", f"{N_MIX_CPU} rows, one EM step on the card, fused vs the per-component "
                 "loop", diffs, TOL_CARD_VS_CPU)

    dense_launches = phase_mix_dense(mix, smi)
    kernel_rows = check_mix_kernels(mix, dataset, sub)
    return {**launches, "full": dense_launches["full"]}, kernel_rows


def rnorm_envelope(mix, rows, rows_host) -> None:
    """The default EM block's expanded |r|^2 in float32 on the card against
    the residual computed directly (config.mix_exact_rnorm) in float64 on
    the CPU, on this data: dev_sq, the noise update's data term, and the
    llk, the sums it enters most directly."""
    from ppca_rs_tpu_torch import config
    from ppca_rs_tpu_torch.ops import mix_fused as mf

    def stats(m, ds):
        Cs, means, sigmas = m._stacked_params()
        return mf.mix_em_stats(Cs, means, sigmas, m.log_weights, ds.data, ds.mask, ds.weights_dev,
                               block_size=config.block_size)

    card = stats(mix, rows)
    config.mix_exact_rnorm = True
    try:
        exact = stats(mix_on_cpu64(mix), rows_host)
    finally:
        config.mix_exact_rnorm = False
    alive = exact.resp_sum > 0
    dev = float(((card.dev_sq.cpu().double() - exact.dev_sq) / exact.dev_sq)[alive].abs().max())
    llk = abs(float(card.llk) - float(exact.llk)) / abs(float(exact.llk))
    print(f"[mix] expanded |r|^2 envelope on {len(rows)} rows: card float32 (default block) vs "
          f"CPU float64 with the residual formed: dev_sq {dev:.3e} (max over live components), "
          f"llk {llk:.3e} relative")
    check(dev <= TOL_CARD_VS_CPU and llk <= TOL_CARD_VS_CPU, "mix: |r|^2 envelope above the bound")


def phase_mix_dense(mix, smi: str) -> dict:
    """A fully observed copy of the mixture data takes the table route with
    one pattern: N_DENSE_ITERS EM iterations and the llk launch ``full``
    for the tables and ``states`` for the row solves, and no ``fullt``.
    One step on its first rows agrees with the general route's."""
    from ppca_rs_tpu_torch import config
    from ppca_rs_tpu_torch.ops import kernels

    dense = make_mix_dataset(observed=1.0)
    pattern = dense.pattern_info(include_dense=True)
    check(dense.all_observed() and pattern is not None and pattern[1].shape[0] == 1,
          "mix dense: fully observed data did not take the single-pattern table route")
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense_mix, llks = mix.iterate_n(dense, N_DENSE_ITERS)
    torch.cuda.synchronize()
    per_iter = (time.perf_counter() - t0) / N_DENSE_ITERS
    final = dense_mix.llk(dense)
    launches = dict(kernels.LAUNCHES)
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(full=N_DENSE_ITERS + 1, states=N_DENSE_ITERS)
    check(launches == want, f"mix dense: launches {launches} != {want}")
    seq = llks.tolist() + [final]
    for a, b in zip(seq, seq[1:]):
        check(b >= a - LLK_SLACK * abs(a), f"mix dense: llk decreased: {a} -> {b}")
    print(f"[mix] dense copy, table route with one pattern: {N_DENSE_ITERS} iterations at "
          f"{per_iter:.4f} s each ({smi}); llks {seq}; launches {launches}")

    sub = dense.slice(0, N_MIX_CPU)
    table = mix._iterate_with_llk(sub, None)
    config.use_pattern_dedup = False
    try:
        general = mix._iterate_with_llk(sub, None)
    finally:
        config.use_pattern_dedup = True
    diffs = mix_diffs(table[0], general[0])
    diffs["llk"] = abs(table[1] - general[1]) / abs(general[1])
    report_diffs("mix", f"dense copy, {N_MIX_CPU} rows, one EM step, table route vs general route "
                 "on the card", diffs, TOL_CARD_VS_CPU)
    time_pattern_grouping(config.mix_block_rows(M_MIX, K_MIX, 4))
    return launches


def time_pattern_grouping(rows: int) -> None:
    """The table route's per-pattern second-moment sums of one block (M x
    ``rows`` samples, k = K_MIX) both ways ``mix_fused.mix_em_stats_pat``
    has them: ``index_add_`` of the (M, rows, k*k) outer products, whose
    atomic adds all land on P rows, and the one-hot matmul it takes for
    P <= k (CUDA events, 30 calls each, in turns)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 16)
    M, k = M_MIX, K_MIX
    s = torch.randn(M, rows, k, generator=gen, device="cuda")
    sw = s * torch.rand(M, rows, 1, generator=gen, device="cuda")
    for P in (1, 8, 32):
        pb = torch.randint(0, P, (rows,), generator=gen, device="cuda")
        Souter = torch.zeros(M, P, k * k, device="cuda")

        def by_index_add():
            Souter.index_add_(1, pb, (sw[..., :, None] * s[..., None, :]).view(M, -1, k * k))

        def by_one_hot():
            onehot = torch.nn.functional.one_hot(pb, P).float()
            A = (onehot[None, :, :, None] * sw[:, :, None, :]).view(M, -1, P * k)
            Souter.add_(torch.bmm(A.mT, s).view(M, P, k * k))

        a1, o1, o2, a2 = (cuda_ms(by_index_add, KERNEL_REPS), cuda_ms(by_one_hot, KERNEL_REPS),
                          cuda_ms(by_one_hot, KERNEL_REPS), cuda_ms(by_index_add, KERNEL_REPS))
        print(f"[mix] per-pattern sums of {M} x {rows} rows, k={k}, P={P}: index_add_ "
              f"{a1:.4f}/{a2:.4f} ms, one-hot matmul {o1:.4f}/{o2:.4f} ms")


def row_solve_inputs(stats) -> dict:
    """The M-step's row solve of a mixture's live components (a dead one's
    statistics are 0), lambda = 0: ``spd_estep`` inputs of M x D rows."""
    from ppca_rs_tpu_torch.ops import masked_linalg as ml

    k = stats.cross.shape[-1]
    alive = stats.resp_max > 0
    inv = 1.0 / stats.resp_max[alive]
    S = ml.symmetric_from_lower((stats.S[alive] * inv[:, None, None]).reshape(-1, k, k))
    cross = (stats.cross[alive] * inv[:, None, None]).reshape(-1, k)
    zeros = torch.zeros(cross.shape[0], device="cuda")
    return dict(G=S.contiguous(), b=cross.contiguous(), rnorm=zeros, d_obs=zeros)


def check_estep_at(tag: str, want: str, inp: dict, sigma, k: int) -> float:
    """One float32 launch of ``want`` on ``inp`` into NaN-prefilled outputs
    against its plain version in float64 (TOL_F32 relative to each output's
    largest magnitude; the row solve's states alone); returns the largest
    absolute error."""
    from ppca_rs_tpu_torch.ops import kernels

    n = inp["G"].shape[0]
    outs = tuple(torch.full(sh, math.nan, device="cuda")
                 for sh in kernels.output_shapes(want, n, k, inp["G"].ndim == 2))
    kernels.launch(want, sigma, inp["G"], inp["b"], inp["rnorm"], inp["d_obs"], outs)
    torch.cuda.synchronize()
    ref = kernels.spd_estep_reference(sigma.double(), *(inp[n_].double() for n_ in
                                                        ("G", "b", "rnorm", "d_obs")), want)
    check_above_untouched(f"{tag} {want} B={n}", want, outs)
    outs, ref = defined(want, outs), defined(want, ref)
    if want == "states":      # lambda = 0: the row solve reads the solution alone
        outs, ref = outs[:1], ref[:1]
    check(all(bool(torch.isfinite(o).all()) for o in outs),
          f"{tag} {want} B={n}: an output element was left unwritten or is non-finite")
    err = max(rel_err(o, r) for o, r in zip(outs, ref))
    abs_err = max(float((o.double() - r).abs().max()) for o, r in zip(outs, ref))
    check(err <= TOL_F32, f"{tag} {want} B={n}: relative error {err:.3e} above {TOL_F32}")
    print(f"[{tag}] kernel {want} k={k} B={n} float32: max rel err {err:.3e} (tol {TOL_F32:g}), "
          f"max abs err {abs_err:.3e}")
    return abs_err


def check_mix_kernels(mix, dataset, sub) -> dict:
    """Every kernel at the shapes phase 8 gave it, against its plain
    version on NaN-prefilled outputs, and timed: fullt, llk and infer on
    the first block (M x rows samples, sigma per sample, component-major,
    checked bit for bit against launches with each component's sigma for
    the whole batch); states on the M x D row solve of this mixture's
    statistics (lambda = 0); full on the dense copy's M x 1 tables; chol
    on the 8,192 posterior covariances of the first component."""
    from ppca_rs_tpu_torch import config
    from ppca_rs_tpu_torch.ops import kernels
    from ppca_rs_tpu_torch.ops import masked_linalg as ml
    from ppca_rs_tpu_torch.ops import mix_fused as mf

    Cs, means, sigmas = mix._stacked_params()
    rows = config.mix_block_rows(M_MIX, K_MIX, 4)
    B, k = M_MIX * rows, K_MIX
    block = dataset.slice(0, rows)
    mask_f = block.mask.float()
    _, b, rnorm = mf._projections(Cs, mf._center_prep(Cs, means), block.data, mask_f)
    # the Gram as the route builds it: slabs where the kernel takes them
    G = torch.matmul(mask_f, ml.gram_columns(Cs, torch.float32))
    x = dict(G=kernels.estep_gram(G, B, k), b=b.reshape(B, k),
             rnorm=rnorm.reshape(B), d_obs=mask_f.sum(-1).repeat(M_MIX))
    sig = sigmas.repeat_interleave(rows)

    stats = mf.mix_em_stats(Cs, means, sigmas, mix.log_weights, dataset.data, dataset.mask,
                            dataset.weights_dev, block_size=rows)
    x_states = row_solve_inputs(stats)
    ones = torch.ones(1, D_MIX, device="cuda")
    x_full = dict(G=torch.matmul(ones, ml.outer_flat(Cs)).reshape(M_MIX, k, k),
                  b=torch.zeros(M_MIX, k, device="cuda"), rnorm=torch.zeros(M_MIX, device="cuda"),
                  d_obs=torch.full((M_MIX,), float(D_MIX), device="cuda"))
    cases = [("fullt", x, sig), ("llk", x, sig), ("infer", x, sig),
             ("states", x_states, torch.zeros(1, device="cuda")), ("full", x_full, sigmas)]
    errors = {want: check_estep_at("mix", want, inp, s_, k) for want, inp, s_ in cases}
    which = torch.arange(B, device="cuda") // rows
    for want in ("fullt", "llk", "infer"):
        got = kernels.spd_estep(sig, x["G"], x["b"], x["rnorm"], x["d_obs"], want=want)
        for m in range(M_MIX):
            scalar = kernels.spd_estep(sigmas[m:m + 1], x["G"], x["b"], x["rnorm"], x["d_obs"],
                                       want=want)
            for g, s_ in zip(defined(want, got), defined(want, scalar)):
                check(torch.equal(g[which == m], s_[which == m]),
                      f"mix {want}: component {m}'s samples differ from its scalar-sigma launch")
    print(f"[mix] fullt, llk, infer at B={B}: the {M_MIX} components' sigmas stacked per sample "
          "equal scalar-sigma launches bit for bit")

    covs = mix.infer(sub).sub_states()[0].covariances_array().contiguous()
    L = torch.full_like(covs, math.nan)
    kernels.launch_chol(covs, L)
    torch.cuda.synchronize()
    ref = kernels.spd_chol_reference(covs.double())
    err = rel_err(L, ref)
    errors["chol"] = float((L.double() - ref).abs().max())
    check(bool(torch.isfinite(L).all()) and err <= TOL_F32,
          f"mix chol B={len(covs)}: relative error {err:.3e} or non-finite values")
    print(f"[mix] kernel chol k={k} B={len(covs)} float32: max rel err {err:.3e} "
          f"(tol {TOL_F32:g}), max abs err {errors['chol']:.3e}")

    timed = time_estep(k, x, ("fullt", "llk", "infer"), sigma=sig)
    timed.update(time_estep(k, x_states, ("states",), sigma=torch.zeros(1, device="cuda")))
    timed.update(time_estep(k, x_full, ("full",), sigma=sigmas))
    timed["chol"] = time_chol(covs, L)
    for name, row in timed.items():
        row["max_abs_err"] = errors[name]
    return timed


# --------------------------------------------------------------------- #
# phase 9


def chunk_bytes(ds) -> int:
    return ds.data.nbytes + ds.mask.nbytes + ds.weights_dev.nbytes


def host_copies(parts, pinned: bool):
    """Host copies of the datasets ``parts``, their tensors in pinned (or
    pageable) memory."""
    from ppca_rs_tpu_torch import Dataset

    return [Dataset.from_parts(*(torch.empty(t.shape, dtype=t.dtype, pin_memory=pinned).copy_(t)
                                 for t in (p.data, p.mask, p.weights_dev))) for p in parts]


def lazy(chunks):
    """The chunks as zero-argument callables, as a lazy loader hands them."""
    return [functools.partial(lambda c: c, c) for c in chunks]


def stream_once(model, chunks, prefetch: int, mix: bool = False):
    """One streamed EM iteration, timed by the host clock ending in a device
    sync, with the launch counts of that iteration and its peak device
    memory: (new model, llk, seconds, launches, peak bytes).  The peak is
    the allocator's reserved memory, from an emptied cache: a chunk freed
    while the device still reads it stays reserved (``record_stream``)
    but no longer counts as allocated."""
    from ppca_rs_tpu_torch import iterate_mix_streamed, iterate_streamed
    from ppca_rs_tpu_torch.ops import kernels

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    new, llk = (iterate_mix_streamed if mix else iterate_streamed)(model, chunks, prefetch=prefetch)
    torch.cuda.synchronize()
    return (new, llk, time.perf_counter() - t0, dict(kernels.LAUNCHES),
            torch.cuda.max_memory_reserved())


def resident_step(model, dataset, reps: int = 2):
    """``model._em_step`` over the resident ``dataset``, ``reps`` times (the
    first also decides the route): (new model, llk, seconds of each, peak
    reserved device memory of the last, as :func:`stream_once` reads it)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        new, llk = model._em_step(dataset, None)
        llk = float(llk)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return new, llk, times, torch.cuda.max_memory_reserved()


def counted_pass(model, chunks, sync_free: bool):
    """One streamed EM iteration (``streaming._step``, prefetch 1) from an
    emptied cache: (new model, llk, host chunks brought in
    (``streaming.COUNTS``: slices copied, routes decided), peak requested
    device memory in bytes).  With ``sync_free`` the pass runs under
    ``torch.cuda.set_sync_debug_mode("error")``: any call that waits for the
    device's stream (a copy from pageable memory, a read of a device
    value), but the pass's own event waits, raises.  The llk is read after
    it."""
    from ppca_rs_tpu_torch import streaming

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    streaming.reset_counts()
    if sync_free:
        torch.cuda.set_sync_debug_mode("error")
    try:
        new, llk, _ = streaming._step(model, chunks, None, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = dict(streaming.COUNTS)
    llk = float(llk)
    torch.cuda.synchronize()
    return new, llk, counts, torch.cuda.memory_stats()["requested_bytes.all.peak"]


def merged(spans):
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def overlap_pass(model, chunks):
    """One streamed EM iteration (prefetch 1), untraced, with CUDA events
    on the copy stream around each slice's copy and on the compute stream
    around each piece's statistics: (seconds by the host clock ending in a
    device sync, copy seconds, copy seconds with no statistics running).
    A piece's statistics span from when the compute stream reaches them
    to their end, the gaps between their kernels included, so the exposed
    copy time is a lower bound."""
    from ppca_rs_tpu_torch import streaming

    spans = {"copy": [], "stats": []}
    copy_fn, accumulate = streaming._Transfer.__call__, streaming._accumulate

    def timed(stream, kind, fn, *args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = fn(*args)
        end.record(stream)
        spans[kind].append((start, end))
        return out

    def transfer(self, ds):
        return timed(self.stream, "copy", copy_fn, self, ds)

    def timed_accumulate(chunks, device, stats_fn, add_fn, prefetch):
        stats = functools.partial(timed, torch.cuda.current_stream(device), "stats", stats_fn)
        return accumulate(chunks, device, stats, add_fn, prefetch)

    torch.cuda.synchronize()
    base = torch.cuda.Event(enable_timing=True)
    base.record()
    streaming._Transfer.__call__, streaming._accumulate = transfer, timed_accumulate
    try:
        t0 = time.perf_counter()
        _, llk, _ = streaming._step(model, chunks, None, 1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        streaming._Transfer.__call__, streaming._accumulate = copy_fn, accumulate
    float(llk)
    at = {kind: [(base.elapsed_time(a) / 1e3, base.elapsed_time(b) / 1e3) for a, b in pairs]
          for kind, pairs in spans.items()}
    busy = merged(at["stats"])
    copy_s = sum(hi - lo for lo, hi in at["copy"])
    hidden = sum(max(0.0, min(hi, b) - max(lo, a)) for lo, hi in at["copy"] for a, b in busy)
    return secs, copy_s, copy_s - hidden


def phase_stream_steady(model, host, ref, bound: int) -> None:
    """9a, the steady pass: with the routes recorded on the host chunks,
    one streamed iteration copies every chunk in slices, decides no route
    and makes no stream synchronization but its own event waits; its
    result is the prefetch runs' bit for bit.  One more, untraced, with
    events on the copy and compute streams, gives the copy time no
    statistics hide.  Then the same rows as two new chunks of several
    slices each: their first pass decides their routes on their masks and
    copies them in slices, with a peak at most two of their masks above
    the next pass's; the next, with no synchronization, holds less than
    two whole chunks (what the pass held at prefetch=1 before it sliced),
    and the slices being the eight chunks' own, gives their result bit for
    bit."""
    from ppca_rs_tpu_torch import Dataset, streaming

    def same(new, llk) -> bool:
        return llk == ref[1] and all(torch.equal(x, y) for x, y in
                                     zip(new._params(), ref[0]._params()))

    n_slices = sum(len(streaming._slices(c)) for c in host)
    new, llk, counts, peak = counted_pass(model, lazy(host), True)
    check(counts == {"slices": n_slices, "routes": 0},
          f"stream: the steady pass brought in {counts}, not {n_slices} slices and no route")
    check(same(new, llk), "stream: the steady pass under the sync check differs from prefetch=0")
    print(f"[stream] steady pass (routes recorded), prefetch=1, under "
          f"set_sync_debug_mode('error'): no synchronization; {counts}; peak requested "
          f"{peak / 2**30:.3f} GiB (prefetch=1 bound, reserved: {bound / 2**30:.3f} GiB)")
    secs, copy_s, exposed = overlap_pass(model, lazy(host))
    print(f"[stream] steady pass timed by events: {secs:.4f} s by the host clock; copies "
          f"{copy_s:.4f} s, of them {exposed:.4f} s ({100 * exposed / copy_s:.2f}% of the copy "
          f"time, {100 * exposed / secs:.2f}% of the pass) with no statistics running")
    half = len(host) // 2
    halves = host_copies([Dataset.concat(host[:half]), Dataset.concat(host[half:])], pinned=True)
    per_half = len(streaming._slices(halves[0])) + len(streaming._slices(halves[1]))
    _, _, counts_f, peak_f = counted_pass(model, lazy(halves), False)
    check(counts_f == {"slices": per_half, "routes": 2} and per_half > 2,
          f"stream: first pass of two chunks {counts_f}, not {per_half} slices and 2 routes")
    new_h, llk_h, counts_h, peak_h = counted_pass(model, lazy(halves), True)
    check(counts_h == {"slices": per_half, "routes": 0},
          f"stream: steady pass of two chunks {counts_h}, not {per_half} slices and no route")
    masks = halves[0].mask.nbytes
    check(peak_f <= peak_h + 2 * masks,
          f"stream: first pass peak {peak_f} B not within two masks ({masks} B each) above the "
          f"steady pass's {peak_h} B")
    check(peak_h < 2 * chunk_bytes(halves[0]),
          f"stream: sliced peak {peak_h} B not below two whole chunks' {2 * chunk_bytes(halves[0])} B")
    check(same(new_h, llk_h), "stream: 2 chunks in slices differ from 8 chunks of the same slices")
    print(f"[stream] the same rows as 2 pinned chunks of {len(halves[0])} rows: first pass "
          f"{counts_f}, peak requested {peak_f / 2**30:.3f} GiB; steady pass {counts_h}, no "
          f"synchronization, peak requested {peak_h / 2**30:.3f} GiB (two whole chunks: "
          f"{2 * chunk_bytes(halves[0]) / 2**30:.3f} GiB), the 8 chunks' result bit for bit")


def model_diffs(a, b) -> dict:
    return {"transform": rel_err(a.transform, b.transform), "mean": rel_err(a.mean, b.mean),
            "isotropic_noise": rel_err(a.isotropic_noise.reshape(1), b.isotropic_noise.reshape(1))}


def launches_of(**counts) -> dict:
    from ppca_rs_tpu_torch.ops import kernels

    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(counts)
    return want


def h2d_gbps(chunks, pinned: bool) -> float:
    """Copies of the chunks' data and mask alone into one device buffer
    (non-blocking from pinned memory), GB/s by the host clock ending in a
    device sync."""
    data = torch.empty(chunks[0].data.shape, dtype=chunks[0].data.dtype, device="cuda")
    mask = torch.empty(chunks[0].mask.shape, dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in chunks:
        data.copy_(c.data, non_blocking=pinned)
        mask.copy_(c.mask, non_blocking=pinned)
    torch.cuda.synchronize()
    return sum(c.data.nbytes + c.mask.nbytes for c in chunks) / (time.perf_counter() - t0) / 1e9


def phase_stream_masked(smi: str):
    """9a: phase 3's configuration streamed from N_STREAM_CHUNKS pinned host
    chunks through StreamingPPCATrainer and iterate_streamed, against the
    same data resident on the card.  Returns (model, host chunks, resident
    dataset, launches of the counted run)."""
    from ppca_rs_tpu_torch import Dataset, StreamingPPCATrainer
    from ppca_rs_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    card = make_main_dataset(N_MAIN)
    host = host_copies(card.chunks(N_STREAM_CHUNKS), pinned=True)
    del card
    torch.cuda.empty_cache()
    per_chunk, total = chunk_bytes(host[0]), sum(chunk_bytes(c) for c in host)
    chunks = lazy(host)
    check(all(c.data.is_pinned() and c.mask.is_pinned() for c in host), "stream: chunks not pinned")
    print(f"[stream] 9a: {len(host)} pinned host chunks of {len(host[0])} rows x {D_MAIN} "
          f"(f32 data + bool mask + f32 weights: {per_chunk / 2**20:.1f} MiB each, "
          f"{total / 2**30:.2f} GiB in all), made in {time.perf_counter() - t0:.2f} s; "
          f"device memory in use {torch.cuda.memory_allocated() / 2**20:.1f} MiB")

    llks, stamps = [], []

    def callback(it, metrics):
        stamps.append(time.perf_counter())
        llks.append(metrics.llk)

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    model = StreamingPPCATrainer(chunks).train(
        state_size=K_MAIN, n_iters=STREAM_ITERS, quiet=True, callback=callback,
        generator=torch.Generator(device="cuda").manual_seed(SEED + 17))
    final = sum(model.llk(c.to("cuda")) for c in host) / N_MAIN
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    n_blocks = N_MAIN // config_block_size()
    want = launches_of(fullt=STREAM_ITERS * n_blocks, states=STREAM_ITERS, llk=n_blocks)
    check(launches == want, f"stream: launches {launches} != {want}")
    seq = llks + [final]
    for a, b in zip(seq, seq[1:]):
        check(math.isfinite(b) and b >= a - LLK_SLACK * abs(a), f"stream: llk decreased: {a} -> {b}")
    check(all(c._all_observed is False and c._patterns is False for c in host),
          "stream: the chunks' routes were not recorded on the host chunks")
    print(f"[stream] StreamingPPCATrainer, {STREAM_ITERS} iterations: llk/sample {llks} then "
          f"{final:.6f} (model.llk over the chunks); seconds per iteration "
          + ", ".join(f"{b - a:.4f}" for a, b in zip(stamps, stamps[1:]))
          + f" (the first decides each chunk's route); launches {launches}")

    runs = {}
    for p in STREAM_PREFETCH + STREAM_PREFETCH[::-1]:
        new, llk, secs, counted, peak = stream_once(model, chunks, p)
        want = launches_of(fullt=n_blocks, states=1)
        check(counted == want, f"stream: prefetch={p}: launches {counted} != {want}")
        runs.setdefault(p, []).append((new, llk, secs, peak))
    ref = runs[0][0]
    for p, rs in runs.items():
        for new, llk, _, _ in rs:
            check(llk == ref[1] and all(torch.equal(x, y) for x, y in
                                        zip(new._params(), ref[0]._params())),
                  f"stream: prefetch={p} is not bit-identical to prefetch=0")
    # a host chunk is one slice here, and prefetch=1 holds slices i - 1 to
    # i + 1 (streaming._accumulate)
    bound = 3 * per_chunk + (1 << 30)
    peak1 = max(r[3] for r in runs[1])
    for p, rs in runs.items():
        secs = [r[2] for r in rs]
        print(f"[stream] prefetch={p}: seconds per streamed iteration "
              + ", ".join(f"{s:.4f}" for s in secs)
              + f" ({smi}); {total / min(secs) / 1e9:.2f} GB/s of chunks; peak reserved device "
              f"memory {max(r[3] for r in rs) / 2**30:.3f} GiB")
    print(f"[stream] prefetch 0/1/2 bit-identical; launches per streamed iteration fullt "
          f"{n_blocks}, states 1; prefetch=1 peak reserved {peak1 / 2**30:.3f} GiB (bound: 3 chunks + "
          f"1 GiB = {bound / 2**30:.3f} GiB)")
    check(peak1 <= bound, f"stream: prefetch=1 peak {peak1} B above {bound} B")
    phase_stream_steady(model, host, ref, bound)

    pageable = host_copies(host, pinned=False)
    new_pg, llk_pg, secs_pg, counted, peak_pg = stream_once(model, lazy(pageable), 1)
    check(llk_pg == ref[1] and all(torch.equal(x, y) for x, y in
                                   zip(new_pg._params(), ref[0]._params())),
          "stream: pageable chunks differ from pinned ones")
    rate_pinned, rate_pageable = h2d_gbps(host, True), h2d_gbps(pageable, False)
    del pageable
    print(f"[stream] pageable chunks, prefetch=1: {secs_pg:.4f} s per streamed iteration "
          f"(pinned {min(r[2] for r in runs[1]):.4f} s), peak reserved {peak_pg / 2**30:.3f} GiB, same "
          f"result bit for bit; copies alone (data + mask, {N_STREAM_CHUNKS} chunks): pinned "
          f"{rate_pinned:.2f} GB/s, pageable {rate_pageable:.2f} GB/s ({smi})")

    t0 = time.perf_counter()
    resident = Dataset.concat([c.to("cuda") for c in host])
    torch.cuda.synchronize()
    check(resident.pattern_info() is None, "stream: the resident copy took another route")
    t_build = time.perf_counter() - t0
    res_model, res_llk, res_secs, res_peak = resident_step(model, resident)
    diffs = model_diffs(runs[1][0][0], res_model)
    diffs["llk"] = abs(runs[1][0][1] - res_llk) / abs(res_llk)
    print(f"[stream] resident on the card (built from the host chunks in {t_build:.2f} s): "
          f"seconds per iteration " + ", ".join(f"{s:.4f}" for s in res_secs)
          + f" ({smi}); peak reserved device memory {res_peak / 2**30:.3f} GiB")
    report_diffs("stream", "one streamed iteration vs one resident _em_step", diffs, TOL_STREAM)
    return model, host, resident, launches


def config_block_size() -> int:
    from ppca_rs_tpu_torch import config

    return config.block_size


def make_stream_kinds(n: int, seed: int):
    """Three n-row datasets on the card from one rank-K_MAIN model plus
    noise at D_MAIN: fully observed, rows from P_PATTERN Bernoulli(0.5) mask
    patterns, and 50% missing at random."""
    from ppca_rs_tpu_torch import Dataset

    gen = torch.Generator(device="cuda").manual_seed(seed)
    opts = dict(generator=gen, device="cuda", dtype=torch.float32)
    C = torch.randn(D_MAIN, K_MAIN, **opts) * (2.0 / math.sqrt(K_MAIN))
    mean = torch.randn(D_MAIN, **opts)
    patterns = torch.rand(P_PATTERN, D_MAIN, generator=gen, device="cuda") < 0.5
    masks = [torch.ones(n, D_MAIN, dtype=torch.bool, device="cuda"),
             patterns[torch.randint(0, P_PATTERN, (n,), generator=gen, device="cuda")],
             torch.rand(n, D_MAIN, generator=gen, device="cuda") >= 0.5]
    out = []
    for m in masks:
        y = torch.randn(n, K_MAIN, **opts) @ C.T + mean + 0.5 * torch.randn(n, D_MAIN, **opts)
        out.append(Dataset.from_parts(torch.where(m, y, torch.zeros_like(y)), m))
    return out


def phase_stream_kinds(model):
    """9b: one streamed iteration over a fully observed, a pattern and a
    randomly masked chunk against one _em_step over their concatenation on
    the card.  Returns the launches of the streamed iteration."""
    from ppca_rs_tpu_torch import Dataset

    kinds = make_stream_kinds(N_STREAM_KIND, SEED + 18)
    host = host_copies(kinds, pinned=True)
    new, llk, secs, launches, _ = stream_once(model, lazy(host), 1)
    n_blocks = N_STREAM_KIND // config_block_size()
    want = launches_of(fullt=n_blocks, full=1, states=1)
    check(launches == want, f"stream kinds: launches {launches} != {want}")
    dense, pattern, masked = host
    check(dense._all_observed is True and pattern._patterns
          and pattern._patterns[1].shape[0] == P_PATTERN and masked._patterns is False,
          "stream kinds: the chunks did not take the dense, pattern and masked routes")
    res_model, res_llk, _, _ = resident_step(model, Dataset.concat(kinds), reps=1)
    diffs = model_diffs(new, res_model)
    diffs["llk"] = abs(llk - res_llk) / abs(res_llk)
    print(f"[stream] 9b: chunks of {N_STREAM_KIND} rows, fully observed (dense pass), "
          f"{P_PATTERN} mask patterns (tables) and random masks: one streamed iteration "
          f"{secs:.4f} s (the first: routes decided), launches {launches}")
    report_diffs("stream", "mixed chunk kinds, streamed vs _em_step on Dataset.concat", diffs,
                 TOL_STREAM)
    return launches


def phase_stream_mix(smi: str):
    """9c: phase 8's mixture configuration streamed from N_STREAM_MIX_CHUNKS
    pinned host chunks through StreamingPPCAMixTrainer and
    iterate_mix_streamed, against PPCAMix._em_step on the resident data.
    Returns the launches of the trainer run."""
    from ppca_rs_tpu_torch import StreamingPPCAMixTrainer
    from ppca_rs_tpu_torch.ops import kernels

    dataset = make_mix_dataset()
    host = host_copies(dataset.chunks(N_STREAM_MIX_CHUNKS), pinned=True)
    chunks = lazy(host)
    kernels.reset_launch_counts()
    llks = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mix = StreamingPPCAMixTrainer(chunks).train(
        n_models=M_MIX, state_size=K_MIX, n_iters=N_DENSE_ITERS, quiet=True,
        callback=lambda it, m: llks.append(m.llk),
        generator=torch.Generator(device="cuda").manual_seed(SEED + 19))
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    rows = -(-len(host[0]) // config_mix_rows())
    want = launches_of(fullt=N_DENSE_ITERS * N_STREAM_MIX_CHUNKS * rows, states=N_DENSE_ITERS)
    check(launches == want, f"stream mix: trainer launches {launches} != {want}")
    check(all(math.isfinite(v) for v in llks) and llks[1] >= llks[0] - LLK_SLACK * abs(llks[0]),
          f"stream mix: llk {llks}")
    new, llk, secs, counted, _ = stream_once(mix, chunks, 1, mix=True)
    want = launches_of(fullt=N_STREAM_MIX_CHUNKS * rows, states=1)
    check(counted == want, f"stream mix: launches {counted} != {want}")
    res, res_llk, res_secs, _ = resident_step(mix, dataset)
    diffs = mix_diffs(new, res)
    live = torch.isfinite(res.log_weights)
    check(torch.equal(live, torch.isfinite(new.log_weights)), "stream mix: dead components differ")
    diffs["log_weights"] = rel_err(new.log_weights[live].cpu(), res.log_weights[live].cpu())
    diffs["llk"] = abs(llk - res_llk) / abs(res_llk)
    print(f"[stream] 9c: mixture, {len(host)} pinned host chunks of {len(host[0])} rows: "
          f"StreamingPPCAMixTrainer {N_DENSE_ITERS} iterations in {t_train:.3f} s, llk/sample "
          f"{llks}, launches {launches}; one streamed iteration {secs:.4f} s, resident _em_step "
          + ", ".join(f"{s:.4f}" for s in res_secs) + f" s ({smi})")
    report_diffs("stream", "mixture, streamed vs resident PPCAMix._em_step", diffs, TOL_STREAM)
    return launches


def config_mix_rows() -> int:
    from ppca_rs_tpu_torch import config

    return config.mix_block_rows(M_MIX, K_MIX, 4)


def in_turns(a, b, reps: int = 1):
    """Host seconds of ``a()`` and ``b()`` (each ending in a device sync),
    in turns a, b, b, a: ((a1, a2), (b1, b2), a's last result, b's last)."""
    times, results = {a: [], b: []}, {}
    for fn in (a, b, b, a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            results[fn] = fn()
        torch.cuda.synchronize()
        times[fn].append((time.perf_counter() - t0) / reps)
    return tuple(times[a]), tuple(times[b]), results[a], results[b]


def phase_packing(smi: str) -> None:
    """9d: host packing.  The native pass of Dataset() (native/packing.py:
    values in float32 and the mask in one multithreaded pass) against its
    plain numpy version on a float64 array with NaN holes, in turns, bit
    for bit; the copy of its output to the card; Dataset() whole, on the
    CPU and to the card.  Then the DataFrame adapters' native scatter
    against numpy fancy assignment on a shuffled long frame, bit for bit,
    and DataFrameAdapter.from_pandas whole."""
    import numpy as np
    import pandas as pd

    from ppca_rs_tpu_torch import DataFrameAdapter, Dataset
    from ppca_rs_tpu_torch.native import packing

    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    x = torch.randn(N_PACK, D_MAIN, generator=gen, dtype=torch.float64, device="cuda")
    x[torch.rand(N_PACK, D_MAIN, generator=gen, device="cuda") < 0.5] = math.nan
    arr = x.cpu().numpy()
    del x
    t0 = time.perf_counter()
    packing.load()
    print(f"[stream] 9d: packing library ready in {time.perf_counter() - t0:.2f} s; "
          f"{os.cpu_count()} host cores")
    gb = arr.nbytes / 1e9
    (n1, n2), (p1, p2), (values, mask), (ref_values, ref_mask) = in_turns(
        lambda: packing.mask_non_finite(arr, torch.float32),
        lambda: packing.mask_non_finite_reference(arr, torch.float32))
    same = (torch.equal(values.view(torch.int32), ref_values.view(torch.int32))
            and torch.equal(mask, ref_mask))
    check(same, "packing: the native pass differs from its plain version")
    del ref_values, ref_mask
    print(f"[stream] 9d: {N_PACK} x {D_MAIN} float64 with NaN holes ({arr.nbytes / 2**30:.2f} "
          f"GiB) to float32 values and a mask: native {n1:.3f}/{n2:.3f} s "
          f"({gb / n1:.2f}/{gb / n2:.2f} GB/s), plain numpy {p1:.3f}/{p2:.3f} s "
          f"({gb / p1:.2f}/{gb / p2:.2f} GB/s); bit for bit equal")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = (values.to("cuda"), mask.to("cuda"))
    torch.cuda.synchronize()
    t_copy = time.perf_counter() - t0
    del on_card, values, mask
    t0 = time.perf_counter()
    ds = Dataset(arr, device="cpu")
    t_host = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds_card = Dataset(arr)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    check(ds.mask.numpy().sum() == np.isfinite(arr).sum() and ds_card.device.type == "cuda",
          "packing: the mask does not match the finite entries")
    print(f"[stream] 9d: the packed values and mask to the card (pageable) {t_copy:.3f} s; "
          f"Dataset() {t_host:.3f} s on the CPU ({gb / t_host:.2f} GB/s), {t_card:.3f} s "
          f"to the card ({gb / t_card:.2f} GB/s) ({smi})")
    del ds, ds_card, arr

    rng = np.random.default_rng(SEED)
    order = rng.permutation(PACK_SAMPLES * PACK_DIMS)
    values = rng.normal(size=PACK_SAMPLES * PACK_DIMS)
    df = pd.DataFrame({"sample": np.repeat(np.arange(PACK_SAMPLES), PACK_DIMS)[order],
                       "dim": np.tile(np.arange(PACK_DIMS), PACK_SAMPLES)[order],
                       "value": values[order]})
    triplets = (df["sample"].to_numpy(), df["dim"].to_numpy(), df["value"].to_numpy(),
                PACK_SAMPLES, PACK_DIMS)
    (n1, n2), (p1, p2), dense, ref = in_turns(
        lambda: packing.scatter_long_to_dense(*triplets),
        lambda: packing.scatter_long_to_dense_reference(*triplets))
    check(np.array_equal(dense.view(np.int64), ref.view(np.int64)),
          "packing: the native scatter differs from numpy fancy assignment")
    rows_m = len(df) / 1e6
    print(f"[stream] 9d: scatter of {len(df)} long rows: native {n1:.3f}/{n2:.3f} s "
          f"({rows_m / n1:.2f}/{rows_m / n2:.2f} M rows/s), numpy fancy assignment "
          f"{p1:.3f}/{p2:.3f} s ({rows_m / p1:.2f}/{rows_m / p2:.2f} M rows/s); bit for bit equal")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    adapter = DataFrameAdapter.from_pandas(df, keys=["sample"], dimensions=["dim"], metric="value")
    torch.cuda.synchronize()
    t_frame = time.perf_counter() - t0
    got = adapter.dataset.numpy()
    check(got.shape == (PACK_SAMPLES, PACK_DIMS) and adapter.dataset.device.type == "cuda"
          and np.array_equal(got, values.reshape(PACK_SAMPLES, PACK_DIMS).astype(np.float32)),
          "packing: the adapter's dataset does not hold the frame's values")
    print(f"[stream] 9d: DataFrameAdapter.from_pandas on a long frame of {len(df)} rows "
          f"({PACK_SAMPLES} samples x {PACK_DIMS} dimensions, shuffled): {t_frame:.3f} s "
          f"({len(df) / t_frame / 1e6:.2f} M rows/s), dataset on the card ({smi})")


def phase_bf16_and_profile(model, resident, host, smi: str) -> None:
    """9e: the resident data stored in bfloat16 against float32 from one
    start, and a streamed training traced through profile_dir."""
    import tempfile

    from ppca_rs_tpu_torch import PPCAModel, StreamingPPCATrainer

    bf16 = resident.astype(torch.bfloat16)
    check(bf16.data.dtype == torch.bfloat16 and bf16.mask.data_ptr() == resident.mask.data_ptr()
          and bf16.weights_dev.data_ptr() == resident.weights_dev.data_ptr(),
          "bf16: astype copied the mask or the weights")
    start = PPCAModel.init(K_MAIN, resident, generator=torch.Generator(device="cuda").manual_seed(SEED + 21))
    out = {}
    for name, ds in (("float32", resident), ("bfloat16", bf16)):
        secs = []
        m = start
        llks = []
        for _ in range(N_DENSE_ITERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m, llk = m._em_step(ds, None)
            llks.append(float(llk))
            secs.append(time.perf_counter() - t0)
        out[name] = (llks, secs, ds.data.nbytes)
    rel = max(abs(a - b) / abs(a) for a, b in zip(out["float32"][0], out["bfloat16"][0]))
    for name, (llks, secs, nbytes) in out.items():
        print(f"[stream] 9e: {name} storage: seconds per iteration "
              + ", ".join(f"{s:.4f}" for s in secs)
              + f" ({smi}); data {nbytes / 2**30:.2f} GiB on the card; llks {llks}")
    print(f"[stream] 9e: bfloat16 vs float32 llk, max relative difference {rel:.3e} (tol "
          f"{TOL_BF16:g}: bfloat16 rounds each value by up to 2^-9 of it)")
    check(rel <= TOL_BF16, f"bf16: llk {rel:.3e} above {TOL_BF16}")
    del bf16

    with tempfile.TemporaryDirectory() as tmp:
        StreamingPPCATrainer(lazy(host)).train(start=model, state_size=K_MAIN, n_iters=1,
                                               quiet=True, profile_dir=tmp)
        traces = list(Path(tmp).glob("*.json"))
        check(len(traces) == 1, f"profile_dir: {len(traces)} trace files")
        text = traces[0].read_text()
        check("spd_estep" in text, "profile_dir: the trace does not name the E-step kernel")
        print(f"[stream] 9e: profile_dir wrote {traces[0].name} ({len(text) / 2**20:.1f} MiB), "
              "which names the spd_estep kernel")


def phase_stream(smi: str):
    """Phase 9: out-of-core streaming at full width.  Returns the launches
    of its counted runs (9a's trainer and llk, 9b's streamed iteration, 9c's
    trainer), by part."""
    model, host, resident, a = phase_stream_masked(smi)
    b = phase_stream_kinds(model)
    torch.cuda.empty_cache()
    phase_bf16_and_profile(model, resident, host, smi)
    del resident, host
    torch.cuda.empty_cache()
    c = phase_stream_mix(smi)
    torch.cuda.empty_cache()
    phase_packing(smi)
    return {"9a": a, "9b": b, "9c": c}


# --------------------------------------------------------------------- #
# phase 10: the ranks (this script run as a child, ``--parallel-child``)


def par_counts(fn):
    """``fn()``'s result, with the kernel launches and the statistics
    all_reduces it made (counts set to 0 just before it)."""
    from ppca_rs_tpu_torch.ops import kernels
    from ppca_rs_tpu_torch.parallel import placement

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    placement.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(kernels.LAUNCHES), dict(placement.STATS_REDUCES)


def par_reduce_ms(nbytes: int, group) -> float:
    """Mean time of one all_reduce of ``nbytes`` of float32 on the card over
    ``group``, alone (every rank of the group runs it together)."""
    buf = torch.zeros(nbytes // 4, dtype=torch.float32, device="cuda")
    torch.distributed.all_reduce(buf, group=group)
    torch.cuda.synchronize()
    torch.distributed.barrier(group=group)
    t0 = time.perf_counter()
    for _ in range(PAR_REDUCE_REPS):
        torch.distributed.all_reduce(buf, group=group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / PAR_REDUCE_REPS * 1e3


def par_print(part: str, rank: int, text: str) -> None:
    """One line in one write, so that the ranks' lines do not interleave."""
    sys.stdout.write(f"[parallel] {part} rank {rank}: {text}\n")
    sys.stdout.flush()


def par_start(out: Path, name: str):
    from ppca_rs_tpu_torch import PPCAMix, PPCAModel

    blob = (out / f"{name}.bin").read_bytes()
    load = PPCAMix.load if name == "mix" else PPCAModel.load
    return load(blob, device="cuda", dtype=torch.float32)


def par_host(model) -> dict:
    return {n: t.detach().cpu() for n, t in zip(("C", "mean", "sigma"), model._params())}


def par_data_axis(rank: int, out: Path) -> dict:
    """10a: phase 3's rows split unevenly over a 2x1 mesh
    (shard_dataset_local), PAR_ITERS PPCATrainer iterations, model.llk,
    infer and the posterior sampler on N_PAR_ROWS_READ local rows."""
    from ppca_rs_tpu_torch import PPCATrainer
    from ppca_rs_tpu_torch.parallel import DATA_AXIS, distributed, make_mesh
    from ppca_rs_tpu_torch.parallel.mesh import axis_group

    mesh = make_mesh(2, 1)
    lo = sum(PAR_ROWS[:rank])
    full = make_main_dataset()
    sds = distributed.shard_dataset_local(full.slice(lo, lo + PAR_ROWS[rank]), mesh)
    del full
    torch.cuda.empty_cache()
    start = par_start(out, "start")
    llks, stamps = [], []

    def run():
        def callback(it, metrics):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            llks.append(metrics.llk)

        torch.distributed.barrier()
        stamps.append(time.perf_counter())
        model = PPCATrainer(sds).train(start=start, state_size=K_MAIN, n_iters=PAR_ITERS,
                                       quiet=True, callback=callback)
        total = model.llk(sds)
        sub = distributed.shard_dataset_local(sds.slice(0, N_PAR_ROWS_READ), mesh)
        draw = model.infer(sub).posterior_sampler().sample(
            generator=torch.Generator(device="cuda").manual_seed(SEED + 33)).data
        return model, total, bool(torch.isfinite(draw).all()) and tuple(draw.shape) == (
            len(sub.data), D_MAIN)

    (model, total, draw_ok), launches, reduces = par_counts(run)
    secs = [b - a for a, b in zip(stamps, stamps[1:])]
    per = reduces["bytes"] // max(reduces["calls"], 1)
    reduce_ms = par_reduce_ms(per, axis_group(mesh, DATA_AXIS))
    par_print("10a", rank, f"{len(sds.data)} of {len(sds)} rows; seconds per iteration "
              + ", ".join(f"{s:.4f}" for s in secs) + f"; llk/sample {llks} then "
              f"{total / len(sds):.6f}; statistics all_reduce {reduces['calls']} per training "
              f"({per / 2**20:.2f} MiB each), alone {reduce_ms:.2f} ms (gloo, two ranks on one "
              f"card); launches {launches}")
    return dict(params=par_host(model), llks=llks, llk=total, secs=secs, launches=launches,
                reduces=reduces, reduce_ms=reduce_ms, reduce_bytes=per, draw_ok=draw_ok,
                rows=len(sds.data))


def par_model_axis(rank: int, out: Path) -> dict:
    """10c: the first N_MODEL_AXIS rows of phase 3's data with D on a 1x2
    model axis: two iterations, then llks and extrapolate on the rank's
    block of columns."""
    from ppca_rs_tpu_torch.parallel import MODEL_AXIS, distributed, make_mesh
    from ppca_rs_tpu_torch.parallel.mesh import axis_group

    mesh = make_mesh(1, 2)
    sds = distributed.shard_dataset_local(make_main_dataset(N_MODEL_AXIS), mesh)
    torch.cuda.empty_cache()
    start = par_start(out, "start")
    secs = []

    def run():
        model = start
        for _ in range(2):
            torch.distributed.barrier()
            t0 = time.perf_counter()
            model = model.iterate(sds)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return model, model.llks(sds), model.extrapolate(sds).data[:N_PAR_ROWS_READ]

    (model, llks, extrapolated), launches, _ = par_counts(run)
    k = K_MAIN
    # a block's E-step inputs: G (slabs where the kernel takes them), b,
    # |r|^2 and the observed counts; beside it the size with square G
    from ppca_rs_tpu_torch.ops import kernels

    width = kernels.slab_width(k) if kernels.uses_slabs(k, torch.float32) else k * k
    block_bytes = config_block_size() * (width + k + 2) * 4
    square_bytes = config_block_size() * (k * k + k + 2) * 4
    group = axis_group(mesh, MODEL_AXIS)
    reduce_ms = par_reduce_ms(block_bytes, group)
    square_ms = par_reduce_ms(square_bytes, group)
    par_print("10c", rank, f"columns {sds.data.shape[1]} of {sds.output_size()}; seconds per "
              "iteration " + ", ".join(f"{s:.4f}" for s in secs) + f"; per-block E-step "
              f"all_reduce over the model axis ({block_bytes / 2**20:.1f} MiB, G as {width} "
              f"columns, gloo through the host) alone {reduce_ms:.1f} ms (square G's "
              f"{square_bytes / 2**20:.1f} MiB {square_ms:.1f} ms), "
              f"{-(-len(sds.data) // config_block_size())} blocks a pass; launches {launches}")
    return dict(params=par_host(model), llks=llks.cpu(), extrapolated=extrapolated.cpu(),
                secs=secs, launches=launches, reduce_ms=reduce_ms, reduce_bytes=block_bytes,
                square_ms=square_ms, square_bytes=square_bytes,
                columns=(rank * sds.data.shape[1], (rank + 1) * sds.data.shape[1]))


def par_patterns(rank: int, out: Path) -> dict:
    """10d: phase 5's data, 500,000 rows a rank: collective detection, the
    sorted per-segment EM on each rank, two iterations and model.llk."""
    from ppca_rs_tpu_torch.models import routes
    from ppca_rs_tpu_torch.parallel import distributed, make_mesh

    mesh = make_mesh(2, 1)
    half = N_PATTERN // 2
    full, _ = make_pattern_dataset()
    sds = distributed.shard_dataset_local(full.slice(rank * half, (rank + 1) * half), mesh)
    del full
    torch.cuda.empty_cache()
    before = sds.pattern_info() is None
    torch.distributed.barrier()
    t0 = time.perf_counter()
    pidx, patterns = sds.detect_patterns()
    t_detect = time.perf_counter() - t0
    route = routes.route(sds)
    start = par_start(out, "start_pattern")

    def run():
        model, llks = start, []
        for _ in range(2):
            model, llk = model._em_step(sds, None)
            llks.append(float(llk))
        return model, llks, model.llk(sds)

    (model, llks, total), launches, _ = par_counts(run)
    par_print("10d", rank, f"detect_patterns {t_detect:.3f} s, P={patterns.shape[0]}, route "
              f"{route.kind} (sorted: {route.order is not None}); llks {llks} then {total:.6e}; "
              f"launches {launches}")
    return dict(params=par_host(model), llks=llks, llk=total, launches=launches,
                patterns=patterns.cpu(), before=before,
                mapped=bool(torch.equal(patterns[pidx], sds.mask)),
                sorted=route.kind == "pattern" and route.order is not None)


def par_mixture(rank: int, out: Path) -> dict:
    """10e: phase 8's mixture, 100,000 rows a rank: N_DENSE_ITERS
    PPCAMixTrainer iterations, then infer_cluster on the rank's rows."""
    from ppca_rs_tpu_torch import PPCAMixTrainer
    from ppca_rs_tpu_torch.parallel import distributed, make_mesh

    mesh = make_mesh(2, 1)
    half = N_MIX // 2
    full = make_mix_dataset()
    sds = distributed.shard_dataset_local(full.slice(rank * half, (rank + 1) * half), mesh)
    del full
    start = par_start(out, "mix")
    llks = []

    def run():
        mix = PPCAMixTrainer(sds).train(start=start, n_models=M_MIX, state_size=K_MIX,
                                        n_iters=N_DENSE_ITERS, quiet=True,
                                        callback=lambda it, m: llks.append(m.llk))
        return mix, mix.infer_cluster(sds)

    (mix, cluster), launches, reduces = par_counts(run)
    ok = bool(torch.isfinite(cluster.exp().sum(-1)).all()) and tuple(cluster.shape) == (half, M_MIX)
    par_print("10e", rank, f"llk/sample {llks}; statistics all_reduces {reduces['calls']}; "
              f"launches {launches}")
    return dict(stacked=[t.cpu() for t in mix._stacked_params()], weights=mix.weights.cpu(),
                llks=llks, cluster=cluster[:N_PAR_ROWS_READ].cpu(), cluster_ok=ok,
                launches=launches, reduces=reduces)


def par_stream(rank: int, out: Path) -> dict:
    """10f: each rank streams 4 of 9a's 8 pinned host chunks; one
    iterate_streamed over the 2x1 mesh."""
    from ppca_rs_tpu_torch import iterate_streamed
    from ppca_rs_tpu_torch.parallel import make_mesh

    mesh = make_mesh(2, 1)
    full = make_main_dataset()
    mine = list(full.chunks(N_STREAM_CHUNKS))[rank::2]
    host = host_copies(mine, pinned=True)
    del full, mine
    torch.cuda.empty_cache()
    start = par_start(out, "start")
    torch.distributed.barrier()
    t0 = time.perf_counter()
    (new, llk), launches, reduces = par_counts(
        lambda: iterate_streamed(start, lazy(host), mesh=mesh))
    secs = time.perf_counter() - t0
    par_print("10f", rank, f"{len(host)} chunks of {len(host[0])} rows; one streamed iteration "
              f"{secs:.4f} s; statistics all_reduces {reduces['calls']}; launches {launches}")
    return dict(params=par_host(new), llk=llk, secs=secs, launches=launches, reduces=reduces)


def par_world_of_one(out: Path) -> dict:
    """10b: a world of one rank through initialize()'s default backend: one
    iterate on a 1x1 mesh against _em_step on the same, unsharded rows."""
    from ppca_rs_tpu_torch.parallel import make_mesh, shard_dataset

    mesh = make_mesh()
    full = make_main_dataset()
    sds = shard_dataset(full, mesh)
    start = par_start(out, "start")
    sharded = start.iterate(sds)
    single, _ = start._em_step(full, None)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(sharded._params(), single._params()))
    backend = str(torch.distributed.get_backend())
    par_print("10b", 0, f"backend {backend}, mesh {tuple(mesh.shape)}: iterate on the sharded "
              f"dataset {'equals' if same else 'DIFFERS FROM'} _em_step bit for bit")
    return dict(same=same, backend=backend)


PAR_PARTS = {"10a": par_data_axis, "10c": par_model_axis, "10d": par_patterns,
             "10e": par_mixture, "10f": par_stream}


def parallel_child(job: str, rank: int, out: str) -> int:
    """One rank of a phase-10 job; writes its results to OUT/JOB_RANK.pt."""
    sys.path.insert(0, str(ROOT))
    import ppca_rs_tpu_torch  # noqa: F401  (sets full-float32 matmuls)
    from ppca_rs_tpu_torch.parallel import distributed

    out = Path(out)
    distributed.initialize(backend="gloo" if job == "gloo" else None)
    if job == "nccl":
        results = {"10b": par_world_of_one(out)}
    else:
        results = {}
        for part, fn in PAR_PARTS.items():
            results[part] = fn(rank, out)
            torch.cuda.empty_cache()
            torch.distributed.barrier()
    torch.save(results, out / f"{job}_{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


# --------------------------------------------------------------------- #
# phase 10: the parent


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_job(job: str, world: int, out: Path) -> list:
    """Start ``world`` ranks of ``job`` as child processes of this script,
    wait for all with PAR_TIMEOUT (killing every rank on timeout), fail on
    any non-zero exit; return each rank's results."""
    import os

    port = free_port()
    sys.stdout.flush()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--parallel-child", job, str(rank),
             str(out)], env=env, cwd=str(ROOT)))
    deadline = time.monotonic() + PAR_TIMEOUT
    try:
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    codes = [proc.returncode for proc in procs]
    check(codes == [0] * world, f"parallel job {job}: exit codes {codes}")
    return [torch.load(out / f"{job}_{rank}.pt", weights_only=False) for rank in range(world)]


def par_references(out: Path) -> dict:
    """The single-process runs phase 10 is held against, on this card, from
    the starts the ranks load: 10a's trainer and llk, 10f's resident
    _em_step, 10c's two iterations on its rows, 10d's table and two
    pattern-route iterations, 10e's mixture trainer."""
    from ppca_rs_tpu_torch import PPCAMix, PPCAMixTrainer, PPCAModel, PPCATrainer

    gen = lambda s: torch.Generator(device="cuda").manual_seed(s)  # noqa: E731
    ref = {}
    main = make_main_dataset()
    start = PPCAModel.init(K_MAIN, main, generator=gen(SEED + 30))
    (out / "start.bin").write_bytes(start.dump())
    llks = []
    model = PPCATrainer(main).train(start=start, state_size=K_MAIN, n_iters=PAR_ITERS,
                                    quiet=True, callback=lambda it, m: llks.append(m.llk))
    ref["10a"] = dict(params=par_host(model), llks=llks, llk=model.llk(main))
    new, llk = start._em_step(main, None)
    ref["10f"] = dict(params=par_host(new), llk=float(llk))
    del main
    rows = make_main_dataset(N_MODEL_AXIS)
    model = start.iterate(rows).iterate(rows)
    ref["10c"] = dict(params=par_host(model), llks=model.llks(rows).cpu(),
                      extrapolated=model.extrapolate(rows).data[:N_PAR_ROWS_READ].cpu())
    del rows
    pattern, _ = make_pattern_dataset()
    start_p = PPCAModel.init(K_MAIN, pattern, generator=gen(SEED + 31))
    (out / "start_pattern.bin").write_bytes(start_p.dump())
    model, llks = start_p, []
    for _ in range(2):
        model, llk = model._em_step(pattern, None)
        llks.append(float(llk))
    ref["10d"] = dict(params=par_host(model), llks=llks, llk=model.llk(pattern),
                      patterns=pattern.pattern_info()[1].cpu())
    del pattern
    mixd = make_mix_dataset()
    mix = PPCAMix.init(M_MIX, K_MIX, mixd, generator=gen(SEED + 32))
    (out / "mix.bin").write_bytes(mix.dump())
    llks = []
    mix = PPCAMixTrainer(mixd).train(start=mix, n_models=M_MIX, state_size=K_MIX,
                                     n_iters=N_DENSE_ITERS, quiet=True,
                                     callback=lambda it, m: llks.append(m.llk))
    half = N_MIX // 2
    ref["10e"] = dict(stacked=[t.cpu() for t in mix._stacked_params()], weights=mix.weights.cpu(),
                      llks=llks, cluster=[mix.infer_cluster(mixd.slice(lo, lo + N_PAR_ROWS_READ)).cpu()
                                          for lo in (0, half)])
    del mixd
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return ref


def par_same(a: dict, b: dict, keys) -> bool:
    """Two ranks' results bit for bit."""
    def same(x, y):
        if isinstance(x, torch.Tensor):
            return torch.equal(x, y)
        if isinstance(x, dict):
            return all(same(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(same(u, v) for u, v in zip(x, y))
        return x == y

    return all(same(a[k], b[k]) for k in keys)


def par_diffs(got: dict, want: dict) -> dict:
    return {name: rel_err(got[name].reshape(-1), want[name].reshape(-1)) for name in want}


def gram(C: torch.Tensor) -> torch.Tensor:
    return C.double() @ C.double().mT


def sv_gap(C: torch.Tensor) -> float:
    """The smallest gap between neighbouring singular values of C (or of
    any of a stack of transforms), relative to the largest."""
    sv = torch.linalg.svdvals(C.double())
    return float(((sv[..., :-1] - sv[..., 1:]) / sv[..., :1]).min())


def canonical_diffs(got: dict, want: dict) -> dict:
    """par_diffs of two trainers' canonical models, the transform held
    through C C^T: to_canonical's SVD fixes the latent rotation, and where
    two singular values lie close its rotation between them is
    ill-conditioned, so C itself may differ more than the model does."""
    diffs = par_diffs({k: v for k, v in got.items() if k != "C"},
                      {k: v for k, v in want.items() if k != "C"})
    diffs["C C^T"] = rel_err(gram(got["C"]), gram(want["C"]))
    return diffs


def phase_parallel(smi: str) -> dict:
    """Phase 10: the sharded path in two jobs of child processes on this
    card.  Returns rank 0's launches in the counted runs, by part."""
    import tempfile

    def blocks(n):
        return -(-n // config_block_size())

    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        t0 = time.perf_counter()
        ref = par_references(out)
        print(f"[parallel] single-process references on this card in "
              f"{time.perf_counter() - t0:.1f} s; starting 2 gloo ranks on the one card ({smi})",
              flush=True)
        t0 = time.perf_counter()
        ranks = run_job("gloo", 2, out)
        t_gloo = time.perf_counter() - t0
        t0 = time.perf_counter()
        (one,) = run_job("nccl", 1, out)
        t_nccl = time.perf_counter() - t0
    print(f"[parallel] jobs: 2 gloo ranks {t_gloo:.1f} s, 1 NCCL rank {t_nccl:.1f} s "
          "(process start, data, all parts)")

    # 10a
    for rank, res in enumerate(ranks):
        a = res["10a"]
        n_b = blocks(PAR_ROWS[rank])
        want = launches_of(fullt=PAR_ITERS * n_b, states=PAR_ITERS, llk=n_b, infer=1, chol=1)
        check(a["launches"] == want, f"10a rank {rank}: launches {a['launches']} != {want}")
        check(a["reduces"]["calls"] == PAR_ITERS, f"10a rank {rank}: {a['reduces']} statistics "
              f"all_reduces, want {PAR_ITERS}")
        check(a["draw_ok"], f"10a rank {rank}: posterior draws not finite")
        for x, y in zip(a["llks"], a["llks"][1:]):
            check(y >= x - LLK_SLACK * abs(x), f"10a rank {rank}: llk decreased: {x} -> {y}")
    check(par_same(ranks[0]["10a"], ranks[1]["10a"], ("params", "llks", "llk")),
          "10a: the ranks' parameters or llks differ")
    a, r = ranks[0]["10a"], ref["10a"]
    diffs = canonical_diffs(a["params"], r["params"])
    diffs["llk"] = abs(a["llk"] - r["llk"]) / abs(r["llk"])
    diffs["llks"] = max(abs(x - y) / abs(y) for x, y in zip(a["llks"], r["llks"]))
    report_diffs("parallel", f"10a: 2 ranks ({PAR_ROWS[0]} + {PAR_ROWS[1]} rows), "
                 f"{PAR_ITERS} trainer iterations and llk vs one process", diffs, TOL_STREAM)
    print(f"[parallel] 10a: seconds per iteration rank 0 "
          + ", ".join(f"{s:.4f}" for s in a["secs"]) + ", rank 1 "
          + ", ".join(f"{s:.4f}" for s in ranks[1]["10a"]["secs"])
          + f" (two ranks share the card: not a scale-out figure); C itself "
          f"{rel_err(a['params']['C'], r['params']['C']):.3e} (smallest singular value gap "
          f"{sv_gap(r['params']['C']):.3e} of the largest); statistics all_reduce "
          f"{a['reduce_bytes'] / 2**20:.2f} MiB alone {a['reduce_ms']:.2f} / "
          f"{ranks[1]['10a']['reduce_ms']:.2f} ms (gloo) ({smi})")

    # 10b
    check(one["10b"]["same"], "10b: the world of one is not bit-identical to _em_step")
    check("nccl" in one["10b"]["backend"], f"10b: backend {one['10b']['backend']}")
    print(f"[parallel] 10b: one NCCL rank ({one['10b']['backend']}): iterate on a 1x1 mesh "
          "equals _em_step bit for bit")

    # 10c
    n_b = blocks(N_MODEL_AXIS)
    for rank, res in enumerate(ranks):
        c = res["10c"]
        want = launches_of(fullt=2 * n_b, states=2 + n_b, llk=n_b)
        check(c["launches"] == want, f"10c rank {rank}: launches {c['launches']} != {want}")
        lo, hi = c["columns"]
        diffs = par_diffs(c["params"], ref["10c"]["params"])
        diffs["llks"] = rel_err(c["llks"], ref["10c"]["llks"])
        diffs["extrapolate"] = rel_err(c["extrapolated"], ref["10c"]["extrapolated"][:, lo:hi])
        report_diffs("parallel", f"10c rank {rank} (columns {lo}-{hi}): 1x2 model axis, 2 "
                     "iterations, llks and extrapolate vs one process", diffs, TOL_STREAM)
    check(par_same(ranks[0]["10c"], ranks[1]["10c"], ("params", "llks")),
          "10c: the ranks' parameters or llks differ")
    print(f"[parallel] 10c: seconds per iteration " + ", ".join(
        f"{s:.4f}" for s in ranks[0]["10c"]["secs"]) + f"; per-block all_reduce "
          f"{ranks[0]['10c']['reduce_bytes'] / 2**20:.1f} MiB alone "
          f"{ranks[0]['10c']['reduce_ms']:.1f} ms (with square G "
          f"{ranks[0]['10c']['square_bytes'] / 2**20:.1f} MiB "
          f"{ranks[0]['10c']['square_ms']:.1f} ms) (gloo through the host) ({smi})")

    # 10d
    for rank, res in enumerate(ranks):
        d = res["10d"]
        want = launches_of(full=3, states=2)
        check(d["launches"] == want, f"10d rank {rank}: launches {d['launches']} != {want}")
        check(d["before"] and d["mapped"] and d["sorted"],
              f"10d rank {rank}: pattern_info before detection, the row map or the sorted route")
        check(torch.equal(d["patterns"], ref["10d"]["patterns"]),
              f"10d rank {rank}: the table differs from the single-process table")
    check(par_same(ranks[0]["10d"], ranks[1]["10d"], ("params", "llks", "llk")),
          "10d: the ranks' parameters or llks differ")
    d = ranks[0]["10d"]
    diffs = par_diffs(d["params"], ref["10d"]["params"])
    diffs["llk"] = abs(d["llk"] - ref["10d"]["llk"]) / abs(ref["10d"]["llk"])
    report_diffs("parallel", f"10d: pattern route, {P_PATTERN} patterns detected collectively, "
                 "sorted EM on each rank, 2 iterations vs one process", diffs, TOL_STREAM)

    # 10e
    for rank, res in enumerate(ranks):
        e = res["10e"]
        n_b = -(-(N_MIX // 2) // config_mix_rows())
        want = launches_of(fullt=N_DENSE_ITERS * n_b, states=N_DENSE_ITERS, llk=n_b)
        check(e["launches"] == want, f"10e rank {rank}: launches {e['launches']} != {want}")
        check(e["reduces"]["calls"] == 2 * N_DENSE_ITERS,
              f"10e rank {rank}: {e['reduces']} statistics all_reduces")
        check(e["cluster_ok"], f"10e rank {rank}: infer_cluster rows not finite")
        cd = rel_err(e["cluster"], ref["10e"]["cluster"][rank])
        check(cd <= TOL_STREAM, f"10e rank {rank}: infer_cluster {cd:.3e}")
    check(par_same(ranks[0]["10e"], ranks[1]["10e"], ("stacked", "weights", "llks")),
          "10e: the ranks' mixtures differ")
    e = ranks[0]["10e"]
    diffs = {name: rel_err(x, y) for name, x, y in
             zip(("means", "noises"), e["stacked"][1:], ref["10e"]["stacked"][1:])}
    diffs["C C^T"] = rel_err(gram(e["stacked"][0]), gram(ref["10e"]["stacked"][0]))
    diffs["weights"] = rel_err(e["weights"], ref["10e"]["weights"])
    diffs["llks"] = max(abs(x - y) / abs(y) for x, y in zip(e["llks"], ref["10e"]["llks"]))
    report_diffs("parallel", f"10e: mixture, {N_DENSE_ITERS} PPCAMixTrainer iterations vs one "
                 "process (resp_max combined by MAX; transforms C itself "
                 f"{rel_err(e['stacked'][0], ref['10e']['stacked'][0]):.3e}, smallest singular "
                 f"value gap {sv_gap(ref['10e']['stacked'][0]):.3e})", diffs, TOL_STREAM)

    # 10f
    for rank, res in enumerate(ranks):
        f = res["10f"]
        want = launches_of(fullt=(N_STREAM_CHUNKS // 2) * blocks(N_MAIN // N_STREAM_CHUNKS),
                           states=1)
        check(f["launches"] == want, f"10f rank {rank}: launches {f['launches']} != {want}")
        check(f["reduces"]["calls"] == 1, f"10f rank {rank}: {f['reduces']} statistics "
              "all_reduces in one streamed pass, want 1")
    check(par_same(ranks[0]["10f"], ranks[1]["10f"], ("params", "llk")),
          "10f: the ranks' parameters differ")
    f = ranks[0]["10f"]
    diffs = par_diffs(f["params"], ref["10f"]["params"])
    diffs["llk"] = abs(f["llk"] - ref["10f"]["llk"]) / abs(ref["10f"]["llk"])
    report_diffs("parallel", f"10f: 2 ranks streaming 4 chunks each, one streamed iteration "
                 f"({f['secs']:.4f} / {ranks[1]['10f']['secs']:.4f} s) vs the resident "
                 "_em_step", diffs, TOL_STREAM)
    return {part: ranks[0][part]["launches"] for part in PAR_PARTS}


# --------------------------------------------------------------------- #
# phase 11


def check_launches(tag: str, launches: dict, want: dict, served: dict, dtype=torch.float32):
    """Exact launch counts, printed with the design that served each kernel
    launched (``served``: kernel -> k)."""
    from ppca_rs_tpu_torch.ops import kernels

    full = dict.fromkeys(kernels.KERNELS, 0)
    full.update(want)
    check(launches == full, f"{tag}: launches {launches} != {full}")
    designs = {name: kernels.design(k, "chol" if name == "chol" else "estep", dtype)
               for name, k in served.items() if full[name]}
    print(f"[large-k] {tag}: launches {launches}; "
          + ", ".join(f"{name} (k={served[name]}) by the {d} design" for name, d in designs.items()))
    return designs


def large_k_masked(smi: str, tag: str, k: int, n: int, n_iters: int, seed: int,
                   n_readout: int, n_sampler: int, n_cpu: int, profile: bool) -> dict:
    """11a/11b: bench_suite.py's masked row at state size k (D=1024, n
    rows, 50% missing at random): training, model.llk, the readouts on
    ``n_readout`` rows (none if 0), the sampler's moments on ``n_sampler``
    rows, exact launch counts with the design of each kernel, a profile of
    one more iteration, and card vs CPU on ``n_cpu`` rows.  Returns the
    model and the launches."""
    from ppca_rs_tpu_torch import config
    from ppca_rs_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    dataset = make_main_dataset(n, k, seed)
    torch.cuda.synchronize()
    rows = config.block_rows(k, 4)
    n_blocks = -(-n // rows)
    print(f"[large-k] {tag}: dataset N={n} D={D_MAIN} k={k} float32, 50% missing at random, "
          f"made in {time.perf_counter() - t0:.2f} s; {rows} rows a block ({n_blocks} blocks)")
    check(dataset.pattern_info() is None, f"{tag}: random masks were taken for structured missingness")
    model, train_launches = train(f"large-k {tag}", dataset, seed + 1, smi, k=k, n_iters=n_iters)
    check_launches(f"{tag} training", train_launches,
                   dict(fullt=n_iters * n_blocks, states=n_iters), dict(fullt=k, states=k))
    n_sub = -(-n_readout // rows)
    if n_readout:
        check_readouts(f"large-k {tag}", model, dataset.slice(0, n_readout), k=k)
    check_sampler_moments(f"large-k {tag}", model, dataset.slice(0, n_sampler))
    launches = dict(kernels.LAUNCHES)
    # readouts: infer, then smooth and extrapolate (states); the moment
    # check: infer, the sampler's factor (chol) and smooth (states)
    n_samp = -(-n_sampler // rows)
    check_launches(f"{tag} training, model.llk, readouts and sampler", launches,
                   dict(fullt=n_iters * n_blocks, states=n_iters + 2 * n_sub + n_samp, llk=n_blocks,
                        infer=n_sub + n_samp, chol=1),
                   dict(fullt=k, states=k, llk=k, infer=k, chol=k))
    if profile:
        profile_iteration(f"large-k {tag}", model, dataset)
    card_vs_cpu(f"large-k {tag}", model, dataset.slice(0, n_cpu), used=("fullt", "llk"))
    return model, launches


def large_k_pattern(model, seed: int) -> dict:
    """11e: one EM step of ``model`` on the pattern route (``full`` on the
    P tables at the model's k) over N_LK_PATTERN rows whose masks are
    P_LK_PATTERN Bernoulli(0.5) patterns, against the general route on the
    same rows (TOL_STREAM).  Returns the launches of the pattern step."""
    from ppca_rs_tpu_torch import Dataset, config
    from ppca_rs_tpu_torch.models import routes
    from ppca_rs_tpu_torch.ops import kernels

    k = model.state_size
    gen = torch.Generator(device="cuda").manual_seed(seed)
    patterns = torch.rand(P_LK_PATTERN, D_MAIN, generator=gen, device="cuda") < 0.5
    mask = patterns[torch.randint(0, P_LK_PATTERN, (N_LK_PATTERN,), generator=gen, device="cuda")]
    y = model.sample(N_LK_PATTERN, 0.0, generator=gen).data
    dataset = Dataset.from_parts(torch.where(mask, y, torch.zeros_like(y)), mask)
    check(routes.route(dataset).kind == "pattern", "11e: the rows did not take the pattern route")
    kernels.reset_launch_counts()
    pat, pat_llk = model._em_step(dataset, None)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check_launches(f"11e pattern route, {P_LK_PATTERN} patterns", launches,
                   dict(full=1, states=1), dict(full=k, states=k))
    config.use_pattern_dedup = False
    try:
        check(routes.route(dataset).kind == "masked", "11e: use_pattern_dedup=False not honoured")
        gen_model, gen_llk = model._em_step(dataset, None)
    finally:
        config.use_pattern_dedup = True
    diffs = model_diffs(pat, gen_model)
    diffs["llk"] = abs(float(pat_llk) - float(gen_llk)) / abs(float(gen_llk))
    report_diffs("large-k", f"11e: k={k}, {N_LK_PATTERN} rows, one EM step, pattern route vs "
                 "general route on the card", diffs, TOL_STREAM)
    return launches


def make_hetero_mix_dataset(seed: int):
    """N_HMIX x D_HMIX float32 rows from a mixture of components with state
    sizes K_HMIX (drawn uniformly), y = C_m z + mu_m + 0.3 eps, C_m ~
    N(0, 1) / sqrt(k_m), mu_m ~ 3 N(0, 1), 50% missing at random."""
    from ppca_rs_tpu_torch import Dataset

    gen = torch.Generator(device="cuda").manual_seed(seed)
    opts = dict(generator=gen, device="cuda", dtype=torch.float32)
    comp = torch.randint(0, len(K_HMIX), (N_HMIX,), generator=gen, device="cuda")
    y = 0.3 * torch.randn(N_HMIX, D_HMIX, **opts)
    for m, k in enumerate(K_HMIX):
        rows = (comp == m).nonzero().squeeze(1)
        C = torch.randn(D_HMIX, k, **opts) / math.sqrt(k)
        z = torch.randn(len(rows), k, **opts)
        y.index_add_(0, rows, z @ C.T + 3.0 * torch.randn(D_HMIX, **opts))
    mask = torch.rand(N_HMIX, D_HMIX, generator=gen, device="cuda") >= 0.5
    return Dataset.from_parts(torch.where(mask, y, torch.zeros_like(y)), mask)


def large_k_mixture(smi: str, seed: int) -> dict:
    """11d: a mixture with heterogeneous state sizes K_HMIX (padded to the
    largest) trained for N_DENSE_ITERS PPCAMixTrainer iterations; one fused
    EM step against the per-component loop (TOL_STREAM), infer_cluster
    against the components' own llks (TOL_POSTERIOR), and one EM step, the
    llks and infer_cluster on N_HMIX_CPU rows against the CPU in float64
    (TOL_CARD_VS_CPU).  Returns the launches of training, model.llk and
    infer_cluster."""
    from ppca_rs_tpu_torch import Dataset, PPCAMix, PPCAModel, Prior, config
    from ppca_rs_tpu_torch.ops import kernels

    dataset = make_hetero_mix_dataset(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    start = PPCAMix([PPCAModel.init(k, dataset, generator=gen) for k in K_HMIX],
                    torch.full((len(K_HMIX),), -math.log(len(K_HMIX)), device="cuda"))
    kmax, M = max(K_HMIX), len(K_HMIX)
    rows = config.mix_block_rows(M, kmax, 4)
    n_blocks = -(-N_HMIX // rows)
    print(f"[large-k] 11d: mixture of state sizes {K_HMIX} (padded to {kmax}), D={D_HMIX}, "
          f"N={N_HMIX}: {rows} data rows a block, {M * rows} kernel samples a launch")
    mix, _ = train("large-k 11d", dataset, seed + 2, smi, k=kmax, n_models=M,
                   n_iters=N_DENSE_ITERS, start=start)
    cluster = mix.infer_cluster(dataset)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    # training; model.llk; infer_cluster (llk)
    check_launches("11d training, model.llk and infer_cluster", launches,
                   dict(fullt=N_DENSE_ITERS * n_blocks, states=N_DENSE_ITERS, llk=2 * n_blocks),
                   dict(fullt=kmax, states=kmax, llk=kmax))
    fused, fused_llk = mix._iterate_with_llk(dataset, Prior())
    loop, loop_llk = mix._iterate_loop(dataset, Prior())
    diffs = mix_diffs(fused, loop)
    diffs["llk"] = abs(fused_llk - loop_llk) / abs(loop_llk)
    own = torch.stack([m.llks(dataset) for m in mix.models], -1) + mix.log_weights
    check(tuple(cluster.shape) == (N_HMIX, M) and bool(torch.isfinite(cluster).all()),
          "11d: infer_cluster has the wrong shape or non-finite values")
    report_diffs("large-k", "11d: one fused EM step vs the per-component loop (each component "
                 "a single model at its own k)", diffs, TOL_STREAM)
    cd = rel_err(cluster.exp(), torch.softmax(own, -1))
    print(f"[large-k] 11d: infer_cluster's posteriors vs the components' own llks: max abs diff "
          f"{cd:.3e} (tol {TOL_POSTERIOR:g})")
    check(cd <= TOL_POSTERIOR, f"11d: infer_cluster {cd:.3e} above {TOL_POSTERIOR}")

    # the independent reference: the port's plain path on the CPU in float64
    sub = dataset.slice(0, N_HMIX_CPU)
    host = mix_on_cpu64(mix)
    sub_host = Dataset.from_parts(sub.data.cpu().double(), sub.mask.cpu(), sub.weights_dev.cpu().double())
    card, card_llk = mix._iterate_with_llk(sub, Prior())
    t0 = time.perf_counter()
    cpu, cpu_llk = host._iterate_with_llk(sub_host, Prior())
    diffs = mix_diffs(card, cpu)
    diffs["llk"] = abs(card_llk - cpu_llk) / abs(cpu_llk)
    diffs["llks"] = rel_err(mix.llks(sub).cpu(), host.llks(sub_host))
    diffs["infer_cluster"] = rel_err(cluster[:N_HMIX_CPU].exp().cpu(), host.infer_cluster(sub_host).exp())
    report_diffs("large-k", f"11d: {N_HMIX_CPU} rows, one EM step, llks and infer_cluster's "
                 f"posteriors, card float32 vs CPU float64 ({time.perf_counter() - t0:.1f} s on "
                 "the CPU)", diffs, TOL_CARD_VS_CPU)
    return launches


def phase_large_k(smi: str) -> dict:
    """Phase 11: the masked route past the register tiles, at bench_suite.py's
    k=256 and k=512 rows, the pattern route at k=256, float64 at k=96 on
    the card, and a mixture with heterogeneous large state sizes.  Returns
    the launches by part."""
    from ppca_rs_tpu_torch import PPCAModel, config
    from ppca_rs_tpu_torch.ops import kernels

    out = {}
    model, out["11a"] = large_k_masked(smi, "11a", 256, N_LK256, 3, SEED + 40, N_LK_READOUT,
                                       N_LK_SAMPLER, N_LK_CPU, profile=True)
    out["11e"] = large_k_pattern(model, SEED + 49)
    del model
    torch.cuda.empty_cache()
    _, out["11b"] = large_k_masked(smi, "11b", 512, N_LK512, 2, SEED + 43, 0, N_LK512_SAMPLER,
                                   N_LK512_CPU, profile=False)
    torch.cuda.empty_cache()

    # 11c: float64 on the card at a k that the float64 tile does not take
    ds = make_main_dataset(N_LK64, K_LK64, SEED + 46).astype(torch.float64)
    model = PPCAModel.init(K_LK64, ds, generator=torch.Generator(device="cuda").manual_seed(SEED + 47))
    check(model.transform.dtype == torch.float64, "11c: the model is not float64")
    kernels.reset_launch_counts()
    model = model.iterate(ds)
    card_vs_cpu("large-k 11c", model, ds, used=("fullt", "states", "llk"), tol=TOL_F64_CARD_VS_CPU)
    out["11c"] = dict(kernels.LAUNCHES)
    n_blocks = -(-N_LK64 // config.block_rows(K_LK64, 8))
    check_launches("11c float64", out["11c"], dict(fullt=2 * n_blocks, states=2, llk=n_blocks),
                   dict(fullt=K_LK64, states=K_LK64, llk=K_LK64), dtype=torch.float64)
    del ds, model
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()
    out["11d"] = large_k_mixture(smi, SEED + 48)
    return out


# --------------------------------------------------------------------- #
# phase 12: a structured mixture


def sorted_rows(dataset, pidx, n_patterns: int):
    """``(data_sorted, weights_sorted, counts)`` of ``dataset``'s rows
    (``pidx`` their pattern indices), as ``Dataset.pattern_order`` sorts
    them."""
    perm = torch.argsort(pidx, stable=True)
    counts = tuple(int(c) for c in torch.bincount(pidx, minlength=n_patterns).tolist())
    return dataset.data.index_select(0, perm), dataset.weights_dev[perm], counts


def stats_diffs(got, want) -> dict:
    """Max relative differences of two MixEMStats, field by field."""
    return {name: rel_err(getattr(got, name).cpu(), getattr(want, name).cpu())
            for name in want._fields}


def check_patmix_kernels(mix, stats, patterns) -> dict:
    """The kernels phase 12 launches, at its shapes, against their plain
    versions and timed: full on the M x P tables (sigma per sample) and
    states on the M x D row solve of this mixture's statistics."""
    from ppca_rs_tpu_torch.ops import masked_linalg as ml

    Cs, _, sigmas = mix._stacked_params()
    M, _, k = Cs.shape
    P = patterns.shape[0]
    pf = patterns.float()
    x_full = dict(G=torch.matmul(pf, ml.outer_flat(Cs)).reshape(M * P, k, k),
                  b=torch.zeros(M * P, k, device="cuda"), rnorm=torch.zeros(M * P, device="cuda"),
                  d_obs=pf.sum(-1).repeat(M))
    sig = sigmas.repeat_interleave(P)
    x_states = row_solve_inputs(stats)
    zero = torch.zeros(1, device="cuda")
    errors = {"full": check_estep_at("patmix", "full", x_full, sig, k),
              "states": check_estep_at("patmix", "states", x_states, zero, k)}
    timed = time_estep(k, x_full, ("full",), sigma=sig)
    timed.update(time_estep(k, x_states, ("states",), sigma=zero))
    for name, row in timed.items():
        row["max_abs_err"] = errors[name]
    return timed


def phase_patmix(smi: str):
    """Phase 12: a structured mixture on the default route, the per-segment
    EM (``mix_fused.mix_em_stats_pat_sorted``): training with exact launch
    counts, a profile, the per-segment EM against the table-grouped EM on
    the same parameters at several segment lengths (times and agreement),
    card vs CPU float64 on a few hundred sorted rows, and the kernels at
    this phase's shapes.  Returns (launches of the training, kernel rows)."""
    from ppca_rs_tpu_torch import config
    from ppca_rs_tpu_torch.ops import kernels
    from ppca_rs_tpu_torch.ops import mix_fused as mf

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    patterns = torch.rand(P_PATMIX, D_PATMIX, generator=gen, device="cuda") < 0.5
    dataset = make_mix_dataset(seed=SEED + 51, n=N_PATMIX, d=D_PATMIX, k=K_PATMIX,
                               m_comp=M_PATMIX, patterns=patterns)
    torch.cuda.synchronize()
    print(f"[patmix] dataset N={N_PATMIX} D={D_PATMIX} k={K_PATMIX} M={M_PATMIX} "
          f"{dataset.dtype}, {P_PATMIX} mask patterns, observed share "
          f"{float(dataset.mask.float().mean()):.4f}, made in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    info = dataset.pattern_info()
    order = dataset.pattern_order()
    torch.cuda.synchronize()
    check(info is not None and info[1].shape[0] == P_PATMIX,
          f"patmix: detection found {None if info is None else info[1].shape[0]} patterns")
    check(order is not None, "patmix: pattern_order() does not apply at the gate")
    pidx, table = info
    counts = order[2]
    print(f"[patmix] detection and the sorted copy in {time.perf_counter() - t0:.3f} s: "
          f"{len(counts)} segments of {min(counts)}-{max(counts)} rows "
          f"(gate {config.pat_sorted_min_rows} a segment on average)")
    rows = config.mix_block_rows(M_PATMIX, K_PATMIX, 4)

    calls = {"sorted": 0, "table": 0}
    inner = {"sorted": mf.mix_em_stats_pat_sorted, "table": mf.mix_em_stats_pat}

    def counted(key):
        def call(*args, **kwargs):
            calls[key] += 1
            return inner[key](*args, **kwargs)
        return call

    mf.mix_em_stats_pat_sorted, mf.mix_em_stats_pat = counted("sorted"), counted("table")
    try:
        mix, launches = train("patmix", dataset, SEED + 52, smi, k=K_PATMIX, n_models=M_PATMIX,
                              n_iters=PATMIX_ITERS)
    finally:
        mf.mix_em_stats_pat_sorted, mf.mix_em_stats_pat = inner["sorted"], inner["table"]
    want = dict.fromkeys(kernels.KERNELS, 0)
    want.update(full=PATMIX_ITERS, states=PATMIX_ITERS)
    check(launches == want, f"patmix: training launches {launches} != {want}")
    check(calls == {"sorted": PATMIX_ITERS, "table": 0},
          f"patmix: training took the EM forms {calls}, not the per-segment EM alone")
    print(f"[patmix] {rows} data rows a block; training ran the per-segment EM "
          f"{calls['sorted']} times, the table-grouped EM {calls['table']} times")
    profile_iteration("patmix", mix, dataset, top=8)

    Cs, means, sigmas = mix._stacked_params()
    lw = mix.log_weights
    at_gate = None
    for seg in PATMIX_SEGMENT_ROWS:
        n = seg * P_PATMIX
        sub = dataset if n == len(dataset) else dataset.slice(0, n)
        pb = pidx[:n]
        if sub is dataset:
            data_s, w_s, cnt = order[0], dataset.weights_dev[order[1]], order[2]
        else:
            data_s, w_s, cnt = sorted_rows(sub, pb, P_PATMIX)
        (s1, s2), (g1, g2), got, ref = in_turns(
            lambda: mf.mix_em_stats_pat_sorted(Cs, means, sigmas, lw, data_s, w_s, table, cnt,
                                               block_size=rows),
            lambda: mf.mix_em_stats_pat(Cs, means, sigmas, lw, sub.data, sub.mask, pb, table,
                                        sub.weights_dev, block_size=rows), PATMIX_REPS)
        print(f"[patmix] EM statistics of N={n} ({seg} rows a segment): per segment "
              f"{s1 * 1e3:.2f}/{s2 * 1e3:.2f} ms, table-grouped {g1 * 1e3:.2f}/{g2 * 1e3:.2f} ms "
              f"({(g1 + g2) / (s1 + s2):.2f}x) ({smi})")
        if sub is dataset:
            at_gate = (got, ref)
        del data_s, w_s, got, ref
    got, ref = at_gate
    diffs = stats_diffs(got, ref)
    new_sorted = mix._finalize(Cs, means, sigmas, got, None)
    new_table = mix._finalize(Cs, means, sigmas, ref, None)
    step = mix_diffs(new_sorted, new_table)
    report_diffs("patmix", f"the statistics at N={N_PATMIX}, per segment vs table-grouped",
                 diffs, TOL_STREAM)
    report_diffs("patmix", "the EM step from either form", step, TOL_STREAM)

    sub = dataset.slice(0, N_PATMIX_CPU)
    data_s, w_s, cnt = sorted_rows(sub, pidx[:N_PATMIX_CPU], P_PATMIX)
    card = mf.mix_em_stats_pat_sorted(Cs, means, sigmas, lw, data_s, w_s, table, cnt,
                                      block_size=rows)
    host = [t.cpu().double() for t in (Cs, means, sigmas, lw, data_s, w_s)]
    t0 = time.perf_counter()
    cpu = mf.mix_em_stats_pat_sorted(*host[:4], host[4], host[5], table.cpu(), cnt,
                                     block_size=rows)
    report_diffs("patmix", f"{N_PATMIX_CPU} sorted rows ({sum(c > 0 for c in cnt)} segments), "
                 f"the per-segment statistics, card float32 vs CPU float64 "
                 f"({time.perf_counter() - t0:.1f} s on the CPU)", stats_diffs(card, cpu),
                 TOL_CARD_VS_CPU)

    kernel_rows = check_patmix_kernels(mix, ref, table)
    return launches, kernel_rows


# --------------------------------------------------------------------- #
# phase 13: the examples


def phase_examples() -> None:
    """Phase 13: every script of examples/torch_port/ on the card with
    ``--device cuda`` in smoke mode, all started together, each in its own
    process group (sharded_training spawns its ranks) and killed after
    EXAMPLE_TIMEOUT seconds; each must exit with 0."""
    import signal
    import tempfile

    scripts = sorted((ROOT / "examples" / "torch_port").glob("*.py"))
    check(len(scripts) == 9, f"examples/torch_port holds {len(scripts)} scripts, not 9")
    env = dict(os.environ, PPCA_EXAMPLE_SMOKE="1", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = {}
        for script in scripts:
            log = open(Path(tmp) / f"{script.stem}.log", "w")
            procs[script.name] = (subprocess.Popen(
                [sys.executable, str(script), "--device", "cuda"], stdout=log,
                stderr=subprocess.STDOUT, env=env, cwd=str(ROOT), start_new_session=True), log)
        ended = {}
        try:
            for name, (proc, _) in procs.items():
                try:
                    proc.wait(timeout=max(1.0, t0 + EXAMPLE_TIMEOUT - time.perf_counter()))
                except subprocess.TimeoutExpired:
                    pass
                ended[name] = time.perf_counter() - t0
        finally:
            for proc, log in procs.values():
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.wait()
                log.close()
        failed = []
        for name, (proc, _) in procs.items():
            text = (Path(tmp) / f"{Path(name).stem}.log").read_text()
            last = text.strip().splitlines()[-1] if text.strip() else ""
            print(f"[examples] {name}: exit code {proc.returncode}, done within "
                  f"{ended[name]:.1f} s: {last[:160]}")
            if proc.returncode != 0:
                failed.append(f"{name} exited {proc.returncode}:\n{text[-3000:]}")
        check(not failed, "examples failed:\n" + "\n".join(failed))
    print(f"[examples] all {len(scripts)} examples passed on the card in smoke mode in "
          f"{time.perf_counter() - t0:.1f} s, run together")


# --------------------------------------------------------------------- #
# phase 14


@contextlib.contextmanager
def launch_log():
    """Record the (kernel, k) of every launch while the block runs, beside
    the wrappers' own counts."""
    from ppca_rs_tpu_torch.ops import kernels

    seen = []
    launch, launch_chol = kernels.launch, kernels.launch_chol

    def logged(want, sigma, G, b, *args, **kwargs):
        seen.append((want, b.shape[-1]))   # k: G may be slabs
        return launch(want, sigma, G, b, *args, **kwargs)

    def logged_chol(M, L):
        seen.append(("chol", M.shape[-1]))
        return launch_chol(M, L)

    kernels.launch, kernels.launch_chol = logged, logged_chol
    try:
        yield seen
    finally:
        kernels.launch, kernels.launch_chol = launch, launch_chol


def dataset_cpu64(ds):
    """``ds`` in float64 on the CPU, with the route the card found for it
    (its mask-only caches), so the host does not detect patterns again."""
    from ppca_rs_tpu_torch import Dataset

    host = Dataset.from_parts(ds.data.cpu().double(), ds.mask.cpu(), ds.weights_dev.cpu().double())
    return ds._share_caches(host, torch.device("cpu"))


def scalar_err(got: float, want: float) -> float:
    return rel_err(torch.tensor([got]), torch.tensor([want]))


def themes_data(n: int, d: int, k: int, seed: int, missing: float = 0.5, patterns: int = 0,
                noise: float = 0.5, scale: float = 1.0, offset=None):
    """n x d float32 rows made on the card, y = z C^T + mean + noise eps
    with C ~ scale N(0, 1) (d x k), z, eps ~ N(0, 1) and mean ~ N(0, 1)
    (or ``offset``); each entry missing with probability ``missing``, or,
    with ``patterns`` = P, each row observed as one of P masks that miss
    each entry with probability ``missing``.  Returns (dataset, C, mean)."""
    from ppca_rs_tpu_torch import Dataset

    gen = torch.Generator(device="cuda").manual_seed(seed)
    opts = dict(generator=gen, device="cuda", dtype=torch.float32)
    C = scale * torch.randn(d, k, **opts)
    mean = torch.randn(d, **opts) if offset is None else offset
    table = torch.rand(patterns, d, generator=gen, device="cuda") >= missing if patterns else None
    data = torch.empty(n, d, device="cuda", dtype=torch.float32)
    mask = torch.empty(n, d, device="cuda", dtype=torch.bool)
    step = 1 << 16
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        y = torch.randn(hi - lo, k, **opts) @ C.T + mean
        if noise:
            y = y + noise * torch.randn(hi - lo, d, **opts)
        if table is not None:
            m = table[torch.randint(0, patterns, (hi - lo,), generator=gen, device="cuda")]
        else:
            m = torch.rand(hi - lo, d, generator=gen, device="cuda") >= missing
        data[lo:hi] = torch.where(m, y, torch.zeros_like(y))
        mask[lo:hi] = m
    return Dataset.from_parts(data, mask), C, mean


def themes_zero_model(tag: str, model, ds, host_ds, kind: str) -> None:
    """(a) A k = 0 model on ``ds``: one EM step, llks, infer and the sampler
    on the card with no launch, against the CPU in float64 (``host_ds``)."""
    from ppca_rs_tpu_torch.models.routes import route
    from ppca_rs_tpu_torch.ops import kernels

    check(route(ds).kind == kind, f"{tag}: the data took route {route(ds).kind}, not {kind}")
    before = dict(kernels.LAUNCHES)
    with launch_log() as seen:
        new, llk = model._iterate_with_llk(ds, None)
        llks = model.llks(ds)
        inferred = model.infer(ds)
        draw = inferred.posterior_sampler().sample(
            generator=torch.Generator(device="cuda").manual_seed(SEED + 141)).data
        torch.cuda.synchronize()
    check(not seen and kernels.LAUNCHES == before, f"{tag}: launches at k = 0: {seen}")
    host = model_cpu64(model)
    cnew, cllk = host._iterate_with_llk(host_ds, None)
    cinf = host.infer(host_ds)
    n, D = len(ds), ds.output_size()
    check(tuple(inferred.states().shape) == (n, 0)
          and tuple(inferred.covariances_array().shape) == (n, 0, 0),
          f"{tag}: infer shapes {tuple(inferred.states().shape)}")
    sigma = float(model.isotropic_noise)
    se = float((draw.mean(0) - model.mean).abs().max()) / (sigma / math.sqrt(n))
    var = float(draw.var(0).mean()) / sigma ** 2
    check(bool(torch.isfinite(draw).all()) and se < SAMPLER_SE and abs(var - 1) < SAMPLER_VAR,
          f"{tag}: sampler draws: mean {se:.2f} standard errors off, variance ratio {var:.4f}")
    diffs = {**model_diffs(new, cnew), "llk": scalar_err(llk, cllk),
             "llks": rel_err(llks.cpu(), host.llks(host_ds)),
             "states": rel_err(inferred.states().cpu(), cinf.states())}
    report_diffs("themes", f"(a) {tag}: N={n} D={D}, one EM step, llks, infer, card float32 "
                 f"vs CPU float64, no launch; sampler draws mean {se:.2f} SE, variance ratio "
                 f"{var:.4f}", diffs, TOL_CARD_VS_CPU)


def themes_zero_mix(tag: str, ks, ds, host_ds, center) -> None:
    """(a) A mixture of state sizes ``ks`` (some 0) on the general route,
    its components' means near the data's (``center``) and their noise
    near the data's spread about it, so that each keeps a share of the
    rows (a component far from every row takes none, and its update then
    differs between float32 and float64 by design): one EM step, llks,
    infer and the sampler on the card against the CPU in float64; no
    launch at k = 0."""
    from ppca_rs_tpu_torch import PPCAMix, PPCAModel, Prior

    gen = torch.Generator(device="cuda").manual_seed(SEED + 142)
    D = ds.output_size()
    spread = math.sqrt(float(((ds.data - center) * ds.mask).pow(2).sum() / ds.mask.sum()))
    models = [PPCAModel._from_params(0.3 * torch.randn(D, k, generator=gen, device="cuda"),
                                     center + 0.1 * torch.randn(D, generator=gen, device="cuda"),
                                     torch.tensor(spread * (1.0 + 0.05 * i), device="cuda"))
              for i, k in enumerate(ks)]
    mix = PPCAMix(models, torch.log(torch.tensor([0.4, 0.6], dtype=torch.float64)))
    check(ds.pattern_info(include_dense=True) is None, f"{tag}: not the general route")
    with launch_log() as seen:
        new, llk = mix._iterate_with_llk(ds, Prior())
        llks = mix.llks(ds)
        inferred = mix.infer(ds)
        draw = inferred.posterior_sampler().sample(
            generator=torch.Generator(device="cuda").manual_seed(SEED + 143)).data
        torch.cuda.synchronize()
    sizes = {k for _, k in seen}
    check(0 not in sizes and sizes <= set(ks), f"{tag}: launches at state sizes {sorted(sizes)}")
    check(bool(seen) == (max(ks) > 0), f"{tag}: {len(seen)} launches")
    check(bool(torch.isfinite(draw).all()) and tuple(draw.shape) == (len(ds), D),
          f"{tag}: sampler draws")
    host = mix_on_cpu64(mix)
    cnew, cllk = host._iterate_with_llk(host_ds, Prior())
    diffs = {**mix_diffs(new, cnew), "llk": scalar_err(llk, cllk),
             "llks": rel_err(llks.cpu(), host.llks(host_ds)),
             "posteriors": rel_err(inferred.posteriors().cpu(),
                                   host.infer(host_ds).posteriors())}
    weights = ", ".join(f"{w:.4f}" for w in cnew.weights.tolist())
    report_diffs("themes", f"(a) {tag}: N={len(ds)} D={D}, one EM step (new weights "
                 f"{weights}), llks, infer, card float32 vs CPU float64, {len(seen)} launches, "
                 f"all at k={sorted(sizes) or '-'}", diffs, TOL_CARD_VS_CPU)


def themes_zero(smi: str) -> None:
    """(a) State size 0 on the card: the masked, pattern and dense routes,
    the sampler, mixtures of (0, 0) and (0, 8) components, two streamed
    chunks."""
    from ppca_rs_tpu_torch import PPCAModel, iterate_streamed
    from ppca_rs_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    masked, _, mean = themes_data(N_ZERO, D_MAIN, K_MAIN, SEED + 140)
    zero = PPCAModel._from_params(torch.zeros(D_MAIN, 0, device="cuda"), mean.clone(),
                                  torch.tensor(0.8, device="cuda"))
    host_masked = dataset_cpu64(masked)
    themes_zero_model("masked route, k=0", zero, masked, host_masked, "masked")
    pattern, _, _ = themes_data(N_ZERO, D_MAIN, K_MAIN, SEED + 144, patterns=P_ZERO)
    themes_zero_model(f"pattern route (P={P_ZERO}), k=0", zero, pattern,
                      dataset_cpu64(pattern), "pattern")
    dense, _, _ = themes_data(N_ZERO, D_MAIN, K_MAIN, SEED + 145, missing=0.0)
    themes_zero_model("dense route, k=0", zero, dense, dataset_cpu64(dense), "dense")
    del pattern, dense
    for ks in K_ZERO_MIX:
        themes_zero_mix(f"mixture of state sizes {ks}", ks, masked, host_masked, mean)

    half = N_ZERO // 2
    before = dict(kernels.LAUNCHES)
    with launch_log() as seen:
        new, llk = iterate_streamed(zero, [masked.slice(0, half), masked.slice(half, N_ZERO)])
        torch.cuda.synchronize()
    check(not seen and kernels.LAUNCHES == before, f"streamed k=0: launches {seen}")
    cnew, cllk = model_cpu64(zero)._iterate_with_llk(host_masked, None)
    report_diffs("themes", "(a) iterate_streamed, k=0, two chunks, card float32 vs the "
                 "CPU's resident step in float64, no launch",
                 {**model_diffs(new, cnew), "llk": scalar_err(llk, cllk)}, TOL_CARD_VS_CPU)
    print(f"[themes] (a) state size 0 in {time.perf_counter() - t0:.1f} s ({smi})")


def themes_golden() -> None:
    """(b) The reference's golden anchors in float64 on the card, through
    the ``infer`` and ``llk`` kernels at k=2 (the register tile)."""
    from ppca_rs_tpu_torch.ops import kernels
    from ppca_rs_tpu_torch.ops import masked_linalg as ml

    f64 = dict(dtype=torch.float64, device="cuda")
    C = torch.tensor([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]], **f64)
    sigma, mean = 0.1, torch.tensor([0.0, 1.0, 0.0], **f64)
    D, k = C.shape
    ones = torch.ones(1, D, dtype=torch.bool, device="cuda")
    check(kernels.design(k, "estep", torch.float64) == "tile", "k=2 is not on the register tile")
    before = dict(kernels.LAUNCHES)
    gram = ml.gram_operand(C, torch.float64)
    post = ml.block_posterior(C, gram, torch.zeros(D, **f64), sigma, torch.ones(1, D, **f64),
                              ones, "infer")
    s, Sigma = post.out[0], post.out[1]
    quad = float((post.rnorm - (post.b * s).sum(-1))[0]) / sigma ** 2
    noise = 2.0 * math.log(sigma) * (D - k)
    logdet = k * 2.0 * math.log(sigma) - float(torch.logdet(Sigma[0])) + noise
    y = torch.tensor([[1.0, 2.0, 3.0]], **f64)
    llk = float(ml.block_posterior(C, gram, mean, sigma, y, ones, "llk").out[0][0])
    torch.cuda.synchronize()
    check(kernels.LAUNCHES["infer"] == before["infer"] + 1
          and kernels.LAUNCHES["llk"] == before["llk"] + 1, "golden: infer and llk not launched")
    cov = (sigma ** 2 * torch.eye(D, dtype=torch.float64) + C.cpu() @ C.cpu().T)
    r = (y - mean).cpu()[0]
    dense = -0.5 * float(r @ torch.linalg.solve(cov, r) + torch.logdet(cov) + D * math.log(2 * math.pi))
    errs = {"quadratic form": abs(quad / 34.219288 - 1), "log det": abs(logdet / -3.49328 - 1),
            "llk": abs(llk / dense - 1)}
    print(f"[themes] (b) golden anchors, float64 on the card (infer and llk kernels, k=2, "
          f"tile): quadratic form {quad:.9f} (34.219288, rel {errs['quadratic form']:.2e}, "
          f"tol 1e-6), log det {logdet:.8f} (-3.49328, rel {errs['log det']:.2e}, tol 1e-5), "
          f"toy llk {llk:.12f} vs the dense density {dense:.12f} (rel {errs['llk']:.2e}, tol 1e-10)")
    check(errs["quadratic form"] <= 1e-6 and errs["log det"] <= 1e-5 and errs["llk"] <= 1e-10,
          f"golden anchors off: {errs}")


def noiseless_steps(tag: str, fit, ds, n_steps: int = NOISELESS_ITERS):
    """(c) ``n_steps`` EM steps of ``fit`` (a model or a mixture at the
    truth, sigma = SIGMA_NOISELESS) on exact low-rank data: every sigma
    finite, >= 0 and < NOISELESS_SIGMA_MAX, every transform finite."""
    from ppca_rs_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trace = []
    for step in range(n_steps):
        fit = fit.iterate(ds)
        models = fit.models if hasattr(fit, "models") else [fit]
        sigmas = [float(m.isotropic_noise) for m in models]
        trace.append(max(sigmas))
        finite = all(bool(torch.isfinite(m.transform).all()) for m in models)
        print(f"[themes] (c) {tag}: step {step + 1}: sigma "
              + ", ".join(f"{v:.4e}" for v in sigmas))
        check(finite and all(math.isfinite(v) and 0.0 <= v < NOISELESS_SIGMA_MAX for v in sigmas),
              f"{tag}: step {step + 1}: sigma {sigmas}, transforms finite {finite}")
    torch.cuda.synchronize()
    launched = {name: n for name, n in kernels.LAUNCHES.items() if n}
    print(f"[themes] (c) {tag}: {n_steps} steps in {time.perf_counter() - t0:.2f} s, "
          f"launches {launched}")
    return trace


def themes_noiseless(smi: str) -> dict:
    """(c) Near-noiseless float32 at full width: exact low-rank data
    (C ~ N(0, 1), Gram entries of order D), the model at the truth with
    sigma = 1e-4, three EM steps on each route; and the dense route's
    large-mean-offset case against the CPU in float64."""
    from ppca_rs_tpu_torch import PPCAMix, PPCAModel, config
    from ppca_rs_tpu_torch.models.routes import route
    from ppca_rs_tpu_torch.ops import kernels

    def at_truth(C):
        return PPCAModel._from_params(C.clone(), torch.zeros(C.shape[0], device="cuda"),
                                      torch.tensor(SIGMA_NOISELESS, device="cuda"))

    def mix_at_truth(C, m):
        return PPCAMix([at_truth(C + 0.01 * i) for i in range(m)],
                       torch.zeros(m, dtype=torch.float64))

    zero = torch.zeros(D_MAIN, device="cuda")
    traces = {}
    t0 = time.perf_counter()
    for tag, k, n, kw in ((f"masked, k={K_MAIN}", K_MAIN, N_NOISELESS, dict(missing=0.3)),
                          (f"masked, k={K_NOISELESS_PANEL}", K_NOISELESS_PANEL,
                           N_NOISELESS_PANEL, dict(missing=0.3)),
                          (f"pattern (P={P_ZERO}), k={K_MAIN}", K_MAIN, N_NOISELESS,
                           dict(missing=0.3, patterns=P_ZERO)),
                          (f"dense, k={K_MAIN}", K_MAIN, N_NOISELESS, dict(missing=0.0))):
        ds, C, _ = themes_data(n, D_MAIN, k, SEED + 150 + k, noise=0.0, offset=zero, **kw)
        kind = route(ds).kind
        design = kernels.design(k, "estep", torch.float32) if kind != "dense" else "no kernel"
        traces[tag] = noiseless_steps(f"{tag}, N={n}, {kind} route, {design}", at_truth(C), ds)
        del ds
        torch.cuda.empty_cache()

    ds, C, _ = themes_data(N_NOISELESS_MIX, D_NOISELESS_MIX, K_NOISELESS_MIX, SEED + 155,
                           missing=0.2, noise=0.0, offset=torch.zeros(D_NOISELESS_MIX, device="cuda"))
    check(ds.pattern_info(include_dense=True) is None, "noiseless mixture: not the general route")
    tag = f"general mixture, M={M_NOISELESS_MIX}, k={K_NOISELESS_MIX}, D={D_NOISELESS_MIX}"
    traces[tag] = noiseless_steps(f"{tag}, N={N_NOISELESS_MIX}", mix_at_truth(C, M_NOISELESS_MIX), ds)

    ds, C, _ = themes_data(N_PATMIX, D_PATMIX, K_PATMIX, SEED + 156, patterns=P_PATMIX,
                           noise=0.0, offset=zero)
    check(ds.pattern_order() is not None, "noiseless sorted mixture: the per-segment EM does not apply")
    tag = f"sorted mixture, M={M_PATMIX}, k={K_PATMIX}, P={P_PATMIX}"
    traces[tag] = noiseless_steps(f"{tag}, N={N_PATMIX} ({config.pat_sorted_min_rows} rows a "
                                  "segment)", mix_at_truth(C, M_PATMIX), ds)
    del ds
    torch.cuda.empty_cache()

    # The dense route's statistics with a mean far from zero: the float32
    # llk within 1e-5 of float64 (the JAX test's bound), one EM step's
    # sigma within 1e-4 and mean within 1e-5 relative + 1e-3 absolute of it.
    gen = torch.Generator(device="cuda").manual_seed(SEED + 157)
    offset = 1000.0 * (1.0 + torch.rand(D_MAIN, generator=gen, device="cuda"))
    ds, C, _ = themes_data(N_OFFSET, D_MAIN, K_MAIN, SEED + 158, missing=0.0, noise=0.1,
                           offset=offset)
    check(route(ds).kind == "dense", "offset case: not the dense route")
    card = PPCAModel._from_params(C.clone(), offset.clone(), torch.tensor(0.5, device="cuda"))
    host, host_ds = model_cpu64(card), dataset_cpu64(ds)
    llk32, llk64 = card.llk(ds), host.llk(host_ds)
    new32, _ = card._iterate_with_llk(ds, None)
    new64, _ = host._iterate_with_llk(host_ds, None)
    mean_diff = (new32.mean.cpu().double() - new64.mean).abs()
    mean_gap = float((mean_diff - 1e-5 * new64.mean.abs()).max())
    sigma_gap = abs(float(new32.isotropic_noise) - float(new64.isotropic_noise))
    diffs = {"llk": abs(llk32 - llk64) / abs(llk64), "sigma (abs)": sigma_gap,
             "transform": rel_err(new32.transform.cpu(), new64.transform)}
    print(f"[themes] (c) large mean offset (1e3), dense, N={N_OFFSET} D={D_MAIN} k={K_MAIN}, card "
          f"float32 vs CPU float64: llk rel {diffs['llk']:.3e} (tol 1e-5), one EM step: sigma "
          f"{float(new32.isotropic_noise):.6f} vs {float(new64.isotropic_noise):.6f} (abs "
          f"{sigma_gap:.3e}, tol 1e-4), mean max abs diff {float(mean_diff.max()):.3e} (tol 1e-3 "
          f"+ 1e-5 |mean|), transform "
          f"{diffs['transform']:.3e} (tol {TOL_CARD_VS_CPU:g})")
    check(diffs["llk"] < 1e-5 and sigma_gap < 1e-4 and mean_gap <= 1e-3
          and diffs["transform"] <= TOL_CARD_VS_CPU, f"large mean offset: {diffs}, mean {mean_gap}")
    print(f"[themes] (c) near-noiseless float32 in {time.perf_counter() - t0:.1f} s ({smi})")
    return traces


def principal_angle(A: torch.Tensor, B: torch.Tensor) -> float:
    """Largest principal angle (radians) between the column spaces."""
    Qa, Qb = torch.linalg.qr(A.double())[0], torch.linalg.qr(B.double())[0]
    s = torch.linalg.svdvals(Qa.T @ Qb).clamp(-1.0, 1.0)
    return float(torch.arccos(s.min()))


def themes_recovery(smi: str) -> dict:
    """(d) Statistical recovery at full width: a planted model with
    orthogonal columns whose signal eigenvalues run from 40 down to 4
    sigma^2, N_RECOVERY rows 50% missing drawn on the card by
    ``PPCAModel.sample``, at most RECOVERY_ITERS trainer iterations."""
    from ppca_rs_tpu_torch import PPCAModel, PPCATrainer

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 160)
    f64 = dict(dtype=torch.float64, device="cuda")
    Q = torch.linalg.qr(torch.randn(D_MAIN, K_MAIN, generator=gen, **f64))[0]
    lam = 4.0 * 10.0 ** torch.linspace(1.0, 0.0, K_MAIN, **f64)
    C_true = (Q * torch.sqrt(lam - 1.0)).float()
    real = PPCAModel._from_params(C_true, torch.randn(D_MAIN, generator=gen, device="cuda"),
                                  torch.tensor(1.0, device="cuda"))
    ds = real.sample(N_RECOVERY, 0.5, generator=gen)
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    llks = []
    t1 = time.perf_counter()
    model = PPCATrainer(ds).train(state_size=K_MAIN, n_iters=RECOVERY_ITERS, quiet=True,
                                  callback=lambda it, m: llks.append(m.llk),
                                  generator=torch.Generator(device="cuda").manual_seed(SEED + 161))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t1
    for a, b in zip(llks, llks[1:]):
        check(b >= a - LLK_SLACK * abs(a), f"recovery: llk decreased: {a} -> {b}")
    angle = principal_angle(model.transform, C_true)
    sigma = float(model.isotropic_noise)
    print(f"[themes] (d) recovery: D={D_MAIN} k={K_MAIN} sigma=1, signal eigenvalues 40..4, "
          f"N={N_RECOVERY} drawn 50% missing in {made:.1f} s; {RECOVERY_ITERS} iterations in "
          f"{secs:.1f} s (llk/sample {llks[0]:.6f} -> {llks[-1]:.6f}): largest principal angle "
          f"{angle:.4f} rad (threshold {RECOVERY_ANGLE_MAX}), sigma {sigma:.6f} (|sigma - 1| "
          f"threshold {RECOVERY_SIGMA_TOL}) ({smi})")
    check(angle < RECOVERY_ANGLE_MAX and abs(sigma - 1.0) < RECOVERY_SIGMA_TOL,
          f"recovery: angle {angle}, sigma {sigma}")
    return {"angle": angle, "sigma": sigma, "seconds": secs}


def fuzz_draw(i: int):
    """The i-th fuzz draw, made on the host from a seed: its state size from
    FUZZ_KS in turn, float64 on even draws and float32 on odd ones, and its
    shape (N log-uniform up to FUZZ_N_MAX), masks, weights, parameters and
    prior.  The float32 draws keep the EM step well posed in float32 (at
    least 4k + 64 rows, at most half the entries missing, so each
    dimension is seen by more than 2k rows, and sigma >= 0.5);
    the float64 draws take the ragged corners (N = 1, N < k, D < k, 90%
    missing, all-masked rows); draws 6, 14 and 22 ask for FUZZ_N_MAX rows
    (more than one block where the work bound allows).  N * D * k^2 stays within FUZZ_WORK, which
    bounds the CPU's float64 side, except where the float32 draw's rows
    need more."""
    g = torch.Generator().manual_seed(SEED + 1400 + i)
    f64 = torch.float64

    def uni(a, b):
        return a + (b - a) * float(torch.rand((), generator=g, dtype=f64))

    def randint(a, b):
        return int(torch.randint(a, b + 1, (), generator=g))

    k = FUZZ_KS[i % len(FUZZ_KS)]
    dtype = torch.float64 if i % 2 == 0 else torch.float32
    kk = max(k, 1)
    if dtype == torch.float64:
        n_min, d_min, missing, sigma = 1, max(1, k // 2), uni(0.0, 0.9), uni(0.05, 2.0)
    else:
        n_min, d_min, missing, sigma = 4 * k + 64, max(1, k), uni(0.0, 0.5), uni(0.5, 1.5)
    n = {2: 1, 6: FUZZ_N_MAX}.get(i % 8) or int(math.exp(uni(math.log(n_min), math.log(FUZZ_N_MAX))))
    d = randint(d_min, max(d_min, min(1024, int(FUZZ_WORK / (n * kk * kk)))))
    n = max(n_min, min(n, int(FUZZ_WORK / (d * kk * kk))))
    patterns = randint(1, 8) if i % 6 == 5 else 0
    if i % 6 == 3:
        missing = 0.0
    C = torch.randn(d, k, generator=g, dtype=f64) * uni(0.5, 2.0) / math.sqrt(kk)
    mean = torch.randn(d, generator=g, dtype=f64)
    data = torch.randn(n, k, generator=g, dtype=f64) @ C.T + mean \
        + sigma * torch.randn(n, d, generator=g, dtype=f64)
    if patterns:
        table = torch.rand(patterns, d, generator=g, dtype=f64) >= missing
        mask = table[torch.randint(0, patterns, (n,), generator=g)]
    else:
        mask = torch.rand(n, d, generator=g, dtype=f64) >= missing
    corners = []
    if n > 3 and dtype == torch.float64 and float(torch.rand((), generator=g)) < 0.5:
        mask[randint(0, n - 1)] = False
        corners.append("all-masked row")
    if d > 2 and missing and float(torch.rand((), generator=g)) < 0.5:
        mask[:, randint(0, d - 1)] = False
        corners.append("empty dimension")
    weights = torch.rand(n, generator=g, dtype=f64) + 0.1
    if n > 2 and float(torch.rand((), generator=g)) < 0.5:
        weights[randint(0, n - 1)] = 0.0
        corners.append("zero weight")
    prior = {}
    if float(torch.rand((), generator=g)) < 0.5:
        prior["noise"] = (uni(0.5, 20.0), uni(0.5, 20.0))
    if float(torch.rand((), generator=g)) < 0.5:
        prior["tprec"] = uni(0.0, 2.0)
    if float(torch.rand((), generator=g)) < 0.5:
        prior["mean"] = (torch.randn(d, generator=g, dtype=f64).numpy(),
                         (torch.eye(d, dtype=f64) * uni(0.2, 2.0)).numpy())
    if dtype == torch.float32:    # both sides see the float32 values
        C, mean, data = C.float().double(), mean.float().double(), data.float().double()
        sigma = float(torch.tensor(sigma).float())
    data = torch.where(mask, data, torch.zeros_like(data))
    return dict(k=k, n=n, d=d, dtype=dtype, missing=missing, patterns=patterns, sigma=sigma,
                C=C, mean=mean, data=data, mask=mask, weights=weights, prior=prior,
                corners=corners)


def fuzz_prior(spec: dict):
    from ppca_rs_tpu_torch import Prior

    prior = Prior()
    if "noise" in spec:
        prior = prior.with_isotropic_noise_prior(*spec["noise"])
    if "tprec" in spec:
        prior = prior.with_transformation_precision(spec["tprec"])
    if "mean" in spec:
        prior = prior.with_mean_prior(*spec["mean"])
    return prior


def fuzz_run(draw: dict, device: str, dtype):
    """One EM step with the draw's prior, llks, infer, smooth and the
    posterior sampler's factor and one draw, on ``device`` in ``dtype``."""
    from ppca_rs_tpu_torch import Dataset, PPCAModel
    from ppca_rs_tpu_torch.models.routes import route

    ds = Dataset.from_parts(draw["data"].to(device=device, dtype=dtype), draw["mask"].to(device),
                            draw["weights"].to(device=device, dtype=dtype))
    model = PPCAModel(isotropic_noise=draw["sigma"], transform=draw["C"].numpy(),
                      mean=draw["mean"].numpy(), device=device, dtype=dtype)
    new, llk = model._iterate_with_llk(ds, fuzz_prior(draw["prior"]))
    inferred = model.infer(ds)
    sampler = inferred.posterior_sampler()
    sample = sampler.sample(generator=torch.Generator(device=device).manual_seed(SEED + 170)).data
    out = {"transform": new.transform, "mean": new.mean, "sigma": new.isotropic_noise.reshape(1),
           "llk": torch.tensor([llk]), "llks": model.llks(ds), "states": inferred.states(),
           "covariances": inferred.covariances_array(), "smooth": model.smooth(ds).data,
           "chol": sampler._chol}
    check(bool(torch.isfinite(sample).all()) and tuple(sample.shape) == (draw["n"], draw["d"]),
          f"fuzz: sampler draw on {device}")
    return {name: t.detach().cpu() for name, t in out.items()}, route(ds).kind


def themes_fuzz(smi: str) -> dict:
    """(e) FUZZ_DRAWS seeded draws through the kernels on the card against
    the CPU in float64: float32 within TOL_CARD_VS_CPU, float64 within
    TOL_FUZZ_F64.  Returns the worst error by design and dtype."""
    from ppca_rs_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    worst = {}
    for i in range(FUZZ_DRAWS):
        t1 = time.perf_counter()
        draw = fuzz_draw(i)
        k, dtype = draw["k"], draw["dtype"]
        with launch_log() as seen:
            card, kind = fuzz_run(draw, "cuda", dtype)
            torch.cuda.synchronize()
        host, host_kind = fuzz_run(draw, "cpu", torch.float64)
        check(kind == host_kind, f"fuzz {i}: card route {kind}, CPU route {host_kind}")
        design = "none" if k == 0 else kernels.design(k, "estep", dtype)
        if k and kernels.design(k, "chol", dtype) != design:
            design += f" (chol {kernels.design(k, 'chol', dtype)})"
        check({kk for _, kk in seen} <= ({k} if k else set()),
              f"fuzz {i}: launches {sorted(set(seen))} at k={k}")
        check(kind == "dense" or bool(seen) == (k > 0), f"fuzz {i}: {len(seen)} launches")
        errs = {name: rel_err(card[name], host[name]) for name in card}
        name, err = max(errs.items(), key=lambda item: item[1])
        tol = TOL_CARD_VS_CPU if dtype == torch.float32 else TOL_FUZZ_F64
        key = f"{design.split()[0]} {str(dtype)[6:]}"
        worst[key] = max(worst.get(key, 0.0), err)
        notes = [f"missing {draw['missing']:.2f}"]
        notes += [f"{draw['patterns']} patterns"] if draw["patterns"] else []
        notes += draw["corners"] + (["prior " + "+".join(draw["prior"])] if draw["prior"] else [])
        print(f"[themes] (e) draw {i:2d}: N={draw['n']} D={draw['d']} k={k} {str(dtype)[6:]}, "
              f"{', '.join(notes)}; {kind} route, {design} design, {len(seen)} launches: "
              f"worst {name} {err:.3e} (tol {tol:g}), {time.perf_counter() - t1:.2f} s")
        check(err <= tol, f"fuzz draw {i}: {name} {err:.3e} above {tol}: {errs}")
    print(f"[themes] (e) {FUZZ_DRAWS} draws in {time.perf_counter() - t0:.1f} s; worst by "
          "design: " + ", ".join(f"{k} {v:.3e}" for k, v in sorted(worst.items())) + f" ({smi})")
    return worst


def phase_themes(smi: str) -> dict:
    """Phase 14: the reference's test themes on the card through the
    kernels: (a) state size 0, (b) the golden anchors, (c) near-noiseless
    float32, (d) statistical recovery, (e) a fuzz."""
    themes_zero(smi)
    themes_golden()
    traces = themes_noiseless(smi)
    recovery = themes_recovery(smi)
    worst = themes_fuzz(smi)
    return {"noiseless": traces, "recovery": recovery, "fuzz": worst}


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--parallel-child":
        return parallel_child(sys.argv[2], int(sys.argv[3]), sys.argv[4])
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
    marks = []

    def done(phase: str) -> None:
        marks.append((phase, time.perf_counter()))
        torch.cuda.empty_cache()

    smi = phase_card()
    done("1")
    summary, wide, panel, f64 = phase_kernels()
    done("2")
    gram = phase_mask_gram(smi)
    done("2b")
    s_row = phase_mask_s(smi)
    done("2c")
    model, dataset, masked_launches = phase_main(smi)
    card_vs_cpu("card-vs-cpu", model, dataset.slice(0, N_CPU), used=("fullt", "llk"))
    del model, dataset
    done("3-4")
    pattern_launches = phase_pattern(smi)
    done("5")
    phase_dense(smi)
    done("6")
    wide_launches = phase_wide(smi)
    done("7")
    mix_launches, mix_rows = phase_mix(smi)
    done("8")
    stream_launches = phase_stream(smi)
    done("9")
    parallel_launches = phase_parallel(smi)
    done("10")
    large_launches = phase_large_k(smi)
    done("11")
    patmix_launches, patmix_rows = phase_patmix(smi)
    done("12")
    phase_examples()
    done("13")
    phase_themes(smi)
    done("14")
    starts = [t_start] + [t for _, t in marks[:-1]]
    print(f"[done] all phases passed in {marks[-1][1] - t_start:.1f} s ("
          + ", ".join(f"phase {p} {t - t0:.1f} s" for (p, t), t0 in zip(marks, starts)) + ")")

    entries = [(f"spd_estep_{want}", ESTEP_SOURCE[summary[want]["design"]], ESTEP_REPLACES, want,
                masked_launches) for want in ("fullt", "states", "llk", "infer")]
    entries += [("spd_estep_full", ESTEP_SOURCE[summary["full"]["design"]], ESTEP_REPLACES, "full",
                 pattern_launches),
                ("spd_chol", CHOL_SOURCE[summary["chol"]["design"]], CHOL_REPLACES, "chol",
                 pattern_launches)]
    fields = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "bound_us",
              "device_ms", "design", "B", "k")
    # each kernel at the main path's k, at phase 7's and at phase 8's shapes
    # (launches from those runs), its launches in phase 9's and phase 10's
    # counted runs (phase 10: rank 0's), and the kernels of phase 12's path
    # at its shapes
    # the variants the routes launch on slab G carry their slab launches
    # (SLAB_COUNTS) and their times on slab G, with square G's under "square"
    def layout(rows, key, tag):
        row = rows[key]
        out = {"slab_launches": SLAB_COUNTS[tag][key]} if key in SLAB_COUNTS[tag] else {}
        out.update({name: row[name] for name in ("layout", "square") if name in row})
        return out

    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[key], **{f: summary[key][f] for f in fields},
         **layout(summary, key, "main"),
         f"at_k{WIDE_K}": {"launches": wide_launches[key], **{f: wide[key][f] for f in fields},
                           **layout(wide, key, "k128")},
         "at_mix": {"launches": mix_launches[key], **{f: mix_rows[key][f] for f in fields},
                    **layout(mix_rows, key, "mix")},
         "at_stream": {"launches": sum(part[key] for part in stream_launches.values()),
                       **{part: counts[key] for part, counts in stream_launches.items()}},
         "at_parallel": {"launches": sum(part[key] for part in parallel_launches.values()),
                         **{part: counts[key] for part, counts in parallel_launches.items()}},
         **({"at_patmix": {"launches": patmix_launches[key],
                           **{f: patmix_rows[key][f] for f in fields}}}
            if key in patmix_rows else {})}
        for name, source, replaces, key, launches in entries
    ]}
    # the panel design: each variant's kernel at PANEL_KS (B=BATCH up to
    # FULL_BATCH_MAX_K, a block's rows above), launched on phase 11's path;
    # fullt also in float64 at F64_TIMED_KS, states and llk at K_LK64
    ref_k = PANEL_KS[1]
    for key in ("fullt", "states", "llk", "infer", "full", "chol"):
        row = panel[ref_k][key]
        entry = {"name": f"spd_panel_{key}", "route": "cuda",
                 "source": "ppca_rs_tpu_torch/csrc/spd_panel.cuh",
                 "replaces": CHOL_REPLACES if key == "chol" else ESTEP_REPLACES,
                 "launches": sum(part[key] for part in large_launches.values()),
                 **{f: row[f] for f in fields},
                 "at_large_k": {part: counts[key] for part, counts in large_launches.items()},
                 **{f"at_k{k}": {f: panel[k][key][f] for f in fields}
                    for k in PANEL_KS if k != ref_k}}
        if key == "fullt":
            entry["at_f64"] = {f"k{k}": {f: f64[k][f] for f in fields if f in f64[k]}
                               for k in F64_TIMED_KS}
        elif (key, K_LK64) in f64:
            row = f64[key, K_LK64]
            entry["at_f64"] = {f"k{K_LK64}": {f: row[f] for f in fields if f in row}}
        kernels_line["kernels"].append(entry)
    # spd_chol's tile in float64 (phase 2's timing)
    chol_entry = next(e for e in kernels_line["kernels"] if e["name"] == "spd_chol")
    chol_entry["at_f64"] = {f"k{k}": {f: f64["chol", k][f] for f in fields}
                            for k in CHOL_F64_TIMED_KS}
    # the Gram kernel: phase 2b's cases, launched on phases 3, 7 and 8's paths
    kernels_line["kernels"].append(
        {"name": "mask_gram", "route": "cuda", "source": "ppca_rs_tpu_torch/csrc/mask_gram.cu",
         "replaces": None, "launches": GRAM_COUNTS["main"]["kernel"],
         "at_k128_launches": GRAM_COUNTS["k128"]["kernel"],
         "at_mix_launches": GRAM_COUNTS["mix"]["kernel"], **gram})
    # the S kernel: phase 2c's cases, launched on phases 3, 7 and 8's paths
    kernels_line["kernels"].append(
        {"name": "mask_s", "route": "cuda", "source": "ppca_rs_tpu_torch/csrc/mask_s.cu",
         "replaces": None, "launches": S_COUNTS["main"]["kernel"],
         "at_k128_launches": S_COUNTS["k128"]["kernel"],
         "at_mix_launches": S_COUNTS["mix"]["kernel"], **s_row})
    for tag in ("main", "k128", "mix"):
        check(S_COUNTS[tag]["kernel"] > 0 and S_COUNTS[tag]["library"] == 0,
              f"{tag}: S launches {S_COUNTS[tag]}")
    for entry in kernels_line["kernels"]:
        check(entry["launches"] > 0, f"{entry['name']} was not launched by its path")
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
