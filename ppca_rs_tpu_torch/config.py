"""Global defaults for ppca_rs_tpu_torch.

Configured are the device (the card by default) and dtype that
constructors use when they are handed host arrays, the number of samples
processed per block by the blocked E-step loops, and the gates of the
mask-pattern path (``ops/pattern_dedup.py``).  Tensors handed in keep their
own device; every computation runs where its dataset lives.

Float32 matrix products run in full float32: TF32 keeps about three decimal
digits, and the log-likelihood's quadratic form cancels near convergence.
"""

from __future__ import annotations

import dataclasses

import torch


#: Bytes of one (M * rows, k, k) tensor of a mixture block: 512 MiB, the
#: single-model route's own largest (8192 x 128 x 128 float32).  At M=8,
#: k=32 in float32 the full 8192 rows fit (256 MiB); at M=8, k=64 the rows
#: halve to 4096.
MIX_BLOCK_MAX_BYTES = 512 << 20


@dataclasses.dataclass
class Config:
    #: Device for datasets and models built from host arrays: the card.
    #: Without one, building from host arrays raises unless the caller asks
    #: for the CPU (``device="cpu"``, or ``config.device = torch.device("cpu")``).
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cuda"))

    #: Floating dtype for datasets and models built from host arrays.
    dtype: torch.dtype = torch.float32

    #: Samples per block in the blocked E-step loops.  Bounds the (block, D)
    #: and (block, k, k) temporaries: at D=1024, k=64 in float32 the Gram and
    #: second-moment blocks are 128 MiB each.
    block_size: int = 8192

    #: Mask-pattern deduplication: when a dataset has P distinct mask
    #: patterns with P << N (structured missingness), the per-sample
    #: factorizations collapse to a P-sized table (ops/pattern_dedup.py).
    use_pattern_dedup: bool = True

    #: Upper bound on P for the pattern path (the tables hold P k^2
    #: entries and the statistics' assembly is a (D, P) contraction).
    pattern_max: int = 4096

    #: Take the pattern path only when P * pattern_min_ratio <= N; below
    #: that the general masked path is as cheap.
    pattern_min_ratio: int = 4

    #: Do not build the rows-sorted-by-pattern copy of the data (the
    #: per-segment EM of ops/pattern_dedup.em_stats_sorted) past this size:
    #: it doubles the dataset's device memory while it lives.
    pat_sorted_max_bytes: int = 4 << 30

    #: Take the per-segment EM only when the segments hold this many rows
    #: on average (N / P); below it the table-grouped EM is faster.  Each
    #: row block of a segment costs ~0.35 ms of host time for its ~35
    #: launches, against ~0.1 us of device time per row that the grouped
    #: EM spends more.  Measured on an H100 (80GB HBM3, 700 W): sorted vs
    #: grouped em_stats 65 vs 105 ms at N=1,000,000, P=32 (31,250 rows a
    #: segment), 104-132 vs 27 ms at N=262,144, P=256 (1,024 rows), and
    #: 763-833 vs 29-34 ms at P=2,048 (128 rows); the two cross near 8,192.
    #: A mixture's grouped EM gathers a (M, rows, k, k) covariance per
    #: block, so its sorted EM wins further down: at M=8, k=64, D=1024,
    #: P=32 (chip_smoke.py phase 12; H100 80GB HBM3, 700 W) 62-96 vs 145-146
    #: ms at 8,192 rows a segment, 41-58 vs 73-80 ms at 4,096, 32-56 vs 37
    #: ms at 2,048, 33-48 vs 19-22 ms at 1,024: they cross between 2,048
    #: and 4,096, below this gate, which both take (the JAX package's rule).
    #: The single model's times are of the per-segment EM's earlier blocks
    #: of 8,192 rows and ~35 launches; its blocks of :meth:`segment_rows`
    #: and a dozen launches are not measured against this gate.
    pat_sorted_min_rows: int = 8192

    #: Compute the fused mixture EM's per-component residual norms from a
    #: materialized (M, block, D) residual (ops/mix_fused._block_mix) instead
    #: of the expanded quadratic |md0|^2 - 2 md0.dm + mask.dm^2 of the
    #: default block.  The expanded form's float32 cancellation grows with
    #: the spread of the component means against the noise: at a separation
    #: of 300 with residual 0.5, dev_sq is 1.8e-3 and the llk 8.5e-4 off
    #: float64 on the CPU, 3.8e-7 and 5.5e-8 with this flag
    #: (tests/test_torch_mix_ops.py::test_exact_rnorm_envelope_float32).  EM
    #: convergence is unaffected.  Turn on when widely separated components
    #: need exact llk and noise values.
    mix_exact_rnorm: bool = False

    def mix_block_rows(self, n_models: int, k: int, itemsize: int) -> int:
        """Data rows per mixture block.  A block of ``rows`` data rows
        factors M * rows posteriors in one kernel launch, with (M * rows, k,
        k) Gram and second-moment tensors; rows are halved from
        :attr:`block_size` until each of those fits MIX_BLOCK_MAX_BYTES."""
        rows = self.block_size
        while rows > 1 and n_models * rows * k * k * itemsize > MIX_BLOCK_MAX_BYTES:
            rows //= 2
        return rows

    def block_rows(self, k: int, itemsize: int) -> int:
        """Rows per block of a single model's blocked loops: the mixture
        rule with one component, so one (rows, k, k) tensor fits
        MIX_BLOCK_MAX_BYTES.  In float32 k <= 128 keeps 8192 rows, k=256
        takes 2048 and k=512 takes 512 (``ppca_rs_tpu/config.py``'s
        ``block_size_for`` also shrinks blocks with k)."""
        return self.mix_block_rows(1, k, itemsize)

    def segment_rows(self, D: int, itemsize: int) -> int:
        """Rows per block of the per-segment EM
        (``ops/pattern_dedup.em_stats_sorted``) and of the dense route's EM
        statistics (``ops/dense_fast.em_stats``), never fewer than
        :attr:`block_size`.  Their temporaries are (rows, D) and (rows, k)
        only, so a block holds MIX_BLOCK_MAX_BYTES of rows: 131,072 at
        D=1024 in float32, where a segment of 31,250 rows is one block of a
        dozen launches instead of four blocks of ~35, and 10,485,760 dense
        rows are 80 blocks of ~37 launches instead of 1,280 (on an H100
        80GB HBM3 at 700 W, 0.18 s an iteration instead of 0.40-0.68 s)."""
        return max(self.block_size, MIX_BLOCK_MAX_BYTES // (D * itemsize))

    def resolve_device(self, device=None) -> torch.device:
        """The device for tensors built from host arrays: ``device`` if
        given, else :attr:`device`.  A CUDA device with no card raises:
        nothing falls back to the CPU unless the caller asks for it."""
        dev = torch.device(device) if device is not None else self.device
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"no CUDA device for {dev}: pass device='cpu' or set "
                "ppca_rs_tpu_torch.config.device = torch.device('cpu') to run on the CPU"
            )
        return dev


config = Config()

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
