"""The batched SPD kernels: hand-written CUDA kernels and their plain versions.

For every sample of a batch, with ``M = sigma^2 I + G`` (G the masked Gram
``C^T diag(m) C``, b = ``C^T (m * (y - mu))``, rnorm = ``|m * (y - mu)|^2``,
d_obs = ``|m|``), :func:`spd_estep` returns by ``want``:

* ``"llk"``    -> ``(llk,)``
* ``"states"`` -> ``(s, llk)`` with ``s = M^{-1} b``
* ``"infer"``  -> ``(s, Sigma, llk, sq)`` with ``Sigma = sigma^2 M^{-1}``
* ``"fullt"``  -> ``(s, SM, llk, sq)`` with ``SM = s s^T + Sigma``
* ``"full"``   -> the same as ``"fullt"``: one kernel body under its own
  code, so that the pattern tables' launches are counted apart

where ``llk`` is the per-sample log-likelihood and ``sq = tr(G Sigma) =
sigma^2 (k - sigma^2 tr M^{-1})``, the noise-update term.  ``"full"`` and
``"infer"`` fill their matrix whole; the kernel writes ``"fullt"``'s SM on
and below the diagonal only (the TPU kernel's contract) and leaves every
element above it as it was, so a caller reads SM's lower triangle only
(the M-steps rebuild S with ``masked_linalg.symmetric_from_lower``).  The
plain version fills SM whole, a superset.

Layout is batch-major: ``G (B, k, k)``, ``b (B, k)``, ``rnorm, d_obs (B,)``;
``sigma`` is one noise level for the batch (a Python float or a one-element
tensor) or one per sample (a tensor of B elements, as the mixtures stack
their components on the batch axis).

Where :func:`uses_slabs` holds (k a multiple of 8, 16 < k <= the tile's
limit), G may instead be a 2-D ``(B, slab_width(k))`` tensor of **slabs**,
the port of the JAX kernel's wedge slabs (``ppca_rs_tpu/ops/kernels.py:
g_slabs``) fitted to the tile, which reads G's lower triangle: k is split
into blocks of 8 rows, and row r of block j = r // 8 holds its first
8 (j + 1) entries (the lower triangle and the upper part of its 8 x 8
diagonal block), rows one after another (:func:`slab_pack`).  Every row
starts 16-byte aligned.  A Gram built as slabs computes
``slab_width(k) / k^2`` of the square one's columns (0.5625 at k=64).  With
slab G, ``"fullt"``'s SM comes back in the same layout, ``(B,
slab_width(k))``, written whole: SM on and below the diagonal, zeros above
it; every other output keeps its shape.

On a CUDA tensor the wrapper launches the kernel behind
``csrc/spd_estep.cu`` (the port of ``ppca_rs_tpu/ops/kernels.py:_make_kernel``
/ ``spd_estep``) or raises: up to the tile limit the library reports
(:func:`design`) the tile design of ``csrc/spd_estep_tile.cuh`` (to k=16 a
sample in a segment of a warp's registers; above, a CTA a sample with its
matrix in shared memory and the products on the tensor cores), above it
the panel design of ``csrc/spd_panel.cuh`` (panel steps whose products run
on the tensor cores, 3xTF32 in float32 and FP64 MMA in float64), which
takes any k device memory holds (``llk`` and ``states``
give it a scratch, :func:`scratch_shape`).  On a CPU tensor it runs
:func:`spd_estep_reference`.  There is no other route.  An all-masked
sample (``G = 0``, ``b = 0``, ``rnorm = d_obs = 0``) is neutral: ``s = 0``,
``Sigma = I``, ``llk = 0``.  A sample whose M is not positive definite
yields non-finite values for that sample only.  State size 0 has no
factorization: both wrappers answer it with :func:`spd_estep_state_size_zero`
and :func:`spd_chol_state_size_zero` on every device and launch nothing, as
the JAX package leaves k = 0 to XLA.

:func:`spd_chol` is the batched lower Cholesky factor ``L (B, k, k)`` of SPD
matrices ``M (B, k, k)`` behind the posterior sampler: the kernel behind
``csrc/spd_chol.cu`` (the port of ``ppca_rs_tpu/ops/kernels.py:spd_chol``)
on CUDA tensors -- up to the tile limit the E-step tile's sixth variant
(``kChol`` in ``csrc/spd_estep_tile.cuh``: the same two bodies, the
products on the tensor cores above k=16), the panel design above it -- and
:func:`spd_chol_reference` on CPU tensors.

:func:`mask_gram` is the masked Gram ``G = mask @ CC`` of a block in
float32, exact to float32 sums on the bf16 tensor cores: the bool mask
times the three bf16 slices of the Gram columns (:func:`gram_slices`, an
exact split of each float32 value), the tensor cores' short runs of
products promoted into float32 sums (``csrc/mask_gram.cu``, which
replaces no TPU kernel: the JAX package leaves ``mask @ CC`` to XLA's
dot), on CUDA tensors, and :func:`mask_gram_reference`, the same three
products in float32, on CPU tensors.

:func:`mask_s` adds the M-step statistic ``mask^T (scale * SM)`` of a block
into the running float32 S, exact to float32 sums on the bf16 tensor cores
by the same arithmetic: the bool mask against the three bf16 slices of the
scaled second moments, cut on chip (``csrc/mask_s.cu``, which replaces no
TPU kernel either), on float32 CUDA tensors, and
:func:`mask_s_reference`, the plain product, on CPU and float64 tensors.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch

LN_2PI = 1.8378770664093453

WANTS = ("fullt", "states", "llk", "infer", "full")
_WANT_CODE = {"fullt": 0, "states": 1, "llk": 2, "infer": 3, "full": 4}
#: G's layout as the library takes it (``csrc/spd_estep.cu``).
LAYOUT_SQUARE, LAYOUT_SLABS = 0, 1

#: Every kernel: the spd_estep variants and the Cholesky factor.
KERNELS = WANTS + ("chol",)

#: Kernel launches per kernel, counted where the kernel is launched.
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
#: Of those, the spd_estep launches that took slab G, per variant.
SLAB_LAUNCHES: Dict[str, int] = {name: 0 for name in WANTS}

#: The masked Gram of each block by the path it took: ``kernel``
#: (:func:`mask_gram` on the card) or ``library`` (``torch.matmul``: CPU
#: and float64 tensors, a mask that is not bool).
GRAM_LAUNCHES: Dict[str, int] = {"kernel": 0, "library": 0}
#: Launches of the split kernel behind :func:`gram_slices` on the card.
SPLIT_LAUNCHES: Dict[str, int] = {"kernel": 0}
#: bf16 slices of the exact split of a float32 Gram column (:func:`gram_slices`).
GRAM_SLICES = 3
#: The M-step statistic S of each block by the path it took: ``kernel``
#: (:func:`mask_s` on the card) or ``library`` (:func:`mask_s_reference`:
#: CPU and float64 tensors).
S_LAUNCHES: Dict[str, int] = {"kernel": 0, "library": 0}

#: The largest k the tile design serves a spd_estep variant, by element
#: size (``estep_tile_max_k`` in ``csrc/spd_common.cuh``); :func:`launch`
#: checks them against the library once.
TILE_MAX_K = {4: 128, 8: 64}
#: Rows of a slab block.
SLAB_ROWS = 8


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
    for name in WANTS:
        SLAB_LAUNCHES[name] = 0
    for name in GRAM_LAUNCHES:
        GRAM_LAUNCHES[name] = 0
    SPLIT_LAUNCHES["kernel"] = 0
    for name in S_LAUNCHES:
        S_LAUNCHES[name] = 0


def uses_slabs(k: int, dtype: torch.dtype) -> bool:
    """Whether spd_estep takes G as slabs at state size k in ``dtype``: k a
    multiple of 8 above 16 (the blocked body of the tile) and within the
    tile's limit (the panel design and the one-block body take square G).
    The JAX package's gate (``ppca_rs_tpu/ops/masked_linalg.py:
    _kernel_prep``) with the port's tile limits; it loads no library."""
    return k % SLAB_ROWS == 0 and 16 < k <= TILE_MAX_K.get(dtype.itemsize, 0)


def slab_width(k: int) -> int:
    """Elements of one sample's slabs: 32 m (m + 1) for m = k / 8."""
    if k % SLAB_ROWS:
        raise ValueError(f"slabs need k a multiple of {SLAB_ROWS}, got k={k}")
    m = k // SLAB_ROWS
    return 32 * m * (m + 1)


@functools.lru_cache(maxsize=None)
def _slab_coords_cpu(k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    rows = [r for r in range(k) for _ in range(8 * (r // 8 + 1))]
    cols = [c for r in range(k) for c in range(8 * (r // 8 + 1))]
    return torch.tensor(rows), torch.tensor(cols)


@functools.lru_cache(maxsize=None)
def _slab_coords_on(k: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    rows, cols = _slab_coords_cpu(k)
    return rows.to(device), cols.to(device)


def slab_coords(k: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row, column) of each slab element, in order: two (slab_width(k),)
    index tensors on ``device``, made once per (k, device) and shared by
    every caller, who only reads them.  The copy to the device is made by
    the first call alone: a copy from pageable memory waits for the whole
    stream, so a statistics pass that made its own would hold the host
    back until the device's work before it is done."""
    slab_width(k)
    if device is None or torch.device(device).type == "cpu":
        return _slab_coords_cpu(k)
    return _slab_coords_on(k, torch.device(device))


def slab_pack(G: torch.Tensor) -> torch.Tensor:
    """(..., k, k) -> (..., slab_width(k)): the lower triangle in the slab
    layout, zeros above the diagonal."""
    k = G.shape[-1]
    rows, cols = slab_coords(k, G.device)
    return torch.where(cols <= rows, G[..., rows, cols], torch.zeros((), dtype=G.dtype,
                                                                      device=G.device))


def slab_unpack_lower(slabs: torch.Tensor, k: int) -> torch.Tensor:
    """(..., slab_width(k)) -> (..., k, k): the lower triangle, zeros above
    the diagonal (what the slabs hold above it inside a diagonal block is
    not read)."""
    if slabs.shape[-1] != slab_width(k):
        raise ValueError(f"slabs of k={k} must have {slab_width(k)} elements, "
                         f"got {slabs.shape[-1]}")
    rows, cols = slab_coords(k, slabs.device)
    out = slabs.new_zeros((*slabs.shape[:-1], k, k))
    out[..., rows, cols] = slabs
    return torch.tril(out)


def gram_width(k: int, dtype: torch.dtype) -> int:
    """The columns of one sample's Gram as the routes build it for the
    kernel: slab_width(k) where :func:`uses_slabs` holds, else k^2."""
    return slab_width(k) if uses_slabs(k, dtype) else k * k


def estep_gram(G: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """``n`` Grams as :func:`spd_estep` takes them: slabs ``(n,
    slab_width(k))`` where :func:`uses_slabs` holds and ``G`` holds n
    slabs (the columns ``masked_linalg.gram_columns`` builds), else square
    ``(n, k, k)`` from any shape of n k^2 elements (flat ``(..., k*k)`` or
    ``(..., k, k)``)."""
    if uses_slabs(k, G.dtype) and G.numel() == n * slab_width(k):
        return G.reshape(n, slab_width(k))
    if G.numel() != n * k * k:
        raise ValueError(f"{n} Grams at k={k} in {G.dtype} must be {n * gram_width(k, G.dtype)} "
                         f"or {n * k * k} elements, got {tuple(G.shape)}")
    return G.reshape(n, k, k)


def unpack_stats(S: torch.Tensor, k: int) -> torch.Tensor:
    """M-step statistics summed over the kernel's second moments, ``(...,
    gram_width(k, S.dtype))``, as ``(..., k*k)``: sums of slab SM unpacked
    to the lower triangle once (the JAX package's ``_s_unpack``), sums of
    square SM as they are."""
    if not uses_slabs(k, S.dtype):
        return S
    return slab_unpack_lower(S, k).reshape(*S.shape[:-1], k * k)


def _library():
    """The kernel library, its tile limits checked once against
    :data:`TILE_MAX_K` (which :func:`uses_slabs` reads without it)."""
    from . import _build

    lib = _build.load()
    if id(lib) not in _CHECKED_LIBRARIES:
        for itemsize, limit in TILE_MAX_K.items():
            got = lib.spd_estep_tile_max_k(itemsize)
            if got != limit:
                raise RuntimeError(f"the kernel library's tile serves k <= {got} for "
                                   f"{itemsize}-byte elements, TILE_MAX_K says {limit}")
        _CHECKED_LIBRARIES.add(id(lib))
    return lib


_CHECKED_LIBRARIES: set = set()


def design(k: int, kernel: str = "estep", dtype: torch.dtype = torch.float32) -> str:
    """Which design serves state size k on the card for ``kernel``
    ("estep": every spd_estep variant; "chol": spd_chol) and ``dtype``:
    "tile" (a sample in one warp's registers up to k=16, one CTA a sample
    with its matrix in shared memory above; spd_chol is the tile's sixth
    variant) or "panel" (one CTA a sample,
    the working matrix in device memory, each panel step's columns staged
    once in shared memory and its products on the tensor cores, any k), by
    the tile limit that the kernel library reports for that kernel and
    element size."""
    if kernel not in ("estep", "chol"):
        raise ValueError(f"kernel must be 'estep' or 'chol', got {kernel!r}")
    lib = _library()
    limit = lib.spd_estep_tile_max_k if kernel == "estep" else lib.spd_chol_tile_max_k
    return "tile" if k <= limit(dtype.itemsize) else "panel"


def tile_occupancy(k: int, dtype: torch.dtype = torch.float32,
                   kernel: str = "estep") -> Tuple[int, int, int]:
    """The tile's residency at state size k on the current card for
    ``kernel`` ("estep": its fullt instantiation; "chol": spd_chol's):
    ``(CTAs per multiprocessor, warps per CTA, samples per CTA)``, as the
    CUDA occupancy calculator gives it for the kernel serving k (the
    blocked body's persistent grid runs that many CTAs a multiprocessor).
    Needs the card; k within the tile limit (:func:`design`)."""
    import ctypes

    if design(k, kernel, dtype) != "tile" or k < 1:
        raise ValueError(f"k={k} is not served by the tile for {kernel} in {dtype}")
    index = torch.cuda.current_device()
    out = [ctypes.c_int(0) for _ in range(3)]
    lib = _library()
    err = lib.spd_estep_tile_occupancy(dtype.itemsize, index, k, int(kernel == "chol"),
                                       *(ctypes.byref(v) for v in out))
    if err != 0:
        raise RuntimeError(f"spd_estep_tile_occupancy failed (k={k}): "
                           f"{lib.spd_estep_error_string(err).decode()}")
    return tuple(v.value for v in out)


#: CTAs a multiprocessor in the panel design's persistent grid, for every
#: variant and dtype: the minimum its launch bounds fix (``kCtasPerSm`` in
#: ``csrc/spd_panel.cuh``), which the staged panel's shared memory (at most
#: ~93 KB a CTA) leaves room for.
PANEL_CTAS_PER_SM = 2


def scratch_shape(want: str, B: int, k: int):
    """The panel design's working storage for ``want``: (B, k+1, k) for
    ``llk`` and ``states`` (the k x k working matrix and the right-hand
    side), None for the variants that work in their own k x k output."""
    _check_want(want)
    return (B, k + 1, k) if want in ("llk", "states") else None


def empty_scratch(want: str, B: int, k: int, like: torch.Tensor):
    """Uninitialised scratch for a launch of ``want`` at (B, k) on the card,
    or None where the design serving k takes none (the register tiles)."""
    shape = scratch_shape(want, B, k)
    if shape is None or design(k, "estep", like.dtype) == "tile":
        return None
    return torch.empty(shape, dtype=like.dtype, device=like.device)


def sigma_arg(sigma, B: int, dtype: torch.dtype, device: torch.device) -> Tuple[torch.Tensor, int]:
    """sigma as the kernel takes it: a contiguous (1,) or (B,) tensor of
    the kernel's dtype on its device, and its element stride (0 or 1).

    A tensor that already is so is used as it is (a view, no copy); one of
    another dtype or device is converted, without a stream synchronisation
    when it goes to the card; a Python number is written on the device by a
    fill kernel, so no host-to-device copy waits on the stream."""
    to_card = device.type == "cuda"
    if isinstance(sigma, torch.Tensor):
        t = sigma.reshape(-1)
        if t.dtype != dtype or t.device != device:
            t = t.to(device=device, dtype=dtype, non_blocking=to_card)
    else:
        host = torch.as_tensor(sigma, dtype=dtype).reshape(-1)
        if host.numel() == 1:
            t = torch.full((1,), float(host[0]), dtype=dtype, device=device)
        else:
            t = host.to(device=device, non_blocking=to_card)
    if t.numel() not in (1, B):
        raise ValueError(f"sigma must be a scalar or have B={B} elements, got {t.numel()}")
    return t.contiguous(), (0 if t.numel() == 1 else 1)


def spd_estep_reference(sigma, G, b, rnorm, d_obs, want: str = "fullt") -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel, on any device.

    Built on ``torch.linalg.cholesky_ex``: a sample whose M does not factor
    gets a NaN factor (as ``jnp.linalg.cholesky`` gives), so its outputs are
    non-finite and no exception is raised.  Slab G (2-D) is unpacked and
    mirrored from its lower triangle, and ``"fullt"``'s SM packed back, zeros
    above the diagonal, as the kernel writes it."""
    _check_want(want)
    if G.ndim == 2:
        k = b.shape[-1]
        low = slab_unpack_lower(G, k)
        out = spd_estep_reference(sigma, low + torch.tril(low, -1).mT, b, rnorm, d_obs, want)
        return (out[0], slab_pack(out[1]), *out[2:]) if want == "fullt" else out
    B, k, _ = G.shape
    dtype, device = G.dtype, G.device
    sigma, _ = sigma_arg(sigma, B, dtype, device)
    s2 = sigma * sigma                      # (1,) or (B,)
    eye = torch.eye(k, dtype=dtype, device=device)
    L, info = torch.linalg.cholesky_ex(G + s2[:, None, None] * eye)
    L = torch.where((info == 0)[:, None, None], L, torch.full_like(L, math.nan))
    y = torch.linalg.solve_triangular(L, b.unsqueeze(-1), upper=False).squeeze(-1)
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    quad = (rnorm - (y * y).sum(-1)) / s2
    llk = -0.5 * (quad + logdet + torch.log(s2) * (d_obs - k) + LN_2PI * d_obs)
    if want == "llk":
        return (llk,)
    s = torch.linalg.solve_triangular(L.mT, y.unsqueeze(-1), upper=True).squeeze(-1)
    if want == "states":
        return s, llk
    W = torch.linalg.solve_triangular(L, eye.expand(B, k, k), upper=False)
    minv = W.mT @ W
    sq = s2 * (k - s2 * torch.diagonal(minv, dim1=-2, dim2=-1).sum(-1))
    cov = s2[:, None, None] * minv
    if want == "infer":
        return s, cov, llk, sq
    return s, s[:, :, None] * s[:, None, :] + cov, llk, sq


def spd_chol_reference(M: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the Cholesky kernel, on any device: the
    lower factor of each ``M (B, k, k)``, NaN for a sample that does not
    factor (its ``info != 0``), as :func:`spd_estep_reference` does."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info == 0)[:, None, None], L, torch.full_like(L, math.nan))


def spd_estep_state_size_zero(sigma, G, b, rnorm, d_obs, want: str = "fullt") -> Tuple[torch.Tensor, ...]:
    """The E-step's outputs at state size 0, in closed form: M is empty, so
    s is (B, 0), SM and Sigma are (B, 0, 0), sq = 0 and
    ``llk = -(rnorm / sigma^2 + d_obs log sigma^2 + d_obs log 2 pi) / 2``
    (0 for an all-masked sample)."""
    _check_want(want)
    B = G.shape[0]
    sigma, _ = sigma_arg(sigma, B, G.dtype, G.device)
    s2 = sigma * sigma
    llk = -0.5 * (rnorm / s2 + (torch.log(s2) + LN_2PI) * d_obs)
    if want == "llk":
        return (llk,)
    s = G.new_empty((B, 0))
    if want == "states":
        return s, llk
    return s, G.new_empty((B, 0, 0)), llk, torch.zeros_like(llk)


def spd_chol_state_size_zero(M: torch.Tensor) -> torch.Tensor:
    """The Cholesky factor at state size 0: an empty (B, 0, 0)."""
    return M.new_empty((M.shape[0], 0, 0))


def spd_chol(M: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky factor ``L (B, k, k)`` of ``M (B, k, k)``,
    lower triangle of ``M`` read, zeros above the diagonal of ``L``.

    k = 0 takes :func:`spd_chol_state_size_zero`; otherwise CPU tensors
    take :func:`spd_chol_reference` and CUDA tensors launch the kernel,
    which raises on anything it does not take."""
    _check_chol_shape(M)
    if M.shape[-1] == 0:
        return spd_chol_state_size_zero(M)
    if M.device.type == "cpu":
        return spd_chol_reference(M)
    L = torch.empty_like(M, memory_format=torch.contiguous_format)
    launch_chol(M, L)
    return L


def spd_estep(sigma, G, b, rnorm, d_obs, want: str = "fullt") -> Tuple[torch.Tensor, ...]:
    """The batched SPD E-step (see the module docstring for the outputs).

    k = 0 takes :func:`spd_estep_state_size_zero`; otherwise CPU tensors
    take :func:`spd_estep_reference` and CUDA tensors launch the kernel,
    which raises on anything it does not take.  Of ``"fullt"``'s square SM
    only the lower triangle (diagonal included) is defined: on the card the
    elements above the diagonal are never written.  Slab G (2-D, see the
    module docstring) is taken where :func:`uses_slabs` holds, on every
    device, and raises elsewhere."""
    _check_want(want)
    _check_shapes(G, b, rnorm, d_obs)
    B, k = b.shape
    slab = G.ndim == 2
    if slab and not uses_slabs(k, G.dtype):
        raise ValueError(f"slab G needs k a multiple of {SLAB_ROWS} in 16 < k <= "
                         f"{TILE_MAX_K.get(G.dtype.itemsize, 0)} for {G.dtype}, got k={k}")
    if k == 0:
        return spd_estep_state_size_zero(sigma, G, b, rnorm, d_obs, want)
    if G.device.type == "cpu":
        return spd_estep_reference(sigma, G, b, rnorm, d_obs, want)
    outs = empty_outputs(want, B, k, G, slab=slab)
    launch(want, sigma, G, b, rnorm, d_obs, outs)
    return outs


def output_shapes(want: str, B: int, k: int, slab: bool = False):
    """The outputs' shapes; with ``slab``, fullt's SM is (B, slab_width(k))."""
    if want == "llk":
        return [(B,)]
    if want == "states":
        return [(B, k), (B,)]
    if want == "fullt" and slab:
        return [(B, k), (B, slab_width(k)), (B,), (B,)]
    return [(B, k), (B, k, k), (B,), (B,)]   # fullt, full, infer


def empty_outputs(want: str, B: int, k: int, like: torch.Tensor,
                  slab: bool = False) -> Tuple[torch.Tensor, ...]:
    """Uninitialised output tensors for ``want`` (the kernel writes every
    element but those above the diagonal of ``"fullt"``'s square SM)."""
    return tuple(torch.empty(sh, dtype=like.dtype, device=like.device)
                 for sh in output_shapes(want, B, k, slab))


def launch(want: str, sigma, G, b, rnorm, d_obs, outs, scratch=None) -> None:
    """Launch the CUDA kernel into caller-provided outputs ``outs`` (as
    returned by :func:`empty_outputs`) on the current stream.  The panel
    design's scratch for ``llk`` and ``states`` (:func:`empty_scratch`) is
    allocated here unless the caller passes it.  G is square (B, k, k) or
    slabs (B, slab_width(k)); the library refuses slabs where the tile does
    not serve k in the blocked body.  Raises on any input the kernel does
    not take and on a failed launch."""
    _check_want(want)
    _check_shapes(G, b, rnorm, d_obs)
    B, k = b.shape
    slab = G.ndim == 2
    dtype, device = G.dtype, G.device
    if device.type != "cuda":
        raise ValueError(f"the spd_estep kernel needs CUDA tensors, got {device}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the spd_estep kernel takes float32 or float64, got {dtype}")
    if k < 1:
        raise ValueError(f"the spd_estep kernel takes k >= 1, got k={k}")
    sigma, sigma_stride = sigma_arg(sigma, B, dtype, device)
    shapes = output_shapes(want, B, k, slab)
    if len(outs) != len(shapes) or any(
        tuple(o.shape) != sh or o.dtype != dtype or o.device != device
        for o, sh in zip(outs, shapes)
    ):
        raise ValueError(f"outputs for want={want!r} must have shapes {shapes}")
    if scratch is None:
        scratch = empty_scratch(want, B, k, G)
    elif tuple(scratch.shape) != scratch_shape(want, B, k):
        raise ValueError(f"scratch for want={want!r} must have shape {scratch_shape(want, B, k)}")
    tensors = (sigma, G, b, rnorm, d_obs, *outs) + (() if scratch is None else (scratch,))
    for t in tensors:
        if t.dtype != dtype or t.device != device:
            raise ValueError("spd_estep tensors must share one dtype and device")
        if not t.is_contiguous():
            raise ValueError("the spd_estep kernel takes contiguous tensors only")
    s = m = sq = None
    if want == "llk":
        (llk,) = outs
    elif want == "states":
        s, llk = outs
    else:
        s, m, llk, sq = outs

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _library()
    fn = lib.spd_estep_f32 if dtype == torch.float32 else lib.spd_estep_f64
    stream = torch.cuda.current_stream(device).cuda_stream
    index = device.index if device.index is not None else torch.cuda.current_device()
    err = fn(_WANT_CODE[want], index, ptr(sigma), sigma_stride, ptr(G), ptr(b), ptr(rnorm),
             ptr(d_obs), ptr(s), ptr(m), ptr(llk), ptr(sq), ptr(scratch), B, k,
             LAYOUT_SLABS if slab else LAYOUT_SQUARE, stream)
    if err != 0:
        raise RuntimeError(
            f"spd_estep kernel launch failed (want={want!r}, B={B}, k={k}"
            f"{', slab G' if slab else ''}): {lib.spd_estep_error_string(err).decode()}"
        )
    LAUNCHES[want] += 1
    if slab:
        SLAB_LAUNCHES[want] += 1


def launch_chol(M: torch.Tensor, L: torch.Tensor) -> None:
    """Launch the Cholesky kernel into a caller-provided ``L`` (same shape,
    dtype and device as ``M``) on the current stream.  Raises on any input
    the kernel does not take and on a failed launch."""
    _check_chol_shape(M)
    B, k, _ = M.shape
    dtype, device = M.dtype, M.device
    if device.type != "cuda":
        raise ValueError(f"the spd_chol kernel needs CUDA tensors, got {device}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the spd_chol kernel takes float32 or float64, got {dtype}")
    if k < 1:
        raise ValueError(f"the spd_chol kernel takes k >= 1, got k={k}")
    if L.shape != M.shape or L.dtype != dtype or L.device != device:
        raise ValueError(f"L must be a {dtype} tensor of shape {tuple(M.shape)} on {device}")
    if not (M.is_contiguous() and L.is_contiguous()):
        raise ValueError("the spd_chol kernel takes contiguous tensors only")
    lib = _library()
    fn = lib.spd_chol_f32 if dtype == torch.float32 else lib.spd_chol_f64
    stream = torch.cuda.current_stream(device).cuda_stream
    index = device.index if device.index is not None else torch.cuda.current_device()
    err = fn(index, M.data_ptr(), L.data_ptr(), B, k, stream)
    if err != 0:
        raise RuntimeError(
            f"spd_chol kernel launch failed (B={B}, k={k}): "
            f"{lib.spd_estep_error_string(err).decode()}"
        )
    LAUNCHES["chol"] += 1


def gram_slices(CC: torch.Tensor) -> torch.Tensor:
    """The exact bf16 split of float32 Gram columns ``CC (..., D, W)``:
    ``(3, ..., D, W8)`` bf16 with hi = bf16(x), mid = bf16(x - hi), lo =
    x - hi - mid, so that hi + mid + lo == x in float32 for 0 and every
    |x| from ~1e-33 (where lo's last bit reaches bf16's smallest
    subnormal) to bf16's largest finite value.  Each difference is exact
    (x - hi has at most 16 significant bits, x - hi - mid at most 8).  W8 is
    W rounded up to a multiple of 8 (the kernel's 16-byte rows), the
    columns past W zero.  CUDA tensors take one launch of the split kernel
    of ``csrc/mask_gram.cu``, CPU tensors :func:`gram_slices_reference`;
    both round to nearest even, bit for bit alike."""
    if CC.dtype != torch.float32:
        raise ValueError(f"the bf16 split takes float32 columns, got {CC.dtype}")
    if CC.device.type == "cpu":
        return gram_slices_reference(CC)
    if CC.device.type != "cuda":
        raise ValueError(f"the split kernel needs CUDA tensors, got {CC.device}")
    CC = CC.contiguous()
    W = CC.shape[-1]
    rows = CC.numel() // W if W else 0
    out = torch.empty((GRAM_SLICES, *CC.shape[:-1], _width8(W)), dtype=torch.bfloat16,
                      device=CC.device)
    lib = _library()
    stream = torch.cuda.current_stream(CC.device).cuda_stream
    index = CC.device.index if CC.device.index is not None else torch.cuda.current_device()
    err = lib.gram_split_bf16x3(index, CC.data_ptr(), out.data_ptr(), rows, W, out.shape[-1],
                                stream)
    if err != 0:
        raise RuntimeError(f"gram split kernel launch failed ({tuple(CC.shape)}): "
                           f"{lib.spd_estep_error_string(err).decode()}")
    SPLIT_LAUNCHES["kernel"] += 1
    return out


def _width8(W: int) -> int:
    return -(-W // 8) * 8


def gram_slices_reference(CC: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`gram_slices`, on any device."""
    W = CC.shape[-1]
    w8 = _width8(W)
    make = torch.empty if w8 == W else torch.zeros
    out = make((GRAM_SLICES, *CC.shape[:-1], w8), dtype=torch.bfloat16, device=CC.device)
    rest = CC
    for i in range(GRAM_SLICES):
        part = out[i, ..., :W]
        part.copy_(rest)                    # rounds to the nearest bf16
        if i + 1 < GRAM_SLICES:
            rest = rest - part.float()
    return out


def mask_gram_reference(mask: torch.Tensor, slices: torch.Tensor, width: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`mask_gram`, on any device: the mask
    (any dtype of 0/1) times each of the slices' first ``width`` columns in
    float32, the three products summed: ``(B, width)``, or ``(M, B, width)``
    for slices of M stacked column sets."""
    m = mask.to(torch.float32)
    G = torch.matmul(m, slices[0, ..., :width].float())
    for i in range(1, GRAM_SLICES):
        G += torch.matmul(m, slices[i, ..., :width].float())
    return G


def mask_gram(mask: torch.Tensor, slices: torch.Tensor, out: torch.Tensor) -> None:
    """``out = mask @ (hi + mid + lo)``, the masked Gram of one block, into
    a caller-provided float32 ``out``.

    ``mask`` (B, D) bool, unit column stride; ``slices`` from
    :func:`gram_slices`, ``(3, D, W8)`` or ``(3, M, D, W8)`` for M stacked
    column sets; ``out`` contiguous ``(B, W)`` or ``(M, B, W)``, W <= W8.
    CPU tensors take :func:`mask_gram_reference`; CUDA tensors launch the
    kernel of ``csrc/mask_gram.cu`` on the current stream, which raises on
    anything it does not take and on a failed launch."""
    if mask.ndim != 2 or mask.dtype != torch.bool:
        raise ValueError(f"mask must be a (B, D) bool tensor, got {tuple(mask.shape)} {mask.dtype}")
    B, D = mask.shape
    stacked = slices.ndim == 4
    M = slices.shape[1] if stacked else 1
    if (slices.ndim not in (3, 4) or slices.shape[0] != GRAM_SLICES or slices.shape[-2] != D
            or slices.dtype != torch.bfloat16):
        raise ValueError(f"slices must be ({GRAM_SLICES}, [M,] {D}, W8) bf16, got "
                         f"{tuple(slices.shape)} {slices.dtype}")
    W = out.shape[-1]
    want = (M, B, W) if stacked else (B, W)
    if tuple(out.shape) != want or out.dtype != torch.float32 or W > slices.shape[-1]:
        raise ValueError(f"out must be float32 {want} with W <= {slices.shape[-1]}, got "
                         f"{tuple(out.shape)} {out.dtype}")
    if not (mask.device == slices.device == out.device):
        raise ValueError("mask_gram tensors must share one device")
    if mask.device.type == "cpu":
        out.copy_(mask_gram_reference(mask, slices, W))
        return
    if mask.device.type != "cuda":
        raise ValueError(f"the mask_gram kernel needs CUDA tensors, got {mask.device}")
    if mask.stride(1) != 1 and D > 1:
        raise ValueError("the mask_gram kernel takes a mask with unit column stride")
    if not (slices.is_contiguous() and out.is_contiguous()) or slices.shape[-1] % 8:
        raise ValueError("the mask_gram kernel takes contiguous slices of a width a multiple "
                         "of 8 and a contiguous out")
    lib = _library()
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    index = mask.device.index if mask.device.index is not None else torch.cuda.current_device()
    err = lib.mask_gram_bf16x3(index, mask.data_ptr(), mask.stride(0), slices.data_ptr(),
                               slices.shape[-1], out.data_ptr(), B, D, W, M, stream)
    if err != 0:
        raise RuntimeError(f"mask_gram kernel launch failed (B={B}, D={D}, W={W}, M={M}): "
                           f"{lib.spd_estep_error_string(err).decode()}")
    GRAM_LAUNCHES["kernel"] += 1


def mask_s_reference(mask: torch.Tensor, SM: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`mask_s`, on any device: ``mask^T
    (scale * SM)`` in SM's dtype, ``(D, W)``, or ``(M, D, W)`` for SM
    ``(M, B, W)`` and scale ``(M, B)``."""
    return torch.matmul(mask.T.to(SM.dtype), scale[..., None] * SM)


def mask_s(mask: torch.Tensor, SM: torch.Tensor, scale: torch.Tensor, S: torch.Tensor) -> None:
    """``S += mask^T (scale * SM)``, the M-step statistic of one block,
    added into the caller's running sum ``S`` in place.

    ``mask`` (B, D) bool, unit column stride; ``SM`` (B, W) and ``scale``
    (B,), or ``(M, B, W)`` and ``(M, B)`` for M components; ``S`` (D, W) or
    (M, D, W); SM, scale and S contiguous, of one dtype.  Float32 CUDA
    tensors launch the kernel of ``csrc/mask_s.cu`` on the current stream,
    which raises on anything it does not take and on a failed launch; CPU
    tensors, and float64 ones anywhere (seven bf16 slices would be needed),
    take :func:`mask_s_reference`.  ``S_LAUNCHES`` counts the path."""
    if mask.ndim != 2 or mask.dtype != torch.bool:
        raise ValueError(f"mask must be a (B, D) bool tensor, got {tuple(mask.shape)} {mask.dtype}")
    B, D = mask.shape
    stacked = SM.ndim == 3
    M = SM.shape[0] if stacked else 1
    W = SM.shape[-1]
    lead = (M,) if stacked else ()
    if (SM.ndim not in (2, 3) or SM.shape[-2] != B or tuple(scale.shape) != (*lead, B)
            or tuple(S.shape) != (*lead, D, W)):
        raise ValueError(f"SM, scale and S must be ([M,] {B}, W), ([M,] {B}) and ([M,] {D}, W) "
                         f"beside a ({B}, {D}) mask, got {tuple(SM.shape)}, "
                         f"{tuple(scale.shape)}, {tuple(S.shape)}")
    if not (SM.dtype == scale.dtype == S.dtype) or SM.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"SM, scale and S must share float32 or float64, got {SM.dtype}, "
                         f"{scale.dtype}, {S.dtype}")
    if not (mask.device == SM.device == scale.device == S.device):
        raise ValueError("mask_s tensors must share one device")
    if not (SM.is_contiguous() and scale.is_contiguous() and S.is_contiguous()):
        raise ValueError("mask_s takes a contiguous SM, scale and S")
    if mask.device.type == "cpu" or SM.dtype == torch.float64:
        S += mask_s_reference(mask, SM, scale)
        S_LAUNCHES["library"] += 1
        return
    if mask.device.type != "cuda":
        raise ValueError(f"the mask_s kernel needs CUDA tensors, got {mask.device}")
    if mask.stride(1) != 1 and D > 1:
        raise ValueError("the mask_s kernel takes a mask with unit column stride")
    lib = _library()
    stream = torch.cuda.current_stream(mask.device).cuda_stream
    index = mask.device.index if mask.device.index is not None else torch.cuda.current_device()
    err = lib.mask_s_bf16x3(index, mask.data_ptr(), mask.stride(0), SM.data_ptr(),
                            scale.data_ptr(), S.data_ptr(), B, D, W, M, stream)
    if err != 0:
        raise RuntimeError(f"mask_s kernel launch failed (B={B}, D={D}, W={W}, M={M}): "
                           f"{lib.spd_estep_error_string(err).decode()}")
    S_LAUNCHES["kernel"] += 1


def mask_s_tile_width(D: int, W: int, M: int = 1) -> int:
    """The columns of S a tile of the kernel takes for (D, W, M) on the
    current card: of 128, 144 and 160, the one that fills its
    multiprocessors in the fewest whole waves' time.  Needs the card."""
    return _library().mask_s_tile_width(torch.cuda.current_device(), D, W, M)


def _check_chol_shape(M: torch.Tensor) -> None:
    if M.ndim != 3 or M.shape[1] != M.shape[2]:
        raise ValueError(f"M must be (B, k, k), got {tuple(M.shape)}")


def _check_want(want: str) -> None:
    if want not in WANTS:
        raise ValueError(f"want must be one of {WANTS}, got {want!r}")


def _check_shapes(G, b, rnorm, d_obs) -> None:
    if G.ndim == 2:
        # slabs: k is read from b
        if b.ndim != 2 or b.shape[0] != G.shape[0]:
            raise ValueError(f"b must be ({G.shape[0]}, k) beside slab G, got {tuple(b.shape)}")
        B, k = b.shape
        if k % SLAB_ROWS or G.shape[1] != slab_width(k):
            width = f"({B}, {slab_width(k)})" if k % SLAB_ROWS == 0 else "undefined"
            raise ValueError(f"G must be (B, k, k) or its slabs (B, slab_width(k)), {width} "
                             f"at k={k}, got {tuple(G.shape)}")
    elif G.ndim != 3 or G.shape[1] != G.shape[2]:
        raise ValueError(f"G must be (B, k, k), got {tuple(G.shape)}")
    else:
        B, k, _ = G.shape
    if tuple(b.shape) != (B, k):
        raise ValueError(f"b must be ({B}, {k}), got {tuple(b.shape)}")
    if tuple(rnorm.shape) != (B,) or tuple(d_obs.shape) != (B,):
        raise ValueError(f"rnorm and d_obs must be ({B},)")
    if not (b.device == rnorm.device == d_obs.device == G.device):
        raise ValueError("spd_estep tensors must share one device")
