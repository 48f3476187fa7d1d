"""The M-step statistic S on the bf16 tensor cores (``ops.kernels.mask_s``),
on the CPU: the plain version the CPU and float64 take
(``kernels.mask_s_reference``) against float64, the wrapper's checks, the
routes' hand-over of each block's S to ``mask_s`` (one running sum, the
bool mask), and the masked and mixture EM statistics against the JAX
package in float64 at the 1e-9 parity budget (docs/DESIGN.md section 6).

The kernel itself (``csrc/mask_s.cu``) runs on the card only; its check
against float64 is ``chip_smoke.py``'s phase 2c.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppca_rs_tpu.config import config as jconfig
from ppca_rs_tpu.ops import masked_linalg as jml
from ppca_rs_tpu.ops import mix_fused as jmf
from ppca_rs_tpu_torch.config import config as tconfig
from ppca_rs_tpu_torch.ops import kernels as tk
from ppca_rs_tpu_torch.ops import masked_linalg as tml
from ppca_rs_tpu_torch.ops import mix_fused as tmf

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
U = 2.0 ** -24          # float32's unit roundoff
PARITY = 1e-9


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port builds on the card by default; these tests ask for the CPU."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))
    tk.reset_launch_counts()


def _operands(B, D, W, M=0, seed=3, dtype=F32):
    """(bool mask, SM, scale) of one block: SM symmetric second moments'
    columns (a positive diagonal), the mask 50% observed with an all-masked
    row, the scale non-unit weights with a zero-weight row, or for M > 0
    responsibilities (each row's M summing to its weight)."""
    gen = torch.Generator().manual_seed(seed)
    mask = torch.rand((B, D), generator=gen) < 0.5
    mask[B // 2] = False
    shape = (M, B, W) if M else (B, W)
    SM = torch.randn(shape, generator=gen, dtype=F64)
    SM[..., ::max(1, W // 7)] = SM[..., ::max(1, W // 7)].abs() + 1.0
    w = torch.rand(B, generator=gen, dtype=F64) + 0.5
    w[min(3, B - 1)] = 0.0
    if M:
        scale = torch.softmax(torch.randn((M, B), generator=gen, dtype=F64) * 2, 0) * w
    else:
        scale = w
    return mask, SM.to(dtype).contiguous(), scale.to(dtype).contiguous()


CASES = [
    # B, D, W, M: a main-path-like block, ragged B, D and W, D not a
    # multiple of 16, odd W (square k=13), stacked components
    (256, 64, 144, 0), (131, 80, 384, 0), (131, 37, 169, 0), (17, 40, 13, 0),
    (1, 5, 7, 0), (200, 48, 640, 3), (33, 21, 169, 2),
]


@pytest.mark.parametrize("B,D,W,M", CASES)
def test_reference_agrees_with_f64(B, D, W, M):
    """The float32 plain version is the product to float32's error of a
    sum over B (and the float64 one to float64's), relative to |mask|^T
    |scale * SM|; the all-masked and zero-weight rows add nothing."""
    mask, SM, scale = _operands(B, D, W, M)
    got = tk.mask_s_reference(mask, SM, scale)
    assert got.shape == ((M, D, W) if M else (D, W)) and got.dtype == F32
    x = scale.double()[..., None] * SM.double()
    exact = torch.matmul(mask.T.double(), x)
    bound = torch.matmul(mask.T.double(), x.abs())
    assert bool(((got.double() - exact).abs() <= 2 * (B + 2) * U * bound + 1e-37).all())
    got64 = tk.mask_s_reference(mask, SM.double(), scale.double())
    assert bool(((got64 - exact).abs() <= 1e-13 * bound + 1e-300).all())
    # the rows that add nothing, taken out
    keep = mask.any(1) & (scale.reshape(-1, B) != 0).all(0)
    alone = tk.mask_s_reference(mask[keep], SM[..., keep, :].contiguous(),
                                scale[..., keep].contiguous())
    np.testing.assert_allclose(alone.numpy(), got.numpy(), rtol=0, atol=4 * B * U * float(bound.max()))


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("B,D,W,M", [(131, 37, 169, 0), (64, 40, 144, 3)])
def test_mask_s_adds_into_S(dtype, B, D, W, M):
    """``mask_s`` adds the block's product into the caller's S in place
    (the CPU's plain version, counted as the library path)."""
    mask, SM, scale = _operands(B, D, W, M, dtype=dtype)
    gen = torch.Generator().manual_seed(8)
    S0 = torch.randn((M, D, W) if M else (D, W), generator=gen, dtype=dtype)
    S = S0.clone()
    ptr = S.data_ptr()
    tk.mask_s(mask, SM, scale, S)
    assert S.data_ptr() == ptr
    assert torch.equal(S, S0 + tk.mask_s_reference(mask, SM, scale))
    assert tk.S_LAUNCHES == {"kernel": 0, "library": 1}
    tk.reset_launch_counts()
    assert tk.S_LAUNCHES == {"kernel": 0, "library": 0}


def _bad_inputs():
    mask, SM, scale = _operands(16, 20, 24)
    S = torch.zeros(20, 24)
    yield "bool", (mask.float(), SM, scale, S)
    yield "bool", (mask[None], SM, scale, S)
    yield "float32 or float64", (mask, SM.half(), scale.half(), S.half())
    yield "share float32 or float64", (mask, SM, scale, S.double())
    yield "share float32 or float64", (mask, SM.double(), scale, S)
    yield "must be", (mask, SM, scale[:8], S)
    yield "must be", (mask, SM, scale, torch.zeros(20, 16))
    yield "must be", (mask[:, :10], SM, scale, S)
    yield "must be", (mask, SM[None], scale, S)
    yield "contiguous", (mask, SM.T.contiguous().T, scale, S)
    yield "contiguous", (mask, SM, scale, torch.zeros(24, 20).T)
    yield "one device", (mask, SM.to("meta"), scale, S)
    yield "CUDA", (mask.to("meta"), SM.to("meta"), scale.to("meta"), S.to("meta"))


@pytest.mark.parametrize("match,args", list(_bad_inputs()))
def test_wrapper_refuses_what_the_kernel_does_not_take(match, args):
    with pytest.raises(ValueError, match=match):
        tk.mask_s(*args)
    assert tk.S_LAUNCHES == {"kernel": 0, "library": 0}


def _masked_problem(rng, N=150, D=12, k=3):
    """numpy (C, mean, sigma, data, mask, weights): a ragged last block, an
    all-masked row, a zero-weight row and an empty dimension."""
    C = rng.normal(size=(D, k))
    C[4] = 0.0
    mean = rng.normal(size=D)
    sigma = 0.6
    data = rng.normal(size=(N, k)) @ C.T + mean + sigma * rng.normal(size=(N, D))
    mask = rng.random((N, D)) > 0.35
    mask[:, 4] = False
    mask[9] = False
    data = np.where(mask, data, 0.0)
    weights = rng.random(N) + 0.5
    weights[20] = 0.0
    return C, mean, sigma, data, mask, weights


def _symmetric(S, k):
    """S's lower triangle of each (k, k) square, mirrored (what the M-steps
    read)."""
    S = np.asarray(S, np.float64).reshape(*np.shape(S)[:-1], k, k)
    return np.tril(S) + np.swapaxes(np.tril(S, -1), -1, -2)


def _close(got, want, rtol=PARITY):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("k,block", [(3, 64), (3, 1000), (24, 64), (13, 50)])
def test_em_stats_match_the_jax_package(rng, k, block):
    """Every statistic of the masked pass, S through ``mask_s`` (slabs at
    k=24), against the JAX package's in float64."""
    C, mean, sigma, data, mask, w = _masked_problem(rng, k=k)
    got = tml.em_stats(torch.from_numpy(C), torch.from_numpy(mean),
                       torch.tensor(sigma, dtype=F64), torch.from_numpy(data),
                       torch.from_numpy(mask), torch.from_numpy(w), block_size=block)
    want = jml.em_stats(jnp.asarray(C), jnp.asarray(mean), jnp.asarray(sigma, jnp.float64),
                        jnp.asarray(data), jnp.asarray(mask), jnp.asarray(w), block_size=block)
    assert tk.S_LAUNCHES == {"kernel": 0, "library": -(-len(data) // block)}
    for name in jml.EMStats._fields:
        g, wnt = getattr(got, name), getattr(want, name)
        if name == "S":
            g, wnt = _symmetric(g, k), _symmetric(wnt, k)
        _close(g, wnt)


def _mix_problem(rng, M=3, N=70, D=9, k=3):
    Cs = rng.normal(size=(M, D, k))
    means = rng.normal(size=(M, D))
    sigmas = 0.5 + rng.random(M)
    lw = np.log(rng.dirichlet(np.ones(M)))
    mask = rng.random((N, D)) > 0.3
    mask[3] = False
    data = np.where(mask, rng.normal(size=(N, D)) + means[rng.integers(0, M, size=N)], 0.0)
    weights = rng.random(N) + 0.5
    weights[5] = 0.0
    return Cs, means, sigmas, lw, data, mask, weights


@pytest.mark.parametrize("k", [3, 24])
@pytest.mark.parametrize("exact", [False, True])
def test_mix_em_stats_match_the_jax_package(rng, k, exact):
    """The general mixture route's statistics (both block forms), S added
    block by block into one running sum, against the JAX package's."""
    inputs = _mix_problem(rng, k=k)
    t = [torch.as_tensor(a) for a in inputs]
    j = [jnp.asarray(a) for a in inputs]
    old = jconfig.mix_exact_rnorm
    jconfig.mix_exact_rnorm = tconfig.mix_exact_rnorm = exact
    try:
        got = tmf.mix_em_stats(*t, block_size=32)
        want = jmf.mix_em_stats(*j, block_size=32)
    finally:
        jconfig.mix_exact_rnorm = old
        tconfig.mix_exact_rnorm = False
    assert tk.S_LAUNCHES == {"kernel": 0, "library": 3}
    for name in got._fields:
        g, wnt = getattr(got, name), getattr(want, name)
        if name == "S":
            g, wnt = _symmetric(g, k), _symmetric(wnt, k)
        _close(g, wnt)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("route", ["masked", "mixture"])
def test_routes_add_each_block_into_one_S(monkeypatch, route, exact):
    """Each block hands ``mask_s`` its bool mask, its SM as (B, W) or (M, B,
    W) and the running S itself: one tensor for the whole pass, no
    per-block S."""
    calls = []
    real = tk.mask_s

    def spy(mask, SM, scale, S):
        calls.append((mask.dtype, tuple(mask.shape), tuple(SM.shape), tuple(scale.shape),
                      S.data_ptr()))
        real(mask, SM, scale, S)

    monkeypatch.setattr(tk, "mask_s", spy)
    monkeypatch.setattr(tconfig, "mix_exact_rnorm", exact)
    rng = np.random.default_rng(4)
    if route == "masked":
        block, lead = 64, ()
        C, mean, sigma, data, mask, w = _masked_problem(rng, k=24)
        tml.em_stats(*(torch.as_tensor(a) for a in (C, mean, sigma, data, mask, w)),
                     block_size=block)
    else:
        block, lead = 32, (3,)
        Cs, means, sigmas, lw, data, mask, w = _mix_problem(rng, k=24)
        tmf.mix_em_stats(*(torch.as_tensor(a) for a in (Cs, means, sigmas, lw, data, mask, w)),
                         block_size=block)
    N, D = data.shape
    W = tk.slab_width(24)
    sizes = [min(block, N - lo) for lo in range(0, N, block)]
    assert [c[:4] for c in calls] == [(torch.bool, (n, D), (*lead, n, W), (*lead, n))
                                      for n in sizes]
    assert len({c[4] for c in calls}) == 1
