"""The masked Gram on the bf16 tensor cores (``ops.kernels.mask_gram``),
on the CPU: the exact three-way bf16 split of the Gram columns
(``kernels.gram_slices``), the plain version the CPU takes
(``kernels.mask_gram_reference``) against float64, the gate that keeps
float64 and CPU tensors on ``torch.matmul``, and the routes' plumbing of
the bool mask and the slices, with the slices forced on so that the CPU
runs the plain version where the card runs the kernel.

The kernel itself (``csrc/mask_gram.cu``) runs on the card only; its
check against float64 is ``chip_smoke.py``'s mask-Gram phase.
"""

import numpy as np
import pytest
import torch

from ppca_rs_tpu_torch.config import config as tconfig
from ppca_rs_tpu_torch.ops import kernels as tk
from ppca_rs_tpu_torch.ops import masked_linalg as tml
from ppca_rs_tpu_torch.ops import mix_fused as tmf

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
U = 2.0 ** -24          # float32's unit roundoff


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port builds on the card by default; these tests ask for the CPU."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))
    tk.reset_launch_counts()


def _values(kind: str, n: int = 4096) -> torch.Tensor:
    gen = np.random.default_rng(7)
    if kind == "normal":
        x = gen.standard_normal(n)
    elif kind == "negative":
        x = -np.abs(gen.standard_normal(n)) * 10.0 ** gen.uniform(-3, 3, n)
    elif kind == "zeros":
        x = np.zeros(n)
    elif kind == "powers_of_two":
        x = 2.0 ** np.arange(-100, 100) * np.where(np.arange(200) % 2, -1.0, 1.0)
    elif kind == "bf16_midpoints":
        # halfway between neighbouring bf16 values (7 stored bits), with and
        # without bits below the halfway bit, on both signs
        base = (1.0 + np.arange(128) / 128.0) * 2.0 ** gen.integers(-40, 40, 128)
        mids = [base * (1 + 2.0 ** -8), base * (1 + 2.0 ** -8 + 2.0 ** -20),
                base * (1 + 3 * 2.0 ** -8), -base * (1 + 2.0 ** -8)]
        x = np.concatenate(mids)
    elif kind == "tiny":
        x = gen.standard_normal(n) * 10.0 ** gen.uniform(-30, -1, n)
    elif kind == "squares":
        # the slab columns are products of C's entries: many binades
        c = gen.standard_normal((n, 2)) * 10.0 ** gen.uniform(-3, 1, (n, 2))
        x = c[:, 0] * c[:, 1]
    else:
        raise ValueError(kind)
    return torch.tensor(x, dtype=F32)


@pytest.mark.parametrize("kind", ["normal", "negative", "zeros", "powers_of_two",
                                  "bf16_midpoints", "tiny", "squares"])
def test_split_is_exact(kind):
    x = _values(kind).reshape(-1, 1).expand(-1, 8).contiguous()
    hi, mid, lo = tk.gram_slices(x).float()
    assert torch.equal((hi + mid) + lo, x)
    # each part is at most half a bf16 step of the one before
    assert bool((mid.abs() <= hi.abs() * 2.0 ** -8).all())
    assert bool((lo.abs() <= mid.abs() * 2.0 ** -8).all())


@pytest.mark.parametrize("W,W8", [(144, 144), (169, 176), (2304, 2304), (7, 8)])
def test_split_pads_to_a_multiple_of_8(W, W8):
    CC = torch.randn(5, W)
    s = tk.gram_slices(CC)
    assert s.shape == (3, 5, W8) and s.dtype == torch.bfloat16
    assert torch.equal(s[..., W:], torch.zeros_like(s[..., W:]))
    assert torch.equal((s[0, :, :W].float() + s[1, :, :W].float()) + s[2, :, :W].float(), CC)


def _columns(D: int, k: int, square: bool = False, M: int = 0, seed: int = 3):
    """Gram columns of a random transform as the routes build them: slabs
    (k a multiple of 8 above 16) or square k^2, stacked for M > 0."""
    gen = torch.Generator().manual_seed(seed)
    shape = (M, D, k) if M else (D, k)
    C = torch.randn(shape, generator=gen, dtype=F64) * 2.0 / k ** 0.5
    CC = tml.outer_flat(C) if square else tml.outer_slab(C)
    return CC.to(F32)


def _mask(B: int, D: int, seed: int = 5, p: float = 0.5):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((B, D), generator=gen) < p


def _check_against_f64(G, mask, CC, D):
    """|G - mask @ CC| within float32's error of a sum over D: the three
    products each round at most D steps, relative to |mask| @ |CC|."""
    exact = torch.matmul(mask.to(F64), CC.to(F64))
    scale = torch.matmul(mask.to(F64), CC.to(F64).abs())
    assert bool(((G.to(F64) - exact).abs() <= 3 * (D + 2) * U * scale + 1e-37).all())


@pytest.mark.parametrize("B,D,k,square", [
    (1, 80, 24, False), (131, 80, 24, False), (8192, 80, 24, False),
    (131, 257, 40, False), (131, 1024, 40, False),
    (131, 257, 24, False), (131, 257, 32, False), (131, 257, 64, False),
    (131, 257, 128, False), (131, 257, 12, True), (131, 257, 13, True),
])
def test_reference_agrees_with_f64(B, D, k, square):
    CC = _columns(D, k, square)
    mask = _mask(B, D)
    slices = tk.gram_slices(CC)
    out = torch.full((B, CC.shape[-1]), float("nan"))
    tk.mask_gram(mask, slices, out)
    assert torch.equal(out, tk.mask_gram_reference(mask, slices, CC.shape[-1]))
    _check_against_f64(out, mask, CC, D)
    # and it is the plain float32 product to float32's error
    _check_against_f64(torch.matmul(mask.to(F32), CC), mask, CC, D)
    assert tk.GRAM_LAUNCHES["kernel"] == 0


@pytest.mark.parametrize("M,B,D,k", [(8, 131, 80, 32), (3, 64, 257, 24), (2, 17, 40, 13)])
def test_mixture_layout(M, B, D, k):
    """(M, B, W), component-major, as torch.matmul(mask_f, CCs) gives it."""
    CCs = _columns(D, k, square=k % 8 != 0, M=M)
    mask = _mask(B, D, seed=11)
    out = torch.full((M, B, CCs.shape[-1]), float("nan"))
    tk.mask_gram(mask, tk.gram_slices(CCs), out)
    plain = torch.matmul(mask.to(F32), CCs)
    assert out.shape == plain.shape
    _check_against_f64(out, mask, CCs, D)
    scale = torch.matmul(mask.to(F32), CCs.abs())
    assert bool(((out - plain).abs() <= 6 * (D + 2) * U * scale + 1e-37).all())


def test_wrapper_refuses_what_the_kernel_does_not_take():
    CC = _columns(80, 24)
    slices = tk.gram_slices(CC)
    mask = _mask(16, 80)
    ok = torch.empty(16, CC.shape[-1])
    with pytest.raises(ValueError, match="bool"):
        tk.mask_gram(mask.float(), slices, ok)
    with pytest.raises(ValueError, match="slices"):
        tk.mask_gram(mask, slices.float(), ok)
    with pytest.raises(ValueError, match="slices"):
        tk.mask_gram(mask[:, :40], slices, ok)
    with pytest.raises(ValueError, match="out"):
        tk.mask_gram(mask, slices, torch.empty(16, CC.shape[-1], dtype=F64))
    with pytest.raises(ValueError, match="out"):
        tk.mask_gram(mask, slices, torch.empty(16, CC.shape[-1] + 8))
    with pytest.raises(ValueError, match="float32"):
        tk.gram_slices(CC.double())


@pytest.mark.parametrize("dtype", [F32, F64])
def test_gate_keeps_cpu_and_f64_on_matmul(dtype):
    """On the CPU, and in float64 anywhere, the routes build no slices and
    keep ``torch.matmul``: the kernel counter stays 0, the library one
    counts a Gram a block, and the results are the plain product's."""
    D, k, N = 64, 24, 300
    gen = torch.Generator().manual_seed(1)
    C = torch.randn((D, k), generator=gen, dtype=dtype) * 0.3
    gram = tml.gram_operand(C, dtype)
    assert gram.slices is None and torch.equal(gram.cols, tml.gram_columns(C, dtype))
    assert tml.gram_operand(C.to("meta"), dtype).slices is None
    mean = torch.randn(D, generator=gen, dtype=dtype)
    data = torch.randn((N, D), generator=gen, dtype=dtype)
    mask = _mask(N, D)
    data = torch.where(mask, data, torch.zeros((), dtype=dtype))
    tk.reset_launch_counts()
    got = tml.llks(C, mean, 0.7, data, mask, block_size=128)
    assert tk.GRAM_LAUNCHES == {"kernel": 0, "library": 3}
    plain = tml.GramOperand(tml.gram_columns(C, dtype), None)
    want = [tml.block_posterior(C, plain, mean, 0.7, data[lo:lo + 128], mask[lo:lo + 128], "llk")
            .out[0] for lo in range(0, N, 128)]
    assert torch.equal(got, torch.cat(want))


def test_kernel_path_refuses_a_float_mask(monkeypatch):
    """Where the routes take the Gram kernel, a mask that is not bool
    raises instead of leaving the kernel for the library product."""
    C, mean, data, mask, _ = _masked_inputs()
    _force_slices(monkeypatch)
    with pytest.raises(ValueError, match="bool"):
        tml.llks(C, mean, 0.7, data, mask.to(F32), block_size=128)
    assert tk.GRAM_LAUNCHES == {"kernel": 0, "library": 0}


def _force_slices(monkeypatch):
    """The routes' kernel path on the CPU: slices built as on the card, so
    ``kernels.mask_gram`` runs its plain version."""
    def forced(C, dtype):
        CC = tml.gram_columns(C, dtype)
        return tml.GramOperand(CC, tk.gram_slices(CC) if CC.dtype == F32 else None)

    monkeypatch.setattr(tml, "gram_operand", forced)


def _masked_inputs(N=300, D=64, k=24, seed=2):
    gen = torch.Generator().manual_seed(seed)
    C = torch.randn((D, k), generator=gen) * 0.3
    mean = torch.randn(D, generator=gen)
    mask = _mask(N, D, seed=seed)
    data = torch.where(mask, torch.randn((N, D), generator=gen), torch.zeros(()))
    return C, mean, data, mask, torch.rand(N, generator=gen) + 0.5


@pytest.mark.parametrize("k", [24, 12])
def test_masked_route_takes_the_kernel_path(monkeypatch, k):
    """Every verb of the masked route hands the Gram to ``mask_gram`` with
    the block's bool mask (no library Gram), and its results stay the
    plain product's to float32's error."""
    C, mean, data, mask, w = _masked_inputs(k=k)
    plain = (tml.llks(C, mean, 0.7, data, mask, block_size=128),
             tml.states(C, mean, 0.7, data, mask, block_size=128),
             *tml.infer(C, mean, 0.7, data, mask, block_size=128),
             *tml.em_stats(C, mean, 0.7, data, mask, w, block_size=128))
    _force_slices(monkeypatch)
    tk.reset_launch_counts()
    calls = []
    real = tk.mask_gram

    def spy(m, s, out):
        calls.append((m.dtype, tuple(m.shape), tuple(out.shape)))
        real(m, s, out)

    monkeypatch.setattr(tk, "mask_gram", spy)
    got = (tml.llks(C, mean, 0.7, data, mask, block_size=128),
           tml.states(C, mean, 0.7, data, mask, block_size=128),
           *tml.infer(C, mean, 0.7, data, mask, block_size=128),
           *tml.em_stats(C, mean, 0.7, data, mask, w, block_size=128))
    assert tk.GRAM_LAUNCHES["library"] == 0
    assert len(calls) == 4 * 3 and all(c[0] == torch.bool for c in calls)
    assert calls[-1][1] == (300 - 256, 64)
    for g, p in zip(got, plain):
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=2e-4, atol=2e-4)


def test_mixture_routes_take_the_kernel_path(monkeypatch):
    """The general mixture route's EM statistics (both block forms) and
    readouts hand the (M, B, W) Gram to ``mask_gram``."""
    M, D, k, N = 3, 64, 24, 300
    gen = torch.Generator().manual_seed(9)
    Cs = torch.randn((M, D, k), generator=gen) * 0.3
    means = torch.randn((M, D), generator=gen)
    sigmas = torch.tensor([0.6, 0.8, 1.0])
    log_w = torch.log(torch.tensor([0.2, 0.3, 0.5]))
    mask = _mask(N, D, seed=4)
    data = torch.where(mask, torch.randn((N, D), generator=gen), torch.zeros(()))
    w = torch.ones(N)

    def run():
        out = [*tmf.mix_em_stats(Cs, means, sigmas, log_w, data, mask, w, block_size=128)]
        out.append(tmf.mix_llks(Cs, means, sigmas, data, mask, block_size=128))
        out += list(tmf.mix_infer(Cs, means, sigmas, log_w, data, mask, block_size=128))
        return out

    plain = run()
    with monkeypatch.context() as mp:
        mp.setattr(tconfig, "mix_exact_rnorm", True)
        plain_exact = tmf.mix_em_stats(Cs, means, sigmas, log_w, data, mask, w, block_size=128)
    _force_slices(monkeypatch)
    tk.reset_launch_counts()
    got = run()
    with monkeypatch.context() as mp:
        mp.setattr(tconfig, "mix_exact_rnorm", True)
        got_exact = tmf.mix_em_stats(Cs, means, sigmas, log_w, data, mask, w, block_size=128)
    assert tk.GRAM_LAUNCHES["library"] == 0
    for g, p in zip([*got, *got_exact], [*plain, *plain_exact]):
        np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=2e-4, atol=2e-4)
