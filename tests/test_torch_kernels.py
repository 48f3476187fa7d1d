"""The port's SPD kernels (ppca_rs_tpu_torch.ops.kernels) against the JAX
package's Pallas kernel, run here in interpret mode.

On the CPU the port's wrapper runs its plain version, spd_estep_reference;
the CUDA kernel itself is checked against that plain version on the card by
chip_smoke.py.  Inputs are made with numpy from a seed and handed to both
packages in float32, at the tolerances of tests/test_kernels.py.
"""

import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppca_rs_tpu.ops import kernels as jk
from ppca_rs_tpu.ops import masked_linalg as jml
from ppca_rs_tpu_torch.ops import _build
from ppca_rs_tpu_torch.ops import kernels as tk
from ppca_rs_tpu_torch.ops import masked_linalg as tml
from ppca_rs_tpu_torch.config import config as tconfig

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port builds on the card by default; these tests ask for the CPU."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))

REPO = Path(__file__).resolve().parent.parent


def estep_inputs(rng, B, D, k, empty_rows=(3,)):
    """float32 (G, b, rnorm, d_obs) of a random model under a 60% mask."""
    C = rng.normal(size=(D, k))
    mean = rng.normal(size=D)
    mask = rng.random((B, D)) > 0.4
    mask[list(empty_rows)] = False
    R = mask * (rng.normal(size=(B, D)) - mean)
    G = np.einsum("bd,di,dj->bij", mask.astype(np.float64), C, C)
    b = R @ C
    return tuple(np.asarray(a, np.float32) for a in (G, b, (R * R).sum(-1), mask.sum(-1)))


def jax_estep(sigma, G, b, rnorm, d_obs, want):
    """The Pallas kernel in interpret mode, in the port's batch-major layout;
    a per-sample sigma goes in as the (1, B) lane vector."""
    sigma = np.asarray(sigma, np.float32)
    sigma = jnp.asarray(sigma if sigma.ndim == 0 else sigma.reshape(1, -1))
    out = jk.spd_estep(sigma, jnp.asarray(np.transpose(G, (1, 2, 0))),
                       jnp.asarray(b.T), jnp.asarray(rnorm[None, :]),
                       jnp.asarray(d_obs[None, :]), want=want, interpret=True)
    out = [np.asarray(o) for o in out]
    if want == "llk":
        return (out[0][0],)
    if want == "states":
        return out[0].T, out[1][0]
    return out[0].T, np.transpose(out[1], (2, 0, 1)), out[2][0], out[3][0]


def torch_estep(sigma, G, b, rnorm, d_obs, want):
    if isinstance(sigma, np.ndarray):
        sigma = torch.from_numpy(sigma)
    out = tk.spd_estep(sigma, *(torch.from_numpy(a) for a in (G, b, rnorm, d_obs)), want=want)
    return [o.numpy() for o in out]


# (rtol, atol) per output, as tests/test_kernels.py holds the Pallas kernel
TOLS = {
    "states": [(3e-4, 3e-5), (3e-4, 3e-3)],
    "llk": [(3e-4, 3e-3)],
    "fullt": [(3e-4, 3e-5), (3e-4, 3e-5), (3e-4, 3e-3), (3e-3, 3e-3)],
    "infer": [(3e-4, 3e-5), (3e-4, 3e-6), (3e-4, 3e-3), (3e-3, 3e-3)],
}
TOLS["full"] = TOLS["fullt"]


@pytest.mark.parametrize("k", [2, 13, 32])
@pytest.mark.parametrize("want", ["fullt", "states", "llk", "infer", "full"])
def test_reference_matches_pallas(rng, want, k):
    G, b, rnorm, d_obs = estep_inputs(rng, B=128, D=24, k=k)
    got = torch_estep(0.7, G, b, rnorm, d_obs, want)
    ref = jax_estep(0.7, G, b, rnorm, d_obs, want)
    assert len(got) == len(ref) == len(TOLS[want])
    for i, (g, r, (rtol, atol)) in enumerate(zip(got, ref, TOLS[want])):
        if want == "fullt" and i == 1:
            # the Pallas fullt SM holds only its lower wedge; the port's is
            # full and symmetric
            np.testing.assert_allclose(g, np.swapaxes(g, -1, -2), rtol=1e-6, atol=1e-6)
            tril = np.tril(np.ones((k, k)))
            g, r = g * tril, r * tril
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=f"output {i}")


@pytest.mark.parametrize("want", ["fullt", "llk"])
def test_reference_matches_pallas_at_k128(rng, want):
    """k=128, the widest register tile on the card, against the Pallas
    kernel (its max_k allows 264 for fullt, 456 for llk)."""
    k = 128
    assert k <= jk.max_k(want)
    G, b, rnorm, d_obs = estep_inputs(rng, B=128, D=160, k=k)
    got = torch_estep(0.7, G, b, rnorm, d_obs, want)
    ref = jax_estep(0.7, G, b, rnorm, d_obs, want)
    for i, (g, r, (rtol, atol)) in enumerate(zip(got, ref, TOLS[want])):
        if want == "fullt" and i == 1:
            tril = np.tril(np.ones((k, k)))
            g, r = g * tril, r * tril
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=f"output {i}")


@pytest.mark.parametrize("want", ["fullt", "states", "llk", "infer", "full"])
def test_reference_per_sample_sigma_matches_pallas(rng, want):
    """A sigma per sample (the mixtures' stacked components) against the
    Pallas kernel's (1, B) lane vector, as tests/test_kernels.py holds it."""
    k = 5
    G, b, rnorm, d_obs = estep_inputs(rng, B=128, D=16, k=k)
    sigmas = np.where(np.arange(128) < 64, 0.4, 1.3).astype(np.float32)
    got = torch_estep(sigmas, G, b, rnorm, d_obs, want)
    ref = jax_estep(sigmas, G, b, rnorm, d_obs, want)
    for i, (g, r, (rtol, atol)) in enumerate(zip(got, ref, TOLS[want])):
        if want == "fullt" and i == 1:
            tril = np.tril(np.ones((k, k)))
            g, r = g * tril, r * tril
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=f"output {i}")


@pytest.mark.parametrize("want", ["fullt", "states", "llk", "infer"])
def test_reference_per_sample_sigma_matches_scalar_calls(rng, want):
    """Each sample of a per-sample-sigma call equals the call with that
    sample's sigma for the whole batch."""
    G, b, rnorm, d_obs = (torch.from_numpy(a.astype(np.float64)) for a in
                          estep_inputs(rng, B=24, D=14, k=4))
    levels = (0.5, 0.9, 1.7)
    which = torch.arange(24) % len(levels)
    sigma = torch.tensor(levels, dtype=torch.float64)[which]
    got = tk.spd_estep(sigma, G, b, rnorm, d_obs, want=want)
    for i, level in enumerate(levels):
        rows = which == i
        for g, r in zip(got, tk.spd_estep(level, G, b, rnorm, d_obs, want=want)):
            torch.testing.assert_close(g[rows], r[rows], rtol=1e-13, atol=1e-13)
    with pytest.raises(ValueError, match="sigma"):
        tk.spd_estep(sigma[:5], G, b, rnorm, d_obs, want=want)


def test_rows_solve_matches_pallas(rng):
    """The M-step row solve at lambda = 0 and k = 13 (not a multiple of 8)."""
    B, k = 100, 13
    V = rng.normal(size=(B, k, 2 * k)) / np.sqrt(2 * k)
    S = (V @ np.swapaxes(V, -1, -2) + 0.05 * np.eye(k)).astype(np.float32)
    cross = rng.normal(size=(B, k)).astype(np.float32)
    got = tml.rows_solve(torch.from_numpy(S), torch.from_numpy(cross), 0.0).numpy()
    ref = np.asarray(jml._kernel_rows_solve(jnp.asarray(S), jnp.asarray(cross), 0.0,
                                            interpret=True))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-5)


def test_rows_solve_singular_row_only_nonfinite(rng):
    """An empty dimension at lambda = 0 (S[d] = 0) fails alone, with no
    exception, so em_finalize can keep the old row."""
    B, k = 40, 13
    V = rng.normal(size=(B, k, 2 * k)) / np.sqrt(2 * k)
    S = V @ np.swapaxes(V, -1, -2) + 0.05 * np.eye(k)
    cross = rng.normal(size=(B, k))
    S[7] = 0.0
    cross[7] = 0.0
    got = tml.rows_solve(torch.from_numpy(S), torch.from_numpy(cross), 0.0).numpy()
    assert not np.isfinite(got[7]).any()
    keep = np.arange(B) != 7
    want = np.linalg.solve(S[keep], cross[keep][..., None])[..., 0]
    np.testing.assert_allclose(got[keep], want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("want", ["fullt", "infer"])
def test_reference_all_masked_sample_neutral(rng, want):
    """All-masked samples: zero states and llk, covariance I."""
    G, b, rnorm, d_obs = (a.astype(np.float64) for a in
                          estep_inputs(rng, B=16, D=12, k=4, empty_rows=(0, 5, 15)))
    s, second, llk, sq = torch_estep(0.6, G, b, rnorm, d_obs, want)
    for r in (0, 5, 15):
        assert abs(llk[r]) < 1e-12 and abs(sq[r]) < 1e-12
        np.testing.assert_array_equal(s[r], 0.0)
        np.testing.assert_allclose(second[r], np.eye(4), atol=1e-14)


def test_reference_variants_agree(rng):
    """llk, states and infer are consistent with fullt (SM = s s^T + Sigma)."""
    G, b, rnorm, d_obs = (torch.from_numpy(a.astype(np.float64)) for a in
                          estep_inputs(rng, B=32, D=20, k=5))
    s, SM, llk, sq = tk.spd_estep_reference(0.8, G, b, rnorm, d_obs, "fullt")
    s_i, cov, llk_i, sq_i = tk.spd_estep_reference(0.8, G, b, rnorm, d_obs, "infer")
    s_s, llk_s = tk.spd_estep_reference(0.8, G, b, rnorm, d_obs, "states")
    (llk_l,) = tk.spd_estep_reference(0.8, G, b, rnorm, d_obs, "llk")
    for x in (s_i, s_s):
        torch.testing.assert_close(x, s, rtol=1e-12, atol=1e-12)
    for x in (llk_i, llk_s, llk_l):
        torch.testing.assert_close(x, llk, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(sq_i, sq, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(cov + s[:, :, None] * s[:, None, :], SM, rtol=1e-12, atol=1e-12)


def test_cpu_wrapper_never_launches(rng, monkeypatch):
    def no_launch(*args):
        raise AssertionError("a CPU tensor reached a kernel launch")

    monkeypatch.setattr(tk, "launch", no_launch)
    monkeypatch.setattr(tk, "launch_chol", no_launch)
    tk.reset_launch_counts()
    G, b, rnorm, d_obs = (torch.from_numpy(a) for a in estep_inputs(rng, B=8, D=10, k=3))
    for want in tk.WANTS:
        tk.spd_estep(0.5, G, b, rnorm, d_obs, want=want)
    tk.spd_chol(G + torch.eye(3))
    assert tk.LAUNCHES == {name: 0 for name in tk.KERNELS}


def test_wrapper_rejects_bad_inputs(rng):
    G, b, rnorm, d_obs = (torch.from_numpy(a) for a in estep_inputs(rng, B=8, D=10, k=3))
    with pytest.raises(ValueError, match="want"):
        tk.spd_estep(0.5, G, b, rnorm, d_obs, want="chol")
    with pytest.raises(ValueError, match="b must be"):
        tk.spd_estep(0.5, G, b[:, :2], rnorm, d_obs)
    with pytest.raises(ValueError, match="G must be"):
        tk.spd_estep(0.5, G[:, :2], b, rnorm, d_obs)
    with pytest.raises(ValueError, match="rnorm and d_obs"):
        tk.spd_estep(0.5, G, b, rnorm[:4], d_obs)
    # the kernel launcher takes CUDA tensors only, and never falls back
    with pytest.raises(ValueError, match="CUDA"):
        tk.launch("llk", 0.5, G, b, rnorm, d_obs, tk.empty_outputs("llk", 8, 3, G))
    with pytest.raises(ValueError, match="M must be"):
        tk.spd_chol(G[:, :2])
    with pytest.raises(ValueError, match="CUDA"):
        tk.launch_chol(G, torch.empty_like(G))


def test_sigma_given_on_the_device_is_used_as_it_is():
    """A sigma tensor of the kernel's dtype and device goes to the kernel
    without a copy (stride 0 for one value, 1 for one per sample); a Python
    number is filled on the device; a wrong length raises."""
    one = torch.tensor(0.7, dtype=torch.float64)
    arg, stride = tk.sigma_arg(one, 6, torch.float64, one.device)
    assert arg.data_ptr() == one.data_ptr() and stride == 0 and arg.shape == (1,)
    per = torch.linspace(0.5, 1.0, 6, dtype=torch.float64)
    arg, stride = tk.sigma_arg(per, 6, torch.float64, per.device)
    assert arg.data_ptr() == per.data_ptr() and stride == 1
    arg, stride = tk.sigma_arg(0.25, 6, torch.float32, torch.device("cpu"))
    assert arg.dtype == torch.float32 and stride == 0 and float(arg) == 0.25
    arg, stride = tk.sigma_arg(per, 6, torch.float32, per.device)
    assert arg.dtype == torch.float32 and stride == 1
    torch.testing.assert_close(arg, per.float())
    with pytest.raises(ValueError, match="sigma"):
        tk.sigma_arg(per[:4], 6, torch.float64, per.device)


def test_design_follows_the_tile_limit(monkeypatch):
    """k up to the tile limit that the kernel library reports, for each
    kernel and element size, takes the register tile, larger k the panel
    design (a stand-in library here: the real one is built on the card)."""
    limits = {("estep", 4): 128, ("estep", 8): 64, ("chol", 4): 96, ("chol", 8): 48}
    lib = types.SimpleNamespace(spd_estep_tile_max_k=lambda size: limits["estep", size],
                                spd_chol_tile_max_k=lambda size: limits["chol", size])
    monkeypatch.setattr(_build, "load", lambda: lib)
    assert tk.design(1) == tk.design(128) == "tile"     # estep, float32 by default
    assert tk.design(129) == tk.design(4096) == "panel"
    for (kernel, size), limit in limits.items():
        dtype = torch.float32 if size == 4 else torch.float64
        assert tk.design(1, kernel, dtype) == tk.design(limit, kernel, dtype) == "tile"
        assert tk.design(limit + 1, kernel, dtype) == "panel"
    with pytest.raises(ValueError, match="kernel"):
        tk.design(4, "full")


def test_build_command_and_source_key(tmp_path, monkeypatch):
    """The build compiles each of the package's sources for sm_90a, then
    links them into a library whose name carries a hash of the sources
    (nvcc itself runs on the card)."""
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cu = [p.name for p in _build.sources() if p.suffix == ".cu"]
    assert cu == ["mask_gram.cu", "mask_s.cu", "spd_chol.cu", "spd_estep.cu",
                  "spd_estep_tile_f32.cu", "spd_estep_tile_f64.cu", "spd_panel_f32.cu",
                  "spd_panel_f64.cu"]
    for name in cu:
        cmd = _build.compile_command(_build.SOURCE_DIR / name, tmp_path / "a.o")
        assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
        assert "-c" in cmd and cmd[-1] == str(_build.SOURCE_DIR / name)
    link = _build.link_command([tmp_path / "a.o", tmp_path / "b.o"], tmp_path / "lib.so")
    assert link[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    assert "-shared" in link and link[-2:] == [str(tmp_path / "a.o"), str(tmp_path / "b.o")]
    key = _build.source_key()
    assert _build.library_path().name == f"ppca_kernels-{key}.so"
    assert _build.library_path().parent == _build.BUILD_DIR

    fake = tmp_path / "csrc"
    fake.mkdir()
    (fake / "a.cu").write_text("int x;")
    monkeypatch.setattr(_build, "SOURCE_DIR", fake)
    k1 = _build.source_key()
    (fake / "a.cu").write_text("int y;")
    assert _build.source_key() != k1


def test_import_leaves_jax_out():
    """The port imports neither jax nor the JAX package."""
    code = ("import sys, ppca_rs_tpu_torch, ppca_rs_tpu_torch.interop, "
            "ppca_rs_tpu_torch.ops.kernels, ppca_rs_tpu_torch.ops._build; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'ppca_rs_tpu' or m.startswith('ppca_rs_tpu.')); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"
