"""The E-step kernel's slab layout (``ops.kernels``: ``slab_width``,
``slab_pack``, ``slab_unpack_lower``, ``uses_slabs``) and the routes that
build only the Gram's lower wedge with it, on the CPU in float64.

G as slabs: k in blocks of 8 rows, row r of block j = r // 8 holding its
first 8 (j + 1) entries.  Every spd_estep variant on slab G must equal the
same variant on square G within 1e-12 (fullt's SM comes back as slabs,
zeros above the diagonal); the masked route (k = 24, 40, 64: 40 is a
multiple of 8 and of neither 16 nor 32) and the general mixture route
(k = 32) must equal the JAX package, whose own wedge slabs are on by
default, within the suite's 1e-9.  Spies on ``kernels.spd_estep`` show
that the routes did hand it slab G.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppca_rs_tpu as jp
from ppca_rs_tpu.ops import mix_fused as jmf
from ppca_rs_tpu_torch import interop
from ppca_rs_tpu_torch.config import config as tconfig
from ppca_rs_tpu_torch.ops import kernels as tk
from ppca_rs_tpu_torch.ops import masked_linalg as tml
from ppca_rs_tpu_torch.ops import mix_fused as tmf

torch.set_num_threads(1)

F64 = torch.float64
TOL = 1e-9
TOL_LAYOUT = 1e-12
LAYOUT_KS = (24, 32, 40, 64, 128)
#: slab_width(k) = 32 m (m + 1), m = k / 8
WIDTHS = {24: 384, 32: 640, 40: 960, 64: 2304, 128: 8704}


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port builds on the card by default; these tests ask for the CPU."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))


@pytest.fixture
def layouts(monkeypatch):
    """Spy on kernels.spd_estep: the layout of every G it is handed, by
    variant, ("slab" or "square", k)."""
    seen = []
    real = tk.spd_estep

    def spy(sigma, G, b, rnorm, d_obs, want="fullt"):
        seen.append((want, "slab" if G.ndim == 2 else "square", b.shape[-1]))
        return real(sigma, G, b, rnorm, d_obs, want)

    monkeypatch.setattr(tk, "spd_estep", spy)
    return seen


def close(got, want, rtol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


def estep_inputs(rng, B, D, k):
    """float64 (G, b, rnorm, d_obs) of a random model under a 60% mask,
    sample 3 all-masked."""
    C = rng.normal(size=(D, k))
    mask = rng.random((B, D)) > 0.4
    mask[3] = False
    R = mask * rng.normal(size=(B, D))
    G = np.einsum("bd,di,dj->bij", mask.astype(np.float64), C, C)
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (G, R @ C, (R * R).sum(-1), mask.sum(-1).astype(np.float64)))


# --------------------------------------------------------------------- #
# the layout


@pytest.mark.parametrize("k", LAYOUT_KS)
def test_slab_width_and_row_offsets(k):
    m = k // 8
    assert tk.slab_width(k) == WIDTHS[k] == 32 * m * (m + 1)
    rows, cols = tk.slab_coords(k)
    # where each row starts: the first slab element of that row
    offsets = [rows.tolist().index(r) for r in range(k)]
    widths = [8 * (r // 8 + 1) for r in range(k)]
    # rows one after another, each 8 (j + 1) wide, 16-byte aligned in float32
    assert offsets[0] == 0
    assert all(b - a == w for a, b, w in zip(offsets, offsets[1:], widths))
    assert offsets[-1] + widths[-1] == tk.slab_width(k)
    assert all(off % 8 == 0 and w >= r + 1 for r, (off, w) in enumerate(zip(offsets, widths)))
    assert offsets == [8 * (r // 8 + 1) * (r - 4 * (r // 8)) for r in range(k)]
    assert rows.tolist() == [r for r in range(k) for _ in range(widths[r])]
    assert all(cols[off:off + w].tolist() == list(range(w))
               for off, w in zip(offsets, widths))


@pytest.mark.parametrize("k", (24, 64))
def test_slab_coords_are_made_once_per_device(monkeypatch, k):
    """A second call for the same (k, device) returns the tensors of the
    first and copies nothing: a copy from pageable host memory would wait
    for the device's stream on every statistics pass.  The CPU's are the
    host index itself; another device ('meta' here) gets its own copy,
    made once."""
    host = tk.slab_coords(k)
    assert tk.slab_coords(k, "cpu")[0] is host[0]
    first = tk.slab_coords(k, torch.device("meta"))
    assert all(t.device.type == "meta" and t.shape == (WIDTHS[k],) for t in first)

    def no_copy(*args, **kwargs):
        raise AssertionError("slab_coords copied its index again")

    monkeypatch.setattr(torch.Tensor, "to", no_copy)
    again = tk.slab_coords(k, "meta")
    assert again[0] is first[0] and again[1] is first[1]
    assert tk.slab_coords(k)[1] is host[1]


@pytest.mark.parametrize("k", LAYOUT_KS)
def test_slab_pack_unpack_round_trip(rng, k):
    A = torch.from_numpy(rng.normal(size=(3, 2, k, k)))
    slabs = tk.slab_pack(A)
    assert slabs.shape == (3, 2, tk.slab_width(k))
    low = tk.slab_unpack_lower(slabs, k)
    assert torch.equal(low, torch.tril(A))
    assert torch.equal(tk.slab_pack(low), slabs)
    rows, cols = tk.slab_coords(k)
    assert bool((slabs[..., cols > rows] == 0).all())
    # the Gram's slab columns are outer_flat's at the slab positions
    C = torch.from_numpy(rng.normal(size=(7, k)))
    assert torch.equal(tml.outer_slab(C), tml.outer_flat(C)[:, rows * k + cols])
    Cs = torch.from_numpy(rng.normal(size=(2, 7, k)))
    assert torch.equal(tml.outer_slab(Cs), tml.outer_flat(Cs)[..., rows * k + cols])


@pytest.mark.parametrize("dtype, k, takes", [
    (torch.float32, 16, False), (torch.float32, 20, False), (torch.float32, 24, True),
    (torch.float32, 128, True), (torch.float32, 136, False),
    (torch.float64, 64, True), (torch.float64, 72, False),
])
def test_gate_edges(rng, dtype, k, takes):
    """k a multiple of 8 above 16 and within the tile: float32 to 128,
    float64 to 64.  Outside the gate slab G raises, on the CPU as on the card."""
    assert tk.uses_slabs(k, dtype) is takes
    width = tml.gram_columns(torch.zeros(3, k, dtype=dtype), dtype).shape[-1]
    assert width == tk.gram_width(k, dtype) == (tk.slab_width(k) if takes else k * k)
    B = 4
    b, rnorm, d_obs = torch.zeros(B, k, dtype=dtype), torch.ones(B, dtype=dtype), torch.ones(
        B, dtype=dtype)
    width = tk.slab_width(k) if k % 8 == 0 else k * (k + 1) // 2
    G = torch.zeros(B, width, dtype=dtype)
    if takes:
        (llk,) = tk.spd_estep(0.5, G, b, rnorm, d_obs, want="llk")
        assert bool(torch.isfinite(llk).all())
    else:
        with pytest.raises(ValueError, match="slab G needs|G must be"):
            tk.spd_estep(0.5, G, b, rnorm, d_obs, want="llk")


@pytest.mark.parametrize("delta", [-1, 8, "square"])
def test_wrapper_refuses_a_wrong_slab_width(rng, delta):
    k = 32
    G, b, rnorm, d_obs = estep_inputs(rng, B=6, D=40, k=k)
    width = k * k if delta == "square" else tk.slab_width(k) + delta
    bad = torch.zeros(6, width, dtype=F64)
    with pytest.raises(ValueError, match="G must be"):
        tk.spd_estep(0.5, bad, b, rnorm, d_obs)
    with pytest.raises(ValueError, match="G must be"):
        tk.launch("llk", 0.5, bad, b, rnorm, d_obs, tk.empty_outputs("llk", 6, k, bad))
    # the launcher takes CUDA tensors only, slabs too, and never falls back
    slabs = tk.slab_pack(G)
    with pytest.raises(ValueError, match="CUDA"):
        tk.launch("fullt", 0.5, slabs, b, rnorm, d_obs,
                  tk.empty_outputs("fullt", 6, k, slabs, slab=True))


@pytest.mark.parametrize("dtype, k", [(F64, 16), (F64, 40), (F64, 72), (torch.float32, 72)])
def test_estep_gram_and_unpack_stats(rng, dtype, k):
    """The routes' flat Grams become the kernel's G by the gate alone, a
    square Gram (flat or not) stays square, any other size raises; summed
    slab statistics unpack to the lower triangle and square ones stay as
    they are."""
    A = torch.from_numpy(rng.normal(size=(2, 3, k, k))).to(dtype)
    slabs = tk.uses_slabs(k, dtype)
    flat = tk.slab_pack(A) if slabs else A.reshape(2, 3, k * k)
    assert flat.shape[-1] == tk.gram_width(k, dtype)
    G = tk.estep_gram(flat, 6, k)
    assert torch.equal(G, flat.reshape(6, -1) if slabs else A.reshape(6, k, k))
    for square in (A, A.reshape(2, 3, k * k)):
        assert torch.equal(tk.estep_gram(square, 6, k), A.reshape(6, k, k))
    with pytest.raises(ValueError, match="must be"):
        tk.estep_gram(flat[..., :-8], 6, k)
    S = tk.unpack_stats(flat, k)
    assert torch.equal(S, (torch.tril(A) if slabs else A).reshape(2, 3, k * k))


@pytest.mark.parametrize("want", tk.WANTS)
@pytest.mark.parametrize("k", (24, 40, 64))
def test_every_variant_on_slab_g_equals_square_g(rng, k, want):
    G, b, rnorm, d_obs = estep_inputs(rng, B=33, D=3 * k, k=k)
    sigma = torch.from_numpy(0.4 + rng.random(33))
    square = tk.spd_estep(sigma, G, b, rnorm, d_obs, want=want)
    slab = tk.spd_estep(sigma, tk.slab_pack(G), b, rnorm, d_obs, want=want)
    assert len(slab) == len(square)
    for i, (s, q) in enumerate(zip(slab, square)):
        if want == "fullt" and i == 1:
            assert s.shape == (33, tk.slab_width(k))
            rows, cols = tk.slab_coords(k)
            assert bool((s[:, cols > rows] == 0).all()), "fullt's slab SM above the diagonal"
            close(tk.slab_unpack_lower(s, k), torch.tril(q), TOL_LAYOUT)
        else:
            assert s.shape == q.shape
            close(s, q, TOL_LAYOUT)


# --------------------------------------------------------------------- #
# the masked route against the JAX package


def masked_problem(rng, k, N=160, D=96):
    C = rng.normal(size=(D, k)) / np.sqrt(k)
    mean = rng.normal(size=D)
    data = rng.normal(size=(N, k)) @ C.T + mean + 0.5 * rng.normal(size=(N, D))
    mask = rng.random((N, D)) > 0.5
    mask[7] = False   # an all-masked row
    data = np.where(mask, data, 0.0)
    C0 = C + 0.1 * rng.normal(size=(D, k))
    tds = interop.dataset_from_arrays(data, mask)
    assert tds.pattern_info() is None
    jds = jp.Dataset.from_parts(jnp.asarray(data), jnp.asarray(mask))
    tm = interop.model_from_arrays(C0, mean, 0.8)
    jm = jp.PPCAModel(isotropic_noise=0.8, transform=C0, mean=mean)
    return tm, jm, tds, jds


@pytest.mark.parametrize("what", ["em_step", "llks", "infer", "states"])
@pytest.mark.parametrize("k", (24, 40, 64))
def test_masked_route_on_slabs_matches_jax(rng, layouts, k, what):
    tm, jm, tds, jds = masked_problem(rng, k)
    if what == "em_step":
        tn, jn = tm.iterate(tds), jm.iterate(jds)
        close(tn.transform, jn.transform)
        close(tn.mean, jn.mean)
        assert float(tn.isotropic_noise) == pytest.approx(float(jn.isotropic_noise), rel=TOL)
        wants = {"fullt"}
    elif what == "llks":
        close(tm.llks(tds), jm.llks(jds))
        wants = {"llk"}
    elif what == "infer":
        ti, ji = tm.infer(tds), jm.infer(jds)
        close(ti.states(), ji.states())
        close(ti.covariances_array(), ji.covariances_array())
        wants = {"infer"}
    else:
        close(tm.smooth(tds).data, jm.smooth(jds).data)
        close(tm.extrapolate(tds).data, jm.extrapolate(jds).data)
        wants = {"states"}
    slabbed = {w for w, layout, kk in layouts if layout == "slab" and kk == k}
    assert slabbed == wants, layouts
    # the M-step's row solve keeps square (k, k) systems
    assert all(layout == "square" for w, layout, _ in layouts if w not in wants)


def test_em_stats_on_slabs_equal_square_stats(rng, monkeypatch):
    """em_stats with the slab Gram and slab S against the same pass with
    both square (the gate forced shut): every statistic, S on and below
    the diagonal."""
    k = 40
    tm, _, tds, _ = masked_problem(rng, k)
    args = (tm.transform, tm.mean, tm.isotropic_noise, tds.data, tds.mask, tds.weights_dev)
    slab = tml.em_stats(*args, block_size=64)
    monkeypatch.setattr(tk, "uses_slabs", lambda k, dtype: False)
    square = tml.em_stats(*args, block_size=64)
    for name in slab._fields:
        g, w = getattr(slab, name), getattr(square, name)
        if name == "S":
            assert bool((g.reshape(-1, k, k).triu(1) == 0).all())
            g, w = g.reshape(-1, k, k), torch.tril(w.reshape(-1, k, k))
        close(g, w, TOL_LAYOUT)


# --------------------------------------------------------------------- #
# the general mixture route against the JAX package


def mix_problem(rng, M=3, N=90, D=48, k=32):
    Cs = rng.normal(size=(M, D, k)) / np.sqrt(k)
    means = rng.normal(size=(M, D))
    sigmas = 0.5 + rng.random(M)
    lw = np.log(rng.dirichlet(np.ones(M)))
    mask = rng.random((N, D)) > 0.3
    mask[3] = False
    data = np.where(mask, rng.normal(size=(N, D)) + means[rng.integers(0, M, size=N)], 0.0)
    weights = rng.random(N) + 0.5
    weights[5] = 0.0
    return Cs, means, sigmas, lw, data, mask, weights


def symmetric(S, k):
    S = np.asarray(S, np.float64).reshape(*np.shape(S)[:-1], k, k)
    return np.tril(S) + np.swapaxes(np.tril(S, -1), -1, -2)


@pytest.mark.parametrize("exact", [False, True])
def test_mix_em_stats_on_slabs_match_jax(rng, layouts, exact):
    from ppca_rs_tpu.config import config as jconfig

    arrays = mix_problem(rng)
    k = arrays[0].shape[-1]
    t = [torch.from_numpy(a) if a.dtype == bool else torch.as_tensor(a, dtype=F64)
         for a in arrays]
    old = jconfig.mix_exact_rnorm
    jconfig.mix_exact_rnorm = tconfig.mix_exact_rnorm = exact
    try:
        got = tmf.mix_em_stats(*t, block_size=32)
        want = jmf.mix_em_stats(*(jnp.asarray(a) for a in arrays), block_size=32)
    finally:
        jconfig.mix_exact_rnorm = old
        tconfig.mix_exact_rnorm = False
    for name in got._fields:
        g, w = getattr(got, name), getattr(want, name)
        if name == "S":
            assert tuple(g.shape) == (3, arrays[0].shape[1], k * k)
            g, w = symmetric(g.numpy(), k), symmetric(w, k)
        close(g, w)
    assert {(w, layout) for w, layout, _ in layouts} == {("fullt", "slab")}


@pytest.mark.parametrize("what", ["em_step", "llks", "infer"])
def test_mixture_on_slabs_matches_jax(rng, layouts, what):
    Cs, means, sigmas, lw, data, mask, weights = mix_problem(rng)
    k = Cs.shape[-1]
    tmix = interop.mix_from_arrays(list(Cs), list(means), list(sigmas), lw)
    jmix = jp.PPCAMix([jp.PPCAModel(isotropic_noise=s, transform=c, mean=mu)
                       for c, mu, s in zip(Cs, means, sigmas)], lw)
    tds = interop.dataset_from_arrays(data, mask, weights)
    assert tds.pattern_info(include_dense=True) is None
    jds = jp.Dataset.from_parts(jnp.asarray(data), jnp.asarray(mask), jnp.asarray(weights))
    if what == "em_step":
        tnew, jnew = tmix.iterate(tds), jmix.iterate(jds)
        for a, b in zip(tnew.models, jnew.models):
            close(a.transform, b.transform)
            close(a.mean, b.mean)
            assert float(a.isotropic_noise) == pytest.approx(float(b.isotropic_noise), rel=TOL)
        close(tnew.log_weights, jnew.log_weights)
        wants = {"fullt"}
    elif what == "llks":
        close(tmix.llks(tds), jmix.llks(jds))
        wants = {"llk"}
    else:
        close(tmix.infer_cluster(tds), jmix.infer_cluster(jds))
        ti, ji = tmix.infer(tds), jmix.infer(jds)
        close(ti.log_posteriors(), ji.log_posteriors())
        close(ti.states(), ji.states())
        for a, b in zip(ti.covariances()[:5], ji.covariances()[:5]):
            close(a, b)
        wants = {"llk", "infer"}
    slabbed = {w for w, layout, kk in layouts if layout == "slab" and kk == k}
    assert wants <= slabbed, layouts


# --------------------------------------------------------------------- #
# the tools that read kernel names


@pytest.mark.parametrize("flag, label", [("Lb1E", ", true"), ("Lb0E", ", false"), ("", "")])
def test_sass_tool_names_the_layout(tmp_path, capsys, flag, label):
    """tools/torch_panel_sass.py labels the blocked body by its layout
    template argument (SLAB: true for slab G), the old names without it."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "tools" / "torch_panel_sass.py"
    spec = importlib.util.spec_from_file_location("torch_panel_sass", path)
    sass = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sass)
    listing = tmp_path / "listing.sass"
    listing.write_text(
        f"\t\tFunction : _ZN4ppca4tile21spd_estep_tile_kernelIfLi64ELi0E{flag}EEvPKT_xS4_\n"
        "        /*0000*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;\n"
        "        /*0010*/                   EXIT ;\n")
    sass.main([str(listing)])
    out = capsys.readouterr().out.strip()
    assert out.startswith(f"spd_estep_tile_kernel<float, 64, 0{label}>: HMMA.TF32 1, DMMA 0, ")
