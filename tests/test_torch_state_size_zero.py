"""State size 0 (noise-only models and components) in the port: no kernel
wrapper launches and no plain version runs at k = 0, on any device, and the
k = 0 verbs equal the JAX package in float64 on the CPU.

The JAX package leaves k = 0 to XLA (``ppca_rs_tpu/ops/kernels.py``'s
``_kernel_config`` declines k < 1); the port's wrappers answer it in closed
form (``kernels.spd_estep_state_size_zero``, ``spd_chol_state_size_zero``).
The wrappers' device branch is reached here on ``meta`` tensors, which need
no card: before the closed form they went on to ``launch``, which raises.

Where the JAX package itself raises at k = 0 (``infer`` on the pattern
route and of a mixture of (0, 0) components, their samplers, and the
(0, 0) mixture's EM step off the masked route) the reference is the JAX
package on the masked route, the port's per-component loop, or the
sampler's closed form.  Tolerance: 1e-9 relative, the parity budget of
docs/DESIGN.md section 6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppca_rs_tpu as jp
import ppca_rs_tpu_torch as tp
from ppca_rs_tpu_torch import interop
from ppca_rs_tpu_torch.config import config as tconfig
from ppca_rs_tpu_torch.models.routes import route as route_of
from ppca_rs_tpu_torch.ops import kernels as tk

torch.set_num_threads(1)

TOL = 1e-9
ROUTES = ("dense", "pattern", "masked")


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port builds on the card by default; these tests ask for the CPU."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))


@pytest.fixture
def spy(monkeypatch):
    """Records the state size of every launch, every plain-version call and
    every closed-form answer; after the test, none of the first two may
    have seen k = 0."""
    calls = []

    def record(name, fn, k_of):
        def wrapped(*args, **kwargs):
            calls.append((name, k_of(*args, **kwargs)))
            return fn(*args, **kwargs)
        monkeypatch.setattr(tk, name, wrapped)

    record("launch", tk.launch, lambda want, sigma, G, *a, **kw: G.shape[-1])
    record("launch_chol", tk.launch_chol, lambda M, L: M.shape[-1])
    record("spd_estep_reference", tk.spd_estep_reference, lambda sigma, G, *a, **kw: G.shape[-1])
    record("spd_chol_reference", tk.spd_chol_reference, lambda M: M.shape[-1])
    record("spd_estep_state_size_zero", tk.spd_estep_state_size_zero,
           lambda sigma, G, *a, **kw: G.shape[-1])
    record("spd_chol_state_size_zero", tk.spd_chol_state_size_zero, lambda M: M.shape[-1])
    yield calls
    assert not [c for c in calls if c[1] == 0 and not c[0].endswith("state_size_zero")], calls


def closed_form_calls(calls):
    return [name for name, _ in calls if name.endswith("state_size_zero")]


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, rtol=TOL):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if got.size:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


def make_data(rng, route, N=60, D=6):
    """Data zero-filled where masked, its mask and weights for ``route``,
    with a zero-weight row, and an all-masked row off the dense route."""
    data = rng.normal(size=(N, D)) + rng.normal(size=D)
    if route == "dense":
        mask = np.ones((N, D), dtype=bool)
    elif route == "pattern":
        patterns = rng.random((3, D)) > 0.4
        patterns[2] = False
        mask = patterns[rng.integers(0, 3, size=N)]
        mask[:3] = patterns
    else:
        mask = rng.random((N, D)) > 0.3
        mask[4] = False
    weights = rng.random(N) + 0.5
    weights[7] = 0.0
    return np.where(mask, data, 0.0), mask, weights


def both_datasets(data, mask, weights):
    jds = jp.Dataset.from_parts(jnp.asarray(data), jnp.asarray(mask), jnp.asarray(weights))
    return jds, interop.dataset_from_arrays(data, mask, weights)


def jax_masked_route(monkeypatch, data, mask, weights):
    """The same data as a JAX dataset that takes the masked route."""
    monkeypatch.setattr(jp.config, "use_pattern_dedup", False)
    return both_datasets(data, mask, weights)[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("want", tk.KERNELS)
def test_wrappers_answer_state_size_zero_off_the_cpu(want, dtype, monkeypatch):
    """On a tensor that is not on the CPU (``meta``: the device branch, no
    card needed) the wrappers answer k = 0 without reaching ``launch``,
    with the closed form's shapes and no launch counted."""
    def launched(*args, **kwargs):
        raise AssertionError("a kernel was launched at k = 0")

    B, before = 5, dict(tk.LAUNCHES)
    G = torch.empty((B, 0, 0), dtype=dtype, device="meta")
    if want == "chol":
        monkeypatch.setattr(tk, "launch_chol", launched)
        out = (tk.spd_chol(G),)
        shapes = [(B, 0, 0)]
    else:
        monkeypatch.setattr(tk, "launch", launched)
        vec = torch.empty((B,), dtype=dtype, device="meta")
        out = tk.spd_estep(vec, G, torch.empty((B, 0), dtype=dtype, device="meta"),
                           vec, vec, want=want)
        shapes = tk.output_shapes(want, B, 0)
    assert [tuple(o.shape) for o in out] == shapes
    assert all(o.device.type == "meta" and o.dtype == dtype for o in out)
    assert tk.LAUNCHES == before


@pytest.mark.parametrize("want", tk.WANTS)
def test_closed_form_equals_the_plain_version(rng, want):
    """The closed form gives what ``spd_estep_reference`` gives at k = 0,
    with one sigma or one per sample, all-masked samples included."""
    B = 9
    G, b = torch.zeros((B, 0, 0), dtype=torch.float64), torch.zeros((B, 0), dtype=torch.float64)
    rnorm = torch.as_tensor(rng.random(B) * 4.0)
    d_obs = torch.as_tensor(rng.integers(0, 7, size=B).astype(np.float64))
    rnorm[d_obs == 0] = 0.0
    for sigma in (0.7, torch.as_tensor(rng.random(B) + 0.2)):
        got = tk.spd_estep_state_size_zero(sigma, G, b, rnorm, d_obs, want)
        want_ = tk.spd_estep_reference(sigma, G, b, rnorm, d_obs, want)
        assert len(got) == len(want_)
        for g, w in zip(got, want_):
            assert g.shape == w.shape and g.dtype == w.dtype
            torch.testing.assert_close(g, w, rtol=1e-14, atol=0.0)
    assert tk.spd_chol_state_size_zero(G).shape == (B, 0, 0)


@pytest.mark.parametrize("route", ROUTES)
def test_model_verbs_match_jax(rng, route, spy, monkeypatch):
    """A k = 0 model on each route: the EM step, llks, infer, smooth,
    extrapolate and the smoothed variances equal the JAX package's; the
    sampler draws ``mean + sigma z`` from its generator; nothing launches
    and no plain version runs at k = 0."""
    data, mask, weights = make_data(rng, route)
    jds, tds = both_datasets(data, mask, weights)
    assert route_of(tds).kind == route
    D = data.shape[1]
    C0, mean, sigma = np.zeros((D, 0)), rng.normal(size=D), 0.8
    jm = jp.PPCAModel(isotropic_noise=sigma, transform=C0, mean=mean)
    tm = interop.model_from_arrays(C0, mean, sigma)

    jnew, jllk = jm._iterate_with_llk(jds, None)
    tnew, tllk = tm._iterate_with_llk(tds, None)
    assert tuple(tnew.transform.shape) == (D, 0)
    assert tllk == pytest.approx(jllk, rel=TOL)
    close(tnew.mean, jnew.mean)
    assert float(tnew.isotropic_noise) == pytest.approx(float(jnew.isotropic_noise), rel=TOL)
    close(tm.llks(tds), jm.llks(jds))
    close(tm.smooth(tds).numpy(), jm.smooth(jds).numpy())
    close(tm.extrapolate(tds).numpy(), jm.extrapolate(jds).numpy())

    # The JAX package's pattern route cannot infer at k = 0: hold the port
    # against its masked route on the same data.
    jinf = jm.infer(jax_masked_route(monkeypatch, data, mask, weights) if route == "pattern" else jds)
    tinf = tm.infer(tds)
    close(tinf.states(), jinf.states())
    close(tinf.covariances_array(), jinf.covariances_array())
    close(tinf.smoothed_covariances_diagonal(tm).numpy(),
          jinf.smoothed_covariances_diagonal(jm).numpy())
    close(tinf.extrapolated_covariances_diagonal(tm, tds).numpy(),
          jinf.extrapolated_covariances_diagonal(jm, jds).numpy())

    sampler = tinf.posterior_sampler()
    draw = sampler.sample(generator=torch.Generator().manual_seed(5)).data
    z = torch.randn((len(tds), D), generator=torch.Generator().manual_seed(5), dtype=torch.float64)
    close(draw, sigma * z.numpy() + mean, 1e-14)
    assert closed_form_calls(spy)


@pytest.mark.parametrize("ks", [(0, 0), (0, 3)])
@pytest.mark.parametrize("route", ROUTES)
def test_mixture_verbs_match_jax(rng, route, ks, spy):
    """Mixtures of (0, 0) and (0, 3) components on each route: llks,
    infer_cluster, smooth, extrapolate, the posteriors and the EM step
    equal the JAX package's (the (0, 0) EM step off the masked route: the
    port's per-component loop, as the JAX package raises there); the
    posterior sampler's draws average to smooth; no launch and no plain
    version at k = 0, while the k = 3 component takes its plain version."""
    data, mask, weights = make_data(rng, route)
    jds, tds = both_datasets(data, mask, weights)
    D = data.shape[1]
    Cs = [rng.normal(size=(D, k)) for k in ks]
    means = [rng.normal(size=D) for _ in ks]
    noises, lw = [0.6, 0.9], np.log([0.4, 0.6])
    jmix = jp.PPCAMix([jp.PPCAModel(isotropic_noise=s, transform=C, mean=m)
                       for C, m, s in zip(Cs, means, noises)], lw)
    tmix = interop.mix_from_arrays(Cs, means, noises, lw)

    close(tmix.llks(tds), jmix.llks(jds))
    close(tmix.infer_cluster(tds), jmix.infer_cluster(jds))
    close(tmix.smooth(tds).numpy(), jmix.smooth(jds).numpy())
    close(tmix.extrapolate(tds).numpy(), jmix.extrapolate(jds).numpy())
    tinf = tmix.infer(tds)
    close(tinf.log_posteriors(), jmix.infer_cluster(jds))
    if ks == (0, 3):
        jinf = jmix.infer(jds)
        close(tinf.log_posteriors(), jinf.log_posteriors())
        for a, b in zip(tinf.sub_states(), jinf.sub_states()):
            close(a.states(), b.states())
            close(a.covariances_array(), b.covariances_array())
        close(tinf.smoothed_covariances_diagonal(tmix).numpy(),
              jinf.smoothed_covariances_diagonal(jmix).numpy())

    tnew, tllk = tmix._iterate_with_llk(tds, tp.Prior())
    if ks == (0, 0) and route != "masked":
        ref, ref_llk = tmix._iterate_loop(tds, tp.Prior())
    else:
        ref, ref_llk = jmix._iterate_with_llk(jds, jp.Prior())
    assert tnew.state_sizes == list(ref.state_sizes) == list(ks)
    assert tllk == pytest.approx(ref_llk, rel=TOL)
    close(tnew.log_weights, ref.log_weights)
    for a, b in zip(tnew.models, ref.models):
        close(a.transform, b.transform)
        close(a.mean, b.mean)
        assert float(a.isotropic_noise) == pytest.approx(float(b.isotropic_noise), rel=TOL)

    sampler = tinf.posterior_sampler()
    n_draws = 64
    avg = sum(sampler.sample(generator=torch.Generator().manual_seed(20 + s)).data
              for s in range(n_draws)) / n_draws
    assert bool(torch.isfinite(avg).all())
    sd = tinf.smoothed_covariances_diagonal(tmix).data.sqrt()
    assert float(((avg - tmix.smooth(tds).data).abs() / (sd / n_draws ** 0.5)).max()) < 6.0
    assert closed_form_calls(spy)
    if 3 in ks:
        assert any(k == 3 for _, k in spy)


@pytest.mark.parametrize("route", ROUTES)
def test_streamed_iterate_matches_jax(rng, route, spy):
    """A streamed EM step of a k = 0 model and of a (0, 3) mixture over
    three chunks equals the JAX package's ``iterate_streamed`` and
    ``iterate_mix_streamed``, with nothing launched at k = 0."""
    data, mask, weights = make_data(rng, route, N=48)
    jds, tds = both_datasets(data, mask, weights)
    D = data.shape[1]
    mean = rng.normal(size=D)
    jm, jllk = jp.iterate_streamed(jp.PPCAModel(isotropic_noise=0.8, transform=np.zeros((D, 0)),
                                                mean=mean), list(jds.chunks(3)))
    tm, tllk = tp.iterate_streamed(interop.model_from_arrays(np.zeros((D, 0)), mean, 0.8),
                                   list(tds.chunks(3)))
    assert tllk == pytest.approx(jllk, rel=TOL)
    close(tm.mean, jm.mean)
    assert float(tm.isotropic_noise) == pytest.approx(float(jm.isotropic_noise), rel=TOL)

    Cs, means = [np.zeros((D, 0)), rng.normal(size=(D, 3))], [mean, rng.normal(size=D)]
    lw = np.log([0.5, 0.5])
    jmix = jp.PPCAMix([jp.PPCAModel(isotropic_noise=s, transform=C, mean=m)
                       for C, m, s in zip(Cs, means, (0.7, 1.1))], lw)
    jnew, jllk = jp.iterate_mix_streamed(jmix, list(jds.chunks(3)))
    tnew, tllk = tp.iterate_mix_streamed(interop.mix_from_arrays(Cs, means, (0.7, 1.1), lw),
                                         list(tds.chunks(3)))
    assert tllk == pytest.approx(jllk, rel=TOL)
    close(tnew.log_weights, jnew.log_weights)
    for a, b in zip(tnew.models, jnew.models):
        close(a.transform, b.transform)
        close(a.mean, b.mean)
        assert float(a.isotropic_noise) == pytest.approx(float(b.isotropic_noise), rel=TOL)
    assert closed_form_calls(spy)
