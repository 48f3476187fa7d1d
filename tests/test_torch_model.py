"""The port's model, dataset and trainer (ppca_rs_tpu_torch) against the JAX
package, both in float64 on the CPU, plus the brute-force reference
(tests/reference_impl.py) and cross-package dump/load.

Both packages get identical state: numpy inputs from a seed, and the port's
parameters through ppca_rs_tpu_torch.interop.  Tolerance: 1e-9 relative,
the parity budget of docs/DESIGN.md section 6, also after five EM
iterations.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppca_rs_tpu as jp
import ppca_rs_tpu_torch as tp
from ppca_rs_tpu_torch import interop
from ppca_rs_tpu_torch.ops import kernels as tk
from ppca_rs_tpu_torch.config import Config
from ppca_rs_tpu_torch.config import config as tconfig

import reference_impl as ref  # tests/ is on sys.path under pytest

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port builds on the card by default; these tests ask for the CPU."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))

F64 = torch.float64


def make_data(rng, N=120, D=8, k=2, missing=0.3):
    C = rng.normal(size=(D, k)) * np.array([2.0, 0.7][:k] + [1.0] * max(0, k - 2))
    mean = rng.normal(size=D)
    data = rng.normal(size=(N, k)) @ C.T + mean + 0.4 * rng.normal(size=(N, D))
    mask = rng.random((N, D)) > missing
    mask[3] = False                      # an all-masked row
    data = np.where(mask, data, 0.0)
    weights = rng.random(N) + 0.5
    weights[11] = 0.0                    # a zero-weight row
    return data, mask, weights


def both_datasets(data, mask, weights):
    jds = jp.Dataset.from_parts(jnp.asarray(data), jnp.asarray(mask), jnp.asarray(weights))
    tds = interop.dataset_from_arrays(data, mask, weights)
    return jds, tds


def start_params(rng, D, k):
    return rng.normal(size=(D, k)), rng.normal(size=D) * 0.1, 1.3


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, rtol):
    got, want = np_(got), np_(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, np.abs(want).max()))


@pytest.fixture
def trained(rng):
    """Five trainer iterations in both packages from the same start."""
    D, k = 8, 2
    data, mask, weights = make_data(rng, D=D, k=k)
    jds, tds = both_datasets(data, mask, weights)
    C0, mu0, s0 = start_params(rng, D, k)
    j_hist, t_hist = [], []
    jm = jp.PPCATrainer(jds).train(
        start=jp.PPCAModel(isotropic_noise=s0, transform=C0, mean=mu0), state_size=k,
        n_iters=5, quiet=True, callback=lambda i, m: j_hist.append(m))
    tm = tp.PPCATrainer(tds).train(
        start=interop.model_from_arrays(C0, mu0, s0), state_size=k,
        n_iters=5, quiet=True, callback=lambda i, m: t_hist.append(m))
    return dict(jm=jm, tm=tm, jds=jds, tds=tds, j_hist=j_hist, t_hist=t_hist,
                data=data, mask=mask)


def test_train_metrics_match(trained):
    assert len(trained["t_hist"]) == 5
    for tmet, jmet in zip(trained["t_hist"], trained["j_hist"]):
        for f in ("llk", "aic", "bic"):
            assert getattr(tmet, f) == pytest.approx(getattr(jmet, f), rel=1e-9)
    llks = [m.llk for m in trained["t_hist"]]
    assert all(b >= a - 1e-12 for a, b in zip(llks, llks[1:]))


def test_trained_params_match(trained):
    """Final (canonical) parameters agree."""
    jm, tm = trained["jm"], trained["tm"]
    assert tm.transform.dtype == F64
    close(tm.transform, jm.transform, 1e-9)
    close(tm.mean, jm.mean, 1e-9)
    assert float(tm.isotropic_noise) == pytest.approx(jm.isotropic_noise, rel=1e-9)
    close(tm.singular_values, jm.singular_values, 1e-9)
    assert tm.n_parameters == jm.n_parameters


def test_trained_llk_and_readouts_match(trained):
    jm, tm, jds, tds = trained["jm"], trained["tm"], trained["jds"], trained["tds"]
    assert tm.llk(tds) == pytest.approx(jm.llk(jds), rel=1e-9)
    close(tm.llks(tds), jm.llks(jds), 1e-9)
    ti, ji = tm.infer(tds), jm.infer(jds)
    close(ti.states(), ji.states(), 1e-9)
    close(ti.covariances_array(), ji.covariances_array(), 1e-9)
    close(ti.second_moments_array(), ji.second_moments_array(), 1e-9)
    close(ti.smoothed_covariances_diagonal(tm).numpy(),
          ji.smoothed_covariances_diagonal(jm).numpy(), 1e-9)
    close(ti.extrapolated_covariances_diagonal(tm, tds).numpy(),
          ji.extrapolated_covariances_diagonal(jm, jds).numpy(), 1e-9)
    close(torch.stack(ti.smoothed_covariances(tm)[:5]),
          np.stack(ji.smoothed_covariances(jm)[:5]), 1e-9)
    close(torch.stack(ti.extrapolated_covariances(tm, tds)[:5]),
          np.stack(ji.extrapolated_covariances(jm, jds)[:5]), 1e-9)
    close(ti.smoothed(tm).numpy(), ji.smoothed(jm).numpy(), 1e-9)
    close(ti.extrapolated(tm, tds).numpy(), ji.extrapolated(jm, jds).numpy(), 1e-9)
    close(tm.smooth(tds).numpy(), jm.smooth(jds).numpy(), 1e-9)
    close(tm.extrapolate(tds).numpy(), jm.extrapolate(jds).numpy(), 1e-9)
    np.testing.assert_array_equal(tm.smooth(tds).weights, jds.weights)


def test_trainer_canonical_matches_to_canonical(trained):
    tm = trained["tm"]
    again = tm.to_canonical()
    close(again.transform, tm.transform, 1e-12)
    gram = (tm.transform.T @ tm.transform).numpy()
    np.testing.assert_allclose(gram - np.diag(np.diag(gram)), 0.0, atol=1e-10)
    assert (tm.transform.sum(0) >= 0).all()


@pytest.mark.parametrize("prior", ["none", "all"])
def test_one_step_matches_reference_impl(rng, prior):
    """One (MAP-)EM step against the brute-force per-sample reference."""
    D, k = 7, 3
    data, mask, weights = make_data(rng, N=60, D=D, k=k)
    C0, mu0, s0 = start_params(rng, D, k)
    model = interop.model_from_arrays(C0, mu0, s0)
    tds = interop.dataset_from_arrays(data, mask, weights)
    kw, tprior = {}, None
    if prior == "all":
        pm, pcov = rng.normal(size=D), np.eye(D) * 2.0
        tprior = (tp.Prior().with_mean_prior(pm, pcov).with_isotropic_noise_prior(2.0, 0.3)
                  .with_transformation_precision(0.5))
        kw = dict(transformation_precision=0.5, noise_prior=(2.0, 0.3),
                  mean_prior=(pm, np.linalg.inv(pcov)))
    new = model.iterate(tds) if tprior is None else model.iterate_with_prior(tds, tprior)
    C1, mu1, s1 = ref.em_iterate(C0, mu0, s0, data, mask, weights, **kw)
    close(new.transform, C1, 1e-9)
    close(new.mean, mu1, 1e-9)
    assert float(new.isotropic_noise) == pytest.approx(s1, rel=1e-9)
    want_llk = sum(w * ref.llk_one(C0, mu0, s0, y, m) for y, m, w in zip(data, mask, weights))
    assert model.llk(tds) == pytest.approx(want_llk, rel=1e-9)
    s_ref, cov_ref = zip(*(ref.infer_one(C0, mu0, s0, y, m) for y, m in zip(data, mask)))
    inferred = model.infer(tds)
    close(inferred.states(), np.stack(s_ref), 1e-9)
    close(inferred.covariances_array(), np.stack(cov_ref), 1e-9)
    diag_ref = [ref.extrapolated_cov_diag_one(C0, s0, c, m) for c, m in zip(cov_ref, mask)]
    close(inferred.extrapolated_covariances_diagonal(model, tds).numpy(), np.stack(diag_ref), 1e-9)


@pytest.mark.parametrize("prior", ["none", "all"])
def test_prior_tensors_are_made_once(monkeypatch, prior):
    """The M-step's prior tensors are made on the first step for a (dtype,
    device) and read from then on, the flat prior's too: a later step
    neither fills a tensor nor copies one (on the card, a launch or a copy
    that waits for the stream)."""
    from ppca_rs_tpu_torch.models.ppca import device_priors

    tprior = None
    if prior == "all":
        tprior = (tp.Prior().with_mean_prior(np.ones(4), np.eye(4) * 2.0)
                  .with_isotropic_noise_prior(2.0, 0.3).with_transformation_precision(0.5))
    like = torch.zeros((4, 2), dtype=F64)
    first = device_priors(tprior, like)
    assert float(first["transformation_precision"]) == (0.5 if tprior else 0.0)
    assert (first["mean_prior"] is None) == (tprior is None)

    def made(*args, **kwargs):
        raise AssertionError("a prior tensor was made again")

    for name in ("full", "as_tensor", "tensor"):
        monkeypatch.setattr(torch, name, made)
    again = device_priors(tprior, like)
    assert all(again[name] is first[name] for name in first)


def test_iterate_n_equals_repeated_iterate(rng):
    data, mask, weights = make_data(rng)
    tds = interop.dataset_from_arrays(data, mask, weights)
    model = interop.model_from_arrays(*start_params(rng, 8, 2))
    n_model, llks = model.iterate_n(tds, 3)
    m, want = model, []
    for _ in range(3):
        m, llk = m._iterate_with_llk(tds, None)
        want.append(llk)
    close(n_model.transform, m.transform, 1e-14)
    close(llks, np.asarray(want), 1e-14)
    assert model.iterate_n(tds, 0)[1].shape == (0,)


def test_model_dump_loads_across_packages(rng):
    C0, mu0, s0 = start_params(rng, 6, 2)
    jm = jp.PPCAModel(isotropic_noise=s0, transform=C0, mean=mu0)
    from_j = tp.PPCAModel.load(jm.dump(), dtype=F64)
    close(from_j.transform, C0, 0)
    close(from_j.mean, mu0, 0)
    assert float(from_j.isotropic_noise) == s0
    back = jp.PPCAModel.load(from_j.dump())
    np.testing.assert_array_equal(back.transform, C0)
    np.testing.assert_array_equal(back.mean, mu0)
    assert back.isotropic_noise == s0
    with pytest.raises(ValueError, match="expected 'ppca_model'"):
        tp.PPCAModel.load(jp.Dataset(np.ones((2, 2))).dump())


def test_dataset_dump_loads_across_packages(rng):
    data, mask, weights = make_data(rng, N=20, D=5)
    jds, tds = both_datasets(data, mask, weights)
    from_j = tp.Dataset.load(jds.dump(), dtype=F64)
    np.testing.assert_array_equal(from_j.numpy(), jds.numpy())
    np.testing.assert_array_equal(from_j.weights, jds.weights)
    back = jp.Dataset.load(tds.dump())
    np.testing.assert_array_equal(back.numpy(), tds.numpy())
    np.testing.assert_array_equal(back.weights, tds.weights)


def test_pickle_round_trips(rng):
    C0, mu0, s0 = start_params(rng, 6, 2)
    model = interop.model_from_arrays(C0, mu0, s0)
    again = pickle.loads(pickle.dumps(model))
    close(again.transform, C0, 1e-7)
    data, mask, weights = make_data(rng, N=20, D=6)
    ds = interop.dataset_from_arrays(data, mask, weights)
    ds2 = pickle.loads(pickle.dumps(ds))
    np.testing.assert_allclose(ds2.numpy(), ds.numpy(), rtol=1e-7)


def test_dataset_basics():
    arr = np.array([[1.0, np.nan, 3.0], [np.inf, np.nan, 2.0], [0.5, np.nan, -1.0]])
    ds = tp.Dataset(arr, weights=[1.0, 2.0, 0.5], dtype=F64)
    assert len(ds) == 3 and ds.output_size() == 3 and not ds.is_empty()
    assert ds.empty_dimensions() == [1]
    assert not ds.all_observed()
    np.testing.assert_array_equal(ds.numpy(), np.where(np.isfinite(arr), arr, np.nan))
    np.testing.assert_array_equal(ds.weights, [1.0, 2.0, 0.5])
    np.testing.assert_array_equal(ds.weights(), [1.0, 2.0, 0.5])
    assert float(ds.data[1, 0]) == 0.0 and not bool(ds.mask[1, 0])
    w2 = ds.with_weights([3.0, 3.0, 3.0])
    assert w2.data is ds.data and list(w2.weights) == [3.0, 3.0, 3.0]
    sl = ds.slice(1, 10)
    assert len(sl) == 2 and list(sl.weights) == [2.0, 0.5]
    un = tp.Dataset.unmasked(np.ones((4, 2)))
    assert un.all_observed() and un.empty_dimensions() == []
    assert ds.to("cpu").device.type == "cpu"
    empty = tp.Dataset(np.zeros((0, 3)))
    assert empty.is_empty() and empty.output_size() is None and empty.empty_dimensions() == []
    with pytest.raises(ValueError):
        tp.Dataset(np.ones(3))
    with pytest.raises(ValueError):
        tp.Dataset(np.ones((2, 2)), weights=[1.0])


def test_init_zeroes_empty_dimensions_and_is_seeded(rng):
    data, mask, weights = make_data(rng, N=30, D=6)
    mask[:, 2] = False
    tds = interop.dataset_from_arrays(np.where(mask, data, 0.0), mask, weights)
    g = torch.Generator().manual_seed(5)
    m1 = tp.PPCAModel.init(3, tds, generator=g)
    m2 = tp.PPCAModel.init(3, tds, generator=torch.Generator().manual_seed(5))
    assert m1.transform.shape == (6, 3) and m1.transform.dtype == F64
    np.testing.assert_array_equal(m1.transform[2].numpy(), 0.0)
    torch.testing.assert_close(m1.transform, m2.transform)
    assert float(m1.isotropic_noise) == 1.0 and not m1.mean.any()
    tp.seed(3)
    a = tp.PPCAModel.init(3, tds).transform
    tp.seed(3)
    torch.testing.assert_close(tp.PPCAModel.init(3, tds).transform, a)
    with pytest.raises(ValueError):
        tp.PPCAModel.init(2, tp.Dataset(np.zeros((0, 3))))


def test_sample_shapes_and_mask_rate():
    model = tp.PPCAModel(isotropic_noise=0.1, transform=np.ones((5, 2)), mean=np.arange(5.0),
                         dtype=F64)
    ds = model.sample(4000, mask_prob=0.3, generator=torch.Generator().manual_seed(0))
    assert ds.data.shape == (4000, 5)
    assert abs(float(ds.mask.double().mean()) - 0.7) < 0.03
    assert float(ds.data[~ds.mask].abs().max()) == 0.0


def test_trainer_checkpoint_and_printout(rng, tmp_path, capsys):
    data, mask, weights = make_data(rng)
    tds = interop.dataset_from_arrays(data, mask, weights)
    path = tmp_path / "model.bin"
    model = tp.PPCATrainer(tds).train(
        state_size=2, n_iters=3, metric="bic", checkpoint_path=str(path), checkpoint_every=2,
        generator=torch.Generator().manual_seed(1))
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == [f"Masked PPCA iteration {i}" for i in (1, 2, 3)]
    assert all("bic=" in line for line in out)
    saved = tp.PPCAModel.load(path.read_bytes(), dtype=F64)
    # the checkpoint holds the last iterate; the trainer returns it canonicalized
    close(saved.to_canonical().transform, model.transform, 1e-12)


def test_main_path_never_launches_on_cpu(rng):
    data, mask, weights = make_data(rng)
    tds = interop.dataset_from_arrays(data, mask, weights)
    tk.reset_launch_counts()
    model = tp.PPCATrainer(tds).train(state_size=2, n_iters=2, quiet=True)
    model.infer(tds).posterior_sampler()
    model.smooth(tds)
    assert tk.LAUNCHES == {name: 0 for name in tk.KERNELS}


def test_model_constructor_and_module():
    with pytest.raises(TypeError):
        tp.PPCAModel(transform=np.ones((3, 2)), mean=np.zeros(3))
    with pytest.raises(ValueError):
        tp.PPCAModel(isotropic_noise=1.0, transform=np.ones((3, 2)), mean=np.zeros(4))
    m = tp.PPCAModel(isotropic_noise=0.5, transform=np.ones((3, 2)), mean=np.zeros((1, 3)))
    assert isinstance(m, torch.nn.Module)
    assert set(dict(m.named_buffers())) == {"transform", "mean", "isotropic_noise"}
    assert m.transform.dtype == tp.config.dtype and m.device.type == "cpu"
    inferred = m.infer(tp.Dataset(np.full((3, 3), np.nan)))   # all-masked rows
    np.testing.assert_allclose(inferred.covariances_array().numpy(),
                               np.broadcast_to(np.eye(2), (3, 2, 2)), atol=1e-6)
    assert len(inferred) == 3 and len(inferred.covariances()) == 3
    assert len(inferred.second_moments()) == 3


def test_config_defaults_to_the_card():
    assert Config().device.type == "cuda"


@pytest.mark.parametrize("build", [
    "Dataset", "from_parts", "unmasked", "Dataset.load", "PPCAModel", "PPCAModel.load",
    "model_from_arrays", "dataset_from_arrays",
])
def test_host_arrays_without_a_card_raise(monkeypatch, build):
    """With the default device and no card, building from host arrays
    raises: nothing falls back to the CPU unless the caller asks for it."""
    arr = np.ones((4, 3))
    C, mean = np.ones((3, 2)), np.zeros(3)
    dumped = {"Dataset.load": tp.Dataset(arr, device="cpu").dump(),
              "PPCAModel.load": tp.PPCAModel(1.0, C, mean, device="cpu").dump()}
    calls = {
        "Dataset": lambda: tp.Dataset(arr),
        "from_parts": lambda: tp.Dataset.from_parts(arr, arr > 0),
        "unmasked": lambda: tp.Dataset.unmasked(arr),
        "Dataset.load": lambda: tp.Dataset.load(dumped["Dataset.load"]),
        "PPCAModel": lambda: tp.PPCAModel(1.0, C, mean),
        "PPCAModel.load": lambda: tp.PPCAModel.load(dumped["PPCAModel.load"]),
        "model_from_arrays": lambda: interop.model_from_arrays(C, mean, 1.0),
        "dataset_from_arrays": lambda: interop.dataset_from_arrays(arr, arr > 0),
    }
    monkeypatch.setattr(tconfig, "device", Config().device)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[build]()


def test_from_parts_honours_config_device(monkeypatch):
    """Host arrays go to config.device; tensors keep their own device."""
    arr = np.arange(6.0).reshape(3, 2)
    monkeypatch.setattr(tconfig, "device", torch.device("meta"))
    ds = tp.Dataset.from_parts(arr, arr > 1, np.ones(3))
    assert ds.device.type == "meta" and ds.mask.device.type == "meta"
    assert ds.weights_dev.device.type == "meta"
    assert tp.Dataset.unmasked(arr).device.type == "meta"
    kept = tp.Dataset.from_parts(torch.from_numpy(arr), torch.from_numpy(arr > 1))
    assert kept.device.type == "cpu" and kept.mask.device.type == "cpu"


def zero_state_data(rng, route, N=40, D=5):
    """(data zero-filled where masked, mask, weights) that take ``route``;
    a zero-weight row."""
    data = rng.normal(size=(N, D)) + rng.normal(size=D)
    if route == "dense":
        mask = np.ones((N, D), dtype=bool)
    elif route == "pattern":
        patterns = rng.random((3, D)) > 0.4
        mask = patterns[rng.integers(0, 3, size=N)]
        mask[:3] = patterns
    else:
        mask = rng.random((N, D)) > 0.3
    weights = rng.random(N) + 0.5
    weights[7] = 0.0
    return np.where(mask, data, 0.0), mask, weights


ZERO_ROUTES = ("dense", "pattern", "masked")


@pytest.mark.parametrize("route", ZERO_ROUTES)
def test_state_size_zero_iterates_like_jax(rng, route):
    """State size 0 (a noise-only model) on each route: one EM iteration
    gives the JAX package's finite model (the masked and pattern routes
    used to fail reshaping 0 elements)."""
    from ppca_rs_tpu_torch.models import routes

    data, mask, weights = zero_state_data(rng, route)
    jds, tds = both_datasets(data, mask, weights)
    assert routes.route(tds).kind == route
    C0, mean = np.zeros((data.shape[1], 0)), rng.normal(size=data.shape[1])
    jm, jllk = jp.PPCAModel(isotropic_noise=0.8, transform=C0, mean=mean)._iterate_with_llk(jds, None)
    tm, tllk = interop.model_from_arrays(C0, mean, 0.8)._iterate_with_llk(tds, None)
    assert tuple(tm.transform.shape) == (data.shape[1], 0)
    assert np.isfinite(tllk) and tllk == pytest.approx(jllk, rel=1e-9)
    close(tm.mean, jm.mean, 1e-9)
    assert float(tm.isotropic_noise) == pytest.approx(jm.isotropic_noise, rel=1e-9)


def test_state_size_zero_pattern_infer_matches_masked(rng, monkeypatch):
    """Pattern-route ``infer`` at state size 0 answers as the masked route
    does: (N, 0) states and (N, 0, 0) covariances (the JAX package's
    pattern route raises here, so the masked route is the reference)."""
    from ppca_rs_tpu_torch.models import routes

    data, mask, weights = zero_state_data(rng, "pattern")
    tds = interop.dataset_from_arrays(data, mask, weights)
    model = interop.model_from_arrays(np.zeros((data.shape[1], 0)), np.zeros(data.shape[1]), 0.8)
    assert routes.route(tds).kind == "pattern"
    pat = model.infer(tds)
    monkeypatch.setattr(tconfig, "use_pattern_dedup", False)
    plain = interop.dataset_from_arrays(data, mask, weights)
    assert routes.route(plain).kind == "masked"
    masked = model.infer(plain)
    n = data.shape[0]
    assert tuple(pat.states().shape) == tuple(masked.states().shape) == (n, 0)
    assert tuple(pat.covariances_array().shape) == tuple(masked.covariances_array().shape) == (n, 0, 0)


@pytest.mark.parametrize("route", ZERO_ROUTES)
def test_state_size_zero_streams_like_jax(rng, route):
    """A streamed iteration at state size 0 on each route's chunks gives the
    JAX package's ``iterate_streamed`` (the dense chunks' second moments
    are reshaped with an explicit row count)."""
    data, mask, weights = zero_state_data(rng, route, N=48)
    jds, tds = both_datasets(data, mask, weights)
    C0, mean = np.zeros((data.shape[1], 0)), rng.normal(size=data.shape[1])
    jm, jllk = jp.iterate_streamed(jp.PPCAModel(isotropic_noise=0.8, transform=C0, mean=mean),
                                   list(jds.chunks(2)))
    tm, tllk = tp.iterate_streamed(interop.model_from_arrays(C0, mean, 0.8), list(tds.chunks(2)))
    assert tllk == pytest.approx(jllk, rel=1e-9)
    close(tm.mean, jm.mean, 1e-9)
    assert float(tm.isotropic_noise) == pytest.approx(jm.isotropic_noise, rel=1e-9)
