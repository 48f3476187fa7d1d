"""fullt's SM is defined on and below the diagonal only.

On the card the E-step kernels write ``"fullt"``'s SM on and below the
diagonal and leave everything above it as the output buffer held it
(``csrc/spd_estep.cu``; the TPU kernel's contract).  Here, on the CPU, the
plain version stands in for the kernel with the same contract: a wrapper
fills SM above the diagonal with NaN, as unwritten device memory may hold
it.  One EM step on each route that launches fullt -- the masked route, the
general mixture route, a streamed masked iteration over two chunks, and
the placed step (``parallel/placement``) in a world of one -- must then
still equal the JAX package's in float64 at the suite's 1e-9: every
consumer takes S from its lower triangle alone.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import ppca_rs_tpu as jp
import ppca_rs_tpu_torch as tp
from ppca_rs_tpu_torch import interop
from ppca_rs_tpu_torch.config import config as tconfig
from ppca_rs_tpu_torch.ops import kernels as tk
from ppca_rs_tpu_torch.models import routes
from ppca_rs_tpu_torch.parallel import distributed, placement
from ppca_rs_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

TOL = 1e-9
N, D, K, MISSING = 120, 8, 3, 0.4
ROUTES = ("masked", "mixture", "streamed", "parallel")


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port builds on the card by default; these tests ask for the CPU."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))


@pytest.fixture
def nan_above(monkeypatch):
    """The plain version with the kernel's fullt contract: SM above the
    diagonal is NaN.  Returns the list of fullt batch sizes it served."""
    plain = tk.spd_estep_reference
    served = []

    def card_like(sigma, G, b, rnorm, d_obs, want="fullt"):
        out = plain(sigma, G, b, rnorm, d_obs, want)
        if want != "fullt":
            return out
        s, SM, llk, sq = out
        k = SM.shape[-1]
        above = torch.ones(k, k, dtype=torch.bool).triu(1)
        SM = SM.clone()
        SM[:, above] = float("nan")
        served.append(SM.shape[0])
        return s, SM, llk, sq

    monkeypatch.setattr(tk, "spd_estep_reference", card_like)
    return served


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want):
    got, want = np_(got), np_(want)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(1.0, np.abs(want).max()))


def close_models(t, j):
    close(t.transform, j.transform)
    close(t.mean, j.mean)
    assert float(t.isotropic_noise) == pytest.approx(float(j.isotropic_noise), rel=TOL)


def make_data(rng):
    """N x D rows with MISSING of the entries missing at random: too many
    distinct masks for the pattern route, so they take the masked route."""
    data = rng.normal(size=(N, K)) @ rng.normal(size=(K, D)) + rng.normal(size=(N, D))
    data[rng.random((N, D)) < MISSING] = np.nan
    return data


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of this process alone, torn down after the test."""
    distributed.initialize(init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        yield pmesh.make_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("route", ROUTES)
def test_one_em_step_reads_only_the_lower_triangle(route, rng, nan_above, request):
    data = make_data(rng)
    jds = jp.Dataset(data)
    tds = tp.Dataset(data, dtype=torch.float64)
    C, mean, noise = rng.normal(size=(D, K)), rng.normal(size=D), 0.6
    jm = jp.PPCAModel(isotropic_noise=noise, transform=C, mean=mean)
    tm = interop.model_from_arrays(C, mean, noise)

    if route == "masked":
        close_models(tm.iterate(tds), jm.iterate(jds))
    elif route == "mixture":
        Cs = [rng.normal(size=(D, K)) for _ in range(2)]
        means = [rng.normal(size=D) for _ in Cs]
        noises, logw = [0.5, 0.7], np.log([0.4, 0.6])
        jmix = jp.PPCAMix([jp.PPCAModel(isotropic_noise=s, transform=c, mean=mu)
                           for c, mu, s in zip(Cs, means, noises)], logw)
        tmix = interop.mix_from_arrays(Cs, means, noises, logw)
        tnew, jnew = tmix.iterate(tds), jmix.iterate(jds)
        for a, b in zip(tnew.models, jnew.models):
            close_models(a, b)
        close(tnew.log_weights, jnew.log_weights)
    elif route == "streamed":
        half = N // 2
        tchunks = [tp.Dataset(data[:half], dtype=torch.float64),
                   tp.Dataset(data[half:], dtype=torch.float64)]
        jchunks = [jp.Dataset(data[:half]), jp.Dataset(data[half:])]
        t_new, t_llk = tp.iterate_streamed(tm, tchunks)
        j_new, j_llk = jp.iterate_streamed(jm, jchunks)
        close_models(t_new, j_new)
        assert t_llk == pytest.approx(j_llk, rel=TOL)
    else:
        mesh = request.getfixturevalue("world_of_one")
        sds = pmesh.shard_dataset(tds, mesh)
        tprec, noise_prior, mean_prior = tp.Prior().device_pieces(torch.float64, torch.device("cpu"))
        priors = dict(transformation_precision=tprec, noise_prior=noise_prior,
                      mean_prior=mean_prior)
        # one step through the seam PPCAModel._em_step runs, in blocks of 32 rows
        where, way = placement.place(sds), routes.route(sds)
        Cl, meanl = where.columns(torch.from_numpy(C), torch.from_numpy(mean))
        sigma = torch.tensor(noise, dtype=torch.float64)
        stats = where.reduce(routes.em_stats(way, Cl, meanl, sigma, sds, 32, where.group))
        new_C, new_mean, new_sigma = routes.em_finalize(way, Cl, meanl, sigma, stats, priors,
                                                        where.group)
        new_C, new_mean = where.gather(new_C, new_mean)
        assert where.mesh is mesh
        want = jm.iterate(jds)
        close(new_C, want.transform)
        close(new_mean, want.mean)
        assert float(new_sigma) == pytest.approx(float(want.isotropic_noise), rel=TOL)
    assert nan_above, f"the {route} route launched no fullt"
