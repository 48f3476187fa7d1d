"""The port's masked path at k=128, the tile's widest state size, on the
CPU: one masked EM step, the llks and the posteriors held against the JAX
package in float64 at the suite's 1e-9 (the kernels' plain versions run on
the CPU).  The tile's own steps are transcribed and held against the plain
versions and numpy in ``test_torch_panel_numerics.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ppca_rs_tpu as jp
from ppca_rs_tpu_torch import interop
from ppca_rs_tpu_torch.config import config as tconfig

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port builds on the card by default; these tests ask for the CPU."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))


def test_em_step_at_k128_matches_jax(rng):
    """One masked EM step, the llks and the posteriors at k=128 (the tile's
    widest), port against the JAX package in float64."""
    N, D, k = 256, 160, 128
    C = rng.normal(size=(D, k)) / np.sqrt(k)
    mean = rng.normal(size=D)
    data = rng.normal(size=(N, k)) @ C.T + mean + 0.5 * rng.normal(size=(N, D))
    mask = rng.random((N, D)) > 0.5
    data = np.where(mask, data, 0.0)
    C0 = C + 0.1 * rng.normal(size=(D, k))
    tds = interop.dataset_from_arrays(data, mask)
    assert tds.pattern_info() is None
    jds = jp.Dataset.from_parts(jnp.asarray(data), jnp.asarray(mask))
    tm = interop.model_from_arrays(C0, mean, 0.8)
    jm = jp.PPCAModel(isotropic_noise=0.8, transform=C0, mean=mean)

    def close(got, want):
        got, want = np.asarray(got), np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * max(1.0, np.abs(want).max()))

    tn, jn = tm.iterate(tds), jm.iterate(jds)
    close(tn.transform.numpy(), jn.transform)
    close(tn.mean.numpy(), jn.mean)
    assert float(tn.isotropic_noise) == pytest.approx(float(jn.isotropic_noise), rel=1e-9)
    close(tm.llks(tds).numpy(), jm.llks(jds))
    ti, ji = tm.infer(tds), jm.infer(jds)
    close(ti.states().numpy(), ji.states())
    close(ti.covariances_array().numpy(), ji.covariances_array())
