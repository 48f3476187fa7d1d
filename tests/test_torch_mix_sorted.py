"""The port's per-segment mixture EM (ops/mix_fused.mix_em_stats_pat_sorted)
against the JAX package's, against the port's table-grouped EM, and its
routing, float64 on the CPU.

Both packages get the same numpy inputs from a seed.  The rows come from P
mask patterns: one fully observed, one all-masked, one with no rows (an
empty segment); the weights are not 1 and one is 0.  The masked entries of
the sorted data hold garbage (77.7), which no statistic may read.
``pat_sorted_min_rows`` is lowered on each package's config where a test
needs the sorted route at these sizes.  Tolerance: 1e-9 relative.

The sharded cases run this file as a script, once per rank (``python
test_torch_mix_sorted.py WORLD RANK STORE OUT``), in gloo jobs of two and
four ranks on a data-axis mesh; each rank writes its results to
``OUT/WORLD_RANK.npz``, and the test compares them with one process.  At
module level this file imports numpy, torch and pytest only, so the ranks
never import JAX.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-9
N, D, P = 311, 24, 6
#: the state sizes of each case's components (padded to the largest)
CASES = {"equal": (3, 3, 3), "hetero": (4, 1, 2), "zero_k": (3, 0, 2)}
WORLDS = (2, 4)
JOB_TIMEOUT = 180.0
F64 = torch.float64


# --------------------------------------------------------------------- #
# inputs, made with numpy from seeds


def patterned(seed=0, n=N, d=D, p=P):
    """(values with NaN holes, mask, pattern index, patterns, weights):
    pattern 0 all-masked, pattern 1 fully observed, pattern 2 without rows."""
    rng = np.random.default_rng(seed)
    pats = rng.random((p, d)) < 0.55
    pats[0], pats[1] = False, True
    pidx = rng.integers(0, p, size=n)
    pidx = np.where(pidx == 2, 3, pidx)
    pidx[:2] = (0, 1)
    mask = pats[pidx]
    data = rng.normal(size=(n, d)) + 2.0 * rng.normal(size=(1, d)) * (rng.random((n, 1)) < 0.5)
    weights = rng.random(n) + 0.25
    weights[5] = 0.0
    return np.where(mask, data, np.nan), mask, pidx, pats, weights


def mix_params(ks, seed=1, d=D):
    """numpy (transforms, means, noises, log_weights) of a mixture with state
    sizes ``ks``."""
    rng = np.random.default_rng(seed)
    return ([rng.normal(size=(d, k)) for k in ks], [rng.normal(size=d) for _ in ks],
            [0.5 + 0.2 * i for i in range(len(ks))], np.log(rng.dirichlet(np.ones(len(ks)))))


def stacked(params):
    """(Cs zero-padded to the largest k, means, sigmas, log_weights)."""
    Cs, means, noises, lw = params
    kmax = max(C.shape[1] for C in Cs)
    return (np.stack([np.pad(C, ((0, 0), (0, kmax - C.shape[1]))) for C in Cs]),
            np.stack(means), np.asarray(noises), np.asarray(lw))


def sorted_inputs(values, pidx, weights, p=P):
    """(data sorted by pattern with garbage at masked entries, weights
    sorted, counts)."""
    perm = np.argsort(pidx, kind="stable")
    garbage = np.where(np.isfinite(values), values, 77.7)
    return garbage[perm], weights[perm], tuple(int(c) for c in np.bincount(pidx, minlength=p))


# --------------------------------------------------------------------- #
# the ranks (run as a script: torch and the port only)


def run_rank(world, rank, store, out_dir):
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    import ppca_rs_tpu_torch as tp
    from ppca_rs_tpu_torch import interop, parallel
    from ppca_rs_tpu_torch.config import config
    from ppca_rs_tpu_torch.ops import mix_fused as mf
    from ppca_rs_tpu_torch.parallel import distributed

    config.device = torch.device("cpu")
    config.pat_sorted_min_rows = 0
    distributed.initialize(init_method=f"file://{store}", world_size=world, rank=rank)
    mesh = parallel.make_mesh(world, 1)
    values, _, _, _, weights = patterned(2)
    sds = parallel.shard_dataset(tp.Dataset(values, weights=weights, dtype=F64), mesh)
    sds.detect_patterns(include_dense=True)
    calls = []
    inner = mf.mix_em_stats_pat_sorted
    mf.mix_em_stats_pat_sorted = lambda *a, **kw: (calls.append(1), inner(*a, **kw))[1]
    mix = interop.mix_from_arrays(*mix_params(CASES["hetero"], 3))
    out = {}
    parallel.placement.reset_counts()
    new, llk = mix._iterate_with_llk(sds, tp.Prior().with_isotropic_noise_prior(3.0, 2.0))
    out["reduces"] = parallel.placement.STATS_REDUCES["calls"]
    out["step"] = flat(new, llk)
    _, out["llks"] = mix.iterate_n(sds, 2)
    out["trained"] = flat(tp.PPCAMixTrainer(sds).train(start=mix, n_models=3, state_size=4,
                                                        n_iters=2, quiet=True))
    out["sorted_calls"] = len(calls)
    np.savez(Path(out_dir) / f"{world}_{rank}.npz",
             **{k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in out.items()})
    torch.distributed.destroy_process_group()


def flat(mix, llk=None):
    """Every parameter of a mixture (and an llk) as one float64 vector."""
    parts = [np.asarray(mix.log_weights, np.float64).reshape(-1)]
    for m in mix.models:
        parts += [np.asarray(m.transform, np.float64).reshape(-1),
                  np.asarray(m.mean, np.float64).reshape(-1),
                  np.asarray(m.isotropic_noise, np.float64).reshape(-1)]
    if llk is not None:
        parts.append(np.asarray([float(llk)]))
    return np.concatenate(parts)


# --------------------------------------------------------------------- #
# the tests


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    from ppca_rs_tpu_torch.config import config

    monkeypatch.setattr(config, "device", torch.device("cpu"))


def close(got, want, rtol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = np.abs(want).max() if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, scale))


def T(a):
    return torch.as_tensor(a)


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_sorted_statistics_match_jax(case, exact, monkeypatch):
    """Every MixEMStats field of the port's per-segment EM against the JAX
    package's, with ``mix_exact_rnorm`` off and on in both packages."""
    import jax.numpy as jnp
    from ppca_rs_tpu.config import config as jconfig
    from ppca_rs_tpu.ops import mix_fused as jmf
    from ppca_rs_tpu_torch.config import config as tconfig
    from ppca_rs_tpu_torch.ops import mix_fused as tmf

    monkeypatch.setattr(jconfig, "mix_exact_rnorm", exact)
    monkeypatch.setattr(tconfig, "mix_exact_rnorm", exact)
    values, _, pidx, pats, weights = patterned()
    params = stacked(mix_params(CASES[case]))
    data_s, w_s, counts = sorted_inputs(values, pidx, weights)
    want = jmf.mix_em_stats_pat_sorted(*map(jnp.asarray, params), jnp.asarray(data_s),
                                       jnp.asarray(w_s), jnp.asarray(pats), counts,
                                       block_size=64)
    got = tmf.mix_em_stats_pat_sorted(*map(T, params), T(data_s), T(w_s), T(pats), counts,
                                      block_size=64)
    assert counts[2] == 0 and counts[1] > 0
    for name in want._fields:
        close(getattr(got, name), getattr(want, name))


@pytest.mark.parametrize("case", [*CASES, "all_zero_k", "exact"])
def test_sorted_statistics_match_the_table_route(case, monkeypatch):
    """The per-segment EM is an exact regrouping of the port's
    table-grouped EM, blocks of 40 rows against 64, also when every
    component has state size 0 (which the JAX table route does not take)."""
    from ppca_rs_tpu_torch.config import config as tconfig
    from ppca_rs_tpu_torch.ops import mix_fused as tmf

    monkeypatch.setattr(tconfig, "mix_exact_rnorm", case == "exact")
    ks = {"all_zero_k": (0, 0), "exact": CASES["hetero"]}.get(case) or CASES[case]
    values, mask, pidx, pats, weights = patterned(4)
    params = [T(a) for a in stacked(mix_params(ks, 5))]
    want = tmf.mix_em_stats_pat(*params, T(np.nan_to_num(values, nan=0.0)), T(mask), T(pidx),
                                T(pats), T(weights), block_size=64)
    data_s, w_s, counts = sorted_inputs(values, pidx, weights)
    got = tmf.mix_em_stats_pat_sorted(*params, T(data_s), T(w_s), T(pats), counts, block_size=40)
    for name in want._fields:
        close(getattr(got, name), getattr(want, name))


def test_counts_must_partition_the_rows():
    from ppca_rs_tpu_torch.ops import mix_fused as tmf

    values, _, pidx, pats, weights = patterned()
    params = [T(a) for a in stacked(mix_params(CASES["equal"]))]
    data_s, w_s, counts = sorted_inputs(values, pidx, weights)
    with pytest.raises(ValueError, match="do not partition"):
        tmf.mix_em_stats_pat_sorted(*params, T(data_s), T(w_s), T(pats), counts[:-1],
                                    block_size=64)


def both(values, weights, ks, seed):
    import jax.numpy as jnp
    import ppca_rs_tpu as jp
    import ppca_rs_tpu_torch as tp
    from ppca_rs_tpu_torch import interop

    Cs, means, noises, lw = mix_params(ks, seed)
    jmix = jp.PPCAMix([jp.PPCAModel(isotropic_noise=s, transform=C, mean=m)
                       for C, m, s in zip(Cs, means, noises)], jnp.asarray(lw))
    return ((jp.Dataset(values, weights=weights), jmix),
            (tp.Dataset(values, weights=weights, dtype=F64), interop.mix_from_arrays(*mix_params(ks, seed))))


def assert_mix_close(tmix, jmix):
    close(tmix.log_weights, jmix.log_weights)
    for a, b in zip(tmix.models, jmix.models):
        close(a.transform, b.transform)
        close(a.mean, b.mean)
        close(a.isotropic_noise, b.isotropic_noise)


@pytest.mark.parametrize("sorted_route", [True, False])
@pytest.mark.parametrize("verb", ["iterate", "iterate_n", "trainer"])
def test_routing_follows_pattern_order(verb, sorted_route, monkeypatch):
    """``PPCAMix.iterate``, ``iterate_n`` and ``PPCAMixTrainer.train`` take
    the per-segment EM exactly when ``Dataset.pattern_order`` applies (the
    gate lowered to 0 rows a segment, or left at its default), and the
    trained mixture equals the JAX package's, which routes by the same
    rule."""
    import ppca_rs_tpu as jp
    import ppca_rs_tpu_torch as tp
    from ppca_rs_tpu.config import config as jconfig
    from ppca_rs_tpu_torch.config import config as tconfig
    from ppca_rs_tpu_torch.ops import mix_fused as tmf

    if sorted_route:
        monkeypatch.setattr(jconfig, "pat_sorted_min_rows", 0)
        monkeypatch.setattr(tconfig, "pat_sorted_min_rows", 0)
    values, _, _, _, weights = patterned(6)
    (jds, jmix), (tds, tmix) = both(values, weights, CASES["hetero"], 7)
    assert (tds.pattern_order() is not None) == sorted_route
    assert (jds.pattern_order() is not None) == sorted_route
    calls = {"sorted": 0, "table": 0}
    for name, key in (("mix_em_stats_pat_sorted", "sorted"), ("mix_em_stats_pat", "table")):
        inner = getattr(tmf, name)
        monkeypatch.setattr(tmf, name, lambda *a, _f=inner, _k=key, **kw: (
            calls.__setitem__(_k, calls[_k] + 1), _f(*a, **kw))[1])
    prior_t, prior_j = (p.with_isotropic_noise_prior(3.0, 2.0) for p in (tp.Prior(), jp.Prior()))
    if verb == "iterate":
        got, want = tmix.iterate_with_prior(tds, prior_t), jmix.iterate_with_prior(jds, prior_j)
    elif verb == "iterate_n":
        (got, llks), (want, jllks) = tmix.iterate_n(tds, 3), jmix.iterate_n(jds, 3)
        close(llks, jllks)
    else:
        got = tp.PPCAMixTrainer(tds).train(start=tmix, n_models=3, state_size=4, n_iters=3,
                                           quiet=True)
        want = jp.PPCAMixTrainer(jds).train(start=jmix, n_models=3, state_size=4, n_iters=3,
                                            quiet=True)
    n_steps = {"iterate": 1, "iterate_n": 3, "trainer": 3}[verb]
    assert calls == ({"sorted": n_steps, "table": 0} if sorted_route
                     else {"sorted": 0, "table": n_steps})
    assert_mix_close(got, want)


def test_weights_are_sorted_on_every_call(monkeypatch):
    """A ``with_weights`` twin shares the sorted copy, and its EM step uses
    its own weights: the same step as a fresh dataset with them."""
    import ppca_rs_tpu_torch as tp
    from ppca_rs_tpu_torch import interop
    from ppca_rs_tpu_torch.config import config as tconfig

    monkeypatch.setattr(tconfig, "pat_sorted_min_rows", 0)
    values, _, _, _, weights = patterned(8)
    ds = tp.Dataset(values, weights=weights, dtype=F64)
    mix = interop.mix_from_arrays(*mix_params(CASES["equal"], 9))
    mix._iterate_with_llk(ds, None)
    new_w = np.random.default_rng(10).random(N) + 0.1
    twin = ds.with_weights(new_w)
    assert twin.pattern_order() is ds.pattern_order()
    got, got_llk = mix._iterate_with_llk(twin, None)
    want, want_llk = mix._iterate_with_llk(tp.Dataset(values, weights=new_w, dtype=F64), None)
    assert got_llk == pytest.approx(want_llk, rel=TOL)
    assert_mix_close(got, want)


def test_streamed_chunks_keep_the_table_route(monkeypatch):
    """A streamed chunk takes no sorted copy of its rows, as in the JAX
    package: the streamed iteration runs the table-grouped EM and equals
    the resident iteration, which runs per segment."""
    import ppca_rs_tpu_torch as tp
    from ppca_rs_tpu_torch import interop
    from ppca_rs_tpu_torch.config import config as tconfig
    from ppca_rs_tpu_torch.ops import mix_fused as tmf

    monkeypatch.setattr(tconfig, "pat_sorted_min_rows", 0)
    values, _, _, _, weights = patterned(11)
    ds = tp.Dataset(values, weights=weights, dtype=F64)
    mix = interop.mix_from_arrays(*mix_params(CASES["equal"], 12))
    calls = []
    inner = tmf.mix_em_stats_pat_sorted
    monkeypatch.setattr(tmf, "mix_em_stats_pat_sorted",
                        lambda *a, **kw: (calls.append(1), inner(*a, **kw))[1])
    streamed, llk = tp.iterate_mix_streamed(mix, [ds])
    assert not calls
    resident, resident_llk = mix._iterate_with_llk(ds, None)
    assert calls == [1]
    assert llk == pytest.approx(resident_llk, rel=TOL)
    assert_mix_close(streamed, resident)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``{world: [rank 0's results, ...]}``: a job of two and one of four
    gloo ranks, run together."""
    tmp = tmp_path_factory.mktemp("mix_sorted")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    jobs = {world: [] for world in WORLDS}
    for world in WORLDS:
        for rank in range(world):
            log = open(tmp / f"{world}_{rank}.log", "w")
            proc = subprocess.Popen(
                [sys.executable, __file__, str(world), str(rank), str(tmp / f"{world}.store"),
                 str(tmp)], stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))
            jobs[world].append((proc, log))
    failed = []
    for world, procs in jobs.items():
        deadline = time.monotonic() + JOB_TIMEOUT
        for proc, log in procs:
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for p, _ in procs:
                    p.kill()
                    p.wait()
            log.close()
        for rank, (proc, _) in enumerate(procs):
            if proc.returncode != 0:
                text = (tmp / f"{world}_{rank}.log").read_text()[-3000:]
                failed.append(f"job of {world} rank {rank} exited {proc.returncode}:\n{text}")
    assert not failed, "\n".join(failed)
    return {world: [dict(np.load(tmp / f"{world}_{rank}.npz")) for rank in range(world)]
            for world in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_sorted_route_matches_one_process(ranks, world, monkeypatch):
    """Each rank sorts its own rows against the global table and sums its
    statistics per segment; one step (with a noise prior), ``iterate_n``
    and the trainer equal one process's, every rank bit for bit, with the
    mixture's two statistics all_reduces a step (sum and max)."""
    import ppca_rs_tpu_torch as tp
    from ppca_rs_tpu_torch import interop
    from ppca_rs_tpu_torch.config import config as tconfig

    monkeypatch.setattr(tconfig, "pat_sorted_min_rows", 0)
    values, _, _, _, weights = patterned(2)
    ds = tp.Dataset(values, weights=weights, dtype=F64)
    mix = interop.mix_from_arrays(*mix_params(CASES["hetero"], 3))
    from ppca_rs_tpu_torch.models import routes

    assert routes.route(ds, mixture=True).order is not None
    new, llk = mix._iterate_with_llk(ds, tp.Prior().with_isotropic_noise_prior(3.0, 2.0))
    _, llks = mix.iterate_n(ds, 2)
    trained = tp.PPCAMixTrainer(ds).train(start=mix, n_models=3, state_size=4, n_iters=2,
                                          quiet=True)
    res = ranks[world]
    for r in res:
        assert int(r["sorted_calls"]) == 5          # 1 step + 2 iterate_n + 2 trainer
        assert int(r["reduces"]) == 2
        for key in ("step", "llks", "trained"):
            np.testing.assert_array_equal(r[key], res[0][key])
    close(res[0]["step"], flat(new, llk))
    close(res[0]["llks"], llks)
    close(res[0]["trained"], flat(trained))


if __name__ == "__main__":
    run_rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
