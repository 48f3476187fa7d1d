"""The port's sharded path (ppca_rs_tpu_torch.parallel, on torch.distributed)
against the JAX package's sharded and unsharded results, float64 on the CPU.

Each mesh shape -- (4, 1), (2, 2) and (1, 4) -- runs as one 4-rank gloo job:
this file, started by path once per rank (``python test_torch_parallel.py
JOB RANK STORE OUT``), runs the job's scenarios on its rank and writes its
results to ``OUT/JOB_RANK.npz``.  The module fixture starts the three jobs
together, each with a ``file://`` store in the test's temporary directory
(so parallel test workers never race for a port) and its own timeout that
kills every rank, and loads the results; each case then asserts one
comparison.  At module level this file imports numpy, torch and pytest
only, so the ranks never import JAX; the references are computed in the
test process: JAX's sharded result on its 8 virtual CPU devices
(``make_mesh``/``shard_dataset`` with the same mesh shape) and JAX's
unsharded result, with the parameters carried across as numpy arrays.

Tolerances as tests/test_sharding.py: llk 1e-10, parameters 1e-8 relative
(to each quantity's largest magnitude).  The JAX package pads its shards;
the port does not, so a rank's readouts are compared with JAX's rows of
that rank, and readouts concatenated in rank order with JAX's whole rows.
"""

import functools
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
WORLD = 4
MESHES = {"41": (4, 1), "22": (2, 2), "14": (1, 4)}
JOB_TIMEOUT = 240.0
N, D, K = 101, 8, 3
TOL_LLK = 1e-10
TOL = 1e-8
#: shard_dataset_local's rows per rank in the uneven case (N rows in all)
UNEVEN = (40, 20, 31, 10)
#: the streamed chunks' rows (N in all) and the chunks each rank streams
STREAM_ROWS = (13, 9, 17, 11, 20, 8, 12, 11)
STREAM_CHUNKS = ((0, 1, 2), (3,), (4, 5), (6, 7))


# --------------------------------------------------------------------- #
# inputs, made with numpy from seeds on both sides


def masked_data(seed=1, n=N, d=D):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, d)) + rng.normal(size=d)
    mask = rng.random((n, d)) > 0.3
    mask[5] = False                       # an all-masked row
    data[~mask] = np.nan
    return data, rng.random(n) + 0.5


def dense_data(seed=3, n=N, d=D):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)) @ rng.normal(size=(d, d)) * 0.3 + rng.normal(size=d)


def patterned_data(seed=4, n=N, d=D, p=4):
    """Rows from p mask patterns (one of them all-masked), with weights."""
    rng = np.random.default_rng(seed)
    pats = rng.random((p, d)) < 0.6
    pats[0] = False
    data = rng.normal(size=(n, d)) + rng.normal(size=d)
    data[~pats[rng.integers(0, p, size=n)]] = np.nan
    return data, rng.random(n) + 0.5


def uneven_data(seed=6, n=N, d=D):
    """Dimension 3 is missing in every row, dimension 6 only in the rows of
    the first uneven shard: the global empty dimensions are [3]."""
    data, weights = masked_data(seed, n, d)
    data[:, 3] = np.nan
    data[:UNEVEN[0], 6] = np.nan
    return data, weights


def tiny_data(seed=12, n=3, d=D):
    """Three rows: on the (4, 1) mesh the last rank holds none."""
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, d))
    data[rng.random((n, d)) < 0.3] = np.nan
    return data, rng.random(n) + 0.5


def params(seed=2, d=D, k=K):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(d, k)), rng.normal(size=d), 0.4


def mix_params(seed=5, m=3, d=D, k=2):
    rng = np.random.default_rng(seed)
    comps = [(rng.normal(size=(d, k)), rng.normal(size=d), 0.3 + 0.1 * i) for i in range(m)]
    return comps, np.log(np.array([0.5, 0.3, 0.2])[:m])


def prior_args(seed=9, d=D):
    rng = np.random.default_rng(seed)
    return rng.normal(size=d), np.eye(d) * 0.7


def rank_block(job, rank, n=N, d=D):
    """(rows, cols) of a rank's shard under shard_dataset."""
    a, b = MESHES[job]
    i, j = divmod(rank, b)
    per = -(-n // a)
    lo = min(i * per, n)
    return slice(lo, min(lo + per, n)), slice(j * d // b, (j + 1) * d // b)


# --------------------------------------------------------------------- #
# the ranks (run as a script: torch and the port only)


class Rank:
    """One rank's scenarios; ``out`` collects numpy results by name."""

    def __init__(self, mesh):
        import ppca_rs_tpu_torch as tp
        from ppca_rs_tpu_torch import interop, parallel
        from ppca_rs_tpu_torch.parallel import distributed

        self.tp, self.interop, self.parallel, self.distributed = tp, interop, parallel, distributed
        self.mesh, self.out = mesh, {}
        self.f64 = torch.float64

    def put(self, key, value):
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        self.out[key] = np.asarray(value)

    def dataset(self, data, weights=None):
        return self.tp.Dataset(data, weights=weights, dtype=self.f64)

    def model(self, seed=2):
        return self.interop.model_from_arrays(*params(seed))

    def mix(self):
        comps, lw = mix_params()
        return self.interop.mix_from_arrays(*zip(*comps), lw)

    def prior(self, mean=True):
        p = self.tp.Prior().with_isotropic_noise_prior(3.0, 2.0).with_transformation_precision(0.5)
        return p.with_mean_prior(*prior_args()) if mean else p

    def put_model(self, tag, model, llk=None):
        self.put(f"{tag}.C", model.transform)
        self.put(f"{tag}.mean", model.mean)
        self.put(f"{tag}.sigma", model.isotropic_noise)
        if llk is not None:
            self.put(f"{tag}.llk", llk)

    def put_mix(self, tag, mix, llk=None):
        for i, m in enumerate(mix.models):
            self.put_model(f"{tag}.{i}", m)
        self.put(f"{tag}.log_weights", mix.log_weights)
        if llk is not None:
            self.put(f"{tag}.llk", llk)

    # -- every mesh ---------------------------------------------------- #

    def basic(self):
        sds = self.parallel.shard_dataset(self.dataset(*masked_data()), self.mesh)
        model = self.model()
        inferred = model.infer(sds)
        self.put("basic.len", len(sds))
        self.put("basic.output_size", sds.output_size())
        self.put("basic.llks", model.llks(sds))
        self.put("basic.llk", model.llk(sds))
        self.put("basic.states", inferred.states())
        self.put("basic.covs", inferred.covariances_array())
        self.put("basic.smooth", model.smooth(sds).data)
        self.put("basic.extrapolate", model.extrapolate(sds).data)
        new, llk = model._iterate_with_llk(sds, None)
        self.put_model("basic.em", new, llk)
        _, llks = model.iterate_n(sds, 2)
        self.put("basic.em_n", llks)

    def dense(self):
        sds = self.parallel.shard_dataset(self.dataset(dense_data()), self.mesh)
        model = self.model()
        self.put("dense.route", self.tp.models.routes.route(sds).kind)
        self.put("dense.llks", model.llks(sds))
        new, llk = model._iterate_with_llk(sds, self.prior())
        self.put_model("dense.em", new, llk)

    # -- the data axis (4, 1) ------------------------------------------ #

    def mixture(self, tag="mix"):
        sds = self.parallel.shard_dataset(self.dataset(*masked_data(7)), self.mesh)
        mix = self.mix()
        self.put(f"{tag}.llks", mix.llks(sds))
        self.put(f"{tag}.cluster", mix.infer_cluster(sds))
        self.put(f"{tag}.smooth", mix.smooth(sds).data)
        self.put(f"{tag}.llk", mix.llk(sds))
        new, llk = mix._iterate_with_llk(sds, self.prior(mean=False))
        self.put_mix(f"{tag}.em", new, llk)

    def mixture_table(self):
        sds = self.parallel.shard_dataset(self.dataset(*patterned_data()), self.mesh)
        self.put("mixtable.before", sds.pattern_info(include_dense=True) is None)
        self.put("mixtable.P", sds.detect_patterns(include_dense=True)[1].shape[0])
        mix = self.mix()
        self.put("mixtable.llks", mix.llks(sds))
        new, llk = mix._iterate_with_llk(sds, self.prior(mean=False))
        self.put_mix("mixtable.em", new, llk)

    def patterns(self, tag, min_rows):
        from ppca_rs_tpu_torch.config import config

        config.pat_sorted_min_rows = min_rows
        sds = self.parallel.shard_dataset(self.dataset(*patterned_data()), self.mesh)
        self.put(f"{tag}.before", sds.pattern_info() is None)
        self.put(f"{tag}.before_again", sds.pattern_info() is None)   # not cached
        info = sds.detect_patterns()
        self.put(f"{tag}.cached", sds.pattern_info() is info)
        pidx, patterns = info
        self.put(f"{tag}.patterns", patterns)
        self.put(f"{tag}.pidx_ok", bool(torch.equal(patterns[pidx], sds.mask)))
        route = self.tp.models.routes.route(sds)
        self.put(f"{tag}.route", route.kind)
        self.put(f"{tag}.sorted", route.order is not None)
        model = self.model()
        self.put(f"{tag}.llks", model.llks(sds))
        new, llk = model._iterate_with_llk(sds, self.prior())
        self.put_model(f"{tag}.em", new, llk)
        config.pat_sorted_min_rows = 8192

    def uneven(self):
        data, weights = uneven_data()
        rank = torch.distributed.get_rank()
        lo = sum(UNEVEN[:rank])
        rows = slice(lo, lo + UNEVEN[rank])
        sds = self.distributed.shard_dataset_local(self.dataset(data[rows], weights[rows]),
                                                   self.mesh)
        model = self.model()
        self.put("uneven.len", len(sds))
        self.put("uneven.empty", np.asarray(sds.empty_dimensions()))
        self.put("uneven.llks", model.llks(sds))
        self.put("uneven.states", model.infer(sds).states())
        self.put("uneven.extrapolate", model.extrapolate(sds).data)
        new, llk = model._iterate_with_llk(sds, None)
        self.put_model("uneven.em", new, llk)
        start = self.tp.PPCAModel.init(K, sds, generator=torch.Generator().manual_seed(rank))
        self.put("uneven.init", start.transform)

    def stream(self):
        tp = self.tp
        data, weights = masked_data(8)
        bounds = np.cumsum((0,) + STREAM_ROWS)
        rank = torch.distributed.get_rank()
        chunks = [self.dataset(data[bounds[c]:bounds[c + 1]], weights[bounds[c]:bounds[c + 1]])
                  for c in STREAM_CHUNKS[rank]]
        model, metrics = self.model(), []
        trained = tp.StreamingPPCATrainer(chunks, mesh=self.mesh).train(
            start=model, state_size=K, n_iters=3, quiet=True,
            callback=lambda it, m: metrics.append((m.llk, m.aic, m.bic)))
        self.put("stream.metrics", np.asarray(metrics))
        self.put_model("stream.trained", trained)
        self.parallel.placement.reset_counts()
        new, llk = tp.iterate_streamed(model, [lambda c=c: c for c in chunks], mesh=self.mesh)
        self.put("stream.reduces", self.parallel.placement.STATS_REDUCES["calls"])
        self.put_model("stream.step", new, llk)
        # the JAX package's way: every rank streams the same sharded chunks
        sharded = [self.parallel.shard_dataset(self.dataset(data[a:b], weights[a:b]), self.mesh)
                   for a, b in ((0, 40), (40, 101))]
        new, llk = tp.iterate_streamed(model, sharded)
        self.put_model("stream.sharded", new, llk)
        mix, mix_metrics = self.mix(), []
        trained = tp.StreamingPPCAMixTrainer(chunks, mesh=self.mesh).train(
            start=mix, n_models=3, state_size=2, n_iters=2, quiet=True,
            callback=lambda it, m: mix_metrics.append(m.llk))
        self.put("stream.mix_metrics", np.asarray(mix_metrics))
        self.put_mix("stream.mix", trained)

    def trainers(self):
        tp = self.tp
        sds = self.parallel.shard_dataset(self.dataset(*masked_data(10)), self.mesh)
        metrics = []
        trained = tp.PPCATrainer(sds).train(
            start=self.model(), state_size=K, n_iters=4, quiet=True,
            callback=lambda it, m: metrics.append((m.llk, m.aic, m.bic)))
        self.put("trainer.metrics", np.asarray(metrics))
        self.put_model("trainer.model", trained)
        mix_metrics = []
        trained = tp.PPCAMixTrainer(sds).train(
            start=self.mix(), n_models=3, state_size=2, n_iters=2, quiet=True,
            callback=lambda it, m: mix_metrics.append(m.llk))
        self.put("trainer.mix_metrics", np.asarray(mix_metrics))
        self.put_mix("trainer.mix", trained)

    def tiny(self):
        sds = self.parallel.shard_dataset(self.dataset(*tiny_data()), self.mesh)
        self.put("tiny.rows", len(sds.data))
        new, llk = self.model()._iterate_with_llk(sds, self.prior())
        self.put_model("tiny.em", new, llk)
        new, llk = self.mix()._iterate_with_llk(sds, self.prior(mean=False))
        self.put_mix("tiny.mix", new, llk)

    def mesh_errors(self):
        for tag, shape in (("too_big", dict(data=3, model=2)),
                           ("indivisible", dict(model=3))):
            try:
                self.parallel.make_mesh(**shape)
                self.put(f"errors.{tag}", "")
            except ValueError as err:
                self.put(f"errors.{tag}", str(err))

    # -- the model axis (2, 2) ----------------------------------------- #

    def priors(self):
        sds = self.parallel.shard_dataset(self.dataset(*masked_data(11, n=64)), self.mesh)
        new, llk = self.model()._iterate_with_llk(sds, self.prior())
        self.put_model("priors.em", new, llk)

    def exact_rnorm(self):
        from ppca_rs_tpu_torch.config import config

        config.mix_exact_rnorm = True
        self.mixture("exact")
        config.mix_exact_rnorm = False

    def model_axis_rules(self):
        sds = self.parallel.shard_dataset(self.dataset(*patterned_data()), self.mesh)
        self.put("rules.detect", sds.detect_patterns() is None)
        self.put("rules.route", self.tp.models.routes.route(sds).kind)
        for tag, chunks, mesh in (("stream", [sds], None),
                                  ("stream_mesh", [self.dataset(*patterned_data())], self.mesh)):
            try:
                self.tp.iterate_streamed(self.model(), chunks, mesh=mesh)
                self.put(f"rules.{tag}", "")
            except ValueError as err:
                self.put(f"rules.{tag}", str(err))
        odd = self.dataset(np.ones((16, 7)))
        for tag, fn in (("shard", self.parallel.shard_dataset),
                        ("local", self.distributed.shard_dataset_local)):
            try:
                fn(odd, self.mesh)
                self.put(f"rules.{tag}", "")
            except ValueError as err:
                self.put(f"rules.{tag}", str(err))


SCENARIOS = {
    "41": ("basic", "dense", "mixture", "mixture_table", "pattern_table", "pattern_sorted",
           "uneven", "stream", "trainers", "tiny", "mesh_errors"),
    "22": ("basic", "dense", "mixture", "priors", "exact_rnorm", "model_axis_rules",
           "trainers"),
    "14": ("basic", "dense", "mixture", "trainers"),
}


def run_rank(job, rank, store, out_dir):
    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    from ppca_rs_tpu_torch.config import config
    from ppca_rs_tpu_torch.parallel import distributed, make_mesh

    config.device = torch.device("cpu")
    distributed.initialize(init_method=f"file://{store}", world_size=WORLD, rank=rank)
    me = Rank(make_mesh(*MESHES[job]))
    me.put("coords", np.array([torch.distributed.get_rank()]))
    for name in SCENARIOS[job]:
        if name == "pattern_table":
            me.patterns("pattable", 8192)
        elif name == "pattern_sorted":
            me.patterns("patsorted", 0)
        else:
            getattr(me, name)()
        torch.distributed.barrier()
    np.savez(Path(out_dir) / f"{job}_{rank}.npz", **me.out)
    torch.distributed.destroy_process_group()


# --------------------------------------------------------------------- #
# the jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """``{job: [rank 0's results, ...]}``: the three jobs, run together."""
    tmp = tmp_path_factory.mktemp("parallel")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    jobs = {}
    for job in MESHES:
        jobs[job] = []
        for rank in range(WORLD):
            log = open(tmp / f"{job}_{rank}.log", "w")
            proc = subprocess.Popen(
                [sys.executable, __file__, job, str(rank), str(tmp / f"{job}.store"), str(tmp)],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))
            jobs[job].append((proc, log))
    failed = []
    for job, procs in jobs.items():
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
                text = (tmp / f"{job}_{rank}.log").read_text()[-3000:]
                failed.append(f"job {job} rank {rank} exited {proc.returncode}:\n{text}")
    assert not failed, "\n".join(failed)
    return {job: [dict(np.load(tmp / f"{job}_{rank}.npz")) for rank in range(WORLD)]
            for job in MESHES}


# --------------------------------------------------------------------- #
# the JAX references (computed once each)


def jax_mesh(job):
    from ppca_rs_tpu.parallel.mesh import make_mesh

    a, b = MESHES[job]
    return make_mesh(data=a, model=b)


def jax_sharded(job, ds):
    from ppca_rs_tpu.parallel.mesh import shard_dataset

    return shard_dataset(ds, jax_mesh(job))


def jax_model(seed=2):
    import ppca_rs_tpu as jp

    C, mean, noise = params(seed)
    return jp.PPCAModel(isotropic_noise=noise, transform=C, mean=mean)


def jax_mix():
    import ppca_rs_tpu as jp

    comps, lw = mix_params()
    return jp.PPCAMix([jp.PPCAModel(isotropic_noise=s, transform=C, mean=m)
                       for C, m, s in comps], lw)


def jax_prior(mean=True):
    import ppca_rs_tpu as jp

    p = jp.Prior().with_isotropic_noise_prior(3.0, 2.0).with_transformation_precision(0.5)
    return p.with_mean_prior(*prior_args()) if mean else p


def model_arrays(model, llk=None):
    out = {"C": np.asarray(model.transform), "mean": np.asarray(model.mean),
           "sigma": np.asarray(model.isotropic_noise)}
    if llk is not None:
        out["llk"] = np.asarray(llk)
    return out


def em_arrays(model, llk):
    return {f"em.{k}": v for k, v in model_arrays(model, llk).items()}


def mix_arrays(mix, llk=None):
    out = {"log_weights": np.asarray(mix.log_weights)}
    for i, m in enumerate(mix.models):
        out.update({f"{i}.{key}": v for key, v in model_arrays(m).items()})
    if llk is not None:
        out["llk"] = np.asarray(llk)
    return out


@functools.lru_cache(maxsize=None)
def jax_basic(job):
    """The basic scenario on JAX's sharded dataset of the same mesh shape,
    and unsharded."""
    import ppca_rs_tpu as jp

    ds = jp.Dataset(*masked_data())
    out = {}
    for where, dset in (("sharded", jax_sharded(job, jp.Dataset(*masked_data()))),
                        ("single", ds)):
        model = jax_model()
        inferred = model.infer(dset)
        new, llk = model._iterate_with_llk(dset, None)
        _, llks = model.iterate_n(dset, 2)
        out[where] = dict(
            llks=np.asarray(model.llks(dset)), llk=np.asarray(model.llk(dset)),
            states=np.asarray(inferred.states()), covs=np.asarray(inferred.covariances_array()),
            smooth=model.smooth(dset).numpy(), extrapolate=model.extrapolate(dset).numpy(),
            em_n=np.asarray(llks), **em_arrays(new, llk))
    return out


@functools.lru_cache(maxsize=None)
def jax_single(scenario):
    """Unsharded JAX references of the other scenarios."""
    import ppca_rs_tpu as jp

    model = jax_model()
    if scenario == "dense":
        ds = jp.Dataset(dense_data())
        new, llk = model._iterate_with_llk(ds, jax_prior())
        return dict(llks=np.asarray(model.llks(ds)), **em_arrays(new, llk))
    if scenario == "mix":
        ds, mix = jp.Dataset(*masked_data(7)), jax_mix()
        new, llk = mix._iterate_with_llk(ds, jax_prior(mean=False))
        return dict(llks=np.asarray(mix.llks(ds)), cluster=np.asarray(mix.infer_cluster(ds)),
                    smooth=mix.smooth(ds).numpy(), llk_total=np.asarray(mix.llk(ds)),
                    **{f"em.{k}": v for k, v in mix_arrays(new, llk).items()})
    if scenario == "mixtable":
        ds, mix = jp.Dataset(*patterned_data()), jax_mix()
        new, llk = mix._iterate_with_llk(ds, jax_prior(mean=False))
        return dict(llks=np.asarray(mix.llks(ds)), P=ds.pattern_info()[1].shape[0],
                    **{f"em.{k}": v for k, v in mix_arrays(new, llk).items()})
    if scenario == "patterns":
        ds = jp.Dataset(*patterned_data())
        new, llk = model._iterate_with_llk(ds, jax_prior())
        return dict(llks=np.asarray(model.llks(ds)), patterns=np.asarray(ds.pattern_info()[1]),
                    **em_arrays(new, llk))
    if scenario == "uneven":
        ds = jp.Dataset(*uneven_data())
        new, llk = model._iterate_with_llk(ds, None)
        inferred = model.infer(ds)
        return dict(llks=np.asarray(model.llks(ds)), states=np.asarray(inferred.states()),
                    extrapolate=model.extrapolate(ds).numpy(),
                    empty=np.asarray(ds.empty_dimensions()), **em_arrays(new, llk))
    if scenario == "priors":
        ds = jp.Dataset(*masked_data(11, n=64))
        new, llk = model._iterate_with_llk(ds, jax_prior())
        return em_arrays(new, llk)
    if scenario == "tiny":
        ds, mix = jp.Dataset(*tiny_data()), jax_mix()
        new, llk = model._iterate_with_llk(ds, jax_prior())
        new_mix, mix_llk = mix._iterate_with_llk(ds, jax_prior(mean=False))
        return dict(**em_arrays(new, llk),
                    **{f"mix.{k}": v for k, v in mix_arrays(new_mix, mix_llk).items()})
    if scenario == "stream":
        data, weights = masked_data(8)
        bounds = np.cumsum((0,) + STREAM_ROWS)
        chunks = [jp.Dataset(data[a:b], weights=weights[a:b])
                  for a, b in zip(bounds[:-1], bounds[1:])]
        metrics, mix_metrics = [], []
        trained = jp.StreamingPPCATrainer(chunks).train(
            start=model, state_size=K, n_iters=3, quiet=True,
            callback=lambda it, m: metrics.append((m.llk, m.aic, m.bic)))
        new, llk = jp.iterate_streamed(model, chunks)
        mix = jp.StreamingPPCAMixTrainer(chunks).train(
            start=jax_mix(), n_models=3, state_size=2, n_iters=2, quiet=True,
            callback=lambda it, m: mix_metrics.append(m.llk))
        return dict(metrics=np.asarray(metrics), mix_metrics=np.asarray(mix_metrics),
                    **{f"trained.{k}": v for k, v in model_arrays(trained).items()},
                    **{f"step.{k}": v for k, v in model_arrays(new, llk).items()},
                    **{f"mix.{k}": v for k, v in mix_arrays(mix).items()})
    raise KeyError(scenario)


@functools.lru_cache(maxsize=None)
def jax_mixture_sharded(job):
    import ppca_rs_tpu as jp

    sds, mix = jax_sharded(job, jp.Dataset(*masked_data(7))), jax_mix()
    new, llk = mix._iterate_with_llk(sds, jax_prior(mean=False))
    return {f"em.{k}": v for k, v in mix_arrays(new, llk).items()}


@functools.lru_cache(maxsize=None)
def jax_trainers():
    """Both trainers on JAX's (4, 1)-sharded dataset."""
    import ppca_rs_tpu as jp

    sds = jax_sharded("41", jp.Dataset(*masked_data(10)))
    metrics, mix_metrics = [], []
    trained = jp.PPCATrainer(sds).train(
        start=jax_model(), state_size=K, n_iters=4, quiet=True,
        callback=lambda it, m: metrics.append((m.llk, m.aic, m.bic)))
    mix = jp.PPCAMixTrainer(sds).train(
        start=jax_mix(), n_models=3, state_size=2, n_iters=2, quiet=True,
        callback=lambda it, m: mix_metrics.append(m.llk))
    return dict(metrics=np.asarray(metrics), mix_metrics=np.asarray(mix_metrics),
                **{f"model.{k}": v for k, v in model_arrays(trained).items()},
                **{f"mix.{k}": v for k, v in mix_arrays(mix).items()})


# --------------------------------------------------------------------- #
# comparisons


def close(got, want, rtol=TOL):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def close_prefixed(res, prefix, want, want_prefix):
    """Every ``want_prefix + key`` of ``want`` against ``prefix + key`` of
    one rank's results; llks at TOL_LLK."""
    keys = [k for k in want if k.startswith(want_prefix)]
    assert keys
    for key in keys:
        name = key[len(want_prefix):]
        tol = TOL_LLK if name.endswith("llk") else TOL
        close(res[prefix + name], want[key], tol)


@pytest.mark.parametrize("job", list(MESHES))
@pytest.mark.parametrize("verb", ["llks_llk", "infer", "smooth_extrapolate", "em_step"])
def test_sharded_verbs_match_jax(ranks, job, verb):
    """Each mesh, each verb: every rank against JAX's sharded result on the
    same mesh shape (its rows and columns) and JAX's unsharded one."""
    ref = jax_basic(job)
    for rank, res in enumerate(ranks[job]):
        rows, cols = rank_block(job, rank)
        for where in ("sharded", "single"):
            want = ref[where]
            if verb == "llks_llk":
                close(res["basic.llks"], want["llks"][rows], TOL_LLK)
                close(res["basic.llk"], want["llk"], TOL_LLK)
                assert int(res["basic.len"]) == N and int(res["basic.output_size"]) == D
            elif verb == "infer":
                close(res["basic.states"], want["states"][rows])
                close(res["basic.covs"], want["covs"][rows])
            elif verb == "smooth_extrapolate":
                close(res["basic.smooth"], want["smooth"][rows, cols])
                close(res["basic.extrapolate"], want["extrapolate"][rows, cols])
            else:
                close_prefixed(res, "basic.em.", want, "em.")
                close(res["basic.em_n"], want["em_n"], TOL_LLK)


@pytest.mark.parametrize("job", list(MESHES))
def test_ranks_bit_identical(ranks, job):
    """Trained parameters and llk totals are the same bits on every rank."""
    keys = [k for k in ranks[job][0] if k.endswith((".C", ".mean", ".sigma", ".llk",
                                                     ".log_weights", "metrics"))]
    assert keys
    for res in ranks[job][1:]:
        for key in keys:
            assert np.array_equal(res[key], ranks[job][0][key]), key


@pytest.mark.parametrize("job", list(MESHES))
def test_dense_route(ranks, job):
    want = jax_single("dense")
    for rank, res in enumerate(ranks[job]):
        assert str(res["dense.route"]) == "dense"
        close(res["dense.llks"], want["llks"][rank_block(job, rank)[0]], TOL_LLK)
        close_prefixed(res, "dense.em.", want, "em.")


def test_priors_on_the_model_axis(ranks):
    """Noise, transformation and mean priors on the (2, 2) mesh (the mean
    prior gathers the whole mean over the model axis)."""
    want = jax_single("priors")
    for res in ranks["22"]:
        close_prefixed(res, "priors.em.", want, "em.")


@pytest.mark.parametrize("job", list(MESHES))
def test_mixture_general_route(ranks, job):
    """Fused mixture EM (with a noise prior, so the max-combined resp_max
    scaling matters) against JAX sharded and unsharded, and the rank-local
    readouts against JAX's rows."""
    single, sharded = jax_single("mix"), jax_mixture_sharded(job)
    for rank, res in enumerate(ranks[job]):
        rows, cols = rank_block(job, rank)
        close(res["mix.llks"], single["llks"][rows], TOL_LLK)
        close(res["mix.cluster"], single["cluster"][rows])
        close(res["mix.smooth"], single["smooth"][rows, cols])
        close(res["mix.llk"], single["llk_total"], TOL_LLK)
        close_prefixed(res, "mix.em.", single, "em.")
        close_prefixed(res, "mix.em.", sharded, "em.")


def test_mixture_exact_rnorm_on_the_model_axis(ranks):
    """config.mix_exact_rnorm's materialized residual: its deviation norm
    is column-local and is summed over the model axis."""
    single = jax_single("mix")
    for res in ranks["22"]:
        close_prefixed(res, "exact.em.", single, "em.")


def test_mixture_table_route(ranks):
    want = jax_single("mixtable")
    for rank, res in enumerate(ranks["41"]):
        assert bool(res["mixtable.before"]) and int(res["mixtable.P"]) == want["P"]
        close(res["mixtable.llks"], want["llks"][rank_block("41", rank)[0]], TOL_LLK)
        close_prefixed(res, "mixtable.em.", want, "em.")


@pytest.mark.parametrize("tag", ["pattable", "patsorted"])
def test_pattern_route(ranks, tag):
    """The grouped table EM and the per-rank sorted EM against JAX."""
    want = jax_single("patterns")
    for rank, res in enumerate(ranks["41"]):
        assert str(res[f"{tag}.route"]) == "pattern"
        assert bool(res[f"{tag}.sorted"]) == (tag == "patsorted")
        close(res[f"{tag}.llks"], want["llks"][rank_block("41", rank)[0]], TOL_LLK)
        close_prefixed(res, f"{tag}.em.", want, "em.")


def test_pattern_info_waits_for_detect_patterns(ranks):
    """pattern_info() is None, uncached, until the collective
    detect_patterns(); then it returns the cached table, the same on every
    rank and the single-process table (as a set of rows: the JAX package
    orders its table by hash)."""
    want = jax_single("patterns")["patterns"]
    for tag in ("pattable", "patsorted"):
        first = ranks["41"][0][f"{tag}.patterns"]
        for res in ranks["41"]:
            assert bool(res[f"{tag}.before"]) and bool(res[f"{tag}.before_again"])
            assert bool(res[f"{tag}.cached"]) and bool(res[f"{tag}.pidx_ok"])
            assert np.array_equal(res[f"{tag}.patterns"], first)
        assert sorted(map(tuple, first)) == sorted(map(tuple, want))


def test_model_axis_rules(ranks):
    """On the model axis: detection keeps the general route, model-axis
    chunks (and plain chunks streamed over a model-axis mesh) are refused
    with the JAX package's message, and D must divide by the model axis
    size (shard_dataset and shard_dataset_local)."""
    for res in ranks["22"]:
        assert bool(res["rules.detect"]) and str(res["rules.route"]) == "masked"
        for tag in ("stream", "stream_mesh"):
            assert "data-axis sharded only" in str(res[f"rules.{tag}"])
        for tag in ("shard", "local"):
            assert str(res[f"rules.{tag}"]) == (
                "output_size 7 must be divisible by the model axis size 2")


def test_uneven_local_shards(ranks):
    """shard_dataset_local with 40, 20, 31 and 10 rows: global length,
    readouts concatenated in rank order equal JAX's rows, and the EM step."""
    want = jax_single("uneven")
    results = ranks["41"]
    for key in ("llks", "states", "extrapolate"):
        close(np.concatenate([res[f"uneven.{key}"] for res in results]), want[key],
              TOL_LLK if key == "llks" else TOL)
    for res in results:
        assert int(res["uneven.len"]) == N
        close_prefixed(res, "uneven.em.", want, "em.")


def test_global_decisions(ranks):
    """Empty dimensions are decided over all ranks (a dimension empty on one
    rank only is not one), and an initialized model is rank 0's draw on
    every rank, with the empty dimension's row zeroed."""
    want = jax_single("uneven")["empty"]
    init = ranks["41"][0]["uneven.init"]
    assert want.tolist() == [3] and not np.any(init[3]) and np.all(init[6] != 0)
    for res in ranks["41"]:
        assert res["uneven.empty"].tolist() == want.tolist()
        assert np.array_equal(res["uneven.init"], init)


def test_streaming_trainer_with_uneven_chunk_counts(ranks):
    """Ranks streaming 3, 1, 2 and 2 chunks: the trainer's metrics (global
    N) and model against the JAX package's streaming trainer over all 8."""
    want = jax_single("stream")
    for res in ranks["41"]:
        close(res["stream.metrics"], want["metrics"], TOL_LLK)
        close_prefixed(res, "stream.trained.", want, "trained.")


def test_streamed_iteration_one_reduce_per_pass(ranks):
    """One iterate_streamed: exactly one statistics all_reduce per rank, the
    JAX package's streamed iteration; and from data-axis-sharded chunks
    (the JAX package's way) the same iteration."""
    want = jax_single("stream")
    for res in ranks["41"]:
        assert int(res["stream.reduces"]) == 1
        close_prefixed(res, "stream.step.", want, "step.")
        close_prefixed(res, "stream.sharded.", want, "step.")


def test_streaming_mixture_trainer(ranks):
    want = jax_single("stream")
    for res in ranks["41"]:
        close(res["stream.mix_metrics"], want["mix_metrics"], TOL_LLK)
        close_prefixed(res, "stream.mix.", want, "mix.")


@pytest.mark.parametrize("job", list(MESHES))
def test_trainers_end_to_end(ranks, job):
    """PPCATrainer and PPCAMixTrainer on each mesh against the JAX
    package's trainers on its (4, 1)-sharded dataset: per-iteration metrics
    over all N rows, and the final (canonical) models."""
    want = jax_trainers()
    for res in ranks[job]:
        close(res["trainer.metrics"], want["metrics"], TOL_LLK)
        close(res["trainer.mix_metrics"], want["mix_metrics"], TOL_LLK)
        close_prefixed(res, "trainer.model.", want, "model.")
        close_prefixed(res, "trainer.mix.", want, "mix.")


def test_a_rank_without_rows(ranks):
    """Three rows on four ranks: the last holds none, and still takes part
    in the single model's and the mixture's EM steps."""
    want = jax_single("tiny")
    assert [int(res["tiny.rows"]) for res in ranks["41"]] == [1, 1, 1, 0]
    for res in ranks["41"]:
        close_prefixed(res, "tiny.em.", want, "em.")
        close_prefixed(res, "tiny.mix.", want, "mix.")


def test_mixture_statistics_of_no_rows():
    """Regression: mix_fused.mix_em_stats returned None for no rows (a rank
    of a mesh may hold none); it gives zero statistics of the right shapes."""
    from ppca_rs_tpu_torch.ops import mix_fused as mf

    M, d, k = 3, D, 2
    opts = dict(dtype=torch.float64)
    stats = mf.mix_em_stats(torch.randn(M, d, k, **opts), torch.randn(M, d, **opts),
                            torch.ones(M, **opts), torch.zeros(M, **opts),
                            torch.zeros((0, d), **opts), torch.zeros((0, d), dtype=torch.bool),
                            torch.zeros(0, **opts), block_size=16)
    shapes = [(M, d, k), (M, d, k * k), (M,), (M,), (M, d), (M, d), (M,), (M,), ()]
    assert [tuple(x.shape) for x in stats] == shapes
    assert all(not x.any() for x in stats)


def test_make_mesh_errors(ranks):
    for res in ranks["41"]:
        assert str(res["errors.too_big"]) == "mesh 3x2 needs 6 devices, have 4"
        assert str(res["errors.indivisible"]) == "4 devices not divisible by model=3"


if __name__ == "__main__":
    run_rank(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4])
