"""The seam between the port's layers: one route module, one placement.

``models/routes.route`` alone picks a dataset's route, for a resident
dataset and for a streamed chunk alike, and ``parallel/placement`` alone
knows where a dataset lives, so a sharded dataset runs the same verb bodies
as a local one.  Three checks hold that in place:

* a streamed chunk takes ``routes.route``'s route with no sorted copy, and
  its statistics are ``routes.em_stats``'s on that route, in the JAX
  package's values (float64, the suite's 1e-9);
* the lower layers (``ops/``, ``parallel/``) import nothing of the layers
  above them (``models``, ``streaming``, ``trainer``);
* a dataset sharded over a world of one gives the local dataset's EM step
  and readouts bit for bit, for a single model and a mixture.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import ppca_rs_tpu as jp
import ppca_rs_tpu_torch as tp
from ppca_rs_tpu import streaming as jstreaming
from ppca_rs_tpu_torch import interop, streaming
from ppca_rs_tpu_torch.config import config as tconfig
from ppca_rs_tpu_torch.models import routes
from ppca_rs_tpu_torch.parallel import distributed, placement
from ppca_rs_tpu_torch.parallel import mesh as pmesh

torch.set_num_threads(1)

TOL = 1e-9
PACKAGE = Path(tp.__file__).resolve().parent
LOWER = ("ops", "parallel")
UPPER = ("models", "streaming", "trainer")


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    """The port builds on the card by default; these tests ask for the CPU."""
    monkeypatch.setattr(tconfig, "device", torch.device("cpu"))


def np_(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want):
    got, want = np_(got), np_(want)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * max(1.0, np.abs(want).max()))


def chunk_data(rng, kind, n=32, d=6):
    """``n`` x ``d`` rows: fully observed, two repeating masks, or holes at
    random (too many distinct masks for the pattern route)."""
    data = rng.normal(size=(n, d)) + rng.normal(size=d)
    if kind == "pattern":
        masks = rng.random((2, d)) < 0.4
        data[masks[rng.integers(0, 2, size=n)]] = np.nan
    elif kind == "masked":
        data[rng.random((n, d)) < 0.3] = np.nan
    return data


# --------------------------------------------------------------------- #
# a streamed chunk's route and statistics


@pytest.mark.parametrize("kind", ["dense", "pattern", "masked"])
def test_streamed_chunk_takes_the_route_rule(rng, kind, monkeypatch):
    """The streamed step hands each chunk to ``routes.em_stats`` on
    ``routes.route(chunk, sort=False)``: the resident rule, without the
    sorted copy a resident dataset of the same rows would take.  Its
    statistics are that call's, and the JAX package's for the chunk."""
    monkeypatch.setattr(tconfig, "pat_sorted_min_rows", 0)
    data = chunk_data(rng, kind)
    chunk = tp.Dataset(data, dtype=torch.float64)
    C, mean, noise = rng.normal(size=(6, 2)), rng.normal(size=6), 0.5
    tm = interop.model_from_arrays(C, mean, noise)
    jm = jp.PPCAModel(isotropic_noise=noise, transform=C, mean=mean)

    seen = []
    inner = routes.em_stats

    def spy(way, *args, **kw):
        stats = inner(way, *args, **kw)
        seen.append((way, stats))
        return stats

    monkeypatch.setattr(routes, "em_stats", spy)
    t_new, t_llk = tp.iterate_streamed(tm, [chunk])
    monkeypatch.setattr(routes, "em_stats", inner)

    (way, stats), = seen
    rule = routes.route(chunk, sort=False)
    assert way.kind == rule.kind == kind
    assert way.order is None
    if kind == "pattern":
        assert way.pattern is rule.pattern
        assert routes.route(chunk).order is not None      # resident rows would be sorted
    want = inner(rule, *tm._params(), chunk, tm._block_rows(chunk))
    for got_field, want_field in zip(stats, want):
        assert torch.equal(got_field, want_field)

    # in the common form the pass sums, against the JAX package's chunk statistics
    jchunk = jp.Dataset(data)
    got, ref = streaming._chunk_stats(tm, chunk), jstreaming._chunk_stats(jm, jchunk)
    for name in ("cross", "square_error", "dev_sq", "total_dev", "totals", "llk"):
        close(getattr(got, name), getattr(ref, name))
    lower = np.tril(np.ones((2, 2), dtype=bool)).reshape(-1)
    close(np_(got.S)[:, lower], np_(ref.S)[:, lower])
    j_new, j_llk = jp.iterate_streamed(jm, [jchunk])
    assert t_llk == pytest.approx(j_llk, rel=TOL)
    close(t_new.transform, j_new.transform)
    close(t_new.mean, j_new.mean)
    assert float(t_new.isotropic_noise) == pytest.approx(float(j_new.isotropic_noise), rel=TOL)


# --------------------------------------------------------------------- #
# the import arrows point down


def imported_modules(path: Path, source=None):
    """The dotted names a module of the package imports (``source``, or
    the file at ``path``), relative imports resolved against its package:
    ``from .. import x`` names ``package`` and ``package.x``."""
    package = path.relative_to(PACKAGE.parent).with_suffix("").parts[:-1]
    for node in ast.walk(ast.parse(path.read_text() if source is None else source)):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] if node.level else ()
            module = ".".join(base + tuple(filter(None, (node.module or "").split("."))))
            yield module
            yield from (f"{module}.{alias.name}" for alias in node.names)


def upper_imports(path: Path, source=None):
    above = [f"{PACKAGE.name}.{name}" for name in UPPER]
    return sorted({m for m in imported_modules(path, source)
                   if any(m == a or m.startswith(a + ".") for a in above)})


LOWER_FILES = sorted(p for layer in LOWER for p in (PACKAGE / layer).glob("*.py"))


@pytest.mark.parametrize("path", LOWER_FILES, ids=lambda p: f"{p.parent.name}/{p.name}")
def test_lower_layers_import_nothing_above(path):
    bad = upper_imports(path)
    assert not bad, f"{path.relative_to(PACKAGE)} imports {bad}"


@pytest.mark.parametrize("line", ["from ..models import routes", "from .. import streaming",
                                  "import ppca_rs_tpu_torch.trainer",
                                  "from ppca_rs_tpu_torch.models.mix import PPCAMix"])
def test_the_import_check_sees_each_form(line):
    """Each way a lower module could name a layer above is caught, also
    inside a function; the lower layers' own imports are not."""
    probe = PACKAGE / "ops" / "probe.py"
    assert upper_imports(probe, f"def f():\n    {line}\n")
    assert not upper_imports(probe, "from . import kernels\nfrom ..config import config\n")


# --------------------------------------------------------------------- #
# one body for a sharded and a local dataset


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of this process alone, torn down after the test."""
    distributed.initialize(init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        yield pmesh.make_mesh()
    finally:
        dist.destroy_process_group()


def same(got, want):
    assert torch.equal(torch.as_tensor(got), torch.as_tensor(want))


@pytest.mark.parametrize("data_kind", ["masked", "pattern", "dense"])
@pytest.mark.parametrize("model_kind", ["model", "mixture"])
def test_world_of_one_is_the_local_dataset(rng, world_of_one, model_kind, data_kind):
    """The EM step, ``llks``, ``infer`` and ``extrapolate`` of a dataset
    sharded over a world of one equal the local dataset's bit for bit: the
    placement's reduction, row sum and gather change no bit, and the route
    is the same."""
    data = chunk_data(rng, data_kind, n=48)
    local = tp.Dataset(data, weights=rng.random(48) + 0.5, dtype=torch.float64)
    sharded = pmesh.shard_dataset(local, world_of_one)
    where = placement.place(sharded)
    assert where.mesh is world_of_one and where.group is None
    assert placement.place(local) is placement.LOCAL
    prior = tp.Prior().with_isotropic_noise_prior(3.0, 2.0).with_transformation_precision(0.5)
    if model_kind == "model":
        sharded.detect_patterns()
        model = interop.model_from_arrays(rng.normal(size=(6, 2)), rng.normal(size=6), 0.5)
        assert routes.route(sharded).kind == routes.route(local).kind == data_kind
    else:
        sharded.detect_patterns(include_dense=True)
        model = interop.mix_from_arrays([rng.normal(size=(6, k)) for k in (2, 3)],
                                        [rng.normal(size=6) for _ in range(2)], [0.5, 0.7],
                                        np.log([0.4, 0.6]))
        kind = routes.route(local, mixture=True).kind
        assert routes.route(sharded, mixture=True).kind == kind
        assert kind == ("masked" if data_kind == "masked" else "pattern")

    placement.reset_counts()
    (new_s, llk_s), (new_l, llk_l) = model._em_step(sharded, prior), model._em_step(local, prior)
    assert placement.STATS_REDUCES["calls"] == (1 if model_kind == "model" else 2)
    same(llk_s, llk_l)
    same(model.llk(sharded), model.llk(local))
    same(model.llks(sharded), model.llks(local))
    same(model.extrapolate(sharded).data, model.extrapolate(local).data)
    if model_kind == "model":
        for a, b in zip(new_s._params(), new_l._params()):
            same(a, b)
        inf_s, inf_l = model.infer(sharded), model.infer(local)
        same(inf_s.states(), inf_l.states())
        same(inf_s.covariances_array(), inf_l.covariances_array())
    else:
        same(new_s.log_weights, new_l.log_weights)
        for a, b in zip(new_s.models, new_l.models):
            for x, y in zip(a._params(), b._params()):
                same(x, y)
        same(model.infer_cluster(sharded), model.infer_cluster(local))
        inf_s, inf_l = model.infer(sharded), model.infer(local)
        same(inf_s.log_posteriors(), inf_l.log_posteriors())
        for a, b in zip(inf_s.sub_states(), inf_l.sub_states()):
            same(a.states(), b.states())
            same(a.covariances_array(), b.covariances_array())
