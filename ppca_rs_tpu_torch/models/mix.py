"""PPCA mixture models, on torch tensors.

Port of ``ppca_rs_tpu/models/mix.py`` (a rebuild of `ppca/src/mix.rs`) for
one device.  A mixture of :class:`PPCAModel` components with log-domain
prior weights; components may differ in state size but share the output
size (`mix.rs:41-64`).

Every N-sized computation is fused across components (``ops/mix_fused``):
EM, the per-component llks, infer, smooth and extrapolate are each ONE pass
over the data whatever M is.  Each verb has one body: where the dataset
lives comes from ``parallel/placement.place``, which route its rows take
(the table route or the general one, the EM per pattern segment when the
rows sorted by pattern are available) from ``models/routes.route`` with
``mixture=True``.  Heterogeneous state sizes ride the same pass
zero-padded to the largest k (:meth:`PPCAMix._stacked_params`).  The
reference-shaped per-component loop (:meth:`PPCAMix._iterate_loop`) stays
as the independent implementation the fused step is tested against.

On a sharded dataset readouts give this rank's rows; the llk and the EM
steps cover all rows and are the same on every rank.  Its table route needs
``detect_patterns(include_dense=True)`` first.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import config
from ..dataset import Dataset
from ..ops import masked_linalg as ml
from ..ops import mix_fused as mf
from ..parallel.placement import LOCAL, Placement, place
from ..prior import Prior
from ..utils.profiling import span
from ..utils.rng import ensure_generator
from ..utils.serialization import dump_bytes, load_bytes
from . import routes
from .ppca import (InferredMasked, PosteriorSampler, PPCAModel, device_priors,
                   extrapolated_cov_diag, smoothed_cov_diag, smoothed_cov_full)


class PPCAMix:
    """A mixture of PPCA models (`mix.rs:27-347`).  ``log_weights`` are
    normalized (log-softmax) on construction."""

    __slots__ = ("_models", "_log_weights", "_output_size")

    def __init__(self, models: List[PPCAModel], log_weights):
        models = list(models)
        if not models:
            raise ValueError("mixture must have at least one component")
        sizes = [m.output_size for m in models]
        if len(set(sizes)) != 1:
            raise ValueError(f"Model output sizes are not the same: {sizes}")
        if len({m.device for m in models}) != 1:
            raise ValueError("mixture components must lie on one device")
        first = models[0].transform
        lw = torch.as_tensor(log_weights, dtype=first.dtype, device=first.device).reshape(-1)
        if lw.shape[0] != len(models):
            raise ValueError("log_weights length must match number of models")
        self._models = models
        self._output_size = sizes[0]
        self._log_weights = torch.log_softmax(lw, 0)

    @staticmethod
    def init(n_models: int, state_size: int, dataset: Dataset,
             generator: Optional[torch.Generator] = None) -> "PPCAMix":
        """``n_models`` random untrained components (:meth:`PPCAModel.init`,
        drawn in turn from one generator), uniform weights (`mix.rs:76-83`)."""
        gen = ensure_generator(generator, dataset.device)
        return PPCAMix([PPCAModel.init(state_size, dataset, generator=gen)
                        for _ in range(n_models)], np.zeros(n_models))

    # ------------------------------------------------------------------ #
    # accessors (mix.rs:85-119)

    @property
    def output_size(self) -> int:
        return self._output_size

    @property
    def state_sizes(self) -> List[int]:
        return [m.state_size for m in self._models]

    @property
    def n_parameters(self) -> int:
        """Component parameters plus the M-1 free mixture weights
        (`mix.rs:96-104`)."""
        return sum(m.n_parameters for m in self._models) + len(self._models) - 1

    @property
    def models(self) -> List[PPCAModel]:
        return list(self._models)

    @property
    def log_weights(self) -> torch.Tensor:
        return self._log_weights

    @property
    def weights(self) -> torch.Tensor:
        return torch.exp(self._log_weights)

    @property
    def device(self) -> torch.device:
        return self._log_weights.device

    def __repr__(self) -> str:
        return f"PPCAMix(n_models={len(self._models)}, state_sizes={self.state_sizes})"

    # ------------------------------------------------------------------ #
    # serialization: the JAX package's "ppca_mix" container

    def dump(self) -> bytes:
        def host(t):
            return t.detach().cpu().to(torch.float64).numpy()

        arrays = {"log_weights": host(self._log_weights)}
        for i, m in enumerate(self._models):
            arrays[f"transform_{i}"] = host(m.transform)
            arrays[f"mean_{i}"] = host(m.mean)
            arrays[f"isotropic_noise_{i}"] = host(m.isotropic_noise)
        return dump_bytes("ppca_mix", arrays, {"n_models": len(self._models)})

    @staticmethod
    def load(data: bytes, *, device=None, dtype=None) -> "PPCAMix":
        arrays, meta = load_bytes(data, "ppca_mix")
        models = [
            PPCAModel(isotropic_noise=float(arrays[f"isotropic_noise_{i}"]),
                      transform=arrays[f"transform_{i}"], mean=arrays[f"mean_{i}"],
                      device=device, dtype=dtype)
            for i in range(int(meta["n_models"]))
        ]
        return PPCAMix(models, arrays["log_weights"])

    def __reduce__(self):
        return (PPCAMix.load, (self.dump(),))

    # ------------------------------------------------------------------ #
    # the fused computations

    def _stacked_params(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(Cs (M, D, kmax), means (M, D), sigmas (M,))``.  Heterogeneous
        state sizes are zero-padded to the largest k, and padded latent
        dimensions are exactly inert: their Gram block is 0, so M gains a
        sigma^2 I block whose log-det cancels against the (d_obs - k) noise
        term; their states are 0 and their posterior covariance the prior's
        I (sliced away on readout); the M-step's cross moments for them are
        0, so the solve returns 0; tr(G Sigma) gets nothing from them."""
        kmax = max(self.state_sizes)
        Cs = torch.stack([torch.nn.functional.pad(m.transform, (0, kmax - m.state_size))
                          for m in self._models])
        return (Cs, torch.stack([m.mean for m in self._models]),
                torch.stack([m.isotropic_noise for m in self._models]))

    def _placed(self, dataset: Dataset):
        """``(placement, Cs, means, sigmas)``: where ``dataset`` lives, and
        the stacked parameters with this rank's columns of the transforms
        and means."""
        where = place(dataset)
        Cs, means, sigmas = self._stacked_params()
        return (where, *where.columns(Cs, means), sigmas)

    def _route_args(self, dataset: Dataset, Cs: torch.Tensor, group=None,
                    sort: bool = False) -> dict:
        """``mix_fused``'s keywords for the dataset's rows on their route
        (``routes.route``; the rows sorted by pattern with ``sort``), in
        blocks of ``config.mix_block_rows``, with the model ``group``."""
        way = routes.route(dataset, mixture=True, sort=sort)
        itemsize = ml._compute_dtype(dataset.data, Cs).itemsize
        return dict(routes.mix_keywords(way, dataset), group=group,
                    block_size=config.mix_block_rows(len(self._models), Cs.shape[2], itemsize))

    def _component_llks(self, dataset: Dataset) -> torch.Tensor:
        """(N, M) per-component per-sample log-likelihoods, one fused pass
        (the reference makes M, `mix.rs:283-288`)."""
        where, Cs, means, sigmas = self._placed(dataset)
        return mf.mix_llks(Cs, means, sigmas, dataset.data, dataset.mask,
                           **self._route_args(dataset, Cs, where.group))

    # ------------------------------------------------------------------ #
    # likelihood (mix.rs:136-189)

    def llks(self, dataset: Dataset) -> torch.Tensor:
        """Per-sample mixture log-likelihood: logsumexp over components of
        llk + log weight (`mix.rs:147-159`)."""
        with span("ppca.readout"):
            return torch.logsumexp(self._component_llks(dataset) + self._log_weights, -1)

    def llk(self, dataset: Dataset) -> float:
        """Weighted total mixture log-likelihood (`mix.rs:162-174`)."""
        if dataset.is_empty():
            return 0.0
        return float(place(dataset).row_sum(self.llks(dataset), dataset.weights_dev))

    def infer_cluster(self, dataset: Dataset) -> torch.Tensor:
        """(N, M) per-sample *log*-posterior over components: the reference
        returns the log-softmax values, though its doc comment speaks of
        probabilities (`mix.rs:179-189`); this matches the code."""
        with span("ppca.readout"):
            return torch.log_softmax(self._component_llks(dataset) + self._log_weights, -1)

    # ------------------------------------------------------------------ #
    # sampling (mix.rs:121-134)

    def sample(self, dataset_size: int, mask_probability: float,
               generator: Optional[torch.Generator] = None) -> Dataset:
        """Ancestral sampling: each sample's component from the prior
        weights, then that component's generative model; the latent and
        output noise and the Bernoulli mask (each entry masked with
        probability ``mask_probability``) are drawn once for the batch."""
        Cs, means, sigmas = self._stacked_params()
        gen = ensure_generator(generator, self.device)
        opts = dict(generator=gen, dtype=Cs.dtype, device=gen.device)
        n, D = int(dataset_size), self._output_size
        comp = torch.multinomial(self.weights.to(gen.device), n, replacement=True,
                                 generator=gen).to(self.device)
        z = torch.randn((n, Cs.shape[2]), **opts).to(self.device)
        eps = torch.randn((n, D), **opts).to(self.device)
        observed = (torch.rand((n, D), **opts) < 1.0 - mask_probability).to(self.device)
        proj = torch.zeros((n, D), dtype=Cs.dtype, device=self.device)
        for i in range(len(self._models)):
            proj = torch.where((comp == i)[:, None], z @ Cs[i].T, proj)
        values = proj + means[comp] + sigmas[comp][:, None] * eps
        return Dataset.from_parts(torch.where(observed, values, torch.zeros_like(values)),
                                  observed)

    # ------------------------------------------------------------------ #
    # inference (mix.rs:193-265)

    def uninferred(self, n: int = 1) -> "InferredMaskedMix":
        """The prior mixture posterior: the log-weights as responsibilities
        and each component's uninferred batch (`mix.rs:193-202`)."""
        log_post = self._log_weights.expand(n, len(self._models))
        return InferredMaskedMix(self, log_post, [m.uninferred(n) for m in self._models])

    def inferred_one(self, log_posterior, inferred: List[InferredMasked]) -> "InferredMaskedMix":
        """Posterior batch from raw values (`mix.rs:218-227`)."""
        log_post = torch.atleast_2d(torch.as_tensor(
            log_posterior, dtype=self._log_weights.dtype, device=self.device))
        return InferredMaskedMix(self, log_post, list(inferred))

    def infer(self, dataset: Dataset) -> "InferredMaskedMix":
        """Responsibilities and every component's posterior in ONE pass (the
        reference makes M llk and M infer passes, `mix.rs:205-236`); each
        component's readout is sliced back to its own k."""
        with span("ppca.readout"):
            where, Cs, means, sigmas = self._placed(dataset)
            log_post, states, covs = mf.mix_infer(Cs, means, sigmas, self._log_weights,
                                                  dataset.data, dataset.mask,
                                                  **self._route_args(dataset, Cs, where.group))
            inferred = [InferredMasked(m, states[i, :, :m.state_size],
                                       covs[i, :, :m.state_size, :m.state_size])
                        for i, m in enumerate(self._models)]
            return InferredMaskedMix(self, log_post, inferred)

    def _smooth_fused(self, dataset: Dataset, extrapolate: bool) -> Dataset:
        with span("ppca.readout"):
            where, Cs, means, sigmas = self._placed(dataset)
            out = mf.mix_smooth(Cs, means, sigmas, self._log_weights, dataset.data, dataset.mask,
                                extrapolate=extrapolate,
                                **self._route_args(dataset, Cs, where.group))
            new = Dataset.unmasked(out)
            new._shard = dataset._shard
            return new

    def smooth(self, dataset: Dataset) -> Dataset:
        """Posterior-weighted mixture of the component smoothings
        (`mix.rs:239-251`), one fused pass."""
        return self._smooth_fused(dataset, extrapolate=False)

    def extrapolate(self, dataset: Dataset) -> Dataset:
        """Posterior-weighted mixture of the component extrapolations
        (`mix.rs:253-265`), one fused pass."""
        return self._smooth_fused(dataset, extrapolate=True)

    # ------------------------------------------------------------------ #
    # EM (mix.rs:267-337)

    def iterate(self, dataset: Dataset) -> "PPCAMix":
        return self.iterate_with_prior(dataset, Prior())

    def iterate_with_prior(self, dataset: Dataset, prior: Prior) -> "PPCAMix":
        """One mixture EM iteration: responsibilities in the log domain, then
        a reweighted inner EM per component (`mix.rs:281-337`), fused."""
        return self._em_step(dataset, prior)[0]

    def _em_step(self, dataset: Dataset, prior: Optional[Prior]) -> Tuple["PPCAMix", torch.Tensor]:
        """One fused EM step: (new mixture, weighted llk of *this* mixture
        as a 0-dim tensor), both from the same pass over the data.  Each new
        transform is sliced back to its component's k (its padded columns
        come out exactly 0)."""
        if dataset.is_empty():
            raise ValueError("cannot iterate on an empty dataset")
        with span("ppca.em_step"):
            where, Cs, means, sigmas = self._placed(dataset)
            args = self._route_args(dataset, Cs, where.group, sort=True)
            with span("ppca.em_stats"):
                stats = where.reduce(self._em_stats(dataset, Cs, means, sigmas, **args))
            with span("ppca.em_finalize"):
                new = self._finalize(Cs, means, sigmas, stats, prior, where)
            return new, stats.llk

    def _em_stats(self, dataset: Dataset, Cs, means, sigmas, **route_args) -> mf.MixEMStats:
        """The fused EM statistics of ``dataset``'s rows for the stacked
        parameters ``Cs, means, sigmas`` of this mixture, on the route
        :meth:`_route_args` gives (streamed chunks: with no sorted copy, as
        in the JAX package)."""
        return mf.mix_em_stats(Cs, means, sigmas, self._log_weights, dataset.data, dataset.mask,
                               dataset.weights_dev, **route_args)

    def _finalize(self, Cs, means, sigmas, stats: mf.MixEMStats, prior: Optional[Prior],
                  where: Placement = LOCAL) -> "PPCAMix":
        """The M-step from the statistics, of this rank's columns ``Cs,
        means`` of ``where``, gathered whole."""
        new_Cs, new_means, new_sigmas, new_lw = mf.mix_em_finalize(
            Cs, means, sigmas, stats, **device_priors(prior, Cs), group=where.group)
        return self._from_stacked(*where.gather(new_Cs, new_means), new_sigmas, new_lw)

    def _from_stacked(self, new_Cs, new_means, new_sigmas, new_lw) -> "PPCAMix":
        """The mixture of the new stacked parameters; each new transform is
        sliced back to its component's k."""
        models = [PPCAModel._from_params(new_Cs[i, :, :m.state_size], new_means[i], new_sigmas[i])
                  for i, m in enumerate(self._models)]
        return PPCAMix(models, new_lw)

    def _iterate_with_llk(self, dataset: Dataset, prior: Optional[Prior]) -> Tuple["PPCAMix", float]:
        """Fused EM step: (new mixture, llk of *this* mixture on the dataset)."""
        mix, llk = self._em_step(dataset, prior)
        return mix, float(llk)

    def _iterate_loop(self, dataset: Dataset, prior: Optional[Prior]) -> Tuple["PPCAMix", float]:
        """The reference-shaped per-component loop (`mix.rs:281-337`): the
        responsibilities, then M reweighted single-model EM steps
        (:meth:`PPCAModel.iterate_with_prior`, each on its own route).  The
        independent implementation the fused step is tested against;
        unsharded datasets only."""
        if place(dataset).mesh is not None:
            raise ValueError("_iterate_loop takes an unsharded dataset")
        prior = prior or Prior()
        joint = self._component_llks(dataset) + self._log_weights
        llk = float((torch.logsumexp(joint, -1) * dataset.weights_dev).sum())
        log_post = torch.log_softmax(joint, -1)
        log_w_data = torch.log(dataset.weights_dev)     # -inf for w = 0 drops the sample
        models, log_weights = [], []
        for i, model in enumerate(self._models):
            lp = log_w_data + log_post[:, i]
            max_lp = lp.max()
            # un-normalized posteriors as weights, the largest exactly 1 (mix.rs:310-323)
            unnorm = torch.exp(lp - max_lp)
            log_weights.append(torch.log(unnorm.sum()) + max_lp)
            models.append(model.iterate_with_prior(dataset.with_weights(unnorm), prior))
        return PPCAMix(models, torch.stack(log_weights)), llk

    def iterate_n(self, dataset: Dataset, n_iters: int,
                  prior: Optional[Prior] = None) -> Tuple["PPCAMix", torch.Tensor]:
        """``n_iters`` fused (MAP-)EM iterations.  Returns ``(mix, llks)``
        with ``llks[i]`` the llk of the mixture *before* iteration ``i``;
        nothing is copied to the host between iterations."""
        if dataset.is_empty():
            raise ValueError("cannot iterate on an empty dataset")
        mix, llks = self, []
        for _ in range(int(n_iters)):
            mix, llk = mix._em_step(dataset, prior)
            llks.append(llk)
        if not llks:
            return mix, torch.zeros((0,), dtype=self._log_weights.dtype, device=self.device)
        return mix, torch.stack(llks)

    def to_canonical(self) -> "PPCAMix":
        """:meth:`PPCAModel.to_canonical` of every component (`mix.rs:340-346`)."""
        return PPCAMix([m.to_canonical() for m in self._models], self._log_weights)


class InferredMaskedMix:
    """Batch of mixture posteriors (`mix.rs:349-515`).

    ``states()`` weights the component states by the posterior
    probabilities; the reference weights them by the *log*-posterior
    entries (`mix.rs:374-380`), which ``reference_log_weighting=True``
    reproduces (the JAX package's choice, PARITY.md)."""

    def __init__(self, mix: PPCAMix, log_posteriors: torch.Tensor,
                 inferred: List[InferredMasked]):
        self._mix = mix
        self._log_post = log_posteriors   # (N, M)
        self._inferred = inferred         # M x InferredMasked

    def __len__(self) -> int:
        return int(self._log_post.shape[0])

    def log_posteriors(self) -> torch.Tensor:
        return self._log_post

    def posteriors(self) -> torch.Tensor:
        return torch.exp(self._log_post)

    def sub_states(self) -> List[InferredMasked]:
        return list(self._inferred)

    def _require_equal_state_sizes(self) -> None:
        sizes = {inf.states().shape[1] for inf in self._inferred}
        if len(sizes) != 1:
            raise ValueError("moment-matched state readouts require all components to share "
                             f"a state size; got {sorted(sizes)}")

    def _weighted(self, parts) -> torch.Tensor:
        """sum_m post[:, m] * parts[m] over (N, ...) tensors."""
        post = self.posteriors()
        return sum(post[:, i].reshape(-1, *([1] * (p.ndim - 1))) * p for i, p in enumerate(parts))

    def states(self, *, reference_log_weighting: bool = False) -> torch.Tensor:
        """Moment-matched posterior state means, (N, k)."""
        self._require_equal_state_sizes()
        if reference_log_weighting:
            return sum(self._log_post[:, i:i + 1] * inf.states()
                       for i, inf in enumerate(self._inferred))
        return self._weighted([inf.states() for inf in self._inferred])

    def covariances(self) -> List[torch.Tensor]:
        """Law-of-total-variance state covariances (`mix.rs:383-394`)."""
        self._require_equal_state_sizes()
        return list(self._spread([inf.states() for inf in self._inferred],
                                 [inf.covariances_array() for inf in self._inferred]))

    def second_moments(self) -> List[torch.Tensor]:
        """Mixture-posterior second moments ``E[s s^T] = sum_m post_m
        (Sigma_m + s_m s_m^T)``, consistent with :meth:`covariances`."""
        self._require_equal_state_sizes()
        return list(self._weighted([inf.second_moments_array() for inf in self._inferred]))

    # -- output-space readouts ------------------------------------------ #

    def _component_smoothed(self) -> List[torch.Tensor]:
        return [inf.states() @ m.transform.T + m.mean
                for inf, m in zip(self._inferred, self._mix._models)]

    def _component_extrapolated(self, dataset: Dataset) -> List[torch.Tensor]:
        return [torch.where(dataset.mask, dataset.data, sm) for sm in self._component_smoothed()]

    def _spread(self, parts, covs) -> torch.Tensor:
        """sum_m post_m (covs_m + d_m d_m^T) with d_m = parts_m - their
        posterior mean: (N, D, D) for full covariances, (N, D) with
        diagonals (d_m^2 then)."""
        mean = self._weighted(parts)
        total = []
        for p, c in zip(parts, covs):
            d = p - mean
            total.append(c + (d[:, :, None] * d[:, None, :] if c.ndim == 3 else d * d))
        return self._weighted(total)

    def smoothed(self, mix: PPCAMix) -> Dataset:
        """Posterior-weighted mixture of component smoothings (`mix.rs:397-404`)."""
        return Dataset.unmasked(self._weighted(self._component_smoothed()))

    def extrapolated(self, mix: PPCAMix, dataset: Dataset) -> Dataset:
        """(`mix.rs:407-414`)"""
        return Dataset.unmasked(self._weighted(self._component_extrapolated(dataset)))

    def _covs(self, fn, *args) -> List[torch.Tensor]:
        return [fn(m, inf.covariances_array(), *args)
                for inf, m in zip(self._inferred, self._mix._models)]

    def smoothed_covariances(self, mix: PPCAMix) -> List[torch.Tensor]:
        """Full (D, D) with the between-component spread (`mix.rs:422-435`)."""
        return list(self._spread(self._component_smoothed(), self._covs(smoothed_cov_full)))

    def smoothed_covariances_diagonal(self, mix: PPCAMix) -> Dataset:
        """(`mix.rs:443-455`)"""
        return Dataset.unmasked(self._spread(self._component_smoothed(),
                                             self._covs(smoothed_cov_diag)))

    def extrapolated_covariances(self, mix: PPCAMix, dataset: Dataset) -> List[torch.Tensor]:
        """Full (D, D): each component's *smoothed* covariance plus the spread
        of the extrapolations, as the reference combines them
        (`mix.rs:464-477`)."""
        return list(self._spread(self._component_extrapolated(dataset),
                                 self._covs(smoothed_cov_full)))

    def extrapolated_covariances_diagonal(self, mix: PPCAMix, dataset: Dataset) -> Dataset:
        """(`mix.rs:485-501`)"""
        return Dataset.unmasked(self._spread(self._component_extrapolated(dataset),
                                             self._covs(extrapolated_cov_diag, dataset.mask)))

    def posterior_sampler(self) -> "PosteriorSamplerMix":
        """Every component's :meth:`InferredMasked.posterior_sampler` (one
        ``spd_chol`` launch each on the card) (`mix.rs:505-514`)."""
        return PosteriorSamplerMix(self._log_post,
                                   [inf.posterior_sampler() for inf in self._inferred])


class PosteriorSamplerMix:
    """Ancestral batch sampler: each sample's component from its posterior,
    then that component's posterior sampler (`mix.rs:517-532`).  A fresh
    component is drawn per sample on every :meth:`sample` call, as the
    reference's per-draw ``WeightedIndex`` does."""

    def __init__(self, log_posteriors: torch.Tensor, samplers: List[PosteriorSampler]):
        self._log_post = log_posteriors
        self._samplers = samplers

    def sample(self, generator: Optional[torch.Generator] = None) -> Dataset:
        device = self._log_post.device
        gen = ensure_generator(generator, device)
        comp = torch.multinomial(torch.exp(self._log_post).to(gen.device), 1,
                                 generator=gen).squeeze(-1).to(device)
        out = None
        for i, sampler in enumerate(self._samplers):
            draw = sampler.sample(generator=gen).data
            out = draw if out is None else torch.where((comp == i)[:, None], draw, out)
        return Dataset.unmasked(out)
