"""Train loops for a PPCA model and a PPCA mixture — port of
``ppca_rs_tpu/trainer.py`` (a rebuild of `python/ppca_rs/__init__.py:14-118`).

Same API and metric semantics as the reference trainer (llk/aic/bic per
iteration, optional warm start and prior, final ``to_canonical``).  The
per-iteration log-likelihood comes from the same pass over the data as the
EM update, and is copied to the host only when a callback or the printout
asks for it.  ``profile_dir`` traces the training (``utils/profiling.py``).
The streaming trainers (``streaming.py``) run the same loop.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Literal, Optional

import numpy as np
import torch

from .dataset import Dataset
from .models.mix import PPCAMix
from .models.ppca import PPCAModel
from .prior import Prior
from .utils.profiling import trace


@dataclass(frozen=True)
class TrainMetrics:
    """Per-iteration metrics (`python/ppca_rs/__init__.py:14-18`):
    llk and bic are per-sample; aic = 2 (p - llk_total) / n."""

    llk: float
    aic: float
    bic: float

    @staticmethod
    def compute(llk_total: float, n_parameters: int, n_samples: int) -> "TrainMetrics":
        n = n_samples
        return TrainMetrics(
            llk=llk_total / n,
            aic=2.0 * (n_parameters - llk_total) / n,
            bic=(llk_total - n_parameters * float(np.log(n))) / n,
        )


Metric = Literal["aic", "bic", "llk"]
MetricsCallback = Callable[[int, TrainMetrics], None]


def _maybe_checkpoint(model, iteration: int, n_iters: int, path: Optional[str], every: int) -> None:
    """Atomic dump of the in-progress model or mixture (resume with
    ``train(start=PPCAModel.load(open(path, 'rb').read()), ...)``, or
    ``PPCAMix.load``)."""
    if path is None:
        return
    if iteration % max(every, 1) != 0 and iteration != n_iters:
        return
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(model.dump())
    os.replace(tmp, path)


def _train(model, step, n_samples: Callable[[], int], n_iters: int, metric: Metric,
           quiet: bool, callback: Optional[MetricsCallback], checkpoint_path: Optional[str],
           checkpoint_every: int, label: str, profile_dir: Optional[str]):
    """The EM loop every trainer shares: ``step(model)`` gives the new model
    and the llk of the current one from one pass over the data; the llk
    reaches the host only for the callback or the printout, which divide
    it by ``n_samples()``.  With ``profile_dir``, the loop is traced there
    (``utils.profiling.trace``)."""
    with trace(profile_dir):
        for idx in range(n_iters):
            new_model, llk = step(model)
            if not quiet or callback is not None:
                metrics = TrainMetrics.compute(float(llk), model.n_parameters, n_samples())
                if callback is not None:
                    callback(idx + 1, metrics)
                if not quiet:
                    print(f"{label} iteration {idx + 1}: {metric}={getattr(metrics, metric)}")
            model = new_model
            _maybe_checkpoint(model, idx + 1, n_iters, checkpoint_path, checkpoint_every)
    return model.to_canonical()


@dataclass
class PPCATrainer:
    """A trainer for a PPCA model over masked data
    (`python/ppca_rs/__init__.py:21-67`)."""

    dataset: Dataset

    def train(
        self,
        *,
        start: Optional[PPCAModel] = None,
        prior: Optional[Prior] = None,
        state_size: int,
        n_iters: int = 10,
        metric: Metric = "aic",
        quiet: bool = False,
        callback: Optional[MetricsCallback] = None,
        generator: Optional[torch.Generator] = None,
        profile_dir: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 10,
    ) -> PPCAModel:
        model = start if start is not None else PPCAModel.init(
            state_size, self.dataset, generator=generator)
        return _train(model, lambda m: m._em_step(self.dataset, prior), lambda: len(self.dataset),
                      n_iters, metric, quiet, callback, checkpoint_path, checkpoint_every,
                      "Masked PPCA", profile_dir)


@dataclass
class PPCAMixTrainer:
    """A trainer for a PPCA mixture over masked data
    (`python/ppca_rs/__init__.py:70-118`).  The per-iteration llk comes from
    the responsibilities of the fused EM step (``PPCAMix._em_step``, the
    tensor form of ``_iterate_with_llk``)."""

    dataset: Dataset

    def train(
        self,
        *,
        start: Optional[PPCAMix] = None,
        prior: Optional[Prior] = None,
        n_models: int,
        state_size: int,
        n_iters: int = 10,
        metric: Metric = "aic",
        quiet: bool = False,
        callback: Optional[MetricsCallback] = None,
        generator: Optional[torch.Generator] = None,
        profile_dir: Optional[str] = None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 10,
    ) -> PPCAMix:
        model = start if start is not None else PPCAMix.init(
            n_models, state_size, self.dataset, generator=generator)
        return _train(model, lambda m: m._em_step(self.dataset, prior), lambda: len(self.dataset),
                      n_iters, metric, quiet, callback, checkpoint_path, checkpoint_every,
                      "Masked PPCA mix", profile_dir)
