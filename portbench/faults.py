"""Faults planted in the program underneath the timed path, to show that
the check catches them: each is a context manager that patches the
program's functions and restores them on exit.

- ``unchanged``: an EM step returns the model it started from;
- ``half``: half of the rows are left out and the sums taken over the
  rest are doubled (a readout repeats the first half's answers);
- ``alter``: an answer is altered where it is produced, by a relative
  1e-3: a step's llk, or a readout pass's score of the largest magnitude
  (a model's llk, a mixture's log-posterior).

Those are the ``train`` and ``readout`` kinds' faults.  Each kind's drive
module names the faults it can have (``FAULTS``); another kind plants its
own, by its drive module's ``plant(name)``.  One card runs the cells, so
no exchange between cards can be left out.
"""

from __future__ import annotations

import contextlib
import importlib

import torch

ALTER = 1e-3


@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _scaled(stats, scale, keep=("resp_max",)):
    return stats._replace(**{f: getattr(stats, f) * scale for f in stats._fields if f not in keep})


def _repeat_half(out: torch.Tensor, n: int, axis: int = 0) -> torch.Tensor:
    idx = torch.arange(n, device=out.device) % out.shape[axis]
    return out.index_select(axis, idx)


def _altered(out: torch.Tensor) -> torch.Tensor:
    out = out.clone()
    flat = out.view(-1)
    flat[flat.abs().argmax()] *= 1.0 + ALTER
    return out


def plant(name: str, kind: str):
    """A context manager that plants fault ``name`` of traffic ``kind``."""
    drive = importlib.import_module(f"portbench.drives.{kind}")
    if name not in drive.FAULTS:
        raise ValueError(f"no fault {name!r} for {kind} traffic")
    if hasattr(drive, "plant"):
        return drive.plant(name)
    return _plant(name, kind)


@contextlib.contextmanager
def _plant(name: str, kind: str):
    from ppca_rs_tpu_torch.models import mix as pmix
    from ppca_rs_tpu_torch.models import ppca as pmodel
    from ppca_rs_tpu_torch.models import routes
    from ppca_rs_tpu_torch.ops import mix_fused as mf

    with contextlib.ExitStack() as stack:
        if (name, kind) == ("unchanged", "train"):
            def stuck(orig):
                def step(self, *a, **kw):
                    _, llk = orig(self, *a, **kw)
                    return self, llk
                return step
            stack.enter_context(_patched(pmodel.PPCAModel, "_em_step", stuck))
            stack.enter_context(_patched(pmix.PPCAMix, "_em_step", stuck))
        elif (name, kind) == ("half", "train"):
            def half_single(orig):
                def em_stats(way, C, mean, sigma, dataset, block_size, group=None):
                    n = len(dataset)
                    h = max(n // 2, 1)
                    return _scaled(orig(way, C, mean, sigma, dataset.slice(0, h), block_size,
                                        group), n / h, keep=())
                return em_stats

            def half_mix(orig):
                def mix_em_stats(Cs, means, sigmas, log_weights, data, mask, weights, **kw):
                    n = data.shape[0]
                    h = max(n // 2, 1)
                    return _scaled(orig(Cs, means, sigmas, log_weights, data[:h], mask[:h],
                                        weights[:h], **kw), n / h)
                return mix_em_stats
            stack.enter_context(_patched(routes, "em_stats", half_single))
            stack.enter_context(_patched(mf, "mix_em_stats", half_mix))
        elif (name, kind) == ("alter", "train"):
            def alter_single(orig):
                def em_stats(*a, **kw):
                    stats = orig(*a, **kw)
                    return stats._replace(llk=stats.llk * (1.0 + ALTER))
                return em_stats
            stack.enter_context(_patched(routes, "em_stats", alter_single))
            stack.enter_context(_patched(mf, "mix_em_stats", alter_single))
        elif (name, kind) == ("half", "readout"):
            def half_readout(orig):
                def readout(verb, way, C, mean, sigma, dataset, block_size, group=None):
                    n = len(dataset)
                    out = orig(verb, way, C, mean, sigma, dataset.slice(0, max(n // 2, 1)),
                               block_size, group)
                    if isinstance(out, tuple):
                        return tuple(_repeat_half(o, n) for o in out)
                    return _repeat_half(out, n)
                return readout

            def half_mix_llks(orig):
                def mix_llks(Cs, means, sigmas, data, mask, **kw):
                    n = data.shape[0]
                    h = max(n // 2, 1)
                    return _repeat_half(orig(Cs, means, sigmas, data[:h], mask[:h], **kw), n)
                return mix_llks

            def half_mix_smooth(orig):
                def mix_smooth(Cs, means, sigmas, log_weights, data, mask, **kw):
                    n = data.shape[0]
                    h = max(n // 2, 1)
                    return _repeat_half(orig(Cs, means, sigmas, log_weights, data[:h], mask[:h],
                                             **kw), n)
                return mix_smooth
            stack.enter_context(_patched(routes, "readout", half_readout))
            stack.enter_context(_patched(mf, "mix_llks", half_mix_llks))
            stack.enter_context(_patched(mf, "mix_smooth", half_mix_smooth))
        elif (name, kind) == ("alter", "readout"):
            def alter_readout(orig):
                def readout(verb, *a, **kw):
                    out = orig(verb, *a, **kw)
                    return _altered(out) if verb == "llks" else out
                return readout

            def alter_cluster(orig):
                def infer_cluster(self, dataset):
                    return _altered(orig(self, dataset))
                return infer_cluster
            stack.enter_context(_patched(routes, "readout", alter_readout))
            stack.enter_context(_patched(pmix.PPCAMix, "infer_cluster", alter_cluster))
        else:
            raise ValueError(f"no fault {name!r} for {kind} traffic")
        yield
