"""Streamed training traffic: the table lives in pinned host memory and EM
of a single model (a configuration of ``model`` ``ppca``) runs out of core
through the program's streaming trainer, as the library documents it for
tables that live on the host (pinned ``Dataset.chunks``,
``StreamingPPCATrainer(chunks).train(prefetch=...)``).

Set-up copies the card's table, chunk by chunk, into host tensors allocated
pinned: the ``chunks`` slices of ``Dataset.chunks``, each its values, mask
and weights (never a pageable copy of the whole table, which would double
the host's peak).  It then drops the device table, returns its memory to
the card and resets the card's peak-memory statistics, so that
``peak_mem_gib`` is the streamed path's own, and drives the streaming
trainer from the seed's start through ``check_steps`` iterations with
``prefetch`` chunks in flight (which also fixes each chunk's route).  The
window, ``em_iter_s`` and the check's numbers are :mod:`.train`'s: one more
``train`` call of as many iterations as fill ``seconds``, a non-finite llk
a failed iteration; ``release`` drops the device state and leaves the
pinned chunks in the inputs.  The check copies the pinned chunks back into one table
on the card and follows the set-up's steps with the reference, as the
resident cell's does.

Faults (planted in ``ppca_rs_tpu_torch.streaming`` from outside):

- ``unchanged``: a streamed EM step returns the model it started from;
- ``half``: each chunk's statistics are taken over its first half of rows
  and doubled;
- ``drop``: the last chunk's statistics are left out of the pass's sum;
- ``twice``: the last chunk's statistics are added twice;
- ``alter``: the first chunk's largest statistic is multiplied by 1 + 1e-3.
"""

from __future__ import annotations

import contextlib
import functools
import sys
import types

import torch

from .. import faults
from ..reference import ppca as ref
from ..reference.linalg import F64
from . import common, train
from .train import compare_to, forget, outputs, release, window  # noqa: F401 - the kind's own

STARTS = True
CHECK_AFTER_WINDOW = False
NUMBERS = train.NUMBERS
FAULTS = ("unchanged", "half", "drop", "twice", "alter")


def host_chunks(inputs: dict, n_chunks: int, device) -> list:
    """The table as ``n_chunks`` host datasets, pinned where the card is the
    device.  The first call moves the table out of ``inputs`` (``data`` and
    ``mask`` give way to ``chunks``); later calls find the chunks there."""
    from ppca_rs_tpu_torch import Dataset

    if "chunks" not in inputs:
        t0 = common.now()
        pin = torch.device(device).type == "cuda"
        whole = Dataset.from_parts(inputs.pop("data"), inputs.pop("mask"))
        inputs["chunks"] = [
            Dataset.from_parts(*(torch.empty(t.shape, dtype=t.dtype, pin_memory=pin).copy_(t)
                                 for t in (part.data, part.mask, part.weights_dev)))
            for part in whole.chunks(n_chunks)]
        sys.stderr.write(f"portbench: the table to {len(inputs['chunks'])} host chunks "
                         f"(pinned: {pin}) in {common.now() - t0:.3f} s\n")
    return inputs["chunks"]


def table(inputs: dict, device):
    """The pinned chunks back in one (data, mask) table on ``device``."""
    chunks = inputs["chunks"]
    rows = sum(len(c) for c in chunks)
    D = chunks[0].data.shape[1]
    data = torch.empty(rows, D, dtype=chunks[0].data.dtype, device=device)
    mask = torch.empty(rows, D, dtype=torch.bool, device=device)
    lo = 0
    for c in chunks:
        data[lo:lo + len(c)].copy_(c.data)
        mask[lo:lo + len(c)].copy_(c.mask)
        lo += len(c)
    return data, mask


def setup(cell, inputs: dict, device, tracer, seed: int) -> dict:
    from ppca_rs_tpu_torch import StreamingPPCATrainer

    chunks = host_chunks(inputs, cell.traffic["chunks"], device)
    common.release(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    trainer = StreamingPPCATrainer(chunks)
    streamed = types.SimpleNamespace(
        train=functools.partial(trainer.train, prefetch=cell.traffic["prefetch"]))
    return train.steps(cell, streamed, sum(len(c) for c in chunks), inputs, device, tracer)


def reference(cell, session: dict, inputs: dict, prec) -> dict:
    """The reference's steps from the same start over the whole table."""
    data, mask = table(inputs, inputs["start"]["Cs"].device)
    llks, params = ref.em(prec, inputs["start"], data, mask, cell.traffic["check_steps"])
    n = data.shape[0]
    del data, mask
    common.release(inputs["start"]["Cs"].device)
    return {"llks": [v / n for v in llks], "params": params}


def check(cell, session: dict, inputs: dict) -> dict:
    """The set-up's streamed steps against the reference's in float64."""
    return compare_to(cell, outputs(session), reference(cell, session, inputs, F64))


def _altered_stats(stats):
    """``stats`` with its entry of the largest magnitude, over every field,
    altered by :func:`portbench.faults._altered`."""
    field = max(stats._fields, key=lambda f: float(getattr(stats, f).abs().max()))
    return stats._replace(**{field: faults._altered(getattr(stats, field))})


@contextlib.contextmanager
def plant(name: str):
    """Plant fault ``name`` in the streamed step (``streaming._step``) or
    in its pass over the chunks (``_accumulate``)."""
    from ppca_rs_tpu_torch import streaming

    if name == "unchanged":
        def stuck(orig):
            def step(model, *a, **kw):
                _, llk, n = orig(model, *a, **kw)
                return model, llk, n
            return step
        with faults._patched(streaming, "_step", stuck):
            yield
        return
    orig = streaming._accumulate

    def accumulate(chunks, device, stats_fn, add_fn, prefetch):
        last, at = len(chunks) - 1, [-1]

        def stats(ds):
            at[0] += 1
            if name == "half":
                h = max(len(ds) // 2, 1)
                return faults._scaled(stats_fn(ds.slice(0, h)), len(ds) / h)
            out = stats_fn(ds)
            return _altered_stats(out) if name == "alter" and at[0] == 0 else out

        def add(total, st):
            if at[0] == last and name == "drop":
                return total
            if at[0] == last and name == "twice":
                return add_fn(add_fn(total, st), st)
            return add_fn(total, st)

        return orig(chunks, device, stats, add, prefetch)

    streaming._accumulate = accumulate
    try:
        yield
    finally:
        streaming._accumulate = orig
