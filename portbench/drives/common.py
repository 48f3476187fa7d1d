"""What both kinds of traffic use."""

from __future__ import annotations

import time

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def now() -> float:
    return time.perf_counter()


def release(device) -> None:
    """Return the freed blocks of the caching allocator to the device."""
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
