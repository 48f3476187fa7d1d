"""Randomness plumbing.

Every sampling entry point takes an optional ``generator=`` (a
``torch.Generator``) for reproducible use.  Without one, a process-global
generator chain (seeded from OS entropy, re-seedable with :func:`seed`)
hands out a freshly seeded generator per call, the counterpart of the JAX
package's global key chain.  The two packages draw different numbers from
the same seed.
"""

from __future__ import annotations

import secrets
import threading
from typing import Optional

import torch


class _GlobalGeneratorChain:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._gen: Optional[torch.Generator] = None

    def seed(self, value: int) -> None:
        with self._lock:
            self._gen = torch.Generator().manual_seed(int(value))

    def next_seed(self) -> int:
        with self._lock:
            if self._gen is None:
                self._gen = torch.Generator().manual_seed(secrets.randbits(63))
            return int(torch.randint(0, 2**62, (), generator=self._gen))


_chain = _GlobalGeneratorChain()


def seed(value: int) -> None:
    """Seed the process-global chain used when no ``generator`` is passed."""
    _chain.seed(value)


def ensure_generator(generator: Optional[torch.Generator], device) -> torch.Generator:
    """Return ``generator`` if given, else a new generator on ``device``
    seeded from the global chain."""
    if generator is not None:
        return generator
    return torch.Generator(device=torch.device(device)).manual_seed(_chain.next_seed())
