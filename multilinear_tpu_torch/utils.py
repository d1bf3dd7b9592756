"""Per-phase wall-clock attribution for the PCS prover.

Inactive by default: ``PhaseTimer.mark`` is a no-op unless
``collect_phases()`` is live.  When active, each mark synchronizes the
device first, so a phase's time includes the kernels it enqueued.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch

_PHASES: Optional[dict] = None


@contextlib.contextmanager
def collect_phases() -> Iterator[dict]:
    """Activate phase collection; yields the dict the timers fill."""
    global _PHASES
    _PHASES = {}
    try:
        yield _PHASES
    finally:
        _PHASES = None


class PhaseTimer:
    def __init__(self, device: str):
        self._cuda = torch.device(device).type == "cuda"
        self._t = time.perf_counter() if _PHASES is not None else None

    def mark(self, name: str) -> None:
        """Attribute the time since the previous mark to ``name``."""
        if _PHASES is None:
            return
        if self._cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        _PHASES[name] = _PHASES.get(name, 0.0) + now - self._t
        self._t = now
