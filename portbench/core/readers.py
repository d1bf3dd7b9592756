"""Shared arithmetic of the per-layer metric readers (``metrics/*.py``).

A reader gets the traced run's context: ``ops`` (the device operations of
the profiled stretch, ``devtrace.Op``), ``window_s`` and ``proofs`` of that
stretch, ``phases`` (the program's phase timers summed over the second
stretch, seconds) and ``phase_proofs``, the cell's ``workload`` and
``config`` and the card's ``kind``.  It returns a number, or None when the
cell has nothing for it to read; never 0 for a share of a peak.
"""

from __future__ import annotations

from typing import Optional


def phase_ms(ctx, *names: str) -> Optional[float]:
    """Mean ms per proof spent in the program's phases ``names``."""
    seen = [ctx.phases[n] for n in names if n in ctx.phases]
    if not seen or not ctx.phase_proofs:
        return None
    return 1e3 * sum(seen) / ctx.phase_proofs
