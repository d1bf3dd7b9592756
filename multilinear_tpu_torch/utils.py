"""The prover's spans: named ranges around each layer of a prove.

``span(name)`` is the ONE tracing mechanism of the port.  It does nothing
but two flag tests unless one of these is live:

* a ``torch.profiler`` profile: the span is a ``record_function`` range,
  on the profiler's clock beside the device trace (with CPU activity it is
  a user annotation; under ``torch.autograd.profiler.emit_nvtx`` an NVTX
  range).  It never synchronises.
* ``collect_phases()``: a span named as one of ``PHASES`` synchronises the
  device when it closes and adds its time to the phase dict.  This is a
  second, synchronising clock; the other spans do not touch it.

The spans of the prove paths, outermost first ("<" reads "inside"):

* ``proof``: ``PCSProof.prove``, ``BatchedPCSProof.prove``,
  ``System.prove_snark``;
* the layers, which follow one another inside a proof: ``encode``,
  ``commit_l0`` (plain) or ``commit_batch`` (batched), ``tables``,
  ``snark_tables`` (the SNARK's trace tables), ``rounds``,
  ``sumcheck_rounds``, ``queries``; and ``serialize``, the proof bytes
  (``serialize.*_proof_to_bytes``), outside ``proof``;
* ``round`` < ``rounds``: one PCS round (``pcs.DeviceRounds.round``);
  ``sumcheck_round`` < ``sumcheck_rounds``: one trace-sumcheck round
  (``sumcheck.DeviceSumcheckRounds.launch``); ``replay`` < ``rounds`` or
  ``sumcheck_rounds``: the rounds' one copy and the host transcript's
  replay; ``open`` < ``queries``: the query openings.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch
from torch._C._autograd import _profiler_enabled

# the spans that are also phases of ``collect_phases``
PHASES = frozenset(
    {"encode", "commit_l0", "commit_batch", "tables", "rounds", "queries", "snark_tables", "sumcheck_rounds"})

_PHASES: Optional[dict] = None


@contextlib.contextmanager
def collect_phases() -> Iterator[dict]:
    """Activate phase collection; yields the dict the spans fill with
    seconds by phase name."""
    global _PHASES
    _PHASES = {}
    try:
        yield _PHASES
    finally:
        _PHASES = None


class span:
    """``with span(name):`` around one layer of a prove (module docstring)."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self._range = None
        if _profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter() if _PHASES is not None and self.name in PHASES else None
        return self

    def __exit__(self, *exc) -> None:
        if self._t0 is not None and _PHASES is not None:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            _PHASES[self.name] = _PHASES.get(self.name, 0.0) + time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
