"""The port's one counter registry: device->host copies, kernel launches
and routing events.  ``counts()`` reads them, ``reset()`` sets them to 0.
(Time is the other tracing mechanism: ``utils.span``.)

``fetch`` is the ONE place the prover copies a device tensor to the host,
so ``counts()["d2h_copies"]`` is the number of host synchronizations a
prove paid.  The rounds draw their challenges on the device and copy
nothing; a PCS prove copies twice (the end of the rounds, the query
openings), a batched prove three times (the batch root first).

``launch.<kernel>``: each launch of one of the port's hand-written kernels
(``field.cuda_ops``, ``sha256_cuda``, ``device_transcript``), bumped where
the wrapper enqueues it; PyTorch's own kernels are not counted here.

Routing events, bumped where a module picks a kernel, so that a test can
assert which one ran:

* ``ntt_double_stages`` / ``ntt_notw_stages`` / ``ntt_single_stages`` - the
  Pease stages that went through ``butterfly2``, ``butterfly_notw`` and
  ``butterfly`` (``ntt._pease_rows``);
* ``fri_folds_fused`` / ``fri_folds_plain`` - folds through
  ``fold_commit_leaves`` and through ``fold_codeword`` (``fri``);
* ``merkle_paths_built`` - ``merkle.MerklePath`` objects made: a prove and
  its serialization make none (the openings go from the gather to the
  proof's bytes by numpy), a reader of a proof's queries (``verify``,
  ``*_from_bytes``, ``open_batch``) makes one a path;
* a sharded prove (``parallel``): ``rounds_sharded`` - PCS rounds (plain or
  batched) whose sums were added over the ranks; ``sc_rounds_sharded`` -
  the same for a SNARK's trace-sumcheck rounds; ``fri_rounds_sharded`` -
  folds and commits made on a rank's block (PCS or standalone FRI);
  ``collectives``, ``collective_bytes`` and ``collective_staged_copies``
  (``parallel.comm``); and the series ``round_collective_bytes``, the bytes
  this rank sent in each PCS or FRI round, and ``rounds_sharded_sum_bytes`` /
  ``sc_rounds_sharded_sum_bytes``, the bytes of each sharded round's exact
  sum.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

_COUNTS: Counter = Counter()
_SERIES: dict = {}


def bump(name: str, n: int = 1) -> None:
    _COUNTS[name] += n


def counts() -> dict:
    return dict(_COUNTS)


def append(name: str, value) -> None:
    _SERIES.setdefault(name, []).append(value)


def series() -> dict:
    return {k: list(v) for k, v in _SERIES.items()}


def reset() -> None:
    _COUNTS.clear()
    _SERIES.clear()


def fetch(t: torch.Tensor) -> np.ndarray:
    """Copy a tensor to the host as a numpy array (counted when it crosses
    from a device)."""
    if t.device.type != "cpu":
        bump("d2h_copies")
    return t.detach().cpu().contiguous().numpy()
