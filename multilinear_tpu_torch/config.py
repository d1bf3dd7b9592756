"""Runtime configuration and the protocol constants' home.

``LOG_BLOWUP`` and ``NUM_QUERIES`` fix the proof format and the transcript
(reference src/fri/mod.rs:16-17); they are module constants, not knobs.
``ProverConfig`` holds what is left once the knobs that exist only for a
TPU, a remote dispatch tunnel or XLA are gone: the device the prover's
tensors live on, and the debug sanitizer.  The config is passed explicitly
to the entry points; there is no process-global "current config".
"""

from __future__ import annotations

from dataclasses import dataclass

LOG_BLOWUP = 1  # Reed-Solomon rate 1/2
NUM_QUERIES = 128  # FRI query count


@dataclass(frozen=True)
class ProverConfig:
    # Where the prover's tensors live.  On "cuda" every hot primitive
    # launches its hand-written kernel; on "cpu" the same wrappers run
    # their plain PyTorch versions (the device of the tensor decides,
    # nothing else does).
    device: str = "cuda"
    # Limb sanitizer: assert every field element crossing a protocol
    # boundary (codeword, folded codeword, folded table) is canonical
    # (< p).  One device->host sync per check; tests and debugging only.
    debug_checks: bool = False
