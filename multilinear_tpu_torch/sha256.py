"""SHA-256 over batches of word-aligned messages, and the word/byte views.

``sha256_words`` hashes N equal-length messages at once: one CUDA thread
per message on the card (:mod:`.sha256_cuda`), tensor code on the CPU.
Merkle layer hashing is one of the two bulk workloads of the prover (the
other is field multiplication).

Layouts: a message batch is ``(N, n_words)`` int32 big-endian words, a
digest batch ``(N, 8)`` int32 big-endian words - each message and each
digest contiguous, so a tree level of N digests viewed as ``(N/2, 16)`` IS
the next level's message batch.  The digest equals byte-for-byte standard
SHA-256 of the corresponding message bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from . import sha256_cuda


def sha256_words(msg_words: torch.Tensor) -> torch.Tensor:
    """SHA-256 of word-aligned messages: (N, n_words) -> (N, 8) digest words."""
    return sha256_cuda.sha256_words(msg_words)


limbs_to_words = sha256_cuda.limbs_to_words


def digests_to_bytes(words) -> np.ndarray:
    """(N, 8) digest words (tensor or ndarray) -> (N, 32) uint8."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().contiguous().numpy()
    w = np.ascontiguousarray(words).view(np.uint32).reshape(-1, 8)
    return w.astype(">u4").view(np.uint8).reshape(w.shape[0], 32)


def digest_to_bytes(words) -> bytes:
    """(8,) digest words -> 32 bytes (big-endian per word)."""
    return digests_to_bytes(np.asarray(words).reshape(1, 8))[0].tobytes()
