"""The protocol's Fiat-Shamir transcript, on ``hashlib``: absorb bytes into a
running SHA-256; a challenge is the digest of a copy of the state (the state
does not advance), its first 16 bytes little-endian mod p; a query index is
its first 8 bytes little-endian mod the pair count.

This module imports nothing of the program under test.
"""

from __future__ import annotations

import hashlib

from .field import P


class Transcript:
    def __init__(self):
        self._h = hashlib.sha256()

    def absorb(self, data: bytes) -> None:
        self._h.update(data)

    def absorb_felt(self, x: int) -> None:
        self._h.update(int(x % P).to_bytes(16, "little"))

    def digest(self) -> bytes:
        return self._h.copy().digest()

    def challenge(self) -> int:
        return int.from_bytes(self.digest()[:16], "little") % P

    def index(self, modulus: int) -> int:
        return int.from_bytes(self.digest()[:8], "little") % modulus
