"""Fiat-Shamir transcript: a running SHA-256 state on the host.

Own copy of the host transcript semantics (reference src/transcript.rs):

* ``absorb`` feeds bytes into the running hash state.
* ``random`` finalizes a *clone* of the state - the state itself does not
  advance (quirk Q1: two consecutive ``next_challenge`` calls return the
  same element; absorbing the produced data is the caller's job).
* ``next_challenge`` takes the first 16 digest bytes as a little-endian
  u128 and reduces mod p.

In this port the transcript stays on the host for the whole prove: each
round copies two field elements and a 32-byte root from the device and
sends one challenge back.
"""

from __future__ import annotations

import hashlib

from .field.scalar import Fp


class Transcript:
    __slots__ = ("_state",)

    def __init__(self):
        self._state = hashlib.sha256()

    def clone(self) -> "Transcript":
        t = Transcript.__new__(Transcript)
        t._state = self._state.copy()
        return t

    def absorb(self, data: bytes) -> None:
        self._state.update(data)

    def random(self) -> bytes:
        """32 digest bytes of a finalized clone; does NOT advance the state."""
        return self._state.copy().digest()

    def next_challenge(self) -> Fp:
        return Fp(int.from_bytes(self.random()[:16], "little"))

    # -- convenience helpers ----------------------------------------------
    def absorb_field(self, x: Fp) -> None:
        self.absorb(x.to_bytes())

    def absorb_fields(self, xs) -> None:
        for x in xs:
            self.absorb(x.to_bytes())

    def absorb_index(self, index: int) -> None:
        """Absorb a query index as 8 LE bytes (usize::to_le_bytes, quirk Q5)."""
        self.absorb(index.to_bytes(8, "little"))

    def random_index(self, modulus: int) -> int:
        """Draw a query index: first 8 digest bytes as LE u64, mod ``modulus``
        (reference src/fri/mod.rs:269-271)."""
        return int.from_bytes(self.random()[:8], "little") % modulus
