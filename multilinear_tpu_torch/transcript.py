"""Fiat-Shamir transcript: a running SHA-256 state on the host.

Own copy of the host transcript semantics (reference src/transcript.rs):

* ``absorb`` feeds bytes into the running hash state.
* ``random`` finalizes a *clone* of the state - the state itself does not
  advance (quirk Q1: two consecutive ``next_challenge`` calls return the
  same element; absorbing the produced data is the caller's job).
* ``next_challenge`` takes the first 16 digest bytes as a little-endian
  u128 and reduces mod p.

The state can hop to the prover's device and back.  ``hashlib`` can
neither export nor import its internal state, so a transcript keeps
``hashlib`` for ``absorb`` and ``random`` (the verifier's speed) and also
the bytes absorbed since its last exported midstate; ``export_state``
compresses those with :class:`Sha256Midstate`, a pure-Python SHA-256 whose
state is open.  A prove exports once, before its rounds: the rounds run
their absorbs and challenges on the device (``device_transcript``), and at
the end the host REPLAYS the device's absorbs into its own ``hashlib``
state and checks the digest the device computed.  ``import_state`` makes a
transcript that runs on :class:`Sha256Midstate` itself.
"""

from __future__ import annotations

import hashlib
import struct

from .field.scalar import Fp

_H0 = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)
_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)
_M32 = 0xFFFFFFFF


def _rotr(x: int, r: int) -> int:
    return ((x >> r) | (x << (32 - r))) & _M32


def sha256_compress(st, block: bytes) -> list:
    """One SHA-256 compression of a 64-byte block into the 8 chaining words."""
    w = list(struct.unpack(">16I", block))
    for t in range(16, 64):
        w1, w14 = w[t - 15], w[t - 2]
        s0 = _rotr(w1, 7) ^ _rotr(w1, 18) ^ (w1 >> 3)
        s1 = _rotr(w14, 17) ^ _rotr(w14, 19) ^ (w14 >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
    a, b, c, d, e, f, g, h = st
    for t in range(64):
        t1 = (h + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)) + ((e & f) ^ (~e & g)) + _K[t] + w[t]) & _M32
        t2 = ((_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)) + ((a & b) ^ (a & c) ^ (b & c))) & _M32
        a, b, c, d, e, f, g, h = (t1 + t2) & _M32, a, b, c, (d + t1) & _M32, e, f, g
    return [(x + y) & _M32 for x, y in zip(st, (a, b, c, d, e, f, g, h))]


class Sha256Midstate:
    """Streaming SHA-256 with an open state, ``hashlib``-compatible in
    ``update`` / ``copy`` / ``digest``: 8 chaining words, the bytes of the
    partial block (any number, 0-63) and the total length in bytes."""

    __slots__ = ("st", "buf", "total")

    def __init__(self, st=_H0, buf: bytes = b"", total: int = 0):
        if len(st) != 8 or len(buf) >= 64 or total < len(buf) or (total - len(buf)) % 64:
            raise ValueError("not a SHA-256 midstate")
        self.st = [int(x) & _M32 for x in st]
        self.buf = bytes(buf)
        self.total = int(total)

    def update(self, data) -> None:
        data = self.buf + bytes(data)
        self.total += len(data) - len(self.buf)
        full = len(data) - len(data) % 64
        for i in range(0, full, 64):
            self.st = sha256_compress(self.st, data[i : i + 64])
        self.buf = data[full:]

    def copy(self) -> "Sha256Midstate":
        return Sha256Midstate(self.st, self.buf, self.total)

    def digest(self) -> bytes:
        """32 digest bytes of a finalized clone; the stream does not advance."""
        tail = self.buf + b"\x80" + b"\0" * ((55 - len(self.buf)) % 64) + struct.pack(">Q", 8 * self.total)
        st = self.st
        for i in range(0, len(tail), 64):
            st = sha256_compress(st, tail[i : i + 64])
        return struct.pack(">8I", *st)

    def export(self):
        return list(self.st), self.buf, self.total


class Transcript:
    __slots__ = ("_state", "_mid", "_tail")

    def __init__(self):
        self._state = hashlib.sha256()
        self._mid = Sha256Midstate()  # midstate of the bytes absorbed before _tail
        self._tail = bytearray()

    def clone(self) -> "Transcript":
        t = Transcript.__new__(Transcript)
        t._state = self._state.copy()
        t._mid = self._mid.copy() if self._mid is not None else None
        t._tail = bytearray(self._tail) if self._tail is not None else None
        return t

    # -- midstate hopping ----------------------------------------------------
    def export_state(self):
        """(8 chaining words, partial block bytes, total length in bytes)."""
        if self._tail is None:
            return self._state.export()
        self._mid.update(self._tail)
        self._tail.clear()
        return self._mid.export()

    @staticmethod
    def import_state(st_words, buf: bytes, total: int) -> "Transcript":
        """A transcript that continues from a midstate (it runs on
        :class:`Sha256Midstate`, not ``hashlib``)."""
        t = Transcript.__new__(Transcript)
        t._state = Sha256Midstate(st_words, buf, total)
        t._mid = t._tail = None
        return t

    def absorb(self, data: bytes) -> None:
        self._state.update(data)
        if self._tail is not None:
            self._tail += data

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
