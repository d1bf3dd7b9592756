"""The proof's bytes, written from the protocol's wire format, and the
comparison of two proofs section by section.

Wire format (little-endian, bincode's fixed-int conventions): a sequence is
a u64 count, then its items; a field element is its 16 little-endian bytes;
a digest is 32 raw bytes; a Merkle path is its leaf's elements (a sequence),
then a sequence of (sibling digest, one direction byte: 0 when the path node
is a left child, 1 when it is a right child).

This module imports nothing of the program under test.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .field import P


class Writer:
    """Bytes plus named sections: ``mark(name)`` starts a section that runs
    to the next mark or the end."""

    def __init__(self):
        self.buf = bytearray()
        self.marks: List[Tuple[str, int]] = []

    def mark(self, name: str) -> None:
        self.marks.append((name, len(self.buf)))

    def u64(self, v: int) -> None:
        self.buf += struct.pack("<Q", v)

    def u8(self, v: int) -> None:
        self.buf.append(v)

    def raw(self, b: bytes) -> None:
        self.buf += b

    def felt(self, x: int) -> None:
        self.buf += int(x % P).to_bytes(16, "little")

    def felts(self, xs: Sequence[int]) -> None:
        self.u64(len(xs))
        for x in xs:
            self.felt(x)

    def path(self, values: Sequence[int], index: int, siblings: Sequence[bytes]) -> None:
        self.felts(values)
        self.u64(len(siblings))
        for level, sib in enumerate(siblings):
            self.raw(sib)
            self.u8((index >> level) & 1)

    def sections(self) -> List[Tuple[str, int, int]]:
        ends = [pos for _, pos in self.marks[1:]] + [len(self.buf)]
        return [(name, start, end) for (name, start), end in zip(self.marks, ends)]

    def nest(self, inner: "Writer", prefix: str) -> None:
        """Append ``inner``'s bytes behind a u64 length, keeping its sections."""
        self.u64(len(inner.buf))
        base = len(self.buf)
        for name, pos in inner.marks:
            self.marks.append((prefix + name, base + pos))
        self.buf += inner.buf


def compare(got: bytes, want: bytes, sections: Sequence[Tuple[str, int, int]]) -> Dict[str, int]:
    """Bytes of ``got`` that differ from the reference's ``want``, counted in
    each of the reference's sections (bytes missing from ``got`` count in
    their section, bytes beyond ``want``'s end in the last), and in all:
    ``bytes``."""
    a = np.frombuffer(got, dtype=np.uint8)
    b = np.frombuffer(want, dtype=np.uint8)
    out = {}
    for name, start, end in sections:
        x, y = a[start:end], b[start:end]
        k = min(len(x), len(y))
        out[name] = out.get(name, 0) + int(np.count_nonzero(x[:k] != y[:k])) + (len(y) - k)
    if sections:
        out[sections[-1][0]] += max(0, len(a) - len(b))
    out["bytes"] = sum(out.values())
    return out
