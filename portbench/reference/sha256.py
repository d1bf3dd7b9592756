"""Plain SHA-256 over many equal-length messages at once, and Merkle trees.

Words are int64 tensors holding 32-bit values; every message of a batch has
the same length, so the padding is the same for all of them and a block made
only of padding is a constant whose message schedule is worked out once on
the host.  Small tree levels, where a tensor op costs more to launch than it
computes, are hashed with ``hashlib`` instead: both give the same digests.

Merkle conventions of the protocol (no leaf or node domain separation): a
leaf digest is SHA-256 of the leaf's payload bytes, a node's is SHA-256 of
its two children's digests, left first.

This module imports nothing of the program under test.
"""

from __future__ import annotations

import hashlib
from typing import List, Sequence, Union

import numpy as np
import torch

M32 = 0xFFFFFFFF
H0 = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A, 0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1, 0x923F82A4, 0xAB1C5ED5,
    0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3, 0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174,
    0xE49B69C1, 0xEFBE4786, 0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147, 0x06CA6351, 0x14292967,
    0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13, 0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85,
    0xA2BFE8A1, 0xA81A664B, 0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A, 0x5B9CCA4F, 0x682E6FF3,
    0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208, 0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)
# levels with at most this many nodes are hashed on the host
HOST_LEVEL = 1 << 12

Word = Union[torch.Tensor, int]


def _rotr(x, r: int):
    return (x >> r) | ((x << (32 - r)) & M32)


def _schedule_const(block: Sequence[int]) -> List[int]:
    w = list(block)
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    return w


def _compress(st: List[Word], block: Sequence[Word]) -> List[torch.Tensor]:
    """One compression of a batch: ``st`` the 8 chaining words, ``block`` 16
    words (tensors, or ints where every message has the same word)."""
    if all(isinstance(x, int) for x in block):
        w = _schedule_const(block)
    else:
        w = list(block)
        for t in range(16, 64):
            a, b = w[t - 15], w[t - 2]
            s0 = _rotr(a, 7) ^ _rotr(a, 18) ^ (a >> 3)
            s1 = _rotr(b, 17) ^ _rotr(b, 19) ^ (b >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = st
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ M32) & g)
        t1 = h + s1 + ch + (K[t] + w[t])
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = (t1 + s0 + maj) & M32, a, b, c, (d + t1) & M32, e, f, g
    return [(x + y) & M32 for x, y in zip(st, (a, b, c, d, e, f, g, h))]


def digest_words(words: List[Word], n: int, device) -> torch.Tensor:
    """SHA-256 of ``n`` messages of ``len(words)`` big-endian 32-bit words
    each: ``words[j]`` is word j of every message, an (n,) tensor or an int.
    Returns the (8, n) digest words."""
    n_bits = 32 * len(words)
    msg = list(words) + [0x80000000]
    while len(msg) % 16 != 14:
        msg.append(0)
    msg += [n_bits >> 32, n_bits & M32]
    st: List[Word] = [torch.full((n,), v, dtype=torch.int64, device=device) for v in H0]
    for i in range(0, len(msg), 16):
        st = _compress(st, msg[i : i + 16])
    return torch.stack(st)


def element_words(x: torch.Tensor) -> List[torch.Tensor]:
    """The four big-endian message words of each element's 16 little-endian
    bytes, from the (8, ...) 16-bit limbs."""
    def swap16(v):
        return ((v & 0xFF) << 8) | (v >> 8)

    return [(swap16(x[2 * j]) << 16) | swap16(x[2 * j + 1]) for j in range(4)]


def words_to_bytes(dig: torch.Tensor) -> np.ndarray:
    """(8, n) digest words -> (n, 32) uint8 digest bytes on the host."""
    return dig.detach().to("cpu").numpy().astype(">u4").T.copy().view(np.uint8).reshape(-1, 32)


def leaf_digests(payload: Sequence[torch.Tensor]) -> torch.Tensor:
    """Digests of leaves whose payloads are ``payload[0][i] || payload[1][i] ||
    ...``, each an (8, n) element tensor: (8, n) digest words."""
    words = [w for col in payload for w in element_words(col)]
    return digest_words(words, payload[0].shape[1], payload[0].device)


class Tree:
    """A Merkle tree: ``levels[0]`` the leaf digests, ``levels[-1]`` the root.
    A level is an (8, n) word tensor, or, once small enough, an (n, 32) array
    of digest bytes on the host."""

    def __init__(self, leaves: torch.Tensor):
        levels: list = [leaves]
        cur = leaves
        while (cur.shape[1] if isinstance(cur, torch.Tensor) else cur.shape[0]) > 1:
            if isinstance(cur, torch.Tensor) and cur.shape[1] > HOST_LEVEL:
                left, right = cur[:, 0::2], cur[:, 1::2]
                cur = digest_words(list(left.unbind(0)) + list(right.unbind(0)), left.shape[1], left.device)
            else:
                if isinstance(cur, torch.Tensor):
                    cur = words_to_bytes(cur)
                    levels[-1] = cur
                pairs = cur.reshape(-1, 64)
                cur = np.frombuffer(b"".join(hashlib.sha256(p.tobytes()).digest() for p in pairs),
                                    dtype=np.uint8).reshape(-1, 32)
            levels.append(cur)
        self.levels = levels

    def root(self) -> bytes:
        top = self.levels[-1]
        return (words_to_bytes(top) if isinstance(top, torch.Tensor) else top)[0].tobytes()

    def siblings(self, indices: Sequence[int]) -> List[List[bytes]]:
        """For each index, the sibling digests from the leaf level up."""
        out = [[] for _ in indices]
        cur = np.asarray(indices, dtype=np.int64)
        for level in self.levels[:-1]:
            sib = cur ^ 1
            if isinstance(level, torch.Tensor):
                got = words_to_bytes(level[:, torch.as_tensor(sib, device=level.device)])
            else:
                got = level[sib]
            for q in range(len(indices)):
                out[q].append(got[q].tobytes())
            cur = cur >> 1
        return out
