"""The SHA-256 CUDA kernel's wrapper, plain version and launch counter.

Counterpart of the JAX package's ``sha256_pallas.py``.  A CUDA tensor
launches ``csrc/sha256_words.cu`` (one message per thread, padding built
in-kernel) or raises; a CPU tensor runs the plain tensor-code version.
"""

from __future__ import annotations

import torch

_K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
]
_H0 = [
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
]
_M32 = 0xFFFFFFFF

_LAUNCHES = {"sha256_words": 0}


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES["sha256_words"] = 0


def n_blocks(n_words: int) -> int:
    """64-byte blocks after the mandatory 0x80 byte and the 8-byte length."""
    return (n_words + 1 + 2 + 15) // 16


def _rotr(x, r):
    return ((x >> r) | (x << (32 - r))) & _M32


def _compress(state, w):
    """One SHA-256 compression on int64 lanes holding 32-bit words."""
    a, b, c, d, e, f, g, h = state
    w = list(w)
    for t in range(64):
        if t >= 16:
            w1, w14 = w[t - 15], w[t - 2]
            s0 = _rotr(w1, 7) ^ _rotr(w1, 18) ^ (w1 >> 3)
            s1 = _rotr(w14, 17) ^ _rotr(w14, 19) ^ (w14 >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M32)
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ _M32) & g)
        t1 = h + S1 + ch + _K[t] + w[t]
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = S0 + maj
        a, b, c, d, e, f, g, h = (t1 + t2) & _M32, a, b, c, (d + t1) & _M32, e, f, g
    return [(s + x) & _M32 for s, x in zip(state, (a, b, c, d, e, f, g, h))]


def sha256_words_plain(msg_words: torch.Tensor) -> torch.Tensor:
    """Plain version: (N, n_words) int32 -> (N, 8) int32, any device."""
    n, n_words = msg_words.shape
    m = msg_words.to(torch.int64) & _M32
    zero = torch.zeros(n, dtype=torch.int64, device=msg_words.device)
    total = n_blocks(n_words) * 16
    bit_len = 32 * n_words
    words = [m[:, i] for i in range(n_words)] + [zero + 0x80000000]
    words += [zero] * (total - 2 - len(words))
    words += [zero + (bit_len >> 32), zero + (bit_len & _M32)]
    state = [zero + h for h in _H0]
    for blk in range(total // 16):
        state = _compress(state, words[16 * blk : 16 * blk + 16])
    out = torch.stack(state, dim=-1)
    return ((out ^ 0x80000000) - 0x80000000).to(torch.int32)


def sha256_words(msg_words: torch.Tensor) -> torch.Tensor:
    """SHA-256 of N messages of ``n_words`` big-endian 32-bit words each:
    (N, n_words) int32 -> (N, 8) int32 digest words."""
    if not isinstance(msg_words, torch.Tensor) or msg_words.dtype != torch.int32:
        raise TypeError("sha256_words: expected an int32 tensor")
    if msg_words.dim() != 2 or msg_words.shape[1] < 1:
        raise ValueError(f"sha256_words: expected (N, n_words), got {tuple(msg_words.shape)}")
    if not msg_words.is_contiguous():
        raise ValueError("sha256_words: messages must be contiguous")
    dev = msg_words.device
    if dev.type == "cpu":
        return sha256_words_plain(msg_words)
    if dev.type != "cuda":
        raise ValueError(f"sha256_words: unsupported device {dev}")
    from . import _build

    n, n_words = msg_words.shape
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    if n:
        rc = _build.lib()["mlt_sha256_words"](
            msg_words.data_ptr(), out.data_ptr(), n, n_words,
            dev.index if dev.index is not None else torch.cuda.current_device(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"CUDA kernel sha256_words failed to launch (cudaError {rc})")
        _LAUNCHES["sha256_words"] += 1
    return out
