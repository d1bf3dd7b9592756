"""The SHA-256 CUDA kernels' wrappers and plain versions.

Counterpart of the JAX package's ``sha256_pallas.py``.  Three kernels share
one compression (``csrc/sha256.cuh``):

* ``sha256_words``  - N contiguous big-endian messages, one per thread
  (``csrc/sha256_words.cu``);
* ``leaf_hashes``   - Merkle leaf digests of ``(B, n, 4)`` field-element
  columns read where they lie, bytes swapped in registers
  (``csrc/sha256_leaves.cu``, counted as ``sha256_leaves``);
* ``tree_levels``   - every level above the leaf digests, up to eleven
  levels a launch (``csrc/merkle_levels.cu``, counted as ``merkle_levels``).

Beside them, ``open_gather`` (``csrc/open_gather.cu``) gathers the query
openings of every tree of a proof - leaf payloads and sibling digests - in
one launch.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
tensor-code version beside each wrapper.  Each launch is counted in
``stats`` as ``launch.<kernel>``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import stats
from .field import limbs

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

def _launch(kernel: str, symbol: str, device: torch.device, *args) -> None:
    """Enqueue one kernel on PyTorch's current stream of ``device``."""
    from . import _build

    rc = _build.lib()[symbol](
        *args,
        device.index if device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch (cudaError {rc})")
    stats.bump("launch." + kernel)


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
    n, n_words = msg_words.shape
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    if n:
        _launch("sha256_words", "mlt_sha256_messages", dev,
                msg_words.data_ptr(), out.data_ptr(), n, n_words)
    return out


# ---------------------------------------------------------------------------
# Merkle leaves: field-element columns hashed in place
# ---------------------------------------------------------------------------


def limbs_to_words(a: torch.Tensor) -> torch.Tensor:
    """S+(4,) field tensor -> S+(4,) big-endian SHA message words.

    Hashing an element means hashing its 16 little-endian bytes (quirk Q9);
    read as big-endian words, that is a byte swap of each 32-bit limb.
    """
    b = a.contiguous().view(torch.uint8).reshape(a.shape + (4,))
    return b.flip(-1).contiguous().view(torch.int32).reshape(a.shape)


def leaf_hashes_plain(leaf_columns: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`leaf_hashes`: swap each limb's bytes,
    concatenate the columns into messages, hash the messages."""
    B = leaf_columns.shape[0]
    msg = torch.cat([limbs_to_words(leaf_columns[b]) for b in range(B)], dim=-1)
    return sha256_words_plain(msg)


def leaf_hashes(leaf_columns: torch.Tensor) -> torch.Tensor:
    """(B, n, 4) leaf payload columns -> (n, 8) leaf digests; leaf i's
    message is the B elements' 16-byte little-endian encodings concatenated.

    The columns are read through their strides (a pair view of a codeword,
    the batch tree's view of B codewords, a slice): every element must be a
    whole 16-byte-aligned unit."""
    t = leaf_columns
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
        raise TypeError("leaf_hashes: expected an int32 tensor")
    if t.dim() != 3 or t.shape[0] < 1 or t.shape[2] != 4:
        raise ValueError(f"leaf_hashes: expected (B, n, 4), got {tuple(t.shape)}")
    dev = t.device
    if dev.type == "cpu":
        return leaf_hashes_plain(t)
    if dev.type != "cuda":
        raise ValueError(f"leaf_hashes: unsupported device {dev}")
    return _leaf_hashes_launch(t)


def _leaf_hashes_launch(t: torch.Tensor) -> torch.Tensor:
    B, n, _ = t.shape
    sb, sn, s1 = t.stride()
    if n and (s1 != 1 or sb % 4 or sn % 4 or t.data_ptr() % 16):
        raise ValueError("leaf_hashes: elements must be whole 16-byte-aligned units")
    out = torch.empty((n, 8), dtype=torch.int32, device=t.device)
    if n:
        _launch("sha256_leaves", "mlt_sha256_leaves", t.device,
                t.data_ptr(), sb // 4, sn // 4, out.data_ptr(), n, B)
    return out


# ---------------------------------------------------------------------------
# Merkle inner levels: several levels a launch
# ---------------------------------------------------------------------------

# A block of the kernel takes 512 child digests (9 levels a launch) or 2048
# (11 levels, less of the block idle in its thin upper levels).  The wide
# block has a quarter of the blocks, so it needs a level large enough to fill
# the card with them: on an H100 it is the faster one from 2^18 digests up
# and the slower one below (chip_smoke.py's routes phase times both on trees
# of 2^10 to 2^22 digests).  A level of 2^10 or 2^11 digests takes it all the
# same, because one wide block finishes that tree in one launch.
_NARROW_SPAN_BITS = 9
_WIDE_SPAN_BITS = 11
_WIDE_FROM_BITS = 18


def levels_plan(n_leaves: int):
    """The launches that hash every level above ``n_leaves`` leaf digests:
    a list of (digests read, levels written, 1 or 4 parents a thread).  A
    level that fits one block finishes the tree in that launch."""
    bits = n_leaves.bit_length() - 1
    if n_leaves < 1 or 1 << bits != n_leaves:
        raise ValueError("tree_levels: leaf count must be a power of two")
    plan = []
    while bits:
        wide = bits >= _WIDE_FROM_BITS or _NARROW_SPAN_BITS < bits <= _WIDE_SPAN_BITS
        k = min(bits, _WIDE_SPAN_BITS if wide else _NARROW_SPAN_BITS)
        plan.append((1 << bits, k, 4 if wide else 1))
        bits -= k
    return plan


def tree_levels_plain(leaf_digests: torch.Tensor):
    """Plain version of :func:`tree_levels`: one hash pass per level."""
    levels = []
    cur = leaf_digests
    while cur.shape[0] > 1:
        cur = sha256_words_plain(cur.reshape(cur.shape[0] // 2, 16))
        levels.append(cur)
    return levels


def tree_levels(leaf_digests: torch.Tensor):
    """All levels above (n, 8) leaf digests, root last: level j holds
    n / 2^j digests, parent i = SHA-256(child 2i || child 2i+1).  On the card
    the levels are slices of one allocation."""
    t = leaf_digests
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
        raise TypeError("tree_levels: expected an int32 tensor")
    if t.dim() != 2 or t.shape[1] != 8 or not t.is_contiguous():
        raise ValueError(f"tree_levels: expected contiguous (n, 8) digests, got {tuple(t.shape)}")
    n = t.shape[0]
    plan = levels_plan(n)
    dev = t.device
    if dev.type == "cpu":
        return tree_levels_plain(t)
    if dev.type != "cuda":
        raise ValueError(f"tree_levels: unsupported device {dev}")
    return _tree_levels_launch(t, plan)


def _tree_levels_launch(t: torch.Tensor, plan):
    n = t.shape[0]
    if n < 2:
        return []
    store = torch.empty((n - 1, 8), dtype=torch.int32, device=t.device)
    levels, cur, off = [], t, 0
    for n_in, k, per_thread in plan:
        _launch("merkle_levels", "mlt_merkle_levels", t.device,
                cur.data_ptr(), store[off:].data_ptr(), n_in, k, per_thread)
        for j in range(1, k + 1):
            levels.append(store[off : off + (n_in >> j)])
            off += n_in >> j
        cur = levels[-1]
    return levels


# ---------------------------------------------------------------------------
# Merkle openings: every tree's payloads and siblings in one launch
# ---------------------------------------------------------------------------


def open_gather_plain(trees, idx: np.ndarray) -> torch.Tensor:
    """Plain version of :func:`open_gather`: per tree, the payload columns
    gathered at the indices and each level's siblings, concatenated."""
    parts = []
    for cols, levels in trees:
        cur = torch.as_tensor(idx & (cols.shape[1] - 1), device=cols.device)
        parts.append(cols[:, cur].reshape(-1))
        for level in levels:
            parts.append(level[cur ^ 1].reshape(-1))
            cur = cur >> 1
    return torch.cat(parts)


def open_gather_table(trees, idx: np.ndarray):
    """The table ``csrc/open_gather.cu`` reads - the indices, then one
    Segment (seven int64) a payload column and a digest level, in the order
    of the output - and the output's length in int32 words."""
    dev, nq = trees[0][0].device, len(idx)
    segs, out = [], 0  # out: uint4 written so far
    for cols, levels in trees:
        if cols.dtype != torch.int32 or cols.device != dev:
            raise TypeError(f"open_gather: payload columns must be int32 on {dev}")
        if cols.dim() != 3 or cols.shape[2] != 4:
            raise ValueError(f"open_gather: payload columns must be (B, n, 4), got {tuple(cols.shape)}")
        B, n, _ = cols.shape
        sb, sn, s1 = cols.stride()
        if n & (n - 1) or len(levels) != n.bit_length() - 1:
            raise ValueError(f"open_gather: a tree of {n} leaves with {len(levels)} levels below its root")
        if s1 != 1 or sb % 4 or sn % 4 or cols.data_ptr() % 16:
            raise ValueError("open_gather: payload elements must be whole 16-byte-aligned units")
        for b in range(B):
            segs.append((cols.data_ptr() + 4 * sb * b, sn // 4, 1, n - 1, 0, 0, out + b * nq))
        out += B * nq
        for lvl, level in enumerate(levels):
            if (level.dtype != torch.int32 or level.device != dev or tuple(level.shape) != (n >> lvl, 8)
                    or level.stride() != (8, 1) or level.data_ptr() % 16):
                raise ValueError(f"open_gather: level {lvl} must be contiguous ({n >> lvl}, 8) int32 digests on {dev}")
            segs.append((level.data_ptr(), 2, 2, n - 1, lvl, 1, out))
            out += 2 * nq
    table = np.concatenate([idx, np.array(segs, dtype=np.int64).reshape(-1)])
    return table, len(segs), 4 * out


def open_gather(trees, idx) -> torch.Tensor:
    """The openings of Merkle trees at query indices, one flat int32 tensor
    on the trees' device: for each tree in order, its B x nq x 4 payload
    limbs (leaf i_q's column b at [b, q]), then its L x nq x 8 sibling
    digest words (level l: the sibling of node i_q >> l).

    ``trees``: (leaf_columns (B, n, 4), levels) pairs, ``levels`` the digest
    levels below the root, the (n, 8) leaf digests first; n is a power of
    two.  ``idx``: the query indices (host integers), which every tree opens,
    each index taken modulo n - so a FRI chain's trees all take the same
    query indices.  On the card: one copy of the indices and the table, and
    one launch (``csrc/open_gather.cu``)."""
    if not trees:
        raise ValueError("open_gather: no trees")
    idx = np.ascontiguousarray(idx, dtype=np.int64).reshape(-1)
    dev = trees[0][0].device
    if dev.type == "cpu":
        return open_gather_plain(trees, idx)
    if dev.type != "cuda":
        raise ValueError(f"open_gather: unsupported device {dev}")
    table, n_segments, n_words = open_gather_table(trees, idx)
    out = torch.empty(n_words, dtype=torch.int32, device=dev)
    if n_words:
        table = limbs.to_device(torch.from_numpy(table), dev)
        _launch("open_gather", "mlt_open_gather", dev, table.data_ptr(), len(idx), n_segments, out.data_ptr())
    return out
