"""Plain reference of the FRI-based multilinear PCS of ``pcs.py``, worked in
blocks so that 2^29 evaluations fit: the same protocol, the same bytes.

Every vector of the proof (the evaluations, the coefficients, each codeword,
the sumcheck tables) is a list of equal blocks of 2^log_b elements, block j
on ``devices[j % D]``, stored between steps as (2^log_b, 4) int32 limbs (16
bytes an element) and widened to ``field``'s eight int64 limbs only inside a
step.  Where a step pairs element i with i + half (a Moebius bit, an NTT
stage, a fold, a pair leaf) and the pair spans blocks, it pairs block j with
block j + half / 2^log_b; the rest is ``pcs.py``'s code on a block.

One thread feeds every device: a job is a generator whose steps each
enqueue a few hundred operations (:class:`Cards`), and the devices take
turns, so each has work queued while the thread enqueues the next step of
another (a thread a device spent most of its time waiting for the others).
No step waits for a device, so none makes a tensor from host values
(``field.const`` and ``field.sub`` copy their limbs from the host, and such
a copy waits): :func:`sub`, :func:`mul_scalar`, :func:`powers`,
:func:`eq_table` and :func:`moebius_steps` are ``field``'s and ``pcs``'s
functions with their constants written on the device, and
:func:`digest_steps` is ``sha256.digest_words`` cut into steps.

* encode: Moebius transform (the block's own bits, then block pairs), and the
  radix-2 NTT of the bit-reversed, zero-padded coefficients.  Its input after
  the bit-reversal is x[2i] = c[i], x[2i + 1] = 0, which the first stage
  turns into x[2i] = x[2i + 1] = c[i]: codeword block j starts as half j mod 2
  of coefficient block j div 2, each element twice; stages 2 .. log_b run
  inside a block, the later ones pair blocks (twiddle w_L^(u 2^log_b + t));
* Merkle trees: each block of leaf digests hashed up to its root (up to
  GROUP blocks of a device side by side), then the roots up to the tree's
  root; every level is kept (int32 words) for the openings;
* rounds: the sums and folds of ``pcs.sumcheck_round`` / ``fold_table`` and
  ``Layers.fold`` on block pairs (fold twiddle inv_g^(2^k (j 2^log_b + t))),
  and ``pcs.py``'s own functions once a vector is one block.

Nothing of the program under test is imported or read.
"""

from __future__ import annotations

import hashlib
import inspect
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from . import field as F
from . import pcs as ref
from .proof import Writer
from .sha256 import H0, HOST_LEVEL, K, _rotr, _schedule_const, element_words, words_to_bytes
from .transcript import Transcript

M32 = 0xFFFFFFFF
GROUP = 4  # a device's subtrees hashed side by side: a quarter of the launches, 4 x the memory a step


def wide(x: torch.Tensor) -> torch.Tensor:
    """(B, 4) int32 limbs -> (8, B) int64 ``field`` limbs."""
    return F.from_u32_limbs(x)


def narrow(x: torch.Tensor) -> torch.Tensor:
    """(8, B) int64 ``field`` limbs -> (B, 4) int32 limbs."""
    return F.to_u32_limbs(x)


def compact(words: torch.Tensor) -> torch.Tensor:
    """32-bit digest words held in int64 -> the same bits in int32."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def log2(n: int) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"{n} is not a power of two")
    return n.bit_length() - 1


class Cards:
    """The devices of the blocks: block j on ``devices[j % D]``.  ``run`` does
    a list of (block, job) in this thread: a job returns its result, or is a
    generator whose steps each enqueue some work on its block's device and
    which returns its result.  The devices take turns, one step of each
    device's current job at a time, each device's jobs in order; the results
    come back in the list's order."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]

    def of(self, j: int) -> torch.device:
        return self.devices[j % len(self.devices)]

    def run(self, jobs: Sequence[Tuple[int, Callable]]) -> list:
        out = [None] * len(jobs)
        lanes: dict = {}
        for i, (j, job) in enumerate(jobs):
            lanes.setdefault(j % len(self.devices), []).append((i, job))
        waiting = [iter(items) for items in lanes.values()]
        current: list = [None] * len(waiting)
        while waiting:
            for q in range(len(waiting) - 1, -1, -1):
                if current[q] is None:
                    nxt = next(waiting[q], None)
                    if nxt is None:
                        del waiting[q], current[q]
                        continue
                    i, job = nxt
                    res = job()
                    if not inspect.isgenerator(res):
                        out[i] = res
                        continue
                    current[q] = (i, res)
                i, steps = current[q]
                try:
                    next(steps)
                except StopIteration as done:
                    out[i], current[q] = done.value, None
        return out


# -- field and hash functions that enqueue without waiting for the device ------


def limbs_on(v: int, device, extra_dims: int = 1) -> torch.Tensor:
    """v's eight 16-bit limbs as (8,) + (1,) * extra_dims int64, written on
    the device by fills (no copy from the host)."""
    out = torch.empty((F.LIMBS,) + (1,) * extra_dims, dtype=torch.int64, device=device)
    for i in range(F.LIMBS):
        out[i] = (v >> (16 * i)) & F.MASK
    return out


_P_ON: dict = {}  # (device, extra_dims) -> p's limbs


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``field.sub``: a + (p - b) < 2p, the borrows, the canonical step."""
    key = (a.device, a.dim() - 1)
    if key not in _P_ON:
        _P_ON[key] = limbs_on(F.P, *key)
    d = a - b + _P_ON[key]
    out, carry = [], None
    for k in range(F.LIMBS):
        v = d[k] if carry is None else d[k] + carry
        out.append(v & F.MASK)
        carry = v >> 16
    out.append(carry)
    return F._canonical(out)


def mul_scalar(a: torch.Tensor, s: int) -> torch.Tensor:
    """``field.mul_scalar``."""
    return F.mul(a, limbs_on(s % F.P, a.device, a.dim() - 1))


def powers(base: int, count: int, device) -> torch.Tensor:
    """``field.powers``: (8, count) of base^0 .. base^(count-1), by doubling."""
    out = limbs_on(1, device)
    step = base % F.P
    while out.shape[1] < count:
        out = torch.cat([out, F.mul(out, limbs_on(step, device))], dim=1)
        step = step * step % F.P
    return out[:, :count]


def eq_table(point: Sequence[int], device) -> torch.Tensor:
    """``pcs.eq_table``: eq(point, bits(i)) for i < 2^n, point[0] pairing
    with the top bit."""
    t = limbs_on(1, device)
    for p in point:
        t = torch.stack([mul_scalar(t, 1 - p), mul_scalar(t, p)], dim=-1).reshape(F.LIMBS, -1)
    return t


def moebius_steps(x: torch.Tensor):
    """``pcs.moebius`` over the last axis, a step every four bits."""
    shape = x.shape
    for i in range(log2(shape[-1])):
        v = x.reshape(shape[:-1] + (-1, 2, 1 << i))
        lo, hi = v[..., 0, :], v[..., 1, :]
        x = torch.stack([lo, sub(hi, lo)], dim=-2).reshape(shape)
        if i % 4 == 3:
            yield
    return x


def _compress_steps(st: list, block: Sequence):
    """``sha256._compress``, a step every eight rounds; the message schedule
    is made as the rounds use it and each word dropped once no later word
    needs it (16 words live, not 64)."""
    const = all(isinstance(x, int) for x in block)
    w = _schedule_const(block) if const else list(block)
    a, b, c, d, e, f, g, h = st
    for t in range(64):
        if not const and t >= 16:
            x, y = w[t - 15], w[t - 2]
            s0 = _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)
            s1 = _rotr(y, 17) ^ _rotr(y, 19) ^ (y >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
            w[t - 16] = None
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ M32) & g)
        t1 = h + s1 + ch + (K[t] + w[t])
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        a, b, c, d, e, f, g, h = (t1 + s0 + maj) & M32, a, b, c, (d + t1) & M32, e, f, g
        if t % 8 == 7:
            yield
    return [(x + y) & M32 for x, y in zip(st, (a, b, c, d, e, f, g, h))]


def digest_steps(words: list, n: int, device):
    """``sha256.digest_words`` in steps: the (8, n) digest words of n
    messages, ``words[j]`` word j of every message."""
    n_bits = 32 * len(words)
    msg = list(words) + [0x80000000]
    while len(msg) % 16 != 14:
        msg.append(0)
    msg += [n_bits >> 32, n_bits & M32]
    st: list = [torch.full((n,), v, dtype=torch.int64, device=device) for v in H0]
    for i in range(0, len(msg), 16):
        st = yield from _compress_steps(st, msg[i : i + 16])
    return torch.stack(st)


# -- the multilinear extension -------------------------------------------------


def eq_prefix(point: Sequence[int], j: int) -> int:
    """eq(point, bits of block j): point[0] pairs with the top bit."""
    acc = 1
    for i, p in enumerate(point):
        bit = (j >> (len(point) - 1 - i)) & 1
        acc = acc * (p if bit else 1 - p) % F.P
    return acc


def limb_value(sums) -> int:
    """A field value from its limb sums (eight ints, 16-bit limb weights)."""
    return sum(int(v) << (16 * i) for i, v in enumerate(sums)) % F.P


def mle_partial(blocks: Sequence[Tuple[int, torch.Tensor]], point: Sequence[int], log_b: int) -> int:
    """sum over the given blocks (global index j, (2^log_b, 4) int32 tensor)
    of evals[i] eq(point, i): eq(point's first n - log_b, j) times the block's
    sum of evals[t] eq(point's rest, t)."""
    n = len(point)
    lo: dict = {}
    sums = []
    for j, blk in blocks:
        if blk.device not in lo:
            lo[blk.device] = eq_table(point[n - log_b :], blk.device)
        sums.append((j, F.mul(wide(blk), lo[blk.device]).sum(dim=1)))
    return sum(eq_prefix(point[: n - log_b], j) * limb_value(s.tolist()) for j, s in sums) % F.P


def mle_eval(blocks: Sequence[torch.Tensor], point: Sequence[int]) -> int:
    """The multilinear extension of the evaluations in ``blocks`` at ``point``."""
    return mle_partial(list(enumerate(blocks)), point, log2(blocks[0].shape[0]))


# -- the encode ------------------------------------------------------------------


def dit_steps(x: torch.Tensor, pows: torch.Tensor, first: int):
    """Radix-2 decimation-in-time stages ``first`` .. log2(len) of ``pcs.ntt``
    over an (8, B) block, a step a stage; ``pows`` the B / 2 powers of the
    2^log B-th root of unity."""
    m = x.shape[-1]
    for s in range(first, log2(m) + 1):
        length = 1 << s
        v = x.reshape(F.LIMBS, m // length, 2, length // 2)
        tw = pows[:, :: m // length][:, : length // 2].reshape(F.LIMBS, 1, length // 2)
        u, w = v[:, :, 0, :], F.mul(v[:, :, 1, :], tw)
        x = torch.stack([F.add(u, w), sub(u, w)], dim=2).reshape(F.LIMBS, m)
        yield
    return x


def encode(evals: List[torch.Tensor], cards: Cards) -> List[torch.Tensor]:
    """The evaluation blocks -> the blocks of the Reed-Solomon codeword
    (``pcs.encode``), twice as many, of the same size."""
    nb, B = len(evals), evals[0].shape[0]
    log_b = log2(B)

    def moebius_block(j):
        return narrow((yield from moebius_steps(wide(evals[j]))))

    coeffs = cards.run([(j, lambda j=j: moebius_block(j)) for j in range(nb)])
    step = 1
    while step < nb:
        def cross_bit(j, step=step):
            hi, lo = coeffs[j | step], coeffs[j]
            coeffs[j | step] = narrow(sub(wide(hi), wide(lo.to(hi.device))))

        cards.run([(j | step, lambda j=j: cross_bit(j)) for j in range(nb) if not j & step])
        step <<= 1

    pows: dict = {}

    def first_block(j):
        dev = cards.of(j)
        if dev not in pows:
            pows[dev] = powers(F.pow2_generator(log_b), max(B // 2, 1), dev)
        part = coeffs[j // 2][(j % 2) * (B // 2) : (j % 2 + 1) * (B // 2)].to(dev)
        return narrow((yield from dit_steps(wide(part).repeat_interleave(2, dim=1), pows[dev], 2)))

    code = cards.run([(j, lambda j=j: first_block(j)) for j in range(2 * nb)])
    del coeffs, pows
    for s in range(log_b + 1, log2(2 * nb * B) + 1):
        G, gen = 1 << (s - log_b), F.pow2_generator(s)
        table: dict = {}

        def stage(lo_j, u, G=G, gen=gen, table=table):
            dev, hi_j = cards.of(lo_j), lo_j + G // 2
            if dev not in table:
                table[dev] = powers(gen, B, dev)
                yield
            lo, hi = wide(code[lo_j]), wide(code[hi_j].to(dev))
            w = F.mul(hi, table[dev])
            yield
            w = mul_scalar(w, pow(gen, u * B, F.P))
            yield
            code[lo_j] = narrow(F.add(lo, w))
            code[hi_j] = narrow(sub(lo, w)).to(cards.of(hi_j))

        cards.run([(g + u, lambda g=g, u=u: stage(g + u, u)) for g in range(0, 2 * nb, G) for u in range(G // 2)])
    return code


# -- Merkle trees ------------------------------------------------------------------


def _subtree_steps(leaves, blocks: int):
    """The levels of ``blocks`` subtrees side by side: their (8, blocks n)
    leaf digest words (from the steps ``leaves``) hashed up while a block's
    level has more than HOST_LEVEL nodes (``sha256.Tree``'s rule; a pair never
    spans two blocks), each kept as int32 words; the last, still int64, is
    what the host hashes on."""
    cur = yield from leaves
    levels = []
    while cur.shape[1] // blocks > HOST_LEVEL:
        words = list(cur[:, 0::2].unbind(0)) + list(cur[:, 1::2].unbind(0))
        nxt = yield from digest_steps(words, cur.shape[1] // 2, cur.device)
        levels.append(compact(cur))
        cur = nxt
    return levels + [cur]


def _host_levels(level: np.ndarray) -> list:
    """(n, 32) digest bytes -> the levels up to the root, ``level`` first."""
    levels = [level]
    while levels[-1].shape[0] > 1:
        pairs = levels[-1].reshape(-1, 64)
        levels.append(np.frombuffer(b"".join(hashlib.sha256(p.tobytes()).digest() for p in pairs),
                                    dtype=np.uint8).reshape(-1, 32))
    return levels


def _level_bytes(level, idx: np.ndarray) -> np.ndarray:
    """(len(idx), 32) digest bytes of nodes ``idx`` of a kept level."""
    if isinstance(level, torch.Tensor):
        sel = level[:, torch.as_tensor(idx, device=level.device)]
        return words_to_bytes(sel.to(torch.int64) & M32)
    return level[idx]


class BlockTree:
    """A Merkle tree whose leaves come in blocks: each block's subtree, then
    the tree over the blocks' roots.  ``groups`` lists (blocks, leaves):
    blocks on one device whose subtrees are hashed side by side, and
    ``leaves()``, the steps that make their leaf digest words, block after
    block."""

    def __init__(self, groups: List[Tuple[List[int], Callable]], cards: Cards):
        issued = cards.run([(blocks[0], lambda blocks=blocks, leaves=leaves: _subtree_steps(leaves(), len(blocks)))
                            for blocks, leaves in groups])
        self.subtrees: list = [None] * sum(len(blocks) for blocks, _ in groups)
        for (blocks, _), levels in zip(groups, issued):
            g = len(blocks)
            for i, b in enumerate(blocks):
                mine = [lv[:, i * (lv.shape[1] // g) : (i + 1) * (lv.shape[1] // g)] for lv in levels]
                self.subtrees[b] = mine[:-1] + _host_levels(words_to_bytes(mine[-1]))
        self.block_leaves = issued[0][0].shape[1] // len(groups[0][0])
        self.top = _host_levels(np.concatenate([s[-1] for s in self.subtrees]))

    def root(self) -> bytes:
        return self.top[-1][0].tobytes()

    def siblings(self, indices: Sequence[int]) -> List[List[bytes]]:
        """For each leaf index, the sibling digests from the leaf level up."""
        idx = np.asarray(indices, dtype=np.int64)
        blk, local = idx // self.block_leaves, idx % self.block_leaves
        per_level: List[np.ndarray] = []
        for level in range(len(self.subtrees[0]) - 1):
            got = np.empty((len(idx), 32), dtype=np.uint8)
            for b in np.unique(blk):
                rows = np.nonzero(blk == b)[0]
                got[rows] = _level_bytes(self.subtrees[b][level], (local[rows] >> level) ^ 1)
            per_level.append(got)
        for level in range(len(self.top) - 1):
            per_level.append(self.top[level][(blk >> level) ^ 1])
        return [[lv[q].tobytes() for lv in per_level] for q in range(len(idx))]


def _leaf_steps(lo: torch.Tensor, hi: torch.Tensor):
    """``sha256.leaf_digests`` of the pair leaves (lo[i], hi[i]) in steps."""
    words = [w for col in (wide(lo), wide(hi)) for w in element_words(col)]
    return (yield from digest_steps(words, lo.shape[0], lo.device))


def pair_tree(code: List[torch.Tensor], cards: Cards) -> BlockTree:
    """The pair tree of a codeword: leaf i is (code[i], code[i + half]).
    Leaf block j pairs code blocks j and j + half, on block j's device; up to
    GROUP of a device's leaf blocks are hashed side by side."""
    if len(code) == 1:
        h = code[0].shape[0] // 2
        return BlockTree([([0], lambda: _leaf_steps(code[0][:h], code[0][h:]))], cards)
    half, D = len(code) // 2, len(cards.devices)
    lanes = [list(range(c, half, D)) for c in range(min(D, half))]
    groups = [lane[i : i + GROUP] for lane in lanes for i in range(0, len(lane), GROUP)]

    def leaves(blocks):
        dev = cards.of(blocks[0])
        return _leaf_steps(torch.cat([code[j] for j in blocks]), torch.cat([code[j + half].to(dev) for j in blocks]))

    return BlockTree([(blocks, lambda blocks=blocks: leaves(blocks)) for blocks in groups], cards)


def gather_values(code: List[torch.Tensor], positions: np.ndarray) -> List[int]:
    """The codeword's elements at ``positions``, as ints."""
    B = code[0].shape[0]
    out = [0] * len(positions)
    for b in np.unique(positions // B):
        rows = np.nonzero(positions // B == b)[0]
        sel = code[b][torch.as_tensor(positions[rows] % B, device=code[b].device)]
        for q, v in zip(rows, F.to_ints(wide(sel))):
            out[q] = v
    return out


# -- the prover ------------------------------------------------------------------


class BlockedPCS:
    """``pcs.prove`` in blocks, up to the query draw: construction encodes,
    commits, and runs every round; :meth:`proof` draws the queries and
    writes the proof (from a copy of the transcript, so one run of the
    rounds gives the proofs of several query counts)."""

    def __init__(self, evals: List[torch.Tensor], point: Sequence[int], t: Transcript, devices: Sequence):
        cards = self.cards = Cards(devices)
        self.point = [int(p) % F.P for p in point]
        n, nb = len(self.point), len(evals)
        log_b = log2(evals[0].shape[0])
        if nb << log_b != 1 << n:
            raise ValueError(f"{nb} blocks of 2^{log_b} evaluations for {n} variables")
        evals = [e.to(cards.of(j)) for j, e in enumerate(evals)]
        self.output = mle_eval(evals, self.point)
        self.t = t
        code = encode(evals, cards)
        self.codes, self.trees = [code], [pair_tree(code, cards)]
        t.absorb(self.trees[0].root())
        lo: dict = {}

        def eq_block(j):
            dev = cards.of(j)
            if dev not in lo:
                lo[dev] = eq_table(self.point[n - log_b :], dev)
            return narrow(mul_scalar(lo[dev], eq_prefix(self.point[: n - log_b], j)))

        tables = (evals, cards.run([(j, lambda j=j: eq_block(j)) for j in range(nb)]))
        del lo
        prev, self.pols, self.last = self.output, [], None
        m = 2 << n
        self.inv_g = pow(F.pow2_generator(log2(m)), F.P - 2, F.P)
        for k in range(n):
            coeffs, r, prev, tables = self._sumcheck_round(tables, prev)
            self.pols.append(coeffs)
            code = self._fold(code, k, r)

    def _sumcheck_round(self, tables, prev: int):
        """``pcs.sumcheck_round`` and ``pcs.fold_table`` on the (p, delta)
        blocks: returns (coeffs, r, next sum, folded tables)."""
        p, d = tables
        cards = self.cards
        if len(p) == 1:
            x = torch.stack([wide(p[0]), wide(d[0])], dim=1)
            coeffs, r, nxt = ref.sumcheck_round(self.t, x, prev)
            x = ref.fold_table(x, r)
            return coeffs, r, nxt, ([narrow(x[:, 0])], [narrow(x[:, 1])])
        half = len(p) // 2

        def pair(j):
            dev = cards.of(j)
            return [wide(p[j]), wide(d[j]), wide(p[j + half].to(dev)), wide(d[j + half].to(dev))]

        def sums(j):
            lo_p, lo_d, hi_p, hi_d = pair(j)
            e1 = F.mul(hi_p, hi_d).sum(dim=1)
            yield
            e2 = F.mul(sub(F.add(hi_p, hi_p), lo_p), sub(F.add(hi_d, hi_d), lo_d)).sum(dim=1)
            return torch.stack([e1, e2])

        parts = cards.run([(j, lambda j=j: sums(j)) for j in range(half)])
        total = sum(np.asarray(s.tolist(), dtype=object) for s in parts)
        e1, e2 = limb_value(total[0]), limb_value(total[1])
        coeffs = ref.interpolate([(prev - e1) % F.P, e1, e2])
        for c in coeffs[1:]:
            self.t.absorb_felt(c)
        r = self.t.challenge()

        def fold(j):
            lo_p, lo_d, hi_p, hi_d = pair(j)
            p_j = narrow(F.add(lo_p, mul_scalar(sub(hi_p, lo_p), r)))
            yield
            return p_j, narrow(F.add(lo_d, mul_scalar(sub(hi_d, lo_d), r)))

        folded = cards.run([(j, lambda j=j: fold(j)) for j in range(half)])
        return coeffs[1:], r, ref.poly_eval(coeffs, r), ([f[0] for f in folded], [f[1] for f in folded])

    def _fold(self, code: List[torch.Tensor], k: int, r: int) -> List[torch.Tensor]:
        """``pcs.Layers.fold`` of round k on the blocks: commit the result and
        absorb its root, or absorb the last element."""
        cards, B = self.cards, code[0].shape[0]
        base = pow(self.inv_g, 1 << k, F.P)  # twiddle of element t: base^t
        rh = r * F.INV2 % F.P

        def fold(a, b, tw, s):
            x = mul_scalar(F.add(a, b), F.INV2)
            yield
            y = F.mul(sub(a, b), tw)
            yield
            return narrow(F.add(x, mul_scalar(y, rh * s % F.P)))

        if len(code) == 1:
            x = wide(code[0])
            h = x.shape[1] // 2
            new = cards.run([(0, lambda: fold(x[:, :h], x[:, h:], powers(base, h, x.device), 1))])
        else:
            half = len(code) // 2
            table: dict = {}

            def block(j):
                dev = cards.of(j)
                if dev not in table:
                    table[dev] = powers(base, B, dev)
                    yield
                a, b = wide(code[j]), wide(code[j + half].to(dev))
                return (yield from fold(a, b, table[dev], pow(base, j * B, F.P)))

            new = cards.run([(j, lambda j=j: block(j)) for j in range(half)])
        if len(new) * new[0].shape[0] == 1 << ref.LOG_BLOWUP:
            vals = [v for blk in new for v in F.to_ints(wide(blk))]
            if any(v != vals[0] for v in vals):
                raise ValueError("the last fold is not constant: not a Reed-Solomon codeword")
            self.last = vals[0]
            self.t.absorb_felt(self.last)
            return new
        self.codes.append(new)
        self.trees.append(pair_tree(new, cards))
        self.t.absorb(self.trees[-1].root())
        return new

    def proof(self, num_queries: int = ref.NUM_QUERIES) -> Writer:
        """The proof's bytes with ``num_queries`` queries (``pcs.prove``'s)."""
        t = Transcript()
        t._h = self.t._h.copy()
        n = len(self.point)
        indices = ref.draw_queries(t, 1 << n, num_queries)
        w = Writer()
        w.mark("commitments")
        w.u64(len(self.trees))
        for tree in self.trees:
            w.raw(tree.root())
        w.mark("queries")
        w.u64(len(indices))
        layers = []
        for code, tree in zip(self.codes, self.trees):
            half = len(code) * code[0].shape[0] // 2
            idx = np.asarray([i % half for i in indices], dtype=np.int64)
            layers.append((idx, gather_values(code, idx), gather_values(code, idx + half), tree.siblings(idx)))
        for q in range(len(indices)):
            ref.write_paths(w, [([lo[q], hi[q]], int(idx[q]), sibs[q]) for idx, lo, hi, sibs in layers])
        w.mark("last")
        w.felt(self.last)
        w.raw(t.digest())
        ref._write_tail(w, self.pols, list(self.point), [self.output])
        return w

