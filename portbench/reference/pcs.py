"""Plain reference of the FRI-based multilinear PCS, plain and batched.

Follows the protocol of the Rust reference (fr34za/multilinear,
``src/fri/multilinear_pcs.rs:89-136`` and ``src/fri/batched_pcs.rs``), rate
1/2, SHA-256 Merkle trees over pair leaves (p(x), p(-x)):

* encode: Moebius transform (evaluations -> coefficients), coefficients in
  bit-reversed order, zero-padded to twice the length, radix-2 NTT over
  the 2^(n+1) domain (natural order out);
* commit the codeword's pair tree and absorb its root (the batched PCS
  absorbs the claim first, commits the B codewords' column tree, draws the
  fingerprint challenge and absorbs it, and folds the Horner combination of
  the columns in its first round);
* n rounds: the degree-2 sumcheck polynomial of eq(point, x) * p(x)
  (evaluations at 0, 1, 2; its two nonzero coefficients absorbed), the
  challenge r, the tables folded lo + r (hi - lo), the codeword folded
  ((a + b) + r (a - b) g^(-i 2^k)) / 2, then the new pair tree's root
  absorbed, or after the last fold the last element;
* query indices drawn from the transcript, each absorbed as 8 bytes, and
  the pair paths of every tree opened at them; the transcript's digest last.

Everything is computed again from the inputs: nothing of the program under
test is imported or read.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from . import field as F
from .proof import Writer
from .sha256 import Tree, leaf_digests
from .transcript import Transcript

LOG_BLOWUP = 1
NUM_QUERIES = 128


def bitrev(n_bits: int, device) -> torch.Tensor:
    idx = torch.arange(1 << n_bits, dtype=torch.int64, device=device)
    rev = torch.zeros_like(idx)
    for b in range(n_bits):
        rev |= ((idx >> b) & 1) << (n_bits - 1 - b)
    return rev


def moebius(evals: torch.Tensor) -> torch.Tensor:
    """Evaluations on the hypercube -> multilinear coefficients:
    c[j] -= c[j ^ 2^i] for every j with bit i set, bit by bit."""
    n = evals.shape[-1].bit_length() - 1
    x = evals
    for i in range(n):
        v = x.reshape(x.shape[:-1] + (-1, 2, 1 << i))
        lo, hi = v[..., 0, :], v[..., 1, :]
        x = torch.stack([lo, F.sub(hi, lo)], dim=-2).reshape(evals.shape)
    return x


def ntt(x: torch.Tensor, gen: int) -> torch.Tensor:
    """out[i] = sum_j x[j] gen^(i j) over the last axis (a power of two):
    bit-reversal, then radix-2 decimation-in-time stages."""
    m = x.shape[-1]
    log_m = m.bit_length() - 1
    x = x[..., bitrev(log_m, x.device)]
    pows = F.powers(gen, max(m // 2, 1), x.device)
    for s in range(1, log_m + 1):
        length = 1 << s
        v = x.reshape(x.shape[:-1] + (m // length, 2, length // 2))
        tw = pows[:, :: m // length][:, : length // 2]
        tw = tw.reshape((F.LIMBS,) + (1,) * (x.dim() - 2) + (1, length // 2))
        u, w = v[..., 0, :], F.mul(v[..., 1, :], tw)
        x = torch.stack([F.add(u, w), F.sub(u, w)], dim=-2).reshape(x.shape)
    return x


def encode(evals: torch.Tensor) -> torch.Tensor:
    """(8, ..., 2^n) evaluations -> (8, ..., 2^(n+1)) Reed-Solomon codewords."""
    n = evals.shape[-1].bit_length() - 1
    coeffs = moebius(evals)[..., bitrev(n, evals.device)]
    padded = torch.cat([coeffs, torch.zeros_like(coeffs)], dim=-1)
    return ntt(padded, F.pow2_generator(n + LOG_BLOWUP))


def eq_table(point: Sequence[int], device) -> torch.Tensor:
    """eq(point, bits(i)) for i < 2^n; point[0] pairs with the top bit."""
    t = F.const(1, device)
    for p in point:
        t = torch.stack([F.mul_scalar(t, 1 - p), F.mul_scalar(t, p)], dim=-1).reshape(F.LIMBS, -1)
    return t


def mle_eval(evals: torch.Tensor, point: Sequence[int]) -> int:
    """The multilinear extension of ``evals`` (8, 2^n) at ``point``."""
    return F.sum_mod(F.mul(evals, eq_table(point, evals.device)))


def fingerprint(r: int, items: Sequence[int]) -> int:
    """Horner combination: items[0] r^(B-1) + ... + items[B-1]."""
    acc = 0
    for x in items:
        acc = (acc * r + x) % F.P
    return acc


def fingerprint_rows(r: int, cols: torch.Tensor) -> torch.Tensor:
    """Horner combination over the batch axis of (8, B, ...) -> (8, ...)."""
    acc = cols[:, 0]
    for j in range(1, cols.shape[1]):
        acc = F.add(F.mul_scalar(acc, r), cols[:, j])
    return acc


def interpolate(evals: Sequence[int]) -> List[int]:
    """Coefficients of the polynomial through (x, evals[x]), x = 0..d."""
    n = len(evals)
    coeffs = [0] * n
    for j, y in enumerate(evals):
        basis, denom = [1], 1
        for m in range(n):
            if m == j:
                continue
            basis = [(a - m * b) % F.P for a, b in zip([0] + basis, basis + [0])]
            denom = denom * (j - m) % F.P
        scale = y * pow(denom, F.P - 2, F.P) % F.P
        coeffs = [(c + scale * b) % F.P for c, b in zip(coeffs, basis)]
    return coeffs


def poly_eval(coeffs: Sequence[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % F.P
    return acc


def fold_table(t: torch.Tensor, r: int) -> torch.Tensor:
    off = t.shape[-1] // 2
    lo, hi = t[..., :off], t[..., off:]
    return F.add(lo, F.mul_scalar(F.sub(hi, lo), r))


class Layers:
    """The FRI layers: each committed codeword with its pair tree."""

    def __init__(self, m: int, device):
        self.inv_pows = F.powers(pow(F.pow2_generator(m.bit_length() - 1), F.P - 2, F.P), m // 2, device)
        self.codes: List[torch.Tensor] = []
        self.trees: List[Tree] = []
        self.last = None

    def commit(self, code: torch.Tensor) -> bytes:
        half = code.shape[-1] // 2
        tree = Tree(leaf_digests([code[:, :half], code[:, half:]]))
        self.codes.append(code)
        self.trees.append(tree)
        return tree.root()

    def fold(self, code: torch.Tensor, k: int, r: int, t: Transcript) -> torch.Tensor:
        """Fold with r at round k; commit the result and absorb its root, or
        absorb the last element."""
        half = code.shape[-1] // 2
        a, b = code[:, :half], code[:, half:]
        tw = self.inv_pows[:, :: 1 << k][:, :half]
        nxt = F.add(F.mul_scalar(F.add(a, b), F.INV2), F.mul_scalar(F.mul(F.sub(a, b), tw), r * F.INV2))
        if half == 1 << LOG_BLOWUP:
            vals = F.to_ints(nxt)
            if any(v != vals[0] for v in vals):
                raise ValueError("the last fold is not constant: not a Reed-Solomon codeword")
            self.last = vals[0]
            t.absorb_felt(self.last)
        else:
            t.absorb(self.commit(nxt))
        return nxt

    def open(self, indices: Sequence[int]) -> list:
        """For each query index, each layer's pair path: (values, leaf index,
        siblings)."""
        per_tree = []
        for code, tree in zip(self.codes, self.trees):
            half = code.shape[-1] // 2
            idx = [i % half for i in indices]
            sel = torch.as_tensor(idx, device=code.device)
            vals = F.to_ints(torch.cat([code[:, :half][:, sel], code[:, half:][:, sel]], dim=1))
            per_tree.append((idx, vals, tree.siblings(idx)))
        q = len(indices)
        return [[([vals[i], vals[q + i]], idx[i], sibs[i]) for idx, vals, sibs in per_tree] for i in range(q)]


def write_paths(w: Writer, paths) -> None:
    w.u64(len(paths))
    for values, index, sibs in paths:
        w.path(values, index, sibs)


def sumcheck_round(t: Transcript, tables: torch.Tensor, prev: int):
    """One degree-2 round of sum_x delta(x) p(x) over tables (8, 2, h):
    p in row 0, delta in row 1.  Returns (nonzero coeffs, r, next sum)."""
    off = tables.shape[-1] // 2
    lo, hi = tables[..., :off], tables[..., off:]
    e1 = F.sum_mod(F.mul(hi[:, 0], hi[:, 1]))
    two = F.sub(F.add(hi, hi), lo)  # the linear extension at X = 2
    e2 = F.sum_mod(F.mul(two[:, 0], two[:, 1]))
    coeffs = interpolate([(prev - e1) % F.P, e1, e2])
    for c in coeffs[1:]:
        t.absorb_felt(c)
    r = t.challenge()
    return coeffs[1:], r, poly_eval(coeffs, r)


def draw_queries(t: Transcript, n_pairs: int, count: int) -> List[int]:
    out = []
    for _ in range(count):
        i = t.index(n_pairs)
        t.absorb(i.to_bytes(8, "little"))
        out.append(i)
    return out


def prove(evals: torch.Tensor, point: Sequence[int], output: int, t: Transcript,
          num_queries: int = NUM_QUERIES) -> Writer:
    """The PCS proof of p(point) = output for p given by ``evals`` (8, 2^n)."""
    n = len(point)
    code = encode(evals)
    layers = Layers(code.shape[-1], evals.device)
    t.absorb(layers.commit(code))
    tables = torch.stack([evals, eq_table(point, evals.device)], dim=1)
    prev, pols = output % F.P, []
    for k in range(n):
        c, r, prev = sumcheck_round(t, tables, prev)
        pols.append(c)
        tables = fold_table(tables, r)
        code = layers.fold(code, k, r, t)
    indices = draw_queries(t, 1 << n, num_queries)
    w = Writer()
    w.mark("commitments")
    w.u64(len(layers.trees))
    for tree in layers.trees:
        w.raw(tree.root())
    w.mark("queries")
    w.u64(len(indices))
    for paths in layers.open(indices):
        write_paths(w, paths)
    w.mark("last")
    w.felt(layers.last)
    w.raw(t.digest())
    _write_tail(w, pols, list(point), [output])
    return w


def prove_batched(polys: torch.Tensor, point: Sequence[int], outputs: Sequence[int], t: Transcript,
                  num_queries: int = NUM_QUERIES) -> Writer:
    """The batched PCS proof of B claims at one point, ``polys`` (8, B, 2^n)."""
    n = len(point)
    for x in list(point) + list(outputs):
        t.absorb_felt(x)
    codes = encode(polys)  # (8, B, m)
    m = codes.shape[-1]
    half = m // 2
    batch = Tree(leaf_digests([c for j in range(codes.shape[1]) for c in (codes[:, j, :half], codes[:, j, half:])]))
    t.absorb(batch.root())
    fr = t.challenge()
    t.absorb_felt(fr)
    layers = Layers(m, polys.device)
    tables = torch.stack([fingerprint_rows(fr, polys), eq_table(point, polys.device)], dim=1)
    prev, pols = fingerprint(fr, outputs), []
    code = fingerprint_rows(fr, codes)
    for k in range(n):
        c, r, prev = sumcheck_round(t, tables, prev)
        pols.append(c)
        tables = fold_table(tables, r)
        code = layers.fold(code, k, r, t)
    indices = draw_queries(t, half, num_queries)
    w = Writer()
    w.mark("commitments")
    w.raw(batch.root())
    w.u64(len(layers.trees))
    for tree in layers.trees:
        w.raw(tree.root())
    w.mark("queries")
    sel = torch.as_tensor(indices, device=codes.device)
    lo = F.to_ints(codes[:, :, :half][:, :, sel].reshape(F.LIMBS, -1))  # (B, q), row-major
    hi = F.to_ints(codes[:, :, half:][:, :, sel].reshape(F.LIMBS, -1))
    q, batch_sibs = len(indices), batch.siblings(indices)
    w.u64(q)
    for i, paths in enumerate(layers.open([j % (half // 2) for j in indices])):
        vals = [v for j in range(codes.shape[1]) for v in (lo[j * q + i], hi[j * q + i])]
        w.path(vals, indices[i], batch_sibs[i])
        write_paths(w, paths)
    w.mark("last")
    w.felt(layers.last)
    w.raw(t.digest())
    _write_tail(w, pols, list(point), list(outputs), batched=True)
    return w


def _write_tail(w: Writer, pols, inputs, outputs, batched: bool = False) -> None:
    w.mark("rounds")
    w.u64(len(pols))
    for c in pols:
        w.felts(c)
    w.mark("claim")
    w.felts(inputs)
    if batched:
        w.felts(outputs)
    else:
        w.felt(outputs[0])
