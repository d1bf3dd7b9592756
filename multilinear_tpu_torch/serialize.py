"""Proof serialization: a deterministic little-endian binary codec.

Capability parity with the reference's serde+bincode round-trip
(reference src/fri/mod.rs:367-397: little-endian, fixed-int encoding;
field elements as 16 raw LE bytes per src/field.rs:40-64).  The layout
mirrors bincode's fixed-int conventions - u64 LE length prefixes for
sequences, raw fixed-size byte blobs for digests and field elements,
one byte per Direction - so proof sizes are directly comparable, and the
bytes equal the JAX package's for the same proof.

Codecs: the standalone FRI proof, the PCS proof, the batched FRI and
batched PCS proofs, and the constraint-system SNARK proof (a tag byte for
its PCS type, then the inner proof behind a length prefix).

A prover's queries travel in its proof as the fetched openings
(``fri.OpenedQueries``); the query section - 128 queries, each a path a
tree, ~1.4 MB at 2^24 - is laid out from them by numpy (:func:`pack_queries`).
The Python writers below are the reference it is tested against, and write
every proof whose queries were read or changed.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from .batched_fri import BatchedFriProof, BatchedQueryProof
from .batched_pcs import BatchedPCSClaim, BatchedPCSProof
from .field.scalar import Fp
from .fri import FriProof, OpenedQueries, QueryProof
from .merkle import MerklePath
from .pcs import PCSProof
from .sumcheck import SumcheckPoly
from .system import SnarkProof
from .utils import span


class _Writer:
    def __init__(self):
        self.parts: List[bytes] = []

    def u64(self, v: int):
        self.parts.append(struct.pack("<Q", v))

    def u8(self, v: int):
        self.parts.append(bytes([v]))

    def raw(self, b: bytes):
        self.parts.append(b)

    def felt(self, x: Fp):
        self.parts.append(x.to_bytes())

    def felts(self, xs):
        self.u64(len(xs))
        for x in xs:
            self.felt(x)

    def digest(self, d: bytes):
        assert len(d) == 32
        self.parts.append(d)

    def done(self) -> bytes:
        return b"".join(self.parts)


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u64(self) -> int:
        return struct.unpack("<Q", self.raw(8))[0]

    def u8(self) -> int:
        return self.raw(1)[0]

    def raw(self, n: int) -> bytes:
        b = self.buf[self.off : self.off + n]
        if len(b) != n:
            raise ValueError("truncated proof buffer")
        self.off += n
        return b

    def felt(self) -> Fp:
        return Fp.from_bytes(self.raw(16))

    def felts(self) -> List[Fp]:
        return [self.felt() for _ in range(self.u64())]

    def digest(self) -> bytes:
        return self.raw(32)

    def expect_end(self):
        if self.off != len(self.buf):
            raise ValueError("trailing bytes in proof buffer")


# -- Merkle paths -------------------------------------------------------------


def _write_path(w: _Writer, p: MerklePath):
    w.felts(p.values)
    w.u64(len(p.path))
    for sib, direction in p.path:
        w.digest(sib)
        w.u8(direction)


def _read_path(r: _Reader) -> MerklePath:
    values = r.felts()
    path = []
    for _ in range(r.u64()):
        sib = r.digest()
        direction = r.u8()
        path.append((sib, direction))
    return MerklePath(values, path)


# -- FRI ----------------------------------------------------------------------


def _write_query(w: _Writer, q: QueryProof):
    w.u64(len(q.paths))
    for p in q.paths:
        _write_path(w, p)


def _read_query(r: _Reader) -> QueryProof:
    return QueryProof([_read_path(r) for _ in range(r.u64())])


def _write_batched_query(w: _Writer, q: BatchedQueryProof):
    _write_path(w, q.batch_path)
    _write_query(w, q.query_proof)


def _read_batched_query(r: _Reader) -> BatchedQueryProof:
    batch_path = _read_path(r)
    return BatchedQueryProof(batch_path, _read_query(r))


def pack_queries(openings: np.ndarray, trees, idx: np.ndarray, batched: bool = False) -> bytes:
    """The query section of a FRI proof (``batched``: of a batched FRI
    proof) from its trees' fetched openings (``sha256_cuda.open_gather``'s
    layout) at the query indices ``idx``: for each query, the bytes that
    ``_write_query`` (``_write_batched_query``) writes, laid out a tree at a
    time.  ``trees``: each tree's (payload columns B, leaf count n); a query
    opens leaf idx mod n.  A FRI query is [T, path 0 .. path T-1], a batched
    one [path 0 (the batch tree), T - 1, path 1 .. path T-1]; a path is
    [B, B values, L, L x (sibling, direction)], the values the limbs' own
    bytes, a sibling its digest words' big-endian bytes, and the direction
    of level l bit l of the leaf index."""
    nq = len(idx)
    count_at = 1 if batched else 0
    width = 8 + sum(16 + 16 * B + 33 * (n.bit_length() - 1) for B, n in trees)
    rows = np.empty(nq * width, dtype=np.uint8)
    raw, swapped = openings.view(np.uint8), openings.byteswap().view(np.uint8)
    col, off = 0, 0  # the column of a query's row, the byte of the openings

    def column(dtype, shape, at, strides):  # a strided view of the rows
        return np.ndarray(shape, dtype=dtype, buffer=rows, offset=at, strides=strides)

    def u64(v: int) -> None:
        nonlocal col
        column("<u8", (nq,), col, (width,))[:] = v
        col += 8

    for t, (B, n) in enumerate(trees):
        if t == count_at:
            u64(len(trees) - t)
        L = n.bit_length() - 1
        u64(B)
        column("V16", (nq, B), col, (width, 16))[:] = raw[off : off + 16 * B * nq].view("V16").reshape(B, nq).T
        col, off = col + 16 * B, off + 16 * B * nq
        u64(L)
        column("V32", (nq, L), col, (width, 33))[:] = swapped[off : off + 32 * L * nq].view("V32").reshape(L, nq).T
        column(np.uint8, (nq, L), col + 32, (width, 33))[:] = ((idx & (n - 1))[:, None] >> np.arange(L)) & 1
        col, off = col + 33 * L, off + 32 * L * nq
    if len(trees) == count_at:
        u64(0)
    if off != openings.nbytes:
        raise ValueError(f"{openings.nbytes} bytes of openings for trees {trees} at {nq} queries")
    return struct.pack("<Q", nq) + rows.tobytes()


def _write_queries(w: _Writer, queries, write_query, batched: bool = False) -> None:
    if isinstance(queries, OpenedQueries) and queries.untouched:
        w.raw(pack_queries(queries.openings, queries.shapes, queries.idx, batched))
        return
    w.u64(len(queries))
    for q in queries:
        write_query(w, q)


def _write_fri(w: _Writer, proof: FriProof):
    w.u64(len(proof.commitments))
    for c in proof.commitments:
        w.digest(c)
    _write_queries(w, proof.queries, _write_query)
    w.felt(proof.last_elem)
    w.digest(proof.last_random)


def _read_fri(r: _Reader) -> FriProof:
    commitments = [r.digest() for _ in range(r.u64())]
    queries = [_read_query(r) for _ in range(r.u64())]
    last_elem = r.felt()
    last_random = r.digest()
    return FriProof(commitments, queries, last_elem, last_random)


def fri_proof_to_bytes(proof: FriProof) -> bytes:
    w = _Writer()
    _write_fri(w, proof)
    return w.done()


def fri_proof_from_bytes(buf: bytes) -> FriProof:
    r = _Reader(buf)
    proof = _read_fri(r)
    r.expect_end()
    return proof


# -- sumcheck round polynomials ------------------------------------------------


def _write_pols(w: _Writer, pols: List[SumcheckPoly]):
    w.u64(len(pols))
    for p in pols:
        w.felts(p.nonzero_coeffs)


def _read_pols(r: _Reader) -> List[SumcheckPoly]:
    return [SumcheckPoly(r.felts()) for _ in range(r.u64())]


# -- PCS ------------------------------------------------------------------------


def _write_pcs(w: _Writer, proof: PCSProof):
    _write_fri(w, proof.fri_proof)
    _write_pols(w, proof.sumcheck_polynomials)
    w.felts(proof.inputs)
    w.felt(proof.output)


def pcs_proof_to_bytes(proof: PCSProof) -> bytes:
    with span("serialize"):
        w = _Writer()
        _write_pcs(w, proof)
        return w.done()


def pcs_proof_from_bytes(buf: bytes) -> PCSProof:
    r = _Reader(buf)
    fri = _read_fri(r)
    pols = _read_pols(r)
    inputs = r.felts()
    output = r.felt()
    r.expect_end()
    return PCSProof(fri, pols, inputs, output)


# -- batched FRI / PCS -----------------------------------------------------------


def _write_batched_fri(w: _Writer, proof: BatchedFriProof):
    w.digest(proof.batch_commitment)
    w.u64(len(proof.commitments))
    for c in proof.commitments:
        w.digest(c)
    _write_queries(w, proof.queries, _write_batched_query, batched=True)
    w.felt(proof.last_elem)
    w.digest(proof.last_random)


def _read_batched_fri(r: _Reader) -> BatchedFriProof:
    batch_commitment = r.digest()
    commitments = [r.digest() for _ in range(r.u64())]
    queries = [_read_batched_query(r) for _ in range(r.u64())]
    last_elem = r.felt()
    last_random = r.digest()
    return BatchedFriProof(batch_commitment, commitments, queries, last_elem, last_random)


def batched_fri_proof_to_bytes(proof: BatchedFriProof) -> bytes:
    w = _Writer()
    _write_batched_fri(w, proof)
    return w.done()


def batched_fri_proof_from_bytes(buf: bytes) -> BatchedFriProof:
    r = _Reader(buf)
    proof = _read_batched_fri(r)
    r.expect_end()
    return proof


def _write_batched_pcs(w: _Writer, proof: BatchedPCSProof):
    _write_batched_fri(w, proof.fri_proof)
    _write_pols(w, proof.sumcheck_polynomials)
    w.felts(proof.claim.inputs)
    w.felts(proof.claim.outputs)


def batched_pcs_proof_to_bytes(proof: BatchedPCSProof) -> bytes:
    with span("serialize"):
        w = _Writer()
        _write_batched_pcs(w, proof)
        return w.done()


def batched_pcs_proof_from_bytes(buf: bytes) -> BatchedPCSProof:
    r = _Reader(buf)
    fri = _read_batched_fri(r)
    pols = _read_pols(r)
    inputs = r.felts()
    outputs = r.felts()
    r.expect_end()
    return BatchedPCSProof(fri, pols, BatchedPCSClaim(inputs, outputs))


# -- SNARK (constraint-system proof) -------------------------------------------
#
# The reference never serializes its SNARK flow (its serde round-trip stops
# at FriProof, src/fri/mod.rs:389-397); the JAX package's codec completes the
# set, and this one writes the same bytes.  A tag byte tells the width-1
# plain-PCS flow (0) from the multi-column batched-PCS one (1).


def snark_proof_to_bytes(proof: SnarkProof) -> bytes:
    with span("serialize"):
        w, inner = _Writer(), _Writer()
        _write_pols(w, proof.sumcheck_polynomials)
        w.felts(proof.outputs)
        w.felt(proof.sum_value)
        if isinstance(proof.pcs, PCSProof):
            w.u8(0)
            _write_pcs(inner, proof.pcs)
        elif isinstance(proof.pcs, BatchedPCSProof):
            w.u8(1)
            _write_batched_pcs(inner, proof.pcs)
        else:
            raise TypeError(f"unknown PCS proof type {type(proof.pcs)!r}")
        inner = inner.done()
        w.u64(len(inner))
        w.raw(inner)
        return w.done()


def snark_proof_from_bytes(buf: bytes) -> SnarkProof:
    r = _Reader(buf)
    pols = _read_pols(r)
    outputs = r.felts()
    sum_value = r.felt()
    tag = r.u8()
    inner = r.raw(r.u64())
    if tag == 0:
        pcs = pcs_proof_from_bytes(inner)
    elif tag == 1:
        pcs = batched_pcs_proof_from_bytes(inner)
    else:
        raise ValueError(f"unknown SNARK PCS tag {tag}")
    r.expect_end()
    return SnarkProof(pols, outputs, pcs, sum_value)
