"""The query openings in one pass, on the CPU: ``sha256_cuda.open_gather``
(its plain version and the table its kernel reads) against the per-tree
gathers it replaced, ``serialize.pack_queries`` against the Python writers,
``fri.OpenedQueries`` as a proof's ``queries``, and ``merkle_paths_built``."""

import ctypes

import numpy as np
import pytest
import torch

from multilinear_tpu_torch import fri, sha256_cuda, stats
from multilinear_tpu_torch.batched_fri import BatchedFriProof, BatchedFriProverData, BatchedQueryProof
from multilinear_tpu_torch.batched_pcs import BatchedPCSClaim, BatchedPCSProof
from multilinear_tpu_torch.config import ProverConfig
from multilinear_tpu_torch.field import limbs
from multilinear_tpu_torch.field.scalar import Fp, P
from multilinear_tpu_torch.fri import FriProof, FriProverData, OpenedQueries, QueryProof, encode_mle_for_fri
from multilinear_tpu_torch.merkle import MerkleTree
from multilinear_tpu_torch.mle import evaluate_evals_host
from multilinear_tpu_torch.pcs import PCSProof
from multilinear_tpu_torch.serialize import (
    _write_batched_query,
    _write_query,
    _Writer,
    batched_fri_proof_to_bytes,
    batched_pcs_proof_from_bytes,
    batched_pcs_proof_to_bytes,
    fri_proof_to_bytes,
    pack_queries,
    pcs_proof_from_bytes,
    pcs_proof_to_bytes,
    snark_proof_to_bytes,
)
from multilinear_tpu_torch.system import Commitment, ConstraintSet, System, Trace, WitnessLayout
from multilinear_tpu_torch.testdata import SNARK_CONSTRAINTS, snark_golden_columns
from multilinear_tpu_torch.transcript import Transcript

CPU = ProverConfig(device="cpu")


def _field(rng, shape) -> torch.Tensor:
    n = int(np.prod(shape))
    return limbs.pack_ints([int.from_bytes(rng.bytes(16), "little") % P for _ in range(n)], shape=shape)


# -- the gather ----------------------------------------------------------------


def _gather_then_cat(trees, idx) -> torch.Tensor:
    """The openings as the port gathered them before ``open_gather``: per
    tree the payload at the indices and each level's siblings, one launch
    each, then one concatenation."""
    parts = []
    for t in trees:
        cur = torch.as_tensor(idx % t.num_leaves, dtype=torch.int64)
        parts.append(t.leaf_columns[:, cur].reshape(-1))
        for layer in t.layers[:-1]:
            parts.append(layer[cur ^ 1].reshape(-1))
            cur = cur >> 1
    return torch.cat(parts)


def _run_table(table: np.ndarray, n_idx: int, n_segments: int, n_words: int) -> torch.Tensor:
    """``csrc/open_gather.cu`` on the host: each Segment's units read from
    the addresses in the table."""
    idx, segs = table[:n_idx], table[n_idx:].reshape(n_segments, 7)
    out = np.zeros(4 * n_words, dtype=np.uint8)
    for src, stride, width, mask, shift, flip, out_off in segs.tolist():
        for q in range(n_idx):
            j = ((int(idx[q]) & mask) >> shift) ^ flip
            at = 16 * (out_off + q * width)
            out[at : at + 16 * width] = np.frombuffer(ctypes.string_at(src + 16 * j * stride, 16 * width), np.uint8)
    return torch.from_numpy(out.view(np.int32))


def _chain(rng, B, log_n, depth):
    """Trees of B columns over 2^log_n, 2^(log_n - 1), ... leaves."""
    return [MerkleTree.commit(_field(rng, (B, 1 << (log_n - k)))) for k in range(depth)]


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "plain trees, a chain of 2^9 down to 2^2 leaves":
        trees = _chain(rng, 2, 9, 8)
        return trees, rng.integers(0, 1 << 9, 24)
    if name == "plain trees of 2^3, 2^6, 2^10 leaves, B = 1, 3, 2":
        trees = [MerkleTree.commit(_field(rng, (b, 1 << k))) for b, k in ((1, 3), (3, 6), (2, 10))]
        return trees, rng.integers(0, 1 << 12, 17)
    if name == "PCS pair views: a codeword, inside a batch, every other element":
        code, wide = _field(rng, (1 << 8,)), _field(rng, (4, 1 << 7))
        views = [fri._pair_view(code), wide.view(8, 1 << 6, 4)[2:4], wide[:2, ::2]]
        return [MerkleTree.commit(v) for v in views], rng.integers(0, 1 << 8, 19)
    if name == "a batch tree (B = 8) and its inner pair trees":
        codes = _field(rng, (4, 1 << 7))
        trees = [MerkleTree.commit(codes.view(8, 1 << 6, 4))] + _chain(rng, 2, 5, 5)
        return trees, rng.integers(0, 1 << 6, 33)
    if name == "a single-leaf tree and a one-level tree":
        trees = [MerkleTree.commit(_field(rng, (3, 1))), MerkleTree.commit(_field(rng, (2, 2)))]
        return trees, rng.integers(0, 8, 5)
    if name == "repeated indices":
        return _chain(rng, 2, 6, 4), np.array([5, 5, 0, 63, 5, 0, 63, 63], dtype=np.int64)
    raise KeyError(name)


GATHER_CASES = ["plain trees, a chain of 2^9 down to 2^2 leaves", "plain trees of 2^3, 2^6, 2^10 leaves, B = 1, 3, 2",
                "PCS pair views: a codeword, inside a batch, every other element",
                "a batch tree (B = 8) and its inner pair trees", "a single-leaf tree and a one-level tree",
                "repeated indices"]


@pytest.mark.parametrize("name", GATHER_CASES)
def test_open_gather_matches_the_per_tree_gathers(name):
    trees, idx = _case(name)
    want = _gather_then_cat(trees, idx)
    pairs = [(t.leaf_columns, t.layers[:-1]) for t in trees]
    assert torch.equal(sha256_cuda.open_gather_plain(pairs, idx), want)
    assert torch.equal(sha256_cuda.open_gather(pairs, idx), want)
    table, n_segments, n_words = sha256_cuda.open_gather_table(pairs, idx)
    assert n_words == want.numel() and n_segments == sum(t.leaf_columns.shape[0] + len(t.layers) - 1 for t in trees)
    assert torch.equal(_run_table(table, len(idx), n_segments, n_words), want)


def test_open_batch_many_opens_each_tree_at_its_own_indices():
    rng = np.random.default_rng(11)
    trees = _chain(rng, 2, 6, 3) + [MerkleTree.commit(_field(rng, (3, 1 << 4)))]
    idx_lists = [[3, 63, 3], [], [0, 15, 9, 9], [7]]
    opened = MerkleTree.open_batch_many(trees, idx_lists)
    for t, il, paths in zip(trees, idx_lists, opened):
        assert len(paths) == len(il)
        for i, path in zip(il, paths):
            assert path.verify(t.root_bytes(), i)
            assert [v.v for v in path.values] == list(limbs.unpack_ints(t.leaf_columns[:, i]))


def test_open_gather_refuses_what_its_kernel_cannot_read():
    rng = np.random.default_rng(5)
    tree = MerkleTree.commit(_field(rng, (2, 8)))
    idx = np.arange(4)
    with pytest.raises(ValueError):
        sha256_cuda.open_gather_table([(tree.leaf_columns, tree.layers[:-2])], idx)
    with pytest.raises(TypeError):
        sha256_cuda.open_gather_table([(tree.leaf_columns.long(), tree.layers[:-1])], idx)
    odd = tree.leaf_columns.reshape(-1)[1:33].reshape(1, 8, 4)
    with pytest.raises(ValueError):
        sha256_cuda.open_gather_table([(odd, tree.layers[:-1])], idx)
    with pytest.raises(IndexError):
        MerkleTree.open_batch_many([tree], [[8]])


# -- the packer -------------------------------------------------------------------


@pytest.fixture
def opened(monkeypatch):
    """Every ``open_queries`` call of a prove: (prover data, indices, result)."""
    calls = []
    for cls in (FriProverData, BatchedFriProverData):
        def record(self, indices, original=cls.open_queries):
            out = original(self, indices)
            calls.append((self, list(indices), out))
            return out

        monkeypatch.setattr(cls, "open_queries", record)
    return calls


def _reference_queries(data, indices) -> list:
    """The query proofs built path by path (``MerkleTree.open_batch_many``)."""
    batched = isinstance(data, BatchedFriProverData)
    trees = ([data.batch_tree] + data.fri_data.trees) if batched else data.trees
    paths = MerkleTree.open_batch_many(trees, [[i % t.num_leaves for i in indices] for t in trees])
    if batched:
        return [BatchedQueryProof(paths[0][q], QueryProof([p[q] for p in paths[1:]])) for q in range(len(indices))]
    return [QueryProof([p[q] for p in paths]) for q in range(len(indices))]


def _written(queries, batched: bool) -> bytes:
    w = _Writer()
    w.u64(len(queries))
    for q in queries:
        (_write_batched_query if batched else _write_query)(w, q)
    return w.done()


def _snark():
    cols = snark_golden_columns("pythagorean", 6, 5)
    trace = Trace.from_columns(torch.stack([limbs.pack_ints(c) for c in cols]))
    constraints, degree = SNARK_CONSTRAINTS["pythagorean"]
    t = Transcript()
    return System.prover(t, ConstraintSet(constraints, degree), WitnessLayout(columns=4), trace, CPU).prove_snark(t)


def _prove(kind):
    """(proof, its bytes' writer, its FRI proof) of a small prove of ``kind``."""
    rng = np.random.default_rng(len(kind))
    if kind == "fri":
        proof = FriProof.prove(encode_mle_for_fri(_field(rng, (1 << 6,))), Transcript())
        return proof, fri_proof_to_bytes, proof
    if kind == "batched fri":
        proof = BatchedFriProof.prove(encode_mle_for_fri(_field(rng, (3, 1 << 5))), Transcript())
        return proof, batched_fri_proof_to_bytes, proof
    if kind == "pcs":
        evals, pt = _field(rng, (1 << 7,)), [Fp(3 + i) for i in range(7)]
        proof = PCSProof.prove(pt, evaluate_evals_host(evals, pt), evals, Transcript(), CPU)
        return proof, pcs_proof_to_bytes, proof.fri_proof
    if kind == "batched pcs":
        polys, pt = _field(rng, (5, 1 << 6)), [Fp(7 + i) for i in range(6)]
        claim = BatchedPCSClaim(pt, [evaluate_evals_host(polys[j], pt) for j in range(5)])
        proof = BatchedPCSProof.prove(claim, polys, Transcript(), CPU)
        return proof, batched_pcs_proof_to_bytes, proof.fri_proof
    proof = _snark()
    return proof, snark_proof_to_bytes, proof.pcs.fri_proof


@pytest.mark.parametrize("kind", ["fri", "batched fri", "pcs", "batched pcs", "snark"])
def test_packed_query_section_is_what_the_writers_write(kind, opened):
    proof, to_bytes, fri_proof = _prove(kind)
    blob = to_bytes(proof)
    ((data, indices, opened_queries),) = opened
    batched = isinstance(data, BatchedFriProverData)
    assert isinstance(opened_queries, OpenedQueries) and opened_queries.untouched
    assert fri_proof.queries is opened_queries
    section = pack_queries(opened_queries.openings, opened_queries.shapes, opened_queries.idx, batched)
    reference = _reference_queries(data, indices)
    assert section == _written(reference, batched) and section in blob
    assert list(opened_queries) == reference and _written(opened_queries, batched) == section
    fri_proof.queries = reference
    assert to_bytes(proof) == blob


@pytest.mark.parametrize("kind", ["pcs", "snark"])
def test_a_prove_and_its_bytes_build_no_path(kind):
    stats.reset()
    proof, to_bytes, _ = _prove(kind)
    to_bytes(proof)
    assert stats.counts().get("merkle_paths_built", 0) == 0
    if kind == "pcs":
        proof.verify(Transcript())
    else:
        t = Transcript()
        System.verifier(t, ConstraintSet(*SNARK_CONSTRAINTS["pythagorean"]), WitnessLayout(columns=4), Commitment(),
                        6).verify_snark(t, proof)
    assert stats.counts()["merkle_paths_built"] > 0


@pytest.mark.parametrize("change", ["slice", "mutate", "concatenate"])
def test_a_changed_proof_serialises_what_it_holds(change):
    proof, _, _ = _prove("pcs")
    blob = pcs_proof_to_bytes(proof)
    queries = proof.fri_proof.queries
    if change == "slice":
        proof.fri_proof.queries = queries[:-1]
        assert len(pcs_proof_from_bytes(pcs_proof_to_bytes(proof)).fri_proof.queries) == len(queries) - 1
    elif change == "mutate":
        queries[3].paths[1].values[0] = Fp(5)
        assert not queries.untouched
        got = pcs_proof_from_bytes(pcs_proof_to_bytes(proof))
        assert got.fri_proof.queries[3].paths[1].values[0] == Fp(5) and got != pcs_proof_from_bytes(blob)
    else:
        half = queries[:64]
        proof.fri_proof.queries = half + half
        assert pcs_proof_from_bytes(pcs_proof_to_bytes(proof)).fri_proof.queries == half + half
    assert pcs_proof_to_bytes(proof) != blob


def test_packed_queries_read_as_the_list_they_hold():
    proof, _, _ = _prove("batched pcs")
    blob = batched_pcs_proof_to_bytes(proof)
    queries = proof.fri_proof.queries
    assert len(queries) == 128 and queries.untouched
    parsed = batched_pcs_proof_from_bytes(blob).fri_proof.queries
    assert queries == parsed and list(queries) == parsed and queries[5] == parsed[5]
    assert not queries.untouched and batched_pcs_proof_to_bytes(proof) == blob
