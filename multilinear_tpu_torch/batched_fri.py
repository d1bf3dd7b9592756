"""Batched FRI: B codewords in one column-wise Merkle commitment, folded
into a single codeword by a Horner random linear combination.

Protocol parity with reference src/fri/batched_fri.rs: the batch layer
commits leaf i = H(code_0[i] || code_0[i+n/2] || code_1[i] || ...), the
transcript then yields ``fingerprint_r`` (which is absorbed back - unlike
plain challenges), the FIRST fold step operates on Horner fingerprints of
the B columns (first code gets the HIGHEST power of r, quirk Q6), and all
later steps are plain FRI.

The B codewords live as one ``(B, n, 4)`` device tensor; the batch tree's
leaf payload is a view of it.  The Horner combination is B-1 ``mul`` + ``add``
passes over the batch axis; the first fold is one launch of the
``fold_codeword`` kernel followed by an ordinary pair-tree commit, and every
later fold is the plain-FRI fused fold + commit.  All sizes run on the
device: there is no host branch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from .config import LOG_BLOWUP, NUM_QUERIES
from .field import limbs, ops
from .field.scalar import Fp, TWO_INV, pow2_generator
from .fri import (
    FriError,
    FriProverData,
    OpenedQueries,
    QueryProof,
    _fold_codeword,
    _layer_inv_gens,
    _pair_view,
    _rh_limbs,
    draw_query_indices,
)
from .merkle import MerklePath, MerkleTree, opening_shapes
from .ntt import inv_gen_pows
from .transcript import Transcript


def fingerprint(r: Fp, items: Sequence[Fp]) -> Fp:
    """Horner RLC: items[0]*r^(B-1) + ... + items[B-1] (quirk Q6;
    reference src/fri/batched_fri.rs:30-38)."""
    acc = Fp(0)
    for x in items:
        acc = acc * r + x
    return acc


def _fingerprint_codes(codes: torch.Tensor, r_limbs: torch.Tensor) -> torch.Tensor:
    """Horner RLC over the batch axis: codes (B, n, 4) -> (n, 4), with the
    fingerprint scalar as a (4,) field element on the codes' device."""
    acc = codes[0]
    for j in range(1, codes.shape[0]):
        acc = ops.mul(acc, r_limbs)
        ops.add(acc, codes[j], out=acc)
    return acc


class BatchedFriProverData:
    """Batch commitment + fingerprint challenge + inner plain-FRI state."""

    def __init__(self, batch_tree: MerkleTree, fingerprint_r: Fp, codes: torch.Tensor,
                 debug_checks: bool = False):
        self.batch_tree = batch_tree
        self.fingerprint_r = fingerprint_r
        # packed once: the batched fold and the RLC of the sumcheck table
        # read it on the device
        self.fingerprint_limbs = limbs.pack_scalar(fingerprint_r, codes.device)
        self.fri_data = FriProverData()
        self.fri_data.debug_checks = debug_checks
        self.fri_data._log_domain = codes.shape[-2].bit_length() - 1
        self.fri_data._inv_pows = inv_gen_pows(self.fri_data._log_domain, codes.device)
        self._codes: Optional[torch.Tensor] = codes  # (B, n, 4); dropped after the first fold

    @staticmethod
    def init(codes: torch.Tensor, transcript: Transcript, debug_checks: bool = False) -> "BatchedFriProverData":
        """codes: (B, n, 4) limb tensor of B equal-length codewords.

        Reference init (src/fri/batched_fri.rs:41-99): batch-commit, absorb
        root, draw fingerprint_r, absorb fingerprint_r.
        """
        if codes.dim() != 3 or codes.shape[0] < 1:
            raise ValueError(f"codes must be (B, n, 4), got {tuple(codes.shape)}")
        B, n, _ = codes.shape
        if n < 2 or n & (n - 1):
            raise ValueError("codeword length must be a power of two >= 2")
        if debug_checks and not ops.is_canonical(codes):
            raise FriError("non-canonical field element in codewords")
        codes = codes.contiguous()
        # leaf i = code_0[i] || code_0[i+n/2] || code_1[i] || ...: a view
        batch_tree = MerkleTree.commit(codes.view(2 * B, n // 2, 4))
        transcript.absorb(batch_tree.root_bytes())
        fingerprint_r = transcript.next_challenge()
        transcript.absorb(fingerprint_r.to_bytes())
        return BatchedFriProverData(batch_tree, fingerprint_r, codes, debug_checks)

    def batched_fold_step(self, rh: torch.Tensor) -> None:
        """First fold, with ``rh`` = r/2 on the codes' device: RLC the B
        columns, then the k=0 fold formula (reference batched_fold_step,
        src/fri/batched_fri.rs:101-205), then an ordinary pair commit or the
        end of the chain, as in ``FriProverData.fold_step``; nothing is
        absorbed here.  The batch codewords are released (the queries read
        the batch tree's own view of them)."""
        codes, self._codes = self._codes, None
        if codes is None:
            raise RuntimeError("the batched fold step runs once")
        n = codes.shape[-2]
        blowup = 1 << LOG_BLOWUP
        if n <= blowup:
            return
        fri = self.fri_data
        rlc = _fingerprint_codes(codes, self.fingerprint_limbs)
        nxt = _fold_codeword(rlc, fri._inv_pows, 0, rh)
        fri.push(nxt, None if n // 2 == blowup else MerkleTree.commit(_pair_view(nxt)))

    @staticmethod
    def fold(codes: torch.Tensor, transcript: Transcript) -> "BatchedFriProverData":
        """init + batched first step + plain steps, each challenge drawn on
        the host (reference :207-224)."""
        data = BatchedFriProverData.init(codes, transcript)
        num_steps = codes.shape[-2].bit_length() - 1 - LOG_BLOWUP
        data.batched_fold_step(_rh_limbs(transcript.next_challenge(), codes.device))
        data.fri_data.absorb_fold(transcript)
        for k in range(1, num_steps):
            data.fri_data.fold_step(k, _rh_limbs(transcript.next_challenge(), codes.device))
            data.fri_data.absorb_fold(transcript)
        assert data.fri_data.last_element is not None
        return data

    def open_queries(self, indices: Sequence[int]) -> OpenedQueries:
        """The query proofs of ``indices`` (``fri.OpenedQueries`` of
        ``BatchedQueryProof``): the batch-tree column paths and the inner
        layers' pair paths, in ONE device->host copy.  The inner layers open
        each index modulo their leaf counts (reference src/fri/batched_fri.rs)."""
        trees = [self.batch_tree] + self.fri_data.trees
        idx = np.asarray(indices, dtype=np.int64)
        return OpenedQueries(self.fri_data.gather_openings(trees, idx), opening_shapes(trees), idx,
                             lambda paths: BatchedQueryProof(paths[0], QueryProof(paths[1:])))


@dataclass
class BatchedQueryProof:
    """Batch-layer column path + inner plain-FRI query proof."""

    batch_path: MerklePath
    query_proof: QueryProof

    def verify(
        self,
        proof: "BatchedFriProof",
        n: int,
        index: int,
        gen: Fp,
        random_elements: Sequence[Fp],
        fingerprint_r: Fp,
        inv_gens: Sequence[Fp] = None,
    ) -> None:
        """Reference BatchedQueryProof::verify (src/fri/batched_fri.rs:227-283).

        ``inv_gens``: per-layer inverse generators shared across queries
        (see fri._layer_inv_gens) - replaces the reference's per-layer
        division (one inversion per query per layer) with the identical
        value TWO_INV * inv_gen^index."""
        if len(self.query_proof.paths) != len(proof.commitments):
            raise FriError("wrong number of paths")
        if inv_gens is None:
            inv_gens = _layer_inv_gens(gen, len(proof.commitments) + 1)
        if not self.batch_path.verify(proof.batch_commitment, index):
            raise FriError("batch inclusion path failed")
        # column layout: [c0_val, c0_minus, c1_val, c1_minus, ...]
        values = self.batch_path.values[0::2]
        minus_values = self.batch_path.values[1::2]
        if not values or len(values) != len(minus_values):
            raise FriError("batch leaf is not a list of pairs")
        value = fingerprint(fingerprint_r, values)
        minus_value = fingerprint(fingerprint_r, minus_values)
        even = (value + minus_value) * TWO_INV
        odd = (value - minus_value) * TWO_INV * (inv_gens[0] ** index)
        folded = even + random_elements[0] * odd
        if not self.query_proof.paths:
            if proof.last_elem != folded:
                raise FriError("query mismatch at batch layer")
            return
        next_n = n // 2
        next_index = index % next_n
        next_path = self.query_proof.paths[0]
        if len(next_path.values) != 2:
            raise FriError("layer 0 leaf is not a pair")
        next_value = next_path.values[0] if next_index == index else next_path.values[1]
        if next_value != folded:
            raise FriError("query mismatch at batch layer")
        self.query_proof.verify(
            proof.commitments,
            proof.last_elem,
            next_n,
            next_index,
            gen * gen,
            random_elements[1:],
            inv_gens=inv_gens[1:],
        )


@dataclass
class BatchedFriProof:
    """Reference BatchedFriProof (src/fri/batched_fri.rs:22-28)."""

    batch_commitment: bytes
    commitments: List[bytes]
    queries: Sequence[BatchedQueryProof]  # a prover's: fri.OpenedQueries
    last_elem: Fp
    last_random: bytes

    @staticmethod
    def prove(codes: torch.Tensor, transcript: Transcript) -> "BatchedFriProof":
        """codes: (B, n, 4) limb tensor; it is used where it lies."""
        data = BatchedFriProverData.fold(codes, transcript)
        indices = draw_query_indices(transcript, codes.shape[-2] // 2, NUM_QUERIES)
        queries = data.open_queries(indices)
        return BatchedFriProof(
            batch_commitment=data.batch_tree.root_bytes(),
            commitments=data.fri_data.fold_roots(),
            queries=queries,
            last_elem=data.fri_data.last_element,
            last_random=transcript.random(),
        )

    def verify(self) -> None:
        """Reference verify (src/fri/batched_fri.rs:330-365)."""
        transcript = Transcript()
        transcript.absorb(self.batch_commitment)
        fingerprint_r = transcript.next_challenge()
        transcript.absorb(fingerprint_r.to_bytes())
        random_elements = [transcript.next_challenge()]
        for root in self.commitments:
            transcript.absorb(root)
            random_elements.append(transcript.next_challenge())
        transcript.absorb(self.last_elem.to_bytes())
        self.verify_queries(transcript, random_elements, fingerprint_r)

    def verify_queries(
        self,
        transcript: Transcript,
        random_elements: Sequence[Fp],
        fingerprint_r: Fp,
    ) -> None:
        if len(self.queries) != NUM_QUERIES:
            raise FriError("wrong number of queries")
        log_domain_size = len(self.commitments) + 1 + LOG_BLOWUP
        if log_domain_size > 40:
            raise FriError("domain exceeds the field's two-adicity")
        gen = pow2_generator(log_domain_size)
        inv_gens = _layer_inv_gens(gen, len(self.commitments) + 1)
        n = (1 << log_domain_size) // 2
        indices = draw_query_indices(transcript, n, len(self.queries))
        for query, idx in zip(self.queries, indices):
            query.verify(self, n, idx, gen, random_elements, fingerprint_r, inv_gens=inv_gens)
        if self.last_random != transcript.random():
            raise FriError("incompatible last_random transcript fingerprint")
