"""Batched multilinear PCS: the same claim point for B MLEs, one proof.

Protocol parity with reference src/fri/batched_pcs.rs: the claim
(inputs then outputs) is absorbed first, batched-FRI init yields
``fingerprint_r``, the B polynomials are RLC'd EVAL-WISE into one MLE for
the sumcheck whose target sum is fingerprint(r, outputs), the first FRI
fold is batched and the rest plain, and the final link is the same
eq(inputs, randoms) * last_elem check as the plain PCS.

Transcript schedule of round 0 (must match the reference bit-for-bit):
  absorb(claim); absorb(batch root); fingerprint_r = challenge;
  absorb(fingerprint_r); absorb(round-0 polynomial); r_0 = challenge;
  batched fold with r_0; absorb(root_1) (or last_elem when n = 1);
rounds 1.. are the plain PCS rounds (``pcs.DeviceRounds``).  The batch root
is the one value the host needs before the rounds (fingerprint_r depends on
it): one device->host copy.  The transcript then hops to the device, and
round 0 with its batched fold runs there like every later round.

The B MLEs and their B codewords are ``(B, 2^n, 4)`` / ``(B, 2^(n+1), 4)``
device tensors; the encode is ONE batched pass through the Moebius and NTT
kernels, which carry a batch extent.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional

import torch

from .batched_fri import BatchedFriProof, BatchedFriProverData, _fingerprint_codes, fingerprint
from .checkpoint import barrier, is_writer, load_batched_pcs_state, normalize_ckpt_path, save_batched_pcs_state
from .config import LOG_BLOWUP, NUM_QUERIES, ProverConfig
from .field import ops
from .field.scalar import Fp
from .fri import FriError, draw_query_indices, encode_mle_for_fri
from .mle import eq_scalar
from .pcs import DeviceRounds, launch_rounds, run_rounds
from .sumcheck import SumcheckPoly, SumcheckTables
from .transcript import Transcript
from .utils import span


@dataclass
class BatchedPCSClaim:
    """Shared input point + per-polynomial outputs (reference batched_pcs.rs:31-34)."""

    inputs: List[Fp]
    outputs: List[Fp]

    def absorb_into(self, transcript: Transcript) -> None:
        for x in self.inputs:
            transcript.absorb(x.to_bytes())
        for x in self.outputs:
            transcript.absorb(x.to_bytes())


@dataclass
class BatchedPCSProof:
    """Reference BatchedPCSProof (src/fri/batched_pcs.rs:23-29)."""

    fri_proof: BatchedFriProof
    sumcheck_polynomials: List[SumcheckPoly]
    claim: BatchedPCSClaim

    @staticmethod
    def prove(
        claim: BatchedPCSClaim,
        polys: torch.Tensor,
        transcript: Transcript,
        config: Optional[ProverConfig] = None,
        layout=None,
    ) -> "BatchedPCSProof":
        """``polys``: (B, 2^n, 4) limb tensor of B MLEs in evaluation form;
        it is moved to ``config.device`` (default: the card).  With a
        ``parallel.ShardLayout``, ``polys`` is this rank's B/W whole
        polynomials (``layout.shard_batch``) or its rows of all B
        (``layout.shard_rows``), and every rank returns the same proof.

        Reference flow: src/fri/batched_pcs.rs:36-186.
        """
        with span("proof"):
            session = BatchedPCSProverSession(claim, polys, transcript, config, layout)
            session.run_rounds()
            return session.finish()

    def verify(self, transcript: Transcript) -> None:
        """Reference verify (src/fri/batched_pcs.rs:188-253).  Host-only."""
        if len(self.fri_proof.queries) != NUM_QUERIES:
            raise FriError("wrong number of queries")
        n = len(self.fri_proof.commitments) + 1
        if n != len(self.sumcheck_polynomials) or n != len(self.claim.inputs):
            raise FriError("inconsistent proof dimensions")
        # degree-2 round polynomials, as in the plain PCS
        if any(len(p.nonzero_coeffs) != 2 for p in self.sumcheck_polynomials):
            raise FriError("sumcheck round polynomial exceeds degree bound")

        self.claim.absorb_into(transcript)
        random_elements: List[Fp] = []
        fingerprint_r = Fp(0)
        for i, pol in enumerate(self.sumcheck_polynomials):
            if i == 0:
                transcript.absorb(self.fri_proof.batch_commitment)
                fingerprint_r = transcript.next_challenge()
                transcript.absorb(fingerprint_r.to_bytes())
            else:
                transcript.absorb(self.fri_proof.commitments[i - 1])
            pol.absorb_into(transcript)
            random_elements.append(transcript.next_challenge())
        transcript.absorb(self.fri_proof.last_elem.to_bytes())

        # telescoping sumcheck replay from the fingerprinted output sum
        value = fingerprint(fingerprint_r, self.claim.outputs)
        for sc_pol, r in zip(self.sumcheck_polynomials, random_elements):
            value = sc_pol.to_polynomial(value).evaluate(r)

        delta = eq_scalar(self.claim.inputs, random_elements)
        if delta * self.fri_proof.last_elem != value:
            raise FriError("batched PCS link check failed")

        self.fri_proof.verify_queries(transcript, random_elements, fingerprint_r)


class BatchedPCSProverSession:
    """Stage-by-stage batched-PCS prover, mirroring ``pcs.PCSProverSession``:
    construct (encode the B MLEs, commit the batch column tree, draw
    ``fingerprint_r``, build the tables of the combined MLE, run round 0 with
    its batched fold), run some or all of rounds 1.., finish (queries).
    ``save`` / ``resume`` as in the plain PCS session.

    With a ``layout`` (``parallel.ShardLayout``) the session is one rank of
    a sharded prove, in one of two modes that the block's shape tells apart
    (for W > 1 they never coincide):

    * batch-sharded, ``polys`` (B/W, 2^n, 4): the rank's whole polynomials,
      encoded here with no traffic; the codewords and the polynomials then
      turn into row blocks (one all-to-all each);
    * row-sharded, ``polys`` (B, 2^n/W, 4): the rank's contiguous rows of
      every polynomial, turned cyclic (one all-to-all) and encoded by the
      sharded encode in ONE batched pass, whose two all-to-alls carry all B
      columns.  ``cyclic``: the rows are already the rank's cyclic block, as
      a SNARK's trace sumcheck left its columns, and that first exchange is
      skipped.

    Either way the batch tree, the fingerprints and every round are then the
    rank's rows (``parallel.rounds``)."""

    def __init__(
        self,
        claim: BatchedPCSClaim,
        polys: torch.Tensor,
        transcript: Transcript,
        config: Optional[ProverConfig] = None,
        layout=None,
        cyclic: bool = False,
    ):
        self.config = config or ProverConfig()
        self.claim = BatchedPCSClaim([Fp(x) for x in claim.inputs], [Fp(x) for x in claim.outputs])
        self.n_vars = len(self.claim.inputs)
        self.layout = layout
        B, n = len(self.claim.outputs), 1 << self.n_vars
        if layout is None:
            by_rows = False
            if polys.dim() != 3 or polys.shape != (B, n, 4) or self.n_vars < 1 or B < 1:
                raise ValueError("polys must be a (B, 2^n, 4) limb tensor with n = len(inputs) >= 1 and "
                                 f"B = len(outputs) >= 1, got {tuple(polys.shape)}")
        else:
            from .parallel import rounds as sharded

            W = layout.world
            by_rows = tuple(polys.shape) == (B, n // W, 4)
            by_batch = B % W == 0 and tuple(polys.shape) == (B // W, n, 4)
            if not (by_rows or by_batch) or self.n_vars < 1 or B < 1:
                raise ValueError(f"over {W} ranks polys must be (B / {W}, 2^n, 4) whole polynomials (a batch "
                                 f"that splits evenly) or (B, 2^n / {W}, 4) rows, with n = len(inputs) >= 1 and "
                                 f"B = len(outputs) >= 1; got {tuple(polys.shape)} for B = {B}, n = {self.n_vars}")
            sharded.check_rows(self.n_vars, layout)
        self.transcript = transcript
        polys = polys.to(self.config.device if layout is None else layout.device).contiguous()
        debug = self.config.debug_checks
        if debug and not ops.is_canonical(polys):
            raise ValueError("non-canonical field element in polys")

        # RS-encode every polynomial in one batched pass (coeffs
        # bit-reversed, Q8)
        with span("encode"):
            if by_rows:
                if not cyclic:
                    polys = sharded.to_cyclic(polys, layout)
                codes = sharded.encode_cyclic(polys, layout)
            else:
                codes = encode_mle_for_fri(polys)
        with span("commit_batch"):
            self.claim.absorb_into(transcript)
            if layout is None:
                self.bfri = BatchedFriProverData.init(codes, transcript, debug_checks=debug)
            else:
                rows = codes if by_rows else sharded.batch_to_rows(codes, layout)
                self.bfri = sharded.ShardedBatchedFriProverData.init(rows, transcript, layout, debug)
                del rows
            del codes
        # eval-wise Horner RLC of the B MLEs into one sumcheck polynomial
        with span("tables"):
            if layout is None:
                rlc_evals = _fingerprint_codes(polys, self.bfri.fingerprint_limbs)
                self.tables = SumcheckTables.for_pcs(self.claim.inputs, rlc_evals, debug_checks=debug)
            else:
                rows = polys if by_rows else sharded.batch_to_rows(polys, layout)
                rlc_evals = _fingerprint_codes(rows, self.bfri.fingerprint_limbs)
                self.tables = sharded.ShardedTables.for_pcs(self.claim.inputs, rlc_evals, layout, debug)
                self.bfri.fri_data.mark_bytes()
            self.rounds = DeviceRounds(transcript, self.n_vars,
                                       fingerprint(self.bfri.fingerprint_r, self.claim.outputs), polys.device)
        self.pols: List[SumcheckPoly] = []

        # round 0 on the device: the batched fold, which draws on the batch
        # layer exactly once.  No fold tree exists yet, so it absorbs no root;
        # the host replays it with the rounds of the first run_rounds.
        self.k = 0
        with span("rounds"):
            self.rounds.round(self.tables, self.bfri.fri_data, lambda k, rh: self.bfri.batched_fold_step(rh), 0,
                              self.n_vars == 1)
            self.k = 1

    def launch_rounds(self, max_rounds: Optional[int] = None) -> int:
        """Launch up to ``max_rounds`` of rounds 1.. on the device and copy
        nothing back; returns rounds launched."""
        return launch_rounds(self, self.bfri.fri_data, max_rounds)

    def run_rounds(self, max_rounds: Optional[int] = None) -> int:
        """Run up to ``max_rounds`` of rounds 1.. and bring the host transcript
        up to date (one copy, which also replays round 0); returns rounds done."""
        return run_rounds(self, self.bfri.fri_data, max_rounds)

    def finish(self) -> "BatchedPCSProof":
        self.pols += self.rounds.replay(self.bfri.fri_data)
        if self.k != self.n_vars or self.bfri.fri_data.last_element is None:
            raise RuntimeError("finish() before all rounds ran")
        with span("queries"):
            domain_size = 1 << (self.n_vars + LOG_BLOWUP)
            indices = draw_query_indices(self.transcript, domain_size // 2, NUM_QUERIES)
            with span("open"):
                queries = self.bfri.open_queries(indices)
        fri_proof = BatchedFriProof(
            batch_commitment=self.bfri.batch_tree.root_bytes(),
            commitments=self.bfri.fri_data.fold_roots(),
            queries=queries,
            last_elem=self.bfri.fri_data.last_element,
            last_random=self.transcript.random(),
        )
        return BatchedPCSProof(fri_proof, self.pols, self.claim)

    # -- persistence -----------------------------------------------------------
    def save(self, path: str) -> None:
        """Save the session to ``path`` (``.npz`` appended if missing) and its
        claim to ``path + ".claim"``.  Rounds launched and not replayed yet -
        round 0 too, which the constructor launched - are replayed first.  A
        sharded session, in either mode, is saved as in
        ``pcs.PCSProverSession.save``: the single-rank file, written by rank
        0 after the blocks are gathered."""
        self._write(path)
        barrier(self.layout)

    def _write(self, path: str) -> None:
        """``save`` up to its barrier."""
        self.pols += self.rounds.replay(self.bfri.fri_data)
        path = normalize_ckpt_path(path)
        save_batched_pcs_state(path, self.tables, self.bfri, self.transcript, self.k, self.rounds.running_sum(),
                               self.pols, self.layout)
        if is_writer(self.layout):
            with open(path + ".claim", "w") as f:
                json.dump({"inputs": [x.v for x in self.claim.inputs],
                           "outputs": [x.v for x in self.claim.outputs]}, f)

    @staticmethod
    def resume(path: str, config: Optional[ProverConfig] = None, layout=None) -> "BatchedPCSProverSession":
        """The session saved at ``path``, on ``config.device`` (default: the
        card), the batch tree and the fold trees rebuilt.  With a ``layout``,
        every rank calls it and keeps its rows (after round 0 both modes hold
        the same row blocks), as ``pcs.PCSProverSession.resume``."""
        path = normalize_ckpt_path(path)
        s = BatchedPCSProverSession.__new__(BatchedPCSProverSession)
        s.config = config or ProverConfig()
        s.layout = layout
        s.tables, s.bfri, s.transcript, s.k, prev, s.pols = load_batched_pcs_state(
            path, s.config.device, s.config.debug_checks, layout)
        with open(path + ".claim") as f:
            claim = json.load(f)
        s.claim = BatchedPCSClaim([Fp(int(v)) for v in claim["inputs"]], [Fp(int(v)) for v in claim["outputs"]])
        s.n_vars = len(s.claim.inputs)
        s.rounds = DeviceRounds(s.transcript, s.n_vars, prev, s.tables.data.device)
        s.rounds.roots_absorbed = s.k - 1  # round 0 absorbed no fold root, round j >= 1 that of tree j - 1
        if layout is not None:
            s.bfri.fri_data.mark_bytes()
        return s
