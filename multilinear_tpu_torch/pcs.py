"""FRI-based multilinear polynomial commitment scheme (PCS).

Proves p(inputs) = output for one MLE by running sumcheck over
sum_x eq(inputs, x) * p(x) = output while folding the Reed-Solomon
codeword of p with the SAME per-round challenge - each sumcheck challenge
doubles as the FRI fold challenge (reference src/fri/multilinear_pcs.rs).

Wire/transcript schedule (must match the reference bit-for-bit):
  absorb(root_0);
  per round k: absorb(round-poly nonzero coeffs), r_k = challenge,
               fold sumcheck tables AND FRI codeword with r_k,
               absorb(root_{k+1}) (or last_elem on the final round);
  then 128 queries as plain FRI.

The final verifier link: eq(inputs, randoms) * last_elem == s_last(r_last)
(reference multilinear_pcs.rs:179-184).

Fiat-Shamir runs on the host.  A round needs the previous tree's root and
this round's two partial sums before it can draw its challenge; both are
ready at the same point, so they cross to the host in ONE small copy per
round (24 words: the root and the two sums as unreduced limb sums, which
the host reduces mod p), and the challenge goes back as a kernel argument.
Rounds run on the device down to the last element: there is no host tail.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from . import stats
from .config import LOG_BLOWUP, NUM_QUERIES, ProverConfig
from .field import ops
from .field.scalar import Fp
from .fri import FriError, FriProof, FriProverData, draw_query_indices, encode_mle_for_fri
from .mle import eq_scalar
from .sumcheck import SumcheckPoly, SumcheckTables, round_poly_from_sums
from .transcript import Transcript
from .utils import PhaseTimer


@dataclass
class PCSProof:
    """FRI proof + sumcheck round polynomials + the claim
    (reference PCSProof, src/fri/multilinear_pcs.rs:79-87)."""

    fri_proof: FriProof
    sumcheck_polynomials: List[SumcheckPoly]
    inputs: List[Fp]
    output: Fp

    @staticmethod
    def prove(
        inputs: Sequence[Fp],
        output: Fp,
        evals: torch.Tensor,
        transcript: Transcript,
        config: Optional[ProverConfig] = None,
    ) -> "PCSProof":
        """``evals``: the MLE in evaluation form, a (2^n, 4) limb tensor; it
        is moved to ``config.device`` (default: the card).

        Reference flow: src/fri/multilinear_pcs.rs:89-136.
        """
        session = PCSProverSession(inputs, output, evals, transcript, config)
        session.run_rounds()
        return session.finish()

    def verify(self, transcript: Transcript) -> None:
        """Replay the interleaved transcript, telescope the sumcheck, check
        the eq-link, then verify FRI queries (reference
        src/fri/multilinear_pcs.rs:138-190).  Host-only."""
        if len(self.fri_proof.queries) != NUM_QUERIES:
            raise FriError("wrong number of queries")
        n = len(self.fri_proof.commitments)
        if n == 0 or n != len(self.sumcheck_polynomials) or n != len(self.inputs):
            raise FriError("inconsistent proof dimensions")
        # PCS round polynomials are degree 2 (identity composition, reference
        # src/fri/multilinear_pcs.rs:56-57); a longer coefficient vector from
        # a hostile proof would loosen the sumcheck soundness bound.
        if any(len(p.nonzero_coeffs) != 2 for p in self.sumcheck_polynomials):
            raise FriError("sumcheck round polynomial exceeds degree bound")

        random_elements: List[Fp] = []
        for root, pol in zip(self.fri_proof.commitments, self.sumcheck_polynomials):
            transcript.absorb(root)
            pol.absorb_into(transcript)
            random_elements.append(transcript.next_challenge())
        transcript.absorb(self.fri_proof.last_elem.to_bytes())

        # telescoping sumcheck replay
        value = self.output
        for sc_pol, r in zip(self.sumcheck_polynomials, random_elements):
            value = sc_pol.to_polynomial(value).evaluate(r)

        delta = eq_scalar(self.inputs, random_elements)
        if delta * self.fri_proof.last_elem != value:
            raise FriError("PCS link check failed: eq * last_elem != s_last(r)")

        self.fri_proof.verify_queries(transcript, random_elements)


def run_round(tables: SumcheckTables, fri_data: FriProverData, fold_step, k: int, last: bool,
              previous_sum: Fp, transcript: Transcript):
    """One sumcheck + FRI round k, shared by the plain and the batched
    session: round polynomial, challenge, table fold, codeword fold.
    ``fold_step(k, r, transcript or None)`` folds the codeword(s).  Returns
    (round polynomial, s(r)).

    ONE device->host copy: this round's partial sums s(1), s(2), and with
    them the root of ``fri_data``'s newest tree if it has not been absorbed
    yet.  The fold that ends this round leaves ITS root to the next round's
    copy in the same way; the last fold absorbs ``last_element`` itself.
    """
    tree = fri_data.trees[-1] if fri_data.trees else None
    sums_dev = tables.partial_sums().view(torch.int32).reshape(-1)
    if tree is None or tree.has_root_bytes:
        sums = stats.fetch(sums_dev)
    else:
        host = stats.fetch(torch.cat([tree.root_words, sums_dev]))
        tree.set_root_words(host[:8])
        transcript.absorb(tree.root_bytes())
        sums = host[8:]
    s1, s2 = (ops.limb_sums_to_int(lanes) for lanes in sums.view("<i8").reshape(2, 4))
    pol, r, new_sum = round_poly_from_sums([s1, s2], previous_sum, transcript)
    tables.fold(r)
    fold_step(k, r, transcript if last else None)
    return pol, new_sum


def run_rounds(session, fri_data: FriProverData, max_rounds: Optional[int]) -> int:
    """Advance a prover session (plain or batched: ``tables``, ``k``,
    ``n_vars``, ``previous_sum``, ``pols``, ``transcript``, ``config``) by up
    to ``max_rounds`` rounds of plain folds on ``fri_data``; returns the
    number of rounds done."""
    end = session.n_vars if max_rounds is None else min(session.n_vars, session.k + max_rounds)
    pt = PhaseTimer(session.config.device)
    done = 0
    while session.k < end:
        pol, session.previous_sum = run_round(
            session.tables, fri_data, fri_data.fold_step, session.k,
            session.k == session.n_vars - 1, session.previous_sum, session.transcript,
        )
        session.pols.append(pol)
        session.k += 1
        done += 1
    pt.mark("rounds")
    return done


class PCSProverSession:
    """Stage-by-stage PCS prover: construct (encode, commit, tables), run
    some or all rounds, finish (queries).  ``PCSProof.prove`` is the one-shot
    wrapper.  Saving a session to disk and resuming it is a later slice."""

    def __init__(
        self,
        inputs: Sequence[Fp],
        output: Fp,
        evals: torch.Tensor,
        transcript: Transcript,
        config: Optional[ProverConfig] = None,
    ):
        self.config = config or ProverConfig()
        self.inputs = [Fp(x) for x in inputs]
        self.output = Fp(output)
        self.n_vars = len(self.inputs)
        if evals.dim() != 2 or evals.shape != (1 << self.n_vars, 4) or self.n_vars < 1:
            raise ValueError(
                f"evals must be a (2^n, 4) limb tensor with n = len(inputs) >= 1, got {tuple(evals.shape)}"
            )
        self.transcript = transcript
        evals = evals.to(self.config.device).contiguous()
        debug = self.config.debug_checks
        if debug and not ops.is_canonical(evals):
            raise ValueError("non-canonical field element in evals")

        pt = PhaseTimer(self.config.device)
        code = encode_mle_for_fri(evals)
        pt.mark("encode")
        # the root is absorbed with the first round's copy, see run_rounds
        self.fri_data = FriProverData.init(code, None, debug_checks=debug)
        pt.mark("commit_l0")
        self.tables = SumcheckTables.for_pcs(self.inputs, evals, debug_checks=debug)
        pt.mark("tables")
        self.k = 0
        self.previous_sum = self.output
        self.pols: List[SumcheckPoly] = []

    def run_rounds(self, max_rounds: Optional[int] = None) -> int:
        """Run up to ``max_rounds`` sumcheck+FRI rounds; returns rounds done."""
        return run_rounds(self, self.fri_data, max_rounds)

    def finish(self) -> "PCSProof":
        if self.k != self.n_vars or self.fri_data.last_element is None:
            raise RuntimeError("finish() before all rounds ran")
        pt = PhaseTimer(self.config.device)
        domain_size = 1 << (self.n_vars + LOG_BLOWUP)
        indices = draw_query_indices(self.transcript, domain_size // 2, NUM_QUERIES)
        queries = self.fri_data.open_queries(indices)
        pt.mark("queries")
        fri_proof = FriProof(
            commitments=self.fri_data.fold_roots(),
            queries=queries,
            last_elem=self.fri_data.last_element,
            last_random=self.transcript.random(),
        )
        return PCSProof(fri_proof, self.pols, list(self.inputs), self.output)
