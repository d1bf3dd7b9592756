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

The rounds' Fiat-Shamir runs on the device.  The host transcript's
midstate hops to the device before round 0; each round is the partial
sums (the identity composition's program, ONE ``sumcheck_sums`` launch on a
card: ``composition.round_sums``), ONE launch of the round-scalars kernel
(absorb the pending root and the round polynomial, draw r, write r and r/2
where the folds read them), the table fold and the codeword fold; no round
copies anything to or from the host.  A call to ``run_rounds`` ends in ONE
device->host copy (the round polynomials, the roots, the last fold's
elements and the device's digest), after which the host replays the same
absorbs into its own transcript and checks the digest.  Rounds run on the
device down to the last element: there is no host tail.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import composition as cmp
from . import device_transcript as dtr
from . import stats
from .checkpoint import barrier, is_writer, load_pcs_state, normalize_ckpt_path, save_pcs_state
from .config import LOG_BLOWUP, NUM_QUERIES, ProverConfig
from .field import limbs, ops
from .field.scalar import Fp
from .fri import FriError, FriProof, FriProverData, draw_query_indices, encode_mle_for_fri
from .mle import eq_scalar
from .sha256 import digest_to_bytes
from .sumcheck import SumcheckPoly, SumcheckTables, identity_composition
from .transcript import Transcript
from .utils import span

# the PCS's composition, x -> x[0], as a program: no instructions, column 0
# the result; traced once a process
IDENTITY = cmp.trace(identity_composition, 1, None)


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
        layout=None,
    ) -> "PCSProof":
        """``evals``: the MLE in evaluation form, a (2^n, 4) limb tensor; it
        is moved to ``config.device`` (default: the card).  With a
        ``parallel.ShardLayout``, ``evals`` is this rank's block
        (``layout.shard_rows``) and every rank returns the same proof.

        Reference flow: src/fri/multilinear_pcs.rs:89-136.
        """
        with span("proof"):
            session = PCSProverSession(inputs, output, evals, transcript, config, layout)
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


class DeviceRounds:
    """The rounds' Fiat-Shamir on the prover's device, and what the host
    has not replayed yet.

    ``state``: the transcript (``device_transcript``), hopped from the host
    transcript at construction.  ``scal``: (3, 4) - the running sum, then
    this round's r and r/2, which the folds read.  ``coeffs``: (n, 2, 4), the
    nonzero coefficients of round k's polynomial in slot k.  ``sums``: (n, 2,
    4) int64, zeroed once here, round k's unreduced limb sums of s(1), s(2)
    in slot k (the sums kernel adds into it).  ``digest``: the digest of the
    device state after its latest absorb.  The copies to the device are made
    here, before the rounds, and do not make the host wait; a resumed or a
    batched session keeps its round indices into the slots.
    """

    def __init__(self, transcript: Transcript, n_rounds: int, previous_sum: Fp, device):
        self.transcript = transcript
        self.state = dtr.state_from_host(transcript, device)
        self.scal = limbs.pack_ints([Fp(previous_sum), 0, 0], device=device)
        self.coeffs = torch.empty((n_rounds, 2, 4), dtype=torch.int32, device=device)
        self.sums = torch.zeros((n_rounds, 2, 4), dtype=torch.int64, device=device)
        IDENTITY.on(device)  # its one copy to the device, made before the rounds
        self.digest = torch.empty(8, dtype=torch.int32, device=device)
        self.roots_absorbed = 0  # fold trees whose root the device state holds
        self._rounds = []  # (k, tree whose root round k absorbed, or None), not replayed yet
        self._last = False  # the last element was absorbed and not replayed yet

    @property
    def r(self) -> torch.Tensor:
        return self.scal[1]

    def running_sum(self) -> Fp:
        """The running sum the next round starts from (one copy; for a save)."""
        return Fp(int(limbs.unpack_ints(stats.fetch(self.scal[0]).view(np.uint32))[()]))

    @property
    def rh(self) -> torch.Tensor:
        return self.scal[2]

    def round(self, tables: SumcheckTables, fri_data: FriProverData, fold_step, k: int, last: bool) -> None:
        """Round k, all on the device: the round polynomial's sums (the
        tables' sums of the identity program into slot k of ``sums``), its
        Fiat-Shamir (absorbing the newest tree's root first if the state has
        not had it), the table fold, the codeword fold ``fold_step(k, rh)``;
        after the last fold the last element's absorb."""
        with span("round"):
            trees = fri_data.trees
            tree = trees[self.roots_absorbed] if len(trees) > self.roots_absorbed else None
            sums = tables.program_sums(IDENTITY, None, 2, self.sums[k])
            dtr.round_scalars(self.state, self.scal, self.digest, sums=sums,
                              root=tree.root_words if tree is not None else None, coeffs=self.coeffs[k])
            self.roots_absorbed += tree is not None
            self._rounds.append((k, tree))
            tables.fold(self.r)
            fold_step(k, self.rh)
            if last:
                dtr.round_scalars(self.state, self.scal, self.digest, elem=fri_data.final)
                self._last = True

    def replay(self, fri_data: FriProverData) -> List[SumcheckPoly]:
        """ONE device->host copy: the round polynomials of the rounds not
        replayed yet, every root not fetched yet, the last fold's elements
        if the chain ended, the device's digest.  Then the host transcript
        absorbs what the device absorbed, in the same order, and must reach
        the same digest.  Returns the round polynomials."""
        if not self._rounds:
            return []
        with span("replay"):
            fresh = [t for t in fri_data.trees if not t.has_root_bytes]
            k0, n = self._rounds[0][0], len(self._rounds)
            parts = [self.coeffs[k0 : k0 + n].reshape(-1)] + [t.root_words for t in fresh]
            if self._last:
                parts.append(fri_data.final.reshape(-1))
            parts.append(self.digest)
            host = stats.fetch(torch.cat(parts)).view(np.uint32)
            coeffs = limbs.unpack_ints(host[: 8 * n].reshape(-1, 2, 4))
            off = 8 * n
            for t in fresh:
                t.set_root_words(host[off : off + 8])
                off += 8
            pols = []
            for (k, tree), (c1, c2) in zip(self._rounds, coeffs):
                if tree is not None:
                    self.transcript.absorb(tree.root_bytes())
                pol = SumcheckPoly([Fp(int(c1)), Fp(int(c2))])
                pol.absorb_into(self.transcript)
                pols.append(pol)
            if self._last:
                fri_data.set_last_element(limbs.unpack_ints(host[off:-8].reshape(-1, 4)))
                self.transcript.absorb(fri_data.last_element.to_bytes())
            if self.transcript.random() != digest_to_bytes(host[-8:]):
                raise dtr.TranscriptMismatch("the host transcript's replay of the rounds does not reach "
                                             "the digest the device computed")
            self._rounds, self._last = [], False
            return pols


def launch_rounds(session, fri_data: FriProverData, max_rounds: Optional[int]) -> int:
    """Advance a prover session (plain or batched: ``tables``, ``k``,
    ``n_vars``, ``rounds``, ``config``) by up to ``max_rounds`` rounds of
    plain folds on ``fri_data``, all on the device: nothing here copies to
    or from the host.  Returns the number of rounds launched."""
    end = session.n_vars if max_rounds is None else min(session.n_vars, session.k + max_rounds)
    done = 0
    while session.k < end:
        session.rounds.round(session.tables, fri_data, fri_data.fold_step, session.k,
                             session.k == session.n_vars - 1)
        session.k += 1
        done += 1
    return done


def run_rounds(session, fri_data: FriProverData, max_rounds: Optional[int]) -> int:
    """``launch_rounds``, then the one copy that brings the host transcript
    and ``session.pols`` up to date; returns the number of rounds done."""
    with span("rounds"):
        done = launch_rounds(session, fri_data, max_rounds)
        session.pols += session.rounds.replay(fri_data)
    return done


class PCSProverSession:
    """Stage-by-stage PCS prover: construct (encode, commit, tables), run
    some or all rounds, finish (queries).  ``PCSProof.prove`` is the one-shot
    wrapper.  ``save`` writes the session at its round boundary to disk and
    ``resume`` continues it, in this process or another (``checkpoint``).

    With a ``layout`` (``parallel.ShardLayout``) the session is one rank of
    a sharded prove: ``evals`` is the rank's contiguous block of 2^n / W
    rows, the encode, the tables and the FRI layers are the rank's
    (``parallel.rounds``), and the rounds are the same ``DeviceRounds``.
    ``cyclic``: ``evals`` is already the rank's cyclic block (rows i = rank
    mod W), as a SNARK's trace sumcheck left its column, and the exchange
    that turns a contiguous block cyclic is skipped."""

    def __init__(
        self,
        inputs: Sequence[Fp],
        output: Fp,
        evals: torch.Tensor,
        transcript: Transcript,
        config: Optional[ProverConfig] = None,
        layout=None,
        cyclic: bool = False,
    ):
        self.config = config or ProverConfig()
        self.inputs = [Fp(x) for x in inputs]
        self.output = Fp(output)
        self.n_vars = len(self.inputs)
        self.layout = layout
        ranks = 1 if layout is None else layout.world
        if evals.dim() != 2 or evals.shape != ((1 << self.n_vars) // ranks, 4) or self.n_vars < 1:
            raise ValueError(
                f"evals must be a (2^n / ranks, 4) limb tensor with n = len(inputs) >= 1, got {tuple(evals.shape)}"
            )
        self.transcript = transcript
        evals = evals.to(self.config.device if layout is None else layout.device).contiguous()
        debug = self.config.debug_checks
        if debug and not ops.is_canonical(evals):
            raise ValueError("non-canonical field element in evals")

        with span("encode"):
            if layout is None:
                code = encode_mle_for_fri(evals)
            else:
                from .parallel import rounds as sharded

                sharded.check_rows(self.n_vars, layout)
                if cyclic:
                    code = sharded.encode_cyclic(evals, layout)
                else:
                    evals, code = sharded.encode_rows(evals, layout)
        # the root is absorbed on the device by the first round
        with span("commit_l0"):
            if layout is None:
                self.fri_data = FriProverData.init(code, None, debug_checks=debug)
            else:
                self.fri_data = sharded.ShardedFriProverData.init(code, layout, None, debug)
            del code
        with span("tables"):
            if layout is None:
                self.tables = SumcheckTables.for_pcs(self.inputs, evals, debug_checks=debug)
            else:
                self.tables = sharded.ShardedTables.for_pcs(self.inputs, evals, layout, debug)
                self.fri_data.mark_bytes()
            self.rounds = DeviceRounds(transcript, self.n_vars, self.output, evals.device)
        self.k = 0
        self.pols: List[SumcheckPoly] = []

    def launch_rounds(self, max_rounds: Optional[int] = None) -> int:
        """Launch up to ``max_rounds`` sumcheck+FRI rounds on the device and
        copy nothing back; returns rounds launched."""
        return launch_rounds(self, self.fri_data, max_rounds)

    def run_rounds(self, max_rounds: Optional[int] = None) -> int:
        """Run up to ``max_rounds`` sumcheck+FRI rounds and bring the host
        transcript up to date (one copy); returns rounds done."""
        return run_rounds(self, self.fri_data, max_rounds)

    def finish(self) -> "PCSProof":
        self.pols += self.rounds.replay(self.fri_data)
        if self.k != self.n_vars or self.fri_data.last_element is None:
            raise RuntimeError("finish() before all rounds ran")
        with span("queries"):
            domain_size = 1 << (self.n_vars + LOG_BLOWUP)
            indices = draw_query_indices(self.transcript, domain_size // 2, NUM_QUERIES)
            with span("open"):
                queries = self.fri_data.open_queries(indices)
        fri_proof = FriProof(
            commitments=self.fri_data.fold_roots(),
            queries=queries,
            last_elem=self.fri_data.last_element,
            last_random=self.transcript.random(),
        )
        return PCSProof(fri_proof, self.pols, list(self.inputs), self.output)

    # -- persistence -----------------------------------------------------------
    def save(self, path: str) -> None:
        """Save the session to ``path`` (``.npz`` appended if missing) and its
        claim to ``path + ".claim"``.  Rounds launched and not replayed yet
        are replayed first (one copy), so the host transcript is current.
        A sharded session is saved by every rank at once and writes the file
        of the single-rank session at the same round: the blocks are
        gathered, rank 0 writes (on many hosts, to rank 0's disk), and every
        rank returns after a barrier."""
        self._write(path)
        barrier(self.layout)

    def _write(self, path: str) -> None:
        """``save`` up to its barrier."""
        self.pols += self.rounds.replay(self.fri_data)
        path = normalize_ckpt_path(path)
        save_pcs_state(path, self.tables, self.fri_data, self.transcript, self.k, self.rounds.running_sum(),
                       self.pols, self.layout)
        if is_writer(self.layout):
            with open(path + ".claim", "w") as f:
                json.dump({"inputs": [x.v for x in self.inputs], "output": self.output.v}, f)

    @staticmethod
    def resume(path: str, config: Optional[ProverConfig] = None, layout=None) -> "PCSProverSession":
        """The session saved at ``path``, its tensors on ``config.device``
        (default: the card) and its trees rebuilt; the rounds' Fiat-Shamir
        hops to the device again.  With a ``layout``, every rank calls it and
        keeps its cyclic blocks of the file's tables and codewords on the
        layout's device, its subtrees rebuilt over the ranks: the file of a
        sharded or a single-rank session resumes either way."""
        path = normalize_ckpt_path(path)
        s = PCSProverSession.__new__(PCSProverSession)
        s.config = config or ProverConfig()
        s.layout = layout
        s.tables, s.fri_data, s.transcript, s.k, prev, s.pols = load_pcs_state(
            path, s.config.device, s.config.debug_checks, layout)
        with open(path + ".claim") as f:
            claim = json.load(f)
        s.inputs = [Fp(int(v)) for v in claim["inputs"]]
        s.output = Fp(int(claim["output"]))
        s.n_vars = len(s.inputs)
        s.rounds = DeviceRounds(s.transcript, s.n_vars, prev, s.tables.data.device)
        s.rounds.roots_absorbed = s.k  # round j absorbed the root of tree j
        if layout is not None:
            s.fri_data.mark_bytes()
        return s
