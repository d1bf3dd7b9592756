"""AIR-style constraint system and its SNARK: Expr, ConstraintSet, Trace,
System, SnarkProof, SnarkProverSession.

Capability parity with reference src/constraint_system/{constraints,trace,
system}.rs and with the JAX package's ``system.py``.  A constraint is a plain
Python callable over operator-overloading values (``+``, ``-``, ``*``, unary
``-``, ``int`` or ``Fp`` constants), so the SAME expression runs (a) over
the tracer's stand-ins in the prover, once, into the program that the
sumcheck's rounds run (``composition.trace``), and (b) over host ``Fp``
scalars in the verifier - the reference's ``Expr = fn(&[F], &[F]) -> F``
(constraints.rs:3-10).

A SNARK proof is the trace sumcheck over the masked constraints, then a PCS
opening of the trace columns at the sumcheck point: the plain PCS for one
column (the reference snark_test flow, src/fri/multilinear_pcs.rs:279-316),
the batched PCS for several (an extension the reference describes but does
not wire up).  The prover's tensors live on ``ProverConfig.device`` (the
card unless the caller asks for the CPU); its randomness comes only from the
transcript.

Behavioral quirks preserved for transcript parity:

* Q2 - all ChallengeSet challenges are one identical element: the reference
  builds each vector with ``vec![transcript.next_challenge(); n]`` and
  absorbs nothing in between (system.rs:131-146), and next_challenge does
  not advance the sponge (Q1).
* Q3 - the trace ``Commitment`` is a stub that never binds the trace
  (trace.rs:40-48).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from . import stats
from .batched_pcs import BatchedPCSClaim, BatchedPCSProof, BatchedPCSProverSession
from .checkpoint import (
    barrier, checkpoint_kind, is_writer, load_snark_sumcheck_state, normalize_ckpt_path, pols_from_meta,
    pols_to_meta, save_snark_sumcheck_state,
)
from .config import ProverConfig
from .field import limbs
from .field.scalar import Fp, ZERO
from .mle import eq_scalar, evaluate_evals, mask_scalar
from .pcs import PCSProof, PCSProverSession
from .sumcheck import DeviceSumcheckRounds, SumcheckPoly, SumcheckTables, replay_sumcheck
from .transcript import Transcript
from .utils import span

# An Expr takes (values, randoms) and returns a value; polymorphic over the
# tracer's stand-ins (the prover) and host Fp scalars (the verifier).
Expr = Callable[[Sequence, Sequence], object]


class SnarkError(ValueError):
    """The sumcheck's final value does not match delta * composition at the
    claimed column evaluations, or the PCS proof opens another claim."""


@dataclass
class ConstraintSet:
    """Constraints of the form ``expr = 0`` plus their max degree.

    Reference: ConstraintSet (src/constraint_system/constraints.rs:12-34).
    """

    constraints: List[Expr]
    degree: int

    def composition_fn(self):
        """Two-argument composition sum_i mask_i * C_i(cols, randoms): the
        randoms and masks arrive in ``aux`` (randoms first, then one mask per
        constraint) instead of being closed over, so the same callable
        serves every proof with this constraint set.  Cached on the
        instance."""
        if getattr(self, "_comp_fn", None) is None:
            cs = list(self.constraints)
            n = len(cs)

            def comp(cols, aux):
                randoms = aux[: len(aux) - n]
                masks = aux[len(aux) - n :]
                acc = None
                for expr, m in zip(cs, masks):
                    term = expr(cols, randoms) * m
                    acc = term if acc is None else acc + term
                return acc if acc is not None else ZERO

            object.__setattr__(self, "_comp_fn", comp)
        return self._comp_fn


def _is_pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


class Trace:
    """Execution trace of ``width`` columns and a power-of-two height, held
    as a (width, height, 4) field tensor (column c at [c]).

    Reference: Trace (src/constraint_system/trace.rs:3-38).  The row-major
    constructor takes host ints; large traces are built with
    :meth:`from_columns`, which never makes a host int per element.  The
    columns live on ``device``, by default ``ProverConfig().device`` (the
    card) as for every entry point; pass ``"cpu"`` to keep them on the host.
    """

    def __init__(self, matrix: Sequence, width: int, device=None):
        vals = [Fp(v).v for v in matrix]
        if width < 1 or len(vals) % width:
            raise ValueError("the matrix must hold a whole number of rows of the given width")
        height = len(vals) // width
        if not _is_pow2(height):
            raise ValueError("height must be a power of two")
        cols = np.array(vals, dtype=object).reshape(height, width).T.reshape(-1)
        device = ProverConfig().device if device is None else device
        self._cols = limbs.pack_ints(cols, shape=(width, height), device=device)
        self.width, self.height = width, height

    @staticmethod
    def from_columns(columns, device=None) -> "Trace":
        """Tensor- or numpy-backed construction (no per-element host ints).

        ``columns``: a (w, h, 4) limb tensor of canonical residues, which
        stays on its device unless ``device`` is given, or a sequence of w
        1-D numpy uint64 arrays, packed on the host and moved to ``device``,
        by default ``ProverConfig().device`` (the card)."""
        if not isinstance(columns, torch.Tensor):
            if any(not isinstance(c, np.ndarray) or c.ndim != 1 for c in columns):
                raise ValueError("columns must be a (w, h, 4) tensor or 1-D numpy uint64 arrays")
            columns = torch.stack([limbs.pack_ints(np.asarray(c, dtype=np.uint64)) for c in columns])
            device = ProverConfig().device if device is None else device
        if columns.dim() != 3 or columns.shape[-1] != 4 or columns.dtype != torch.int32:
            raise ValueError(f"trace columns must be a (w, h, 4) int32 tensor, got {columns.dtype} "
                             f"{tuple(columns.shape)}")
        if not _is_pow2(columns.shape[1]) or columns.shape[0] < 1:
            raise ValueError("height must be a power of two and width at least 1")
        t = Trace.__new__(Trace)
        t._cols = (columns if device is None else columns.to(device)).contiguous()
        t.width, t.height = columns.shape[0], columns.shape[1]
        return t

    def to(self, device) -> "Trace":
        """This trace with its columns on ``device`` (itself if they are)."""
        device = torch.device(device)
        if self._cols.device.type == device.type and device.index in (None, self._cols.device.index):
            return self
        return Trace.from_columns(self._cols, device)

    def get(self, i: int, j: int) -> Fp:
        """Row i of column j."""
        return Fp(int(limbs.unpack_ints(stats.fetch(self._cols[j, i]))[()]))

    def columns_device(self) -> torch.Tensor:
        """(w, h, 4) limb tensor, column c at [c]."""
        return self._cols

    def evaluate(self, points: Sequence[Fp]) -> List[Fp]:
        """MLE of every column at ``points`` (reference evaluation.rs:31-48):
        one delta table, one batched product and sum on the columns' device,
        one copy of the w results to the host."""
        out = evaluate_evals(self._cols, points)  # (w, 4)
        return [Fp(int(v)) for v in limbs.unpack_ints(stats.fetch(out))]


def trace_from_jax_columns(columns, device=None) -> Trace:
    """A trace of this package from the JAX package's ``Trace.columns_device()``
    as a numpy (8, w, h) uint32 array of 16-bit limbs, on ``device`` (by
    default ``ProverConfig().device``, the card): both packages then prove the
    same thing."""
    columns = np.asarray(columns, dtype=np.uint32)
    if columns.ndim != 3 or columns.shape[0] != 8:
        raise ValueError(f"expected an (8, w, h) limb array, got {columns.shape}")
    device = ProverConfig().device if device is None else device
    return Trace.from_columns(limbs.from_jax_limbs(columns, device))


class Commitment:
    """Stub trace commitment, reproducing reference quirk Q3
    (src/constraint_system/trace.rs:40-48): it never binds the trace."""

    def __init__(self, trace: Optional[Trace] = None):
        pass


@dataclass
class WitnessLayout:
    """Witness shape (reference system.rs:17-30).  ``pre_random_columns``
    and ``sum_columns`` are declared but unused, as in the reference."""

    columns: int
    randoms: int = 0
    pre_random_columns: int = 0
    sum_columns: List[int] = field(default_factory=list)


class ChallengeSet:
    """Row, trace and constraint challenges drawn at construction.

    Quirk Q2: each vector is n copies of ONE next_challenge() result and
    nothing is absorbed in between, so every challenge in the set is the same
    element (reference system.rs:131-146)."""

    def __init__(self, transcript: Transcript, num_randoms: int, log_num_constraints: int, log_num_rows: int):
        self.row = [transcript.next_challenge()] * log_num_rows
        self.trace = [transcript.next_challenge()] * num_randoms
        self.constraint = [transcript.next_challenge()] * log_num_constraints

    @staticmethod
    def from_values(row: Sequence[Fp], trace: Sequence[Fp], constraint: Sequence[Fp]) -> "ChallengeSet":
        """The set drawn earlier, from its values (a resumed session)."""
        ch = ChallengeSet.__new__(ChallengeSet)
        ch.row, ch.trace, ch.constraint = list(row), list(trace), list(constraint)
        return ch


class System:
    """Prover/verifier context tying constraints, challenges and the trace.

    Reference: System (src/constraint_system/system.rs:8-128).

    With a ``shard`` (``parallel.ShardLayout``) the prover is one rank of a
    sharded SNARK: ``trace`` is the rank's contiguous block of rows
    (``shard.shard_rows`` of the whole trace's columns), ``log_num_rows``
    the whole trace's, and the tables are the rank's cyclic block.
    """

    def __init__(self, transcript: Transcript, constraints: ConstraintSet, layout: WitnessLayout,
                 commitment: Commitment, log_num_rows: int, trace: Optional[Trace],
                 config: Optional[ProverConfig] = None, challenges: Optional[ChallengeSet] = None,
                 shard=None):
        """``challenges``: a set drawn earlier (a resumed session), in place
        of drawing one from ``transcript``."""
        n_constraints = len(constraints.constraints)
        log_num_constraints = max(n_constraints - 1, 0).bit_length()
        self.constraints = constraints
        self.layout = layout
        self.commitment = commitment
        self.config = config or ProverConfig()
        self.shard = shard
        self.trace = None if trace is None else trace.to(self.config.device if shard is None else shard.device)
        self._columns: Optional[torch.Tensor] = None
        self.challenges = challenges or ChallengeSet(transcript, layout.randoms, log_num_constraints, log_num_rows)
        cc = self.challenges.constraint
        self.constraint_mask = [mask_scalar(i, len(cc), cc) for i in range(n_constraints)]

    @staticmethod
    def prover(transcript: Transcript, constraints: ConstraintSet, layout: WitnessLayout, trace: Trace,
               config: Optional[ProverConfig] = None, shard=None) -> "System":
        """A prover on ``config.device`` (default: the card); the trace's
        columns are moved there.  With a ``shard``, one rank of a sharded
        prove on the shard's device: ``trace`` is the rank's contiguous
        block, and the row challenges are drawn for the whole trace's
        W x ``trace.height`` rows."""
        ranks = 1 if shard is None else shard.world
        log_num_rows = (trace.height * ranks).bit_length() - 1
        if shard is not None:
            from .parallel.rounds import check_rows

            check_rows(log_num_rows, shard)
        return System(transcript, constraints, layout, Commitment(trace), log_num_rows, trace, config, shard=shard)

    @staticmethod
    def verifier(transcript: Transcript, constraints: ConstraintSet, layout: WitnessLayout,
                 commitment: Commitment, log_num_rows: int) -> "System":
        """A verifier: host only."""
        return System(transcript, constraints, layout, commitment, log_num_rows, None)

    # -- composition / delta glue (reference evaluation.rs:4-29) -------------
    @property
    def aux(self) -> list:
        """The composition's aux scalars: the randoms, then one mask per
        constraint."""
        return list(self.challenges.trace) + list(self.constraint_mask)

    def evaluate_composition(self, values: Sequence) -> object:
        """sum_i mask_i * C_i(values, randoms) over host Fp values."""
        if len(values) != self.layout.columns:
            raise SnarkError(f"expected {self.layout.columns} column values, got {len(values)}")
        return self.constraints.composition_fn()(list(values), self.aux)

    def evaluate_delta(self, inputs: Sequence[Fp]) -> Fp:
        return eq_scalar(self.challenges.row, inputs)

    # -- prover flow ----------------------------------------------------------
    def prover_columns(self) -> torch.Tensor:
        """The trace's columns as the prover holds them, (w, rows, 4): the
        whole trace, or with a shard this rank's cyclic block of it (one
        all-to-all, made once: the trace sumcheck and the PCS both read it)."""
        if self.trace is None:
            raise ValueError("a verifier has no trace")
        if self._columns is None:
            cols = self.trace.columns_device()
            if self.shard is not None:
                from .parallel import to_cyclic

                cols = to_cyclic(cols, self.shard)
            self._columns = cols
        return self._columns

    def build_tables(self) -> SumcheckTables:
        if self.shard is None:
            return SumcheckTables.for_trace(self.challenges.row, self.prover_columns(), self.config.debug_checks)
        from .parallel.rounds import ShardedTables

        return ShardedTables.for_trace(self.challenges.row, self.prover_columns(), self.shard,
                                       self.config.debug_checks)

    def compute_sumcheck_polynomials(self, transcript: Transcript, tables: SumcheckTables, sum_value: Fp):
        """The standalone sumcheck over the masked constraints: (pols, randoms)."""
        return tables.compute_all_rounds(self.constraints.composition_fn(), self.constraints.degree, transcript,
                                         sum_value, aux=self.aux)

    # -- verifier flow ---------------------------------------------------------
    def verify_sumcheck_debug(self, transcript: Transcript, pols, sum_value: Fp) -> None:
        """Prover-side debug check: re-evaluates the trace's MLEs
        (reference sumcheck.rs:55-89)."""
        if self.shard is not None:
            raise ValueError("the debug check evaluates the whole trace, which a rank of a sharded prove lacks")
        rs, final = replay_sumcheck(transcript, pols, sum_value)
        output = self.trace.evaluate(rs)
        if self.evaluate_delta(rs) * self.evaluate_composition(output) != final:
            raise SnarkError("Does not match polynomial evaluation")

    def verify_with_evaluations(self, transcript: Transcript, pols, sum_value: Fp, output: Sequence[Fp]):
        """Verifier-side check against claimed column evaluations (reference
        sumcheck.rs:91-124); the round polynomials must have total degree
        composition degree + 1.  Returns the sumcheck point."""
        rs, final = replay_sumcheck(transcript, pols, sum_value, degree=self.constraints.degree + 1)
        if self.evaluate_delta(rs) * self.evaluate_composition(list(output)) != final:
            raise SnarkError("Does not match polynomial evaluation")
        return rs

    # -- end-to-end SNARK (sumcheck + PCS) -------------------------------------
    def prove_snark(self, transcript: Transcript, sum_value: Fp = None) -> "SnarkProof":
        """Sumcheck over the composed constraints, then a PCS opening of the
        trace columns at the sumcheck point: ``PCSProof`` for width 1,
        ``BatchedPCSProof`` for more columns."""
        with span("proof"):
            session = SnarkProverSession(transcript, self.constraints, self.layout, self.trace, sum_value,
                                         self.config, system=self)
            session.run_sumcheck_rounds()
            return session.finish()

    def verify_snark(self, transcript: Transcript, proof: "SnarkProof") -> None:
        """Verify a :class:`SnarkProof`: the sumcheck replay against the
        claimed outputs, then the PCS proof, which must open exactly those
        outputs at the sumcheck point."""
        rs = self.verify_with_evaluations(transcript, proof.sumcheck_polynomials, proof.sum_value,
                                          proof.outputs)
        pcs = proof.pcs
        if isinstance(pcs, PCSProof):
            claim = (list(pcs.inputs), [pcs.output])
        elif isinstance(pcs, BatchedPCSProof):
            claim = (list(pcs.claim.inputs), list(pcs.claim.outputs))
        else:
            raise SnarkError(f"unknown PCS proof type {type(pcs).__name__}")
        if claim != (list(rs), list(proof.outputs)):
            raise SnarkError("the PCS proof opens another point or other outputs than the sumcheck's")
        pcs.verify(transcript)


class SnarkProof:
    """Sumcheck round polynomials + claimed column evaluations + PCS proof."""

    def __init__(self, sumcheck_polynomials: List[SumcheckPoly], outputs: List[Fp], pcs, sum_value: Fp):
        self.sumcheck_polynomials = sumcheck_polynomials
        self.outputs = outputs
        self.pcs = pcs
        self.sum_value = sum_value


class SnarkProverSession:
    """Stage-by-stage SNARK prover: the trace sumcheck (some or all rounds at
    a time), then the PCS opening (some or all rounds at a time), then
    ``finish``.  ``System.prove_snark`` is the one-shot wrapper.  ``save``
    writes the session to disk in either phase and ``resume`` continues it
    (``checkpoint``).

    Phases (``utils.span``): ``snark_tables``, ``sumcheck_rounds``,
    then the PCS session's own (encode, commit_l0 or commit_batch, tables,
    rounds, queries).  The outputs - each column's MLE at the sumcheck point -
    are what the last round's fold leaves in the tables; they come to the host
    in the copy that ends the rounds.

    With a ``shard`` (``parallel.ShardLayout``) the session is one rank of a
    sharded prove (``System.prover``): the trace sumcheck runs on the rank's
    cyclic block of the columns, and the PCS opens that block as it is - the
    plain PCS row-sharded for one column, the batched PCS in its row mode for
    several - with no second exchange of the trace.  Every rank ends with the
    single-rank proof."""

    def __init__(self, transcript: Transcript, constraints: ConstraintSet, layout: WitnessLayout, trace: Trace,
                 sum_value: Fp = None, config: Optional[ProverConfig] = None, system: Optional[System] = None,
                 shard=None):
        self.system = system or System.prover(transcript, constraints, layout, trace, config, shard)
        self.shard = self.system.shard
        self.config = self.system.config
        self.transcript = transcript
        self.trace = self.system.trace
        self.sum_value = Fp(0) if sum_value is None else Fp(sum_value)
        with span("snark_tables"):
            self.tables = self.system.build_tables()
            comp = self.system.constraints.composition_fn()
            self.rounds = DeviceSumcheckRounds(transcript, self.tables, comp, self.system.constraints.degree + 1,
                                               self.sum_value, self.system.aux)
        self.n_rounds = self.rounds.n_rounds
        self.pols: List[SumcheckPoly] = []
        self.randoms: List[Fp] = []
        self.outputs: Optional[List[Fp]] = None
        self.pcs_session = None

    # -- phase 1: trace sumcheck ------------------------------------------------
    def launch_sumcheck_rounds(self, max_rounds: Optional[int] = None) -> int:
        """Launch up to ``max_rounds`` trace-sumcheck rounds on the device and
        copy nothing back; returns rounds launched."""
        return self.rounds.launch(max_rounds)

    def run_sumcheck_rounds(self, max_rounds: Optional[int] = None) -> int:
        """Run up to ``max_rounds`` trace-sumcheck rounds and bring the host
        transcript up to date (one copy); returns rounds done."""
        with span("sumcheck_rounds"):
            done = self.rounds.launch(max_rounds)
            self._replay()
        return done

    def _replay(self) -> None:
        pols, randoms = self.rounds.replay()
        self.pols += pols
        self.randoms += randoms

    # -- phase 2: PCS opening ---------------------------------------------------
    def start_pcs(self) -> None:
        """Open the PCS at the sumcheck point, claiming the outputs the
        sumcheck's last fold left."""
        if self.pcs_session is not None:
            raise RuntimeError("the PCS phase has started already")
        self._replay()  # rounds launched but not yet replayed
        if len(self.randoms) != self.n_rounds:
            raise RuntimeError("sumcheck phase not finished")
        self.outputs = self.rounds.outputs
        cols = self.system.prover_columns()
        sharded = {} if self.shard is None else {"layout": self.shard, "cyclic": True}
        if cols.shape[0] == 1:
            self.pcs_session = PCSProverSession(self.randoms, self.outputs[0], cols[0], self.transcript, self.config,
                                                **sharded)
        else:
            claim = BatchedPCSClaim(inputs=list(self.randoms), outputs=list(self.outputs))
            self.pcs_session = BatchedPCSProverSession(claim, cols, self.transcript, self.config, **sharded)

    def run_pcs_rounds(self, max_rounds: Optional[int] = None) -> int:
        if self.pcs_session is None:
            self.start_pcs()
        return self.pcs_session.run_rounds(max_rounds)

    def finish(self) -> SnarkProof:
        if self.pcs_session is None:
            self.start_pcs()
        self.pcs_session.run_rounds()
        pcs = self.pcs_session.finish()
        return SnarkProof(self.pols, list(self.outputs), pcs, self.sum_value)

    # -- persistence -------------------------------------------------------------
    def save(self, path: str) -> None:
        """Save the session to ``path`` (``.npz`` appended if missing), rounds
        launched and not replayed yet replayed first.  In the sumcheck phase
        the file holds the trace, the tables, the transcript, the rounds so
        far and the challenges; in the PCS phase it is the PCS session's,
        with the sumcheck's result in ``path + ".snark"``.  A sharded session
        writes the single-rank session's files, as ``pcs.PCSProverSession.save``:
        every rank calls it, rank 0 writes, every rank returns after a barrier."""
        path = normalize_ckpt_path(path)
        if self.pcs_session is None:
            self._replay()
            cols = self.trace.columns_device()
            if self.shard is not None:
                cols = self.shard.gather_rows(cols)
            save_snark_sumcheck_state(path, cols, self.tables, self.transcript, self.rounds.k,
                                      self.rounds.running_sum(), self.pols, self.randoms, self.system.challenges,
                                      self.sum_value, self.rounds.outputs, self.shard)
        else:
            self.pcs_session._write(path)
            if is_writer(self.shard):
                with open(path + ".snark", "w") as f:
                    json.dump({"width": len(self.outputs), "sum_value": self.sum_value.v,
                               "pols": pols_to_meta(self.pols),
                               "outputs": [x.v for x in self.outputs]}, f)
        barrier(self.shard)

    @staticmethod
    def resume(path: str, constraints: ConstraintSet, layout: WitnessLayout,
               config: Optional[ProverConfig] = None, shard=None) -> "SnarkProverSession":
        """The session saved at ``path``, on ``config.device`` (default: the
        card).  Constraints are callables and are not saved: the caller
        passes the same ``constraints`` and ``layout`` again.  With a
        ``shard``, every rank calls it and resumes its share of the file
        (of a sharded or a single-rank session) on the shard's device: the
        trace's contiguous block, the tables' cyclic block, the PCS as
        ``pcs.PCSProverSession.resume`` with a layout."""
        path = normalize_ckpt_path(path)
        config = config or ProverConfig()
        s = SnarkProverSession.__new__(SnarkProverSession)
        s.config = config
        s.shard = shard
        if checkpoint_kind(path) == "snark_sumcheck":
            (cols, s.tables, s.transcript, k, prev, s.pols, s.randoms, ch, s.sum_value,
             outputs) = load_snark_sumcheck_state(path, config.device, config.debug_checks, shard)
            s.trace = Trace.from_columns(cols)
            challenges = ChallengeSet.from_values(ch["row"], ch["trace"], ch["constraint"])
            ranks = 1 if shard is None else shard.world
            s.system = System(s.transcript, constraints, layout, Commitment(s.trace),
                              (s.trace.height * ranks).bit_length() - 1, s.trace, config, challenges, shard)
            s.rounds = DeviceSumcheckRounds(s.transcript, s.tables, constraints.composition_fn(),
                                            constraints.degree + 1, prev, s.system.aux, rounds_done=k)
            s.rounds.outputs = outputs
            s.n_rounds = s.rounds.n_rounds
            s.outputs = None
            s.pcs_session = None
            return s
        # the PCS phase: the sumcheck is done, and the PCS session holds the rest
        with open(path + ".snark") as f:
            sm = json.load(f)
        session_type = PCSProverSession if sm["width"] == 1 else BatchedPCSProverSession
        s.pcs_session = session_type.resume(path, config, shard)
        s.system = s.trace = s.tables = s.rounds = None
        s.transcript = s.pcs_session.transcript
        s.sum_value = Fp(int(sm["sum_value"]))
        s.pols = pols_from_meta(sm["pols"])
        s.outputs = [Fp(int(v)) for v in sm["outputs"]]
        s.randoms = list(s.pcs_session.inputs if sm["width"] == 1 else s.pcs_session.claim.inputs)
        s.n_rounds = len(s.pols)
        return s
