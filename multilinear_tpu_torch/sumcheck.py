"""The sumcheck engine: device partial sums, the table fold, and the
standalone round loop with its Fiat-Shamir on the device.

Protocol semantics match the reference engine
(src/constraint_system/sumcheck.rs): same round-polynomial wire format
(constant coefficient stripped, quirk Q7), same transcript schedule (absorb
the nonzero coefficients, then draw the challenge), same table fold
lo' = (1-r)*lo + r*hi pairing row i with i + h/2 (MSB fold, big-endian
variable order).

The prover state is one packed (w+1, h, 4) tensor: w trace columns (one MLE
for the PCS) and the delta (eq-weight) table in the LAST row, so one
multiply folds everything.  A round evaluates the composition at the
linear extensions X = 1..d of the table halves, weights it by the extended
delta row and sums the limbs unreduced; the round's Fiat-Shamir kernel
reduces the sums.  The composition is traced once to a program
(``composition.trace``), and every table's sums are
:meth:`SumcheckTables.program_sums` (``composition.round_sums``, which picks
the route: one ``sumcheck_sums`` launch on a card where the program fits a
block):

* the PCS (``pcs.DeviceRounds``) runs the identity composition's program at
  degree 2 and calls ``device_transcript.round_scalars``;
* the standalone sumcheck of the constraint system
  (:meth:`SumcheckTables.compute_all_rounds`, :class:`DeviceSumcheckRounds`)
  runs any composition's and calls
  ``device_transcript.sumcheck_round_scalars``, which interpolates through
  V^-1.  A round is three launches on one card: the program's sums, the
  round's scalars, then the fold.  Its rounds copy nothing to the host; one
  copy after the last round brings the coefficients, the randoms, the folded
  columns (each column's MLE at the randoms) and the device's digest back,
  and the host replays the absorbs and challenges and checks them.

Every table folds in one ``sumcheck_fold`` launch (``composition.round_fold``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from . import composition as cmp
from . import device_transcript as dtr
from . import stats
from .field import limbs, ops
from .field.scalar import Fp, ONE, TWO_INV, ZERO
from .mle import combine_subtables, delta_subtables
from .poly import Polynomial
from .sha256 import digest_to_bytes
from .transcript import Transcript
from .utils import span

# A composition maps the columns' values to one value through +, -, * and
# unary -, with int or Fp constants: in the prover it is called once, over
# the tracer's stand-ins (``composition.trace``), and its program runs at
# every point; in the verifier over host Fp.  Two calling conventions, as
# in the JAX package: composition(cols) when there are no aux scalars (e.g.
# identity_composition), composition(cols, aux) otherwise - the randoms and
# constraint masks are aux scalars packed once per proof, not constants
# baked into the composition.
Composition = Callable[..., object]


def identity_composition(cols: Sequence) -> object:
    """The PCS composition: x -> x[0] (reference multilinear_pcs.rs:56)."""
    return cols[0]


@dataclass
class SumcheckPoly:
    """Round-polynomial wire format: constant coefficient stripped (Q7).

    Reference: SumcheckPolynomial (src/constraint_system/sumcheck.rs:263-276).
    """

    nonzero_coeffs: List[Fp]

    def to_polynomial(self, sum_value: Fp) -> Polynomial:
        """Recover the full polynomial from p(0) + p(1) = sum_value."""
        sum_coeff = ZERO
        for c in self.nonzero_coeffs:
            sum_coeff = sum_coeff + c
        a0 = (sum_value - sum_coeff) * TWO_INV
        return Polynomial([a0] + self.nonzero_coeffs)

    def absorb_into(self, transcript: Transcript) -> None:
        for c in self.nonzero_coeffs:
            transcript.absorb(c.to_bytes())


def _pack_tables_kernel(cols: torch.Tensor, subs) -> torch.Tensor:
    """The packed (columns || delta) table: ``cols`` (h, 4) one MLE or
    (w, h, 4) trace columns, ``subs`` the delta sub-tables
    (mle.delta_subtables).  Returns (w+1, h, 4) with the delta weights in the
    LAST row."""
    if cols.dim() == 2:
        cols = cols.unsqueeze(0)
    w = cols.shape[0]
    data = torch.empty((w + 1,) + tuple(cols.shape[1:]), dtype=cols.dtype, device=cols.device)
    data[:w].copy_(cols)
    combine_subtables(subs, out=data[w])
    return data


@lru_cache(maxsize=16)
def vandermonde_inv(n: int, device: torch.device) -> torch.Tensor:
    """V^-1 over the points 0..n-1 as an (n, n, 4) field tensor on
    ``device``, built on the host once per degree and kept on the device:
    coeffs = V^-1 @ evals is the interpolating polynomial (unique, so equal
    to PolynomialEvals.interpolate)."""
    V = [[Fp(i) ** j for j in range(n)] for i in range(n)]
    inv = [[ONE if i == j else ZERO for j in range(n)] for i in range(n)]
    for col in range(n):
        piv = next(r for r in range(col, n) if V[r][col] != ZERO)
        V[col], V[piv] = V[piv], V[col]
        inv[col], inv[piv] = inv[piv], inv[col]
        s = V[col][col].inv()
        V[col] = [x * s for x in V[col]]
        inv[col] = [x * s for x in inv[col]]
        for r in range(n):
            if r != col and V[r][col] != ZERO:
                f = V[r][col]
                V[r] = [a - f * b for a, b in zip(V[r], V[col])]
                inv[r] = [a - f * b for a, b in zip(inv[r], inv[col])]
    return limbs.pack_ints([x for row in inv for x in row], shape=(n, n), device=device)


class SumcheckTables:
    """Prover state of a sumcheck: the packed (w+1, height, 4) tensor of w
    columns and the delta table (w = 1 for the PCS)."""

    def __init__(self, data: torch.Tensor, height: int, debug_checks: bool = False):
        self.data = data.contiguous()  # as the round kernels read it
        self.height = height
        self.debug_checks = debug_checks

    @staticmethod
    def for_pcs(inputs: Sequence[Fp], evals: torch.Tensor, debug_checks: bool = False) -> "SumcheckTables":
        """Tables for the PCS claim p(inputs) = output; ``evals`` is the MLE
        in evaluation form, (2^n, 4).  Reference: build_tables_for_pcs
        (sumcheck.rs:128-145), with the delta table built by tensor-product
        doubling instead of per-row loops."""
        height = evals.shape[0]
        if not inputs or 1 << len(inputs) != height:
            raise ValueError("need one input per variable of the MLE, at least one")
        data = _pack_tables_kernel(evals, delta_subtables(inputs, evals.device))
        return SumcheckTables(data, height, debug_checks)

    @staticmethod
    def for_trace(row_challenges: Sequence[Fp], trace_columns: torch.Tensor,
                  debug_checks: bool = False) -> "SumcheckTables":
        """Tables for a constraint-system trace: ``trace_columns`` (w, h, 4),
        delta[i] = eq(row_challenges, bits(i)) (reference build_tables,
        sumcheck.rs:22-38)."""
        if trace_columns.dim() != 3 or trace_columns.shape[-1] != 4:
            raise ValueError(f"trace columns must be a (w, h, 4) limb tensor, got {tuple(trace_columns.shape)}")
        height = trace_columns.shape[1]
        if not row_challenges or 1 << len(row_challenges) != height:
            raise ValueError("need one row challenge per variable of the trace, at least one")
        if debug_checks and not ops.is_canonical(trace_columns):
            raise ValueError("non-canonical field element in the trace columns")
        data = _pack_tables_kernel(trace_columns, delta_subtables(row_challenges, trace_columns.device))
        return SumcheckTables(data, height, debug_checks)

    def program_sums(self, program: cmp.Program, aux: Optional[torch.Tensor], degree: int,
                     out: torch.Tensor) -> torch.Tensor:
        """A round's sums of s(1)..s(degree): ``program`` (the composition's,
        ``composition.trace``; the PCS's is ``pcs.IDENTITY``) run over the
        table, its limb sums added into ``out``, a zeroed (degree, 4) int64
        row.  Callers read the returned tensor only: here it is ``out``, but
        a rank's tables return the sums over the ranks, a new tensor."""
        cmp.round_sums(self.data, program, aux, degree, out)
        return out

    def gathered(self) -> torch.Tensor:
        """The whole packed table in natural order (a sharded table gathers
        it from every rank's block)."""
        return self.data

    def fold(self, r: torch.Tensor) -> None:
        """Fold with the challenge r, a (4,) field element on the tables'
        device (where the round's Fiat-Shamir kernel drew it): one
        ``sumcheck_fold`` launch."""
        self.data = cmp.round_fold(self.data, r)
        self.height >>= 1
        if self.debug_checks and not ops.is_canonical(self.data):
            raise ValueError("non-canonical field element in folded sumcheck table")

    def compute_all_rounds(self, composition: Composition, composition_degree: int, transcript: Transcript,
                           sum_value: Fp, aux=None):
        """Run all log2(height) rounds of the standalone sumcheck
        (sumcheck.rs:147-172) on the tables' device; round degree =
        composition degree + 1 (the delta factor is multilinear).  Returns
        (pols, randoms); the transcript ends where the host schedule would
        leave it."""
        rounds = DeviceSumcheckRounds(transcript, self, composition, composition_degree + 1, sum_value, aux)
        rounds.launch()
        return rounds.replay()


class DeviceSumcheckRounds:
    """The standalone sumcheck's rounds on the tables' device, and what the
    host has not replayed yet (the counterpart of ``pcs.DeviceRounds``).

    The host transcript's state hops to the device once, here, and the
    composition's program and aux scalars are on the device before the
    first round.  A round is the tables' sums of the program
    (:meth:`SumcheckTables.program_sums`, into the round's zeroed row of
    ``sums``; a rank's tables add them over the ranks), ONE
    ``sumcheck_round_scalars`` launch (reduce, interpolate through V^-1,
    absorb, draw r into the round's slot of ``randoms``, next sum) and the
    table fold, which reads r there: nothing is copied to or from the host.
    ``replay`` makes the one copy (the rounds' coefficients and randoms, the
    device's digest, and after the last round the folded columns); the host
    absorbs the same coefficients and draws the challenges into its own
    transcript, and must reach the same randoms and the same digest.  After
    the last round the tables hold one row, each column's MLE at the
    randoms: ``outputs``.

    ``rounds_done``: the rounds a resumed session ran before it was saved (at
    a round boundary, all replayed); ``tables`` are then the tables they
    folded, ``previous_sum`` the running sum and ``transcript`` the host
    transcript after them, and the round slots keep their indices.
    """

    def __init__(self, transcript: Transcript, tables: SumcheckTables, composition: Composition,
                 total_degree: int, previous_sum: Fp, aux=None, rounds_done: int = 0):
        device = tables.data.device
        limit = dtr.sumcheck_degree_limit(device)
        if total_degree < 1:
            raise ValueError(f"the total degree must be at least 1, got {total_degree}")
        if limit is not None and total_degree > limit:
            raise ValueError(f"total degree {total_degree}: a round on {device} takes degree {limit} at most")
        self.transcript = transcript
        self.tables = tables
        self.total_degree = total_degree
        self.n_rounds = rounds_done + tables.height.bit_length() - 1
        # the copies to the device go through pinned memory and do not make
        # the host wait
        self.state = dtr.state_from_host(transcript, device)
        self.prev = limbs.pack_int(Fp(previous_sum).v, device=device)
        self.vinv = vandermonde_inv(total_degree + 1, device)
        self.aux = None if aux is None else limbs.pack_ints(list(aux), device=device)
        self.program = cmp.trace(composition, tables.data.shape[0] - 1, None if aux is None else len(aux))
        self.program.on(device)  # its one copy to the device, made before the rounds
        self.coeffs = torch.empty((self.n_rounds, total_degree, 4), dtype=torch.int32, device=device)
        self.randoms = torch.empty((self.n_rounds, 4), dtype=torch.int32, device=device)
        self.digest = torch.empty(8, dtype=torch.int32, device=device)
        # a zeroed row of sums a round (the kernel adds into it)
        self.sums = torch.zeros((self.n_rounds, total_degree, 4), dtype=torch.int64, device=device)
        self.k = rounds_done  # rounds launched
        self.replayed = rounds_done  # rounds the host transcript has absorbed
        self.outputs: Optional[List[Fp]] = None  # the columns at the randoms, after the last round

    def launch(self, max_rounds: Optional[int] = None) -> int:
        """Launch up to ``max_rounds`` rounds on the device; copies nothing.
        Returns the number launched."""
        end = self.n_rounds if max_rounds is None else min(self.n_rounds, self.k + max_rounds)
        done = 0
        while self.k < end:
            with span("sumcheck_round"):
                sums = self.tables.program_sums(self.program, self.aux, self.total_degree, self.sums[self.k])
                dtr.sumcheck_round_scalars(self.state, self.prev, self.digest, sums, self.vinv,
                                           self.coeffs[self.k], self.randoms[self.k])
                self.tables.fold(self.randoms[self.k])
            self.k += 1
            done += 1
        return done

    def running_sum(self) -> Fp:
        """The running sum the next round starts from (one copy; for a save)."""
        return Fp(int(limbs.unpack_ints(stats.fetch(self.prev).view(np.uint32))[()]))

    def replay(self):
        """ONE device->host copy of the coefficients and randoms of the
        rounds not replayed yet and of the device's digest, and once the last
        round is in, of the folded columns (``outputs``); the host transcript
        then absorbs each round's coefficients and draws its challenge (Q1:
        the absorb comes first), and must draw the randoms the device folded
        with and reach the same digest.  Returns (pols, randoms) of those
        rounds."""
        if self.replayed == self.k:
            return [], []
        with span("replay"):
            k0, n, d = self.replayed, self.k - self.replayed, self.total_degree
            last = self.k == self.n_rounds
            w = self.tables.data.shape[0] - 1
            parts = [self.coeffs[k0 : self.k].reshape(-1), self.randoms[k0 : self.k].reshape(-1)]
            if last:
                parts.append(self.tables.data[:w, 0].reshape(-1))
            host = stats.fetch(torch.cat(parts + [self.digest])).view(np.uint32)
            coeffs = limbs.unpack_ints(host[: 4 * d * n].reshape(n, d, 4))
            device_rs = limbs.unpack_ints(host[4 * d * n : 4 * (d + 1) * n].reshape(n, 4))
            pols, randoms = [], []
            for row in coeffs:
                pol = SumcheckPoly([Fp(int(c)) for c in row])
                pol.absorb_into(self.transcript)
                pols.append(pol)
                randoms.append(self.transcript.next_challenge())
            if [r.v for r in randoms] != [int(r) for r in device_rs] or \
                    self.transcript.random() != digest_to_bytes(host[-8:]):
                raise dtr.TranscriptMismatch("the host transcript's replay of the sumcheck rounds does not reach "
                                             "the randoms and the digest the device computed")
            if last:
                end = 4 * (d + 1) * n
                self.outputs = [Fp(int(v)) for v in limbs.unpack_ints(host[end : end + 4 * w].reshape(w, 4))]
            self.replayed = self.k
            return pols, randoms


def replay_sumcheck(transcript: Transcript, pols: Sequence[SumcheckPoly], sum_value: Fp, degree: int = None):
    """Verifier-side telescoping replay of the standalone protocol: absorb
    each round polynomial and draw the challenges exactly as the prover did
    (reference verify_sumcheck_debug / verify_with_evaluations,
    sumcheck.rs:55-124).  Returns (randoms, final_value), where final_value =
    p_last(r_last) must equal delta(rs) * composition(trace(rs)).

    ``degree``: the round polynomials' total degree (composition degree + 1);
    when given, a proof whose coefficient vectors have another length is
    rejected before the replay (the wire format sends coeffs[1..], so the
    expected length is exactly ``degree``)."""
    if not pols:
        raise ValueError("at least one round polynomial is expected")
    if degree is not None and any(len(p.nonzero_coeffs) != degree for p in pols):
        raise ValueError("sumcheck round polynomial exceeds degree bound")
    rs: List[Fp] = []
    it = iter(pols)
    first = next(it)
    first.absorb_into(transcript)
    pol = first.to_polynomial(sum_value)
    for sc_pol in it:
        r = transcript.next_challenge()
        sc_pol.absorb_into(transcript)
        pol = sc_pol.to_polynomial(pol.evaluate(r))
        rs.append(r)
    r = transcript.next_challenge()
    rs.append(r)
    return rs, pol.evaluate(r)
