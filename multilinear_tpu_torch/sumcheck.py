"""The sumcheck engine, PCS part: device partial sums and table fold.

Protocol semantics match the reference engine
(src/constraint_system/sumcheck.rs): same round-polynomial wire format
(constant coefficient stripped, quirk Q7), same transcript schedule (absorb
nonzero coeffs, then draw the challenge - on the device, in
``device_transcript.round_scalars``), same table fold
lo' = (1-r)*lo + r*hi pairing row i with i + h/2 (MSB fold, big-endian
variable order).

This slice carries what the PCS needs: the packed (MLE || delta) table, the
degree-2 partial sums for the identity composition, and the fold.  The
general compositions, the constraint-system tables and the standalone
sumcheck loop of the JAX package are later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import torch

from .field import ops
from .field.scalar import Fp, TWO_INV, ZERO
from .mle import combine_subtables, delta_subtables
from .poly import Polynomial
from .transcript import Transcript

PCS_DEGREE = 2  # identity composition times the delta weights


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
    """The packed (columns || delta) table: ``cols`` (h, 4) one MLE, ``subs``
    the delta sub-tables (mle.delta_subtables).  Returns (2, h, 4) with the
    delta weights in the LAST row, so one multiply folds everything."""
    data = torch.empty((2,) + tuple(cols.shape), dtype=cols.dtype, device=cols.device)
    data[0].copy_(cols)
    combine_subtables(subs, out=data[1])
    return data


def _extensions(data: torch.Tensor, total_degree: int) -> List[torch.Tensor]:
    """Linear extensions of the packed table (w+1, h, 4) at X = 1..d, each
    (w+1, h/2, 4).  Incremental form ext(X+1) = ext(X) + (hi - lo): no
    field multiplies."""
    off = data.shape[1] // 2
    lo, hi = data[:, :off], data[:, off:]
    exts = [hi]
    if total_degree > 1:
        diff = ops.sub(hi, lo)
        cur = hi
        for _ in range(2, total_degree + 1):
            cur = ops.add(cur, diff)
            exts.append(cur)
    return exts


def _partial_sums_kernel(data: torch.Tensor, total_degree: int) -> torch.Tensor:
    """Round polynomial evaluations s(X), X = 1..d, for the identity
    composition, as UNREDUCED int64 limb sums (d, 4): s(X) = sum_i
    delta_X[i] * mle_X[i] over the extended rows.  The round's Fiat-Shamir
    kernel reduces them (``device_transcript.round_scalars``): the wide
    reduction of two elements is ~150 tiny launches in tensor code."""
    sums = [ops.sum_limbs(ops.mul(e[-1], e[0]), dim=0) for e in _extensions(data, total_degree)]
    return torch.stack(sums)


def _fold_kernel(data: torch.Tensor, r_limbs: torch.Tensor) -> torch.Tensor:
    """Fold the packed table with challenge r: lo + r*(hi - lo); ONE multiply
    covers the MLE and the delta row."""
    off = data.shape[1] // 2
    lo, hi = data[:, :off], data[:, off:]
    return ops.add(lo, ops.mul(ops.sub(hi, lo), r_limbs))


class SumcheckTables:
    """Prover state of the PCS sumcheck: the MLE and the delta (eq-weight)
    table packed as one (2, height, 4) device tensor."""

    def __init__(self, data: torch.Tensor, height: int, debug_checks: bool = False):
        self.data = data
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

    def partial_sums(self) -> torch.Tensor:
        """(2, 4) int64 device tensor: the unreduced limb sums of s(1), s(2)
        of this round's polynomial."""
        return _partial_sums_kernel(self.data, PCS_DEGREE)

    def fold(self, r: torch.Tensor) -> None:
        """Fold with the challenge r, a (4,) field element on the tables'
        device (where the round's Fiat-Shamir kernel drew it)."""
        self.data = _fold_kernel(self.data, r)
        self.height >>= 1
        if self.debug_checks and not ops.is_canonical(self.data):
            raise ValueError("non-canonical field element in folded sumcheck table")
