"""Plain reference of the constraint-system SNARK: the trace sumcheck over
the masked constraints, then the batched PCS opening of the trace columns
at the sumcheck's point (the flow of the Rust reference's
``src/constraint_system/{system,sumcheck}.rs`` with the batched PCS of
``src/fri/batched_pcs.rs``; one column would take the plain PCS).

Challenges: the row, trace and constraint challenges are each the one
element the transcript gives before anything is absorbed after the
caller's bytes (the reference draws them without absorbing in between, so
all are equal).  A constraint's weight is eq(constraint challenges, bits of
its index), the top bit paired with the first challenge; delta is
eq(row challenges, bits of the row).  Round k: s(X) = sum over rows of
delta_X * sum_i mask_i C_i(columns_X) at X = 1..d+1, s(0) = previous sum -
s(1); the nonzero coefficients absorbed, r drawn, every table folded with r.
The outputs are the folded columns.

Nothing of the program under test is imported or read.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from . import field as F
from .pcs import NUM_QUERIES, eq_table, fold_table, interpolate, poly_eval, prove_batched
from .proof import Writer
from .transcript import Transcript

# a constraint: (column values, randoms) -> value, on (8, ...) tensors
Constraint = Callable[[List[torch.Tensor], List[int]], torch.Tensor]


def mask(index: int, points: Sequence[int]) -> int:
    acc = 1
    n = len(points)
    for i in range(n):
        p = points[n - 1 - i]
        acc = acc * (p if (index >> i) & 1 else 1 - p) % F.P
    return acc


def prove(cols: torch.Tensor, constraints: Sequence[Constraint], degree: int, t: Transcript,
          sum_value: int = 0, num_queries: int = NUM_QUERIES) -> Writer:
    """The SNARK proof of the trace ``cols`` (8, w, 2^n)."""
    w, h = cols.shape[1], cols.shape[2]
    n = h.bit_length() - 1
    c = t.challenge()
    log_nc = max(len(constraints) - 1, 0).bit_length()
    masks = [mask(i, [c] * log_nc) for i in range(len(constraints))]
    randoms: List[int] = []  # the trace challenges: the layout has none
    tables = torch.cat([cols, eq_table([c] * n, cols.device).unsqueeze(1)], dim=1)  # (8, w + 1, h)
    prev, pols, rs = sum_value % F.P, [], []
    for _ in range(n):
        off = tables.shape[-1] // 2
        lo, hi = tables[..., :off], tables[..., off:]
        diff = F.sub(hi, lo)
        evals, cur = [], hi
        for x in range(1, degree + 2):
            if x > 1:
                cur = F.add(cur, diff)
            vals = [cur[:, j] for j in range(w)]
            comp = None
            for m, con in zip(masks, constraints):
                term = F.mul_scalar(con(vals, randoms), m)
                comp = term if comp is None else F.add(comp, term)
            evals.append(F.sum_mod(F.mul(cur[:, w], comp)))
        coeffs = interpolate([(prev - evals[0]) % F.P] + evals)
        for x in coeffs[1:]:
            t.absorb_felt(x)
        r = t.challenge()
        prev = poly_eval(coeffs, r)
        pols.append(coeffs[1:])
        rs.append(r)
        tables = fold_table(tables, r)
    outputs = F.to_ints(tables[:, :w, 0])
    inner = prove_batched(cols, rs, outputs, t, num_queries)
    out = Writer()
    out.mark("sumcheck")
    out.u64(len(pols))
    for p in pols:
        out.felts(p)
    out.mark("outputs")
    out.felts(outputs)
    out.felt(sum_value)
    out.u8(1)  # the PCS is the batched one
    out.nest(inner, "pcs.")
    return out
