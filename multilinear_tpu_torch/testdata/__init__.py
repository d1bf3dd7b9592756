"""Fixtures shared by the CPU tests and the on-card smoke script."""

from __future__ import annotations

import numpy as np

from ..field.scalar import P


def pcs_golden_inputs(log_n: int, seed: int):
    """(evaluations, point) as Python ints for the golden PCS proof whose
    digest is recorded in ``pcs_golden.json``."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(16), "little") % P for _ in range(1 << log_n)]
    point = [int.from_bytes(rng.bytes(16), "little") % P for _ in range(log_n)]
    return vals, point


def batched_pcs_golden_inputs(n_polys: int, log_n: int, seed: int):
    """(evaluations of each polynomial, shared point) as Python ints for the
    golden batched PCS proof whose digest is recorded in
    ``batched_pcs_golden.json``."""
    rng = np.random.default_rng(seed)
    polys = [
        [int.from_bytes(rng.bytes(16), "little") % P for _ in range(1 << log_n)]
        for _ in range(n_polys)
    ]
    point = [int.from_bytes(rng.bytes(16), "little") % P for _ in range(log_n)]
    return polys, point


# The constraint sets of the SNARK paths, as (constraints, degree): each
# constraint is an Expr (values, randoms) -> value that runs over either
# package's tensors and over host field elements alike.
SNARK_CONSTRAINTS = {
    # the reference snark_test's trivial constraint (bench.py's snark metric)
    "width1": ([lambda v, r: v[0] - v[0]], 1),
    # bench.py's sumcheck metric: Pythagorean triples and a sum column
    "pythagorean": ([lambda v, r: v[0] * v[0] + v[1] * v[1] - v[2] * v[2],
                     lambda v, r: v[0] + v[1] - v[3]], 2),
}


def snark_golden_columns(kind: str, log_n: int, seed: int):
    """Trace columns (a list of w lists of 2^log_n Python ints) of the golden
    SNARK proofs whose digests are recorded in ``snark_golden.json``.
    ``width1``: one column of random residues.  ``pythagorean``: rows
    a = m^2 - n^2, b = 2mn, c = m^2 + n^2, d = a + b mod p from random m, n,
    so that every row satisfies both constraints."""
    rng = np.random.default_rng(seed)
    h = 1 << log_n
    if kind == "width1":
        return [[int.from_bytes(rng.bytes(16), "little") % P for _ in range(h)]]
    if kind != "pythagorean":
        raise ValueError(f"unknown SNARK fixture {kind!r}")
    cols = [[], [], [], []]
    for _ in range(h):
        m, n = (int.from_bytes(rng.bytes(16), "little") % P for _ in range(2))
        a, b, c = (m * m - n * n) % P, 2 * m * n % P, (m * m + n * n) % P
        for col, v in zip(cols, (a, b, c, (a + b) % P)):
            col.append(v)
    return cols
