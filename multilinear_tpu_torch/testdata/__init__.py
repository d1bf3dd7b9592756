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
