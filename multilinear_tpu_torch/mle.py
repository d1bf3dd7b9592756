"""Multilinear polynomials on the boolean hypercube.

A multilinear polynomial in n variables is a ``(2^n, 4)`` field tensor
(coefficient or evaluation form over {0,1}^n):

* zeta / Moebius butterflies convert between forms, one pass per index bit
  (reference semantics: src/polynomials.rs:111-124, 150-163);
* the eq/delta weight table is built by tensor-product doubling (same
  output as the reference's per-row Mask loop,
  src/constraint_system/evaluation.rs:50-91);
* evaluation at a point is a delta-table dot product.

Variable order is big-endian (quirk Q8): the FIRST variable corresponds to
the MOST significant bit of the hypercube index.

Both transforms run through the ``zm_butterfly`` kernel (many index bits per
pass) and the tensor products through ``kron_mul``; the transforms and
``bit_reverse`` also take a leading batch dimension, ``(B, 2^n, 4)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .field import cuda_ops, limbs, ops
from .field.scalar import Fp, ONE, P

# ---------------------------------------------------------------------------
# form conversions (zeta / Moebius transforms)
# ---------------------------------------------------------------------------


def to_evals(coeffs: torch.Tensor) -> torch.Tensor:
    """Coefficient -> evaluation form over {0,1}^n (zeta transform)."""
    return cuda_ops.zm_butterfly(coeffs, add=True)


def to_coeffs(evals: torch.Tensor) -> torch.Tensor:
    """Evaluation -> coefficient form (Moebius transform)."""
    return cuda_ops.zm_butterfly(evals, add=False)


def to_coeffs_bitrev_padded(evals: torch.Tensor, log_blowup: int) -> torch.Tensor:
    """``bit_reverse(to_coeffs(evals))`` zero-padded to ``n << log_blowup``
    values: what the Reed-Solomon encode reads.  On the card the Moebius
    kernel's last pass stores it so; no gather and no padded copy run."""
    return cuda_ops.zm_bitrev_pad(evals, add=False, log_blowup=log_blowup)


def bit_reverse(x: torch.Tensor) -> torch.Tensor:
    """Bit-reverse permutation along the value axis of an (n, 4) or
    (B, n, 4) tensor (reference src/ntt/mod.rs:113-123)."""
    n = x.shape[-2]
    bits = n.bit_length() - 1
    if bits <= 1:
        return x
    return x.index_select(-2, bitrev_indices(n, x.device))


_HOST_BITREV_BITS = 13


def _bitrev_host(bits: int) -> np.ndarray:
    idx = np.arange(1 << bits, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def bitrev_indices(n: int, device) -> torch.Tensor:
    """int64 tensor r with r[i] = i bit-reversed over log2(n) bits.  Small
    tables are made on the host; a large one is composed on the device from
    the tables of its two halves: for i = hi * 2^l + lo,
    rev(i) = rev_l(lo) * 2^h + rev_h(hi)."""
    bits = n.bit_length() - 1
    if bits <= _HOST_BITREV_BITS:
        return torch.from_numpy(_bitrev_host(bits)).to(device)
    lo_bits = bits // 2
    hi_bits = bits - lo_bits
    rev_lo = torch.from_numpy(_bitrev_host(lo_bits)).to(device)
    rev_hi = torch.from_numpy(_bitrev_host(hi_bits)).to(device)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return (rev_lo[idx & ((1 << lo_bits) - 1)] << hi_bits) | rev_hi[idx >> lo_bits]


# ---------------------------------------------------------------------------
# eq / delta tables and evaluation
# ---------------------------------------------------------------------------

# Tensor-product tables are built hybrid: exact host integers for sub-tables
# of <= _CHUNK_VARS variables (a few hundred multiplies), then one big device
# multiply per sub-table to kron them together.
_CHUNK_VARS = 8


def _kron_mul(a: torch.Tensor, b: torch.Tensor, out=None) -> torch.Tensor:
    """Tensor-product combine: (m, 4), (n, 4) -> (m*n, 4), out[i*n+j] = a[i]*b[j]."""
    return cuda_ops.kron_mul(a, b, out)


def combine_subtables(subs, out=None) -> torch.Tensor:
    """Left fold of sub-table tensor products: (c0 (x) c1) (x) c2 ...; the
    last product is written into ``out`` when given."""
    d = subs[0]
    for i, s in enumerate(subs[1:], start=2):
        d = _kron_mul(d, s, out if i == len(subs) else None)
    if out is not None and len(subs) == 1:
        out.copy_(d)
        return out
    return d


def _host_factor_table(factors):
    """Product table of per-variable (f0_j, f1_j) factor pairs, big-endian:
    out[i] = prod_j f_{bit_j(i)}(j), earlier pairs on more significant bits."""
    table = [1]
    for f0, f1 in factors:
        table = [v * f % P for v in table for f in (f0, f1)]
    return table


def factor_subtables(factors, device):
    """Host-built device sub-tables of <= _CHUNK_VARS variables each."""
    chunks = [factors[i : i + _CHUNK_VARS] for i in range(0, len(factors), _CHUNK_VARS)]
    return [limbs.pack_ints(_host_factor_table(c), device=device) for c in chunks]


def delta_subtables(points, device):
    """Sub-tables whose tensor product is delta_table(points); None if empty."""
    pts = [Fp(p) for p in points]
    if not pts:
        return None
    return factor_subtables([((ONE - p).v, p.v) for p in pts], device)


def product_table(factors, device) -> torch.Tensor:
    """Device (2^n, 4) table from per-variable factor pairs (host ints)."""
    return combine_subtables(factor_subtables(factors, device))


def delta_table(points, device) -> torch.Tensor:
    """eq(points, .) over all 2^n hypercube corners; points[0] pairs with the
    MSB of the table index (reference Mask convention,
    src/constraint_system/evaluation.rs:62-70)."""
    pts = [Fp(p) for p in points]
    if not pts:
        return limbs.pack_ints([1], device=device)
    return product_table([((ONE - p).v, p.v) for p in pts], device)


def evaluate_evals(evals: torch.Tensor, points) -> torch.Tensor:
    """Evaluate an MLE in evaluation form at an arbitrary point (semantics of
    reference src/polynomials.rs:165-188).  ``evals``: (2^n, 4), or a batch
    (..., 2^n, 4) of MLEs evaluated in one pass; reduces the last value axis,
    so (w, 2^n, 4) gives (w, 4)."""
    d = delta_table(points, evals.device)
    return ops.sum_mod(ops.mul(d, evals), dim=-1)


def evaluate_evals_host(evals: torch.Tensor, points) -> Fp:
    """Convenience: evaluate and return a host Fp."""
    return Fp(limbs.unpack_int(evaluate_evals(evals, points)))


def evaluate_coeffs(coeffs: torch.Tensor, points) -> torch.Tensor:
    """Evaluate an MLE in coefficient form at a point (reference
    src/polynomials.rs:126-147): the weight table prod_j x_j^(bit j) of the
    monomials, then its dot product with the coefficients.  ``coeffs``:
    (2^n, 4) or a batch (..., 2^n, 4); returns (4,) or (..., 4)."""
    pts = [Fp(p) for p in points]
    if not pts:
        return coeffs[..., 0, :]
    weights = product_table([(1, p.v) for p in pts], coeffs.device)
    return ops.dot_mod(weights, coeffs, dim=-1)


# ---------------------------------------------------------------------------
# host reference helpers (exact, for tests and the verifier)
# ---------------------------------------------------------------------------


def eq_scalar(a, b) -> Fp:
    """eq(a, b) = prod a_i b_i + (1-a_i)(1-b_i) on host Fp lists
    (reference Delta::evaluate, src/constraint_system/evaluation.rs:80-91)."""
    acc = ONE
    for x, y in zip(a, b):
        x, y = Fp(x), Fp(y)
        acc = acc * (x * y + (ONE - x) * (ONE - y))
    return acc


def mask_scalar(index: int, n_vars: int, points) -> Fp:
    """eq(points, bits(index)), big-endian (reference Mask::evaluate): the
    weight of constraint ``index`` in the composition."""
    acc = ONE
    for i in range(n_vars):
        pt = Fp(points[n_vars - 1 - i])
        acc = acc * (pt if (index >> i) & 1 else ONE - pt)
    return acc


# ---------------------------------------------------------------------------
# object wrappers (reference src/polynomials.rs:100-188)
# ---------------------------------------------------------------------------


def _as_field_tensor(data, device) -> torch.Tensor:
    """A (2^n, 4) field tensor from a tensor (kept where it lies unless
    ``device`` is given) or from host values (packed onto ``device``, by
    default ``ProverConfig().device``, the card)."""
    if isinstance(data, torch.Tensor):
        return data if device is None else data.to(device)
    from .config import ProverConfig

    return limbs.pack_ints([Fp(v).v for v in data], device=ProverConfig().device if device is None else device)


class MultilinearPolynomial:
    """Coefficient-form MLE (reference src/polynomials.rs:100-147): a thin
    object over the functions above; ``data`` is the (2^n, 4) field tensor."""

    __slots__ = ("data",)

    def __init__(self, data, device=None):
        self.data = _as_field_tensor(data, device)

    @property
    def n_vars(self) -> int:
        return self.data.shape[-2].bit_length() - 1

    def to_evaluation(self) -> "MultilinearPolynomialEvals":
        return MultilinearPolynomialEvals(to_evals(self.data))

    def evaluate(self, args) -> Fp:
        return Fp(limbs.unpack_int(evaluate_coeffs(self.data, args)))

    def coefficients(self):
        return limbs.unpack_fps(self.data)


class MultilinearPolynomialEvals:
    """Evaluation-form MLE (reference src/polynomials.rs:149-188)."""

    __slots__ = ("data",)

    def __init__(self, data, device=None):
        self.data = _as_field_tensor(data, device)

    @property
    def n_vars(self) -> int:
        return self.data.shape[-2].bit_length() - 1

    def to_coefficient(self) -> MultilinearPolynomial:
        return MultilinearPolynomial(to_coeffs(self.data))

    def evaluate(self, args) -> Fp:
        return evaluate_evals_host(self.data, args)

    def evaluations(self):
        return limbs.unpack_fps(self.data)
