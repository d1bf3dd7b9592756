"""Univariate polynomials over GF(p), host-side exact arithmetic.

These are only ever tiny (sumcheck round polynomials of degree <= 3 and the
verifier's telescoping replay), so they live on the host as lists of
:class:`Fp`.  Mirrors reference src/polynomials.rs:4-98.
"""

from __future__ import annotations

from typing import List, Sequence

from .field.scalar import Fp, ONE, ZERO, batch_inv


class Polynomial:
    """Dense coefficient form, coeffs[i] is the X^i coefficient."""

    __slots__ = ("coeffs",)

    def __init__(self, coeffs: Sequence[Fp]):
        self.coeffs = [Fp(c) for c in coeffs]

    def evaluate(self, x: Fp) -> Fp:
        acc = ZERO
        for c in reversed(self.coeffs):
            acc = acc * x + c
        return acc

    def evaluate_over_domain(self) -> "PolynomialEvals":
        return PolynomialEvals([self.evaluate(Fp(i)) for i in range(len(self.coeffs))])

    def __eq__(self, o):
        return isinstance(o, Polynomial) and self.coeffs == o.coeffs

    def __repr__(self):
        return f"Polynomial({[c.v for c in self.coeffs]})"


class PolynomialEvals:
    """Evaluations over the integer domain {0, 1, ..., n-1}."""

    __slots__ = ("evals",)

    def __init__(self, evals: Sequence[Fp]):
        self.evals = [Fp(e) for e in evals]

    def interpolate(self) -> Polynomial:
        """Lagrange interpolation over {0..n-1}.

        Computed via the Newton-free direct basis expansion with batched
        denominator inversion; output coefficients are identical to the
        reference's O(n^3) textbook loop (src/polynomials.rs:51-87) since
        interpolation is unique.
        """
        n = len(self.evals)
        xs = [Fp(i) for i in range(n)]
        denoms = []
        for j in range(n):
            d = ONE
            for m in range(n):
                if m != j:
                    d = d * (xs[j] - xs[m])
            denoms.append(d)
        inv_denoms = batch_inv(denoms)

        coeffs = [ZERO] * n
        for j, yj in enumerate(self.evals):
            # basis_j(X) = prod_{m != j} (X - x_m)
            basis = [ONE]
            for m in range(n):
                if m == j:
                    continue
                basis = _mul_linear(basis, -xs[m])
            scale = yj * inv_denoms[j]
            for i, b in enumerate(basis):
                coeffs[i] = coeffs[i] + scale * b
        return Polynomial(coeffs)

    def __eq__(self, o):
        return isinstance(o, PolynomialEvals) and self.evals == o.evals


def _mul_linear(poly: List[Fp], c: Fp) -> List[Fp]:
    """poly(X) * (X + c)."""
    out = [ZERO] * (len(poly) + 1)
    for i, a in enumerate(poly):
        out[i] = out[i] + a * c
        out[i + 1] = out[i + 1] + a
    return out
