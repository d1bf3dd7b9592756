"""Host-side scalar arithmetic in GF(p), p = 2^128 - 45*2^40 + 1.

The reference implementation wraps winterfell's f128 ``BaseElement``
(reference: src/field.rs:30-31, modulus at src/ntt/mod.rs:34-36), which
stores the canonical residue as a plain (non-Montgomery) u128.  On the host
we use exact Python integers mod p; these drive the Fiat-Shamir transcript,
the verifiers, and all O(log n) per-round scalar work, while bulk tensor
arithmetic lives on the device (see :mod:`multilinear_tpu_torch.field.ops`).

Byte layout parity: elements serialize as 16 little-endian bytes of the
canonical residue (reference: src/field.rs:33-38).
"""

from __future__ import annotations

# The prime: p = 2^128 - 45*2^40 + 1.  Two-adicity 40, generator 3.
P = (1 << 128) - 45 * (1 << 40) + 1
# 2^128 mod p == 2^128 - p == 45*2^40 - 1.  Sparse-modulus fold constant.
K_FOLD = (1 << 128) - P
GENERATOR = 3
TWO_ADICITY = 40

assert P == 340282366920938463463374557953744961537
assert K_FOLD == 45 * (1 << 40) - 1


class Fp:
    """An element of GF(p) as an exact Python integer in [0, p).

    Mirrors the reference ``Field128`` semantics (src/field.rs:138-154):
    ``From<u128>`` reduces mod p; negative machine ints first wrap mod 2^128
    (quirk Q4 in SURVEY.md - the reference casts ``i64 as u128``).
    """

    __slots__ = ("v",)

    def __init__(self, v: int):
        if isinstance(v, Fp):
            self.v = v.v
            return
        if v < 0:
            # Rust `val as u128` wraps mod 2^128 before the mod-p reduction.
            v &= (1 << 128) - 1
        self.v = v % P

    # -- ring ops ---------------------------------------------------------
    # Non-coercible operands return NotImplemented so reflected operations
    # on other wrappers get a chance.
    def __add__(self, o):
        v = _val_or_none(o)
        return NotImplemented if v is None else Fp((self.v + v) % P)

    __radd__ = __add__

    def __sub__(self, o):
        v = _val_or_none(o)
        return NotImplemented if v is None else Fp((self.v - v) % P)

    def __rsub__(self, o):
        v = _val_or_none(o)
        return NotImplemented if v is None else Fp((v - self.v) % P)

    def __mul__(self, o):
        v = _val_or_none(o)
        return NotImplemented if v is None else Fp((self.v * v) % P)

    __rmul__ = __mul__

    def __neg__(self):
        return Fp((-self.v) % P)

    def __truediv__(self, o):
        return self * Fp(_val(o)).inv()

    def __rtruediv__(self, o):
        return Fp(_val(o)) * self.inv()

    def __pow__(self, e: int):
        return Fp(pow(self.v, int(e), P))

    def inv(self) -> "Fp":
        if self.v == 0:
            raise ZeroDivisionError("inverse of zero in GF(p)")
        return Fp(pow(self.v, P - 2, P))

    # -- equality / hashing ------------------------------------------------
    def __eq__(self, o):
        if isinstance(o, Fp):
            return self.v == o.v
        if isinstance(o, int):
            return self.v == o % P
        return NotImplemented

    def __hash__(self):
        return hash(self.v)

    def __repr__(self):
        return f"Fp({self.v})"

    def __int__(self):
        return self.v

    # -- serialization (16 LE bytes of canonical residue, Q9) --------------
    def to_bytes(self) -> bytes:
        return self.v.to_bytes(16, "little")

    @staticmethod
    def from_bytes(b: bytes) -> "Fp":
        """Parse 16 LE bytes, REJECTING non-canonical (>= p) encodings.

        This is the untrusted-deserialization boundary (serialize.py).
        Accepting v >= p would make proofs malleable: the verifier
        re-serializes canonically during transcript replay, so v and
        v - p would replay identically while differing on the wire.
        winterfell's deserialization rejects non-canonical values too.
        """
        if len(b) != 16:
            raise ValueError("Field128 encoding must be 16 bytes")
        v = int.from_bytes(b, "little")
        if v >= P:
            raise ValueError("non-canonical Field128 encoding")
        return Fp(v)


ZERO = Fp(0)
ONE = Fp(1)
TWO_INV = Fp(2).inv()


def _val_or_none(o):
    if isinstance(o, Fp):
        return o.v
    if isinstance(o, int):
        return o % P if o >= 0 else Fp(o).v
    return None


def _val(o) -> int:
    v = _val_or_none(o)
    if v is None:
        raise TypeError(f"cannot coerce {type(o)} to Fp")
    return v


def pow2_generator(log_size: int) -> Fp:
    """Primitive 2^log_size-th root of unity: g^((p-1)/2^log_size).

    Reference: src/ntt/mod.rs:42-54 (``pow_2_generator``).
    """
    if log_size > TWO_ADICITY:
        raise ValueError(f"two-adicity of p is {TWO_ADICITY}, got {log_size}")
    return Fp(pow(GENERATOR, (P - 1) >> log_size, P))


def batch_inv(xs):
    """Montgomery's batch-inversion trick for a list of Fp."""
    n = len(xs)
    if n == 0:
        return []
    prefix = [ONE] * (n + 1)
    for i, x in enumerate(xs):
        prefix[i + 1] = prefix[i] * x
    inv_all = prefix[n].inv()
    out = [ZERO] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all
        inv_all = inv_all * xs[i]
    return out
