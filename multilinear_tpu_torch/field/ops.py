"""GF(p) arithmetic on limb tensors, p = 2^128 - 45*2^40 + 1.

Every function takes and returns canonical field tensors in the layout of
:mod:`.limbs` (``S + (4,)`` int32, four 32-bit limbs per element) and runs
as plain PyTorch tensor code on whatever device its inputs live on - except
:func:`mul`, :func:`add` and :func:`sub`, which dispatch to :mod:`.cuda_ops`,
whose wrappers launch the hand-written CUDA kernels for a CUDA tensor and run
the plain versions (``add_plain``, ``sub_plain``, ``cuda_ops.mul_plain``) for
a CPU tensor.

The plain arithmetic widens the limbs to int64 lanes (PyTorch's CPU kernels
have no uint32 add/shift/compare).  Add, sub and half keep 32-bit limbs
(4-step carry chains); the plain multiply and the wide reductions split to
16-bit limbs so that column sums of 16x16-bit products stay far below 2^63.

The reduction uses the sparse modulus: 2^128 = K (mod p) with
K = 45*2^40 - 1, so a value  lo + 2^128 * hi  folds to  lo + K * hi.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional

import torch

from . import limbs
from .scalar import K_FOLD, P

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF

_K32 = [(K_FOLD >> (32 * i)) & _M32 for i in range(4)]
_K16 = [(K_FOLD >> (16 * i)) & _M16 for i in range(8)]
_HALF_P1_32 = [(((P + 1) // 2) >> (32 * i)) & _M32 for i in range(4)]


# ---------------------------------------------------------------------------
# lane helpers
# ---------------------------------------------------------------------------


def _split32(a: torch.Tensor) -> List[torch.Tensor]:
    """S+(4,) int32 -> four int64 tensors of shape S with values in [0, 2^32)."""
    w = a.to(torch.int64) & _M32
    return [w[..., i] for i in range(4)]


def _join32(limbs: List[torch.Tensor]) -> torch.Tensor:
    """Four int64 tensors in [0, 2^32) -> S+(4,) int32 (bit pattern kept)."""
    w = torch.stack(limbs, dim=-1)
    return ((w ^ 0x80000000) - 0x80000000).to(torch.int32)


def _split16(a: torch.Tensor) -> List[torch.Tensor]:
    """S+(4,) int32 -> eight int64 tensors of 16-bit limbs."""
    out = []
    for w in _split32(a):
        out.append(w & _M16)
        out.append(w >> 16)
    return out


def _join16(limbs: List[torch.Tensor]) -> torch.Tensor:
    return _join32([limbs[2 * j] | (limbs[2 * j + 1] << 16) for j in range(4)])


def _add_chain(a, b, bits: int):
    """Add clean limb lists (b may hold Python ints); returns (limbs, carry)."""
    mask = (1 << bits) - 1
    out = []
    carry = 0
    for x, y in zip(a, b):
        v = x + y + carry
        out.append(v & mask)
        carry = v >> bits
    return out, carry


def _sub_chain(a, b, bits: int):
    """a - b on clean limb lists; returns (limbs, borrow in {0, 1})."""
    mask = (1 << bits) - 1
    out = []
    borrow = 0
    for x, y in zip(a, b):
        v = x - y - borrow  # int64, may be negative
        out.append(v & mask)
        borrow = (v >> bits) & 1  # arithmetic shift: -1 -> borrow 1
    return out, borrow


def _select(mask, a: List, b: List) -> List:
    return [torch.where(mask, x, y) for x, y in zip(a, b)]


def _canon(limbs: List, carry, k_limbs: List[int], bits: int) -> List:
    """Map  carry*2^128 + limbs  (< 2p) into [0, p): the value is >= p
    exactly when adding K overflows 2^128, and then  value - p  is the low
    128 bits of  value + K."""
    t, c2 = _add_chain(limbs, k_limbs, bits)
    return _select((carry + c2) > 0, t, limbs)


# ---------------------------------------------------------------------------
# public field ops (plain tensor code)
# ---------------------------------------------------------------------------


def add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p in tensor code (the plain version of the add kernel)."""
    s, carry = _add_chain(_split32(a), _split32(b), 32)
    return _join32(_canon(s, carry, _K32, 32))


def sub_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p in tensor code (the plain version of the sub kernel)."""
    d, borrow = _sub_chain(_split32(a), _split32(b), 32)
    # a < b: the true value is d - 2^128, and adding p gives d - K
    d2, _ = _sub_chain(d, _K32, 32)
    return _join32(_select(borrow > 0, d2, d))


def neg(a: torch.Tensor) -> torch.Tensor:
    """(-a) mod p."""
    return sub(a.new_zeros(4), a)


def half(a: torch.Tensor) -> torch.Tensor:
    """(a * 2^{-1}) mod p without a multiply: x/2 = x >> 1 for even x and
    (x >> 1) + (p+1)/2 for odd x (exact, and < p)."""
    al = _split32(a)
    odd = al[0] & 1
    sh = [(al[i] >> 1) | ((al[i + 1] & 1) << 31) for i in range(3)] + [al[3] >> 1]
    out, _ = _add_chain(sh, [odd * h for h in _HALF_P1_32], 32)
    return _join32(out)


def mul(a: torch.Tensor, b: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(a * b) mod p - the hot primitive.  CUDA kernel on a CUDA tensor,
    plain version on a CPU tensor (see :func:`.cuda_ops.mul`)."""
    from . import cuda_ops

    return cuda_ops.mul(a, b, out)


def add(a: torch.Tensor, b: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(a + b) mod p; kernel or plain version by device, like :func:`mul`."""
    from . import cuda_ops

    return cuda_ops.add(a, b, out)


def sub(a: torch.Tensor, b: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(a - b) mod p; kernel or plain version by device, like :func:`mul`."""
    from . import cuda_ops

    return cuda_ops.sub(a, b, out)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise select between two field tensors by a value-shaped mask."""
    return torch.where(mask.unsqueeze(-1), a, b)


def is_zero_mask(a: torch.Tensor) -> torch.Tensor:
    """Boolean mask of the value shape: True where the element is 0."""
    return (a == 0).all(dim=-1)


def broadcast_scalar(limbs4: torch.Tensor, shape) -> torch.Tensor:
    """Broadcast a (4,) scalar limb tensor to shape+(4,) (a view)."""
    shape = tuple(shape)
    return limbs4.reshape((1,) * len(shape) + (4,)).expand(shape + (4,))


def is_canonical(a: torch.Tensor) -> bool:
    """True when every element is < p (the debug sanitizer's check)."""
    _, borrow = _sub_chain(_split32(a), [(P >> (32 * i)) & _M32 for i in range(4)], 32)
    return bool((borrow > 0).all())


# ---------------------------------------------------------------------------
# wide reduction (16-bit limbs): used by the plain multiply and by sum_mod
# ---------------------------------------------------------------------------


def _carry_normalize(cols: List, out_len: int):
    """Signed int64 column sums -> clean 16-bit limbs (floor-shift carry
    chain); returns (limbs, final carry)."""
    out = []
    carry = 0
    for k in range(out_len):
        v = (cols[k] if k < len(cols) else 0) + carry
        out.append(v & _M16)
        carry = v >> 16
    return out, carry


def _fold16(t: List):
    """One sparse-modulus fold of a clean 16-bit limb list longer than 8:
    t[:8] + K * t[8:], with K*h = (45*h << 40) - h taken column-wise.
    Returns (max(8, len(hi)+3) clean limbs, carry)."""
    lo, hi = t[:8], t[8:]
    n = max(8, len(hi) + 3)
    cols = []
    for j in range(n):
        c = lo[j] if j < 8 else 0
        if 2 <= j < len(hi) + 2:
            c = c + ((hi[j - 2] * 45) << 8)  # 45*h*2^40 = (45*h << 8) * 2^32
        if j < len(hi):
            c = c - hi[j]
        cols.append(c)
    return _carry_normalize(cols, n)


def _reduce_wide16(t: List) -> List:
    """Clean 16-bit limb list of any length >= 8 -> 8 canonical limbs.

    Each fold shrinks the excess over 128 bits by ~82 bits; once the list
    is back to 8 limbs the fold's carry is 0 or 1, and a carry of 1 means
    the low part is small enough that adding K once more cannot carry.
    """
    carry = 0
    while len(t) > 8:
        t, carry = _fold16(t)
        if len(t) == 8:
            t, _ = _add_chain(t, [carry * k for k in _K16], 16)
            carry = 0
    return _canon(t, carry, _K16, 16)


def sum_limbs(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum the 32-bit limbs of a canonical field tensor over one VALUE axis
    as plain int64 lanes: S'+(4,) int64, exact for fewer than 2^31 terms and
    NOT reduced.  The value is sum_i lane_i * 2^(32 i); reduce it with
    :func:`reduce_limb_sums` on the device or :func:`limb_sums_to_int` on
    the host."""
    if dim < 0:
        dim += a.dim() - 1
    if not 0 <= dim < a.dim() - 1:
        raise ValueError("dim must name a value axis")
    n = a.shape[dim]
    if n == 0:
        raise ValueError("empty sum")
    if n >= 1 << 31:
        raise ValueError("too many terms for exact int64 lane sums")
    return (a.to(torch.int64) & _M32).sum(dim=dim)


def limb_sums_to_int(lanes) -> int:
    """Host reduction of one element's four int64 lane sums to an int mod p."""
    return sum(int(v) << (32 * i) for i, v in enumerate(lanes)) % P


def reduce_limb_sums(s: torch.Tensor) -> torch.Tensor:
    """Device reduction of :func:`sum_limbs` output to canonical elements:
    the four wide sums are carry-normalized into 16-bit limbs and folded."""
    cols = []
    carry = 0
    for i in range(4):
        v = s[..., i] + carry
        cols.append(v & _M16)
        cols.append((v >> 16) & _M16)
        carry = v >> 32  # the part above 32 bits weighs one limb more
    hi = [(carry >> (16 * j)) & _M16 for j in range(4)]
    return _join16(_reduce_wide16(cols + hi))


def sum_mod(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum a canonical field tensor over one VALUE axis, mod p."""
    return reduce_limb_sums(sum_limbs(a, dim))


def dot_mod(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """sum(a * b) mod p over one value axis: the ``mul`` kernel, then
    :func:`sum_mod`."""
    return sum_mod(mul(a, b), dim=dim)


def mul_small(a: torch.Tensor, k: int) -> torch.Tensor:
    """(a * k) mod p for a small constant 0 <= k < 2^16, through the ``mul``
    kernel reading one packed scalar."""
    if not 0 <= k < 1 << 16:
        raise ValueError(f"mul_small takes 0 <= k < 2^16, got {k}")
    return mul(a, packed_scalar(k, a.device))


def pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """a ** e elementwise for a Python-int exponent e >= 0, square and
    multiply through the ``mul`` kernel (a ** 0 = 1)."""
    if e < 0:
        raise ValueError(f"pow_const takes e >= 0, got {e}")
    result = None
    base = a
    while e > 0:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    if result is None:
        result = torch.zeros_like(a)
        result[..., 0] = 1
    return result


@lru_cache(maxsize=256)
def packed_scalar(v: int, device: torch.device) -> torch.Tensor:
    """The (4,) limb tensor of the canonical value ``v`` on ``device``, made
    once (through pinned memory: the copy does not make the host wait)."""
    return limbs.pack_int(v, device=device)
