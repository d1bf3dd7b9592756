"""Plain GF(p) arithmetic on tensors, p = 2^128 - 45*2^40 + 1.

An element is eight 16-bit limbs, least significant first, held in int64
along the FIRST axis: a tensor of shape (8,) + S holds the elements of value
shape S.  Limb products (< 2^32) and their column sums stay far inside int64,
so every operation is a short sequence of ordinary PyTorch integer ops on
whatever device the tensors live on.  Nothing here is fast; it is written to
be read against the definition of the field.

This module imports nothing of the program under test.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

P = (1 << 128) - 45 * (1 << 40) + 1
# 2^128 = C (mod p): the fold constant of the sparse modulus
C = (1 << 128) - P
INV2 = (P + 1) // 2
GENERATOR = 3
LIMBS = 8
MASK = 0xFFFF
_C_LIMBS = [(C >> (16 * i)) & MASK for i in range(3)]  # C < 2^46: three limbs
_P_LIMBS = [(P >> (16 * i)) & MASK for i in range(LIMBS)]


def pow2_generator(log_size: int) -> int:
    """Generator of the multiplicative subgroup of order 2^log_size."""
    return pow(GENERATOR, (P - 1) >> log_size, P)


def _ripple(cols: List[torch.Tensor], n_out: int) -> List[torch.Tensor]:
    """Carry-propagate non-negative limb columns (any size below 2^62) into
    ``n_out`` 16-bit limbs; the value must fit."""
    out, carry = [], None
    for k in range(n_out):
        v = cols[k] if k < len(cols) else None
        if carry is not None:
            v = carry if v is None else v + carry
        if v is None:
            out.append(torch.zeros_like(out[0]))
            carry = None
            continue
        out.append(v & MASK)
        carry = v >> 16
    return out


def _fold(limbs: List[torch.Tensor]) -> List[torch.Tensor]:
    """One application of 2^128 = C: L + H * C, as columns (not rippled)."""
    lo, hi = limbs[:LIMBS], limbs[LIMBS:]
    cols = list(lo) + [None] * max(0, len(hi) + 2 - LIMBS)
    for i, h in enumerate(hi):
        for j, c in enumerate(_C_LIMBS):
            term = h * c
            cols[i + j] = term if cols[i + j] is None else cols[i + j] + term
    return [c for c in cols if c is not None]


def _canonical(limbs9: List[torch.Tensor]) -> torch.Tensor:
    """x < 2p (nine 16-bit limbs) -> x mod p as (8,) + S.  x >= p exactly when
    x + C >= 2^128, and then x - p = x + C - 2^128 (x + C < 2^129)."""
    y = list(limbs9)
    for j, c in enumerate(_C_LIMBS):
        y[j] = y[j] + c
    y = _ripple(y, LIMBS + 1)
    over = y[LIMBS] > 0
    return torch.where(over, torch.stack(y[:LIMBS]), torch.stack(limbs9[:LIMBS]))


def _reduce(limbs16: List[torch.Tensor]) -> torch.Tensor:
    """A product's sixteen 16-bit limbs (below p^2) -> canonical (8,) + S:
    three folds by C, each rippled to the limbs its bound needs."""
    x = _ripple(_fold(limbs16), 11)  # < 2^128 + 2^174
    x = _ripple(_fold(x), LIMBS + 1)  # < 2^128 + 2^94
    x = _ripple(_fold(x), LIMBS + 1)  # < 2^128 + C
    return _canonical(x)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = a + b
    return _canonical(_ripple(list(s.unbind(0)), LIMBS + 1))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b: a + (p - b) < 2p, then the canonical step."""
    d = a - b + torch.tensor(_P_LIMBS, dtype=torch.int64, device=a.device).view((LIMBS,) + (1,) * (a.dim() - 1))
    # limbs of a - b + p may be negative: borrow from the next limb
    out, carry = [], None
    for k in range(LIMBS):
        v = d[k] if carry is None else d[k] + carry
        out.append(v & MASK)  # two's complement: & keeps v mod 2^16
        carry = v >> 16  # arithmetic shift: floor division
    out.append(carry)
    return _canonical(out)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of the limb vectors, then three folds by C."""
    cols = [None] * (2 * LIMBS - 1)
    for i in range(LIMBS):
        prod = a[i] * b  # (8,) + S: columns i .. i+7
        for j in range(LIMBS):
            cols[i + j] = prod[j] if cols[i + j] is None else cols[i + j] + prod[j]
    return _reduce(_ripple(cols, 2 * LIMBS))


def mul_scalar(a: torch.Tensor, s: int) -> torch.Tensor:
    return mul(a, const(s, a.device, a.dim() - 1))


def const(v: int, device, extra_dims: int = 1) -> torch.Tensor:
    """The element v as (8,) + (1,) * extra_dims, for broadcasting."""
    v %= P
    return torch.tensor([(v >> (16 * i)) & MASK for i in range(LIMBS)], dtype=torch.int64,
                        device=device).view((LIMBS,) + (1,) * extra_dims)


def from_ints(vals: Sequence[int], device="cpu") -> torch.Tensor:
    """(8, N) from Python integers (reduced mod p)."""
    arr = np.array([int(v) % P for v in vals], dtype=object)
    out = np.empty((LIMBS, len(vals)), dtype=np.int64)
    for i in range(LIMBS):
        out[i] = ((arr >> (16 * i)) & MASK).astype(np.int64)
    return torch.from_numpy(out).to(device)


def to_ints(x: torch.Tensor) -> List[int]:
    """Python integers of an (8, N) tensor (host copy)."""
    arr = x.detach().to("cpu").numpy().astype(object)
    vals = np.zeros(arr.shape[1:], dtype=object)
    for i in range(LIMBS - 1, -1, -1):
        vals = (vals << 16) | arr[i]
    return [int(v) for v in vals.reshape(-1)]


def from_u32_limbs(t: torch.Tensor) -> torch.Tensor:
    """(…, 4) int32 tensor of little-endian 32-bit limbs -> (8, …) int64."""
    u = t.to(torch.int64) & 0xFFFFFFFF
    lo, hi = u & MASK, u >> 16
    return torch.stack([lo, hi], dim=-1).reshape(t.shape[:-1] + (LIMBS,)).movedim(-1, 0).contiguous()


def to_u32_limbs(x: torch.Tensor) -> torch.Tensor:
    """(8, …) int64 -> (…, 4) int32 tensor of little-endian 32-bit limbs."""
    y = x.movedim(0, -1)
    u = y[..., 0::2] | (y[..., 1::2] << 16)
    return (u - ((u >> 31) << 32)).to(torch.int32).contiguous()


def to_bytes(x: torch.Tensor) -> bytes:
    """16 little-endian bytes per element of an (8, N) tensor, in order."""
    arr = x.detach().to("cpu").numpy().astype("<u2")  # (8, N)
    return np.ascontiguousarray(arr.T).tobytes()


def sum_mod(x: torch.Tensor) -> int:
    """The sum of all elements of an (8, N) tensor, mod p, as a host int.
    Limb sums stay exact in int64 for fewer than 2^47 elements."""
    s = x.sum(dim=tuple(range(1, x.dim()))).to("cpu").tolist()
    return sum(int(v) << (16 * i) for i, v in enumerate(s)) % P


def powers(base: int, count: int, device) -> torch.Tensor:
    """(8, count) of base^0 .. base^(count-1), count a power of two, by
    doubling: the table so far times base^len."""
    out = const(1, device)
    step = base % P
    while out.shape[1] < count:
        out = torch.cat([out, mul(out, const(step, device))], dim=1)
        step = step * step % P
    return out[:, :count]
