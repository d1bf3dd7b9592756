"""Radix-2 NTT over GF(p) and Reed-Solomon encoding.

p has two-adicity 40 with multiplicative generator 3 (reference constants:
src/ntt/mod.rs:34-54); the 2^k-domain generator is 3^((p-1)/2^k).

Structure follows the JAX package: a four-step transform (n = A*B: column
sub-NTTs, twiddle multiply, transpose, row sub-NTTs) whose sub-NTTs are
constant-geometry (Pease) DIF stages along the row axis - two stages per
launch of the ``butterfly2`` kernel, an odd last stage (all twiddles 1)
through ``butterfly_notw``, a two-row sub-transform through ``butterfly`` -
with the twiddle step as one ``twiddle_mul3`` pass over the rank-structured
factors Tc / Tf.  Every transform takes a leading batch dimension,
``(B, n, 4)``: the kernels carry a batch extent, so a batch costs the
launches of one transform.

Output matches the reference exactly: ``ntt(coeffs)[i] = p(g^i)`` in natural
order (src/ntt/mod.rs:131-174).
"""

from __future__ import annotations

import torch

from . import stats
from .config import LOG_BLOWUP  # noqa: F401  (re-exported, as in the JAX package)
from .field import cuda_ops, limbs, ops
from .field.scalar import Fp, P, pow2_generator
from .mle import bitrev_indices, product_table

# Device-constant tables, keyed by (generator, size, device).  At the
# 2^25 encode domain a first-half power table is 256 MiB.
_POW_CACHE: dict = {}
_TWIDDLE_CACHE: dict = {}
_CACHE_MAX = 8


def clear_caches() -> None:
    _POW_CACHE.clear()
    _TWIDDLE_CACHE.clear()


def _cache_put(cache: dict, key, val):
    if len(cache) >= _CACHE_MAX:
        cache.pop(next(iter(cache)))
    cache[key] = val
    return val


def _pow_table(gen_v: int, log_size: int, device) -> torch.Tensor:
    """(2^log_size, 4) tensor of [1, g, g^2, ...]: g^i = prod_{bit j of i}
    g^(2^j), a tensor-product table whose per-bit factors are host scalars
    (big-endian, so bit log_size-1 comes first)."""
    key = (gen_v, log_size, str(device))
    hit = _POW_CACHE.get(key)
    if hit is not None:
        return hit
    if log_size == 0:
        return _cache_put(_POW_CACHE, key, limbs.pack_ints([1], device=device))
    factors = [(1, pow(gen_v, 1 << j, P)) for j in range(log_size - 1, -1, -1)]
    return _cache_put(_POW_CACHE, key, product_table(factors, device))


def gen_pows(log_size: int, device) -> torch.Tensor:
    """Powers of the 2^log_size-domain generator, FIRST HALF of the cycle:
    every twiddle exponent of the Pease NTT and the FRI fold is below
    2^(log_size-1)."""
    if log_size == 0:
        return _pow_table(1, 0, device)
    return _pow_table(pow2_generator(log_size).v, log_size - 1, device)


def inv_gen_pows(log_size: int, device) -> torch.Tensor:
    """First-half powers of the inverse domain generator (FRI fold)."""
    if log_size == 0:
        return _pow_table(1, 0, device)
    return _pow_table(pow2_generator(log_size).inv().v, log_size - 1, device)


def _pease_rows(x: torch.Tensor, pows: torch.Tensor, log_m: int) -> torch.Tensor:
    """Constant-geometry (Pease) DIF butterflies along the row axis of
    (M, C, 4) or (batch, M, C, 4), M = 2^log_m.

    Every stage has identical data movement - split row halves, butterfly,
    interleave rows.  Natural row order in, BIT-REVERSED row order out:

        y[2i]   = x[i] + x[i + M/2]
        y[2i+1] = (x[i] - x[i + M/2]) * g^(((i >> s) mod 2^(L-1-s)) << s)

    ``pows``: (M/2, 4) first-half powers of the M-domain root, possibly a
    strided view of a longer table.  Stages run two per launch; an odd
    ``log_m`` leaves the last stage, whose twiddles are all 1, to the
    twiddle-free kernel, and M = 2 is that one stage with its twiddle.
    """
    if log_m == 0:
        return x
    half = 1 << (log_m - 1)
    if log_m == 1:
        stats.bump("ntt_single_stages")
        return cuda_ops.butterfly(x[..., :1, :, :], x[..., 1:, :, :], pows[:1]).reshape(x.shape)
    for ps in range(log_m // 2):
        x = cuda_ops.butterfly2(x, pows, ps)
    stats.bump("ntt_double_stages", log_m // 2)
    if log_m % 2:
        stats.bump("ntt_notw_stages")
        x = cuda_ops.butterfly_notw(x[..., :half, :, :], x[..., half:, :, :]).reshape(x.shape)
    return x


def _bitrev_rows(x: torch.Tensor, log_m: int) -> torch.Tensor:
    if log_m <= 1:
        return x
    return x.index_select(-3, bitrev_indices(1 << log_m, x.device))


def _twiddle_factors(gen_v: int, log_n: int, device):
    """Rank-structured four-step twiddles: two SMALL factor matrices.

    The dense (A, B) matrix T[a, b] = w^(a*b mod n) factors through the row
    index a = k*S + d:  T[a, b] = w^(k*S*b) * w^(d*b) = Tc[k, b] * Tf[d, b],
    so the transform multiplies by two broadcast factors of (A/S)*B and S*B
    entries instead of materializing T.
    """
    key = (gen_v, log_n, str(device))
    hit = _TWIDDLE_CACHE.get(key)
    if hit is not None:
        return hit
    n = 1 << log_n
    a = (log_n + 1) // 2
    A, B = 1 << a, 1 << (log_n - a)
    S = 1 << (a // 2)  # balances the two factor sizes at ~sqrt(A)*B each
    pows = _pow_table(gen_v, log_n - 1, device)
    ib = torch.arange(B, dtype=torch.int64, device=device)

    def factor(rows: int, step: int):
        ir = torch.arange(rows, dtype=torch.int64, device=device) * step
        e = (ir[:, None] * ib[None, :]) & (n - 1)
        T = pows[e & (n // 2 - 1)]
        # w^(n/2) = -1: exponents in the second half of the cycle negate
        return ops.select(e >= n // 2, ops.neg(T), T)

    return _cache_put(_TWIDDLE_CACHE, key, (factor(A // S, S), factor(S, 1)))


def fourstep_transform(x: torch.Tensor, gen_v: int, log_n: int) -> torch.Tensor:
    """Four-step transform over the 2^log_n domain generated by ``gen_v`` of
    an (n0, 4) or (batch, n0, 4) tensor, n0 <= 2^log_n, taken as zero-padded
    to the domain's size: natural order in, natural order out.

    Every step rebinds ``x``, so at most one input and one output of a step
    are alive at a time (the padded copy is made here, not by the caller,
    for the same reason)."""
    n = 1 << log_n
    lead = x.shape[:-2]
    assert x.shape[-2] <= n and x.shape[-1] == 4 and len(lead) <= 1
    if log_n == 0:
        return x
    if x.shape[-2] < n:
        padded = torch.zeros(lead + (n, 4), dtype=torch.int32, device=x.device)
        padded[..., : x.shape[-2], :] = x
        x = padded
        del padded
    a = (log_n + 1) // 2
    b = log_n - a
    A, B = 1 << a, 1 << b
    pows = _pow_table(gen_v, log_n - 1, x.device)
    Tc, Tf = _twiddle_factors(gen_v, log_n, x.device)
    # powers of w^B (the A-domain root) and w^A (the B-domain root)
    powsA = pows[::B][: max(A // 2, 1)]
    powsB = pows[::A][: max(B // 2, 1)]

    x = _bitrev_rows(_pease_rows(x.reshape(lead + (A, B, 4)), powsA, a), a)
    x = cuda_ops.twiddle_mul3(x, Tc, Tf)
    x = x.transpose(-3, -2).contiguous()  # (B, A, 4)
    x = _bitrev_rows(_pease_rows(x, powsB, b), b)
    # flat(x)[k2*A + k1] = out[k1 + A*k2]: already the natural order
    return x.reshape(lead + (n, 4))


def ntt(coeffs: torch.Tensor) -> torch.Tensor:
    """Forward NTT along the value axis: out[i] = p(g^i), natural order."""
    n = coeffs.shape[-2]
    log_n = n.bit_length() - 1
    assert 1 << log_n == n, "size must be a power of two"
    if log_n == 0:
        return coeffs
    return fourstep_transform(coeffs, pow2_generator(log_n).v, log_n)


def intt(evals: torch.Tensor) -> torch.Tensor:
    """Inverse NTT along the value axis (reference src/ntt/mod.rs:131-174):
    the four-step transform with the inverse generator, then a scale by
    n^-1 through the ``mul`` kernel, reading one packed scalar."""
    n = evals.shape[-2]
    log_n = n.bit_length() - 1
    assert 1 << log_n == n, "size must be a power of two"
    x = fourstep_transform(evals, pow2_generator(log_n).inv().v, log_n)
    return ops.mul(x, ops.packed_scalar(Fp(n).inv().v, x.device))


def reed_solomon(coeffs: torch.Tensor, log_blowup: int = LOG_BLOWUP) -> torch.Tensor:
    """RS-encode an (n, 4) or (batch, n, 4) tensor: the coefficients,
    zero-padded x2^log_blowup, through the NTT over the big domain (reference
    src/fri/mod.rs:19-28, rate 1/2)."""
    n = coeffs.shape[-2]
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    log_m = log_n + log_blowup
    return fourstep_transform(coeffs, pow2_generator(log_m).v, log_m)
