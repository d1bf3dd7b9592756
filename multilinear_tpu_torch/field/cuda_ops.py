"""Hand-written CUDA kernels for the field hot paths, with their wrappers,
plain PyTorch versions.

Counterpart of the JAX package's ``field/pallas_ops.py``.  Each wrapper
validates its inputs and then lets the DEVICE OF THE TENSOR decide: a CUDA
tensor launches the kernel (or raises - there is no fallback), a CPU tensor
runs the plain version, which repeats the same arithmetic in tensor code.
Each launch is counted in ``stats`` as ``launch.<kernel>``.

Kernels (sources under ``csrc/``):

* ``mul``                - a*b mod p elementwise            (csrc/mul.cu)
* ``add``, ``sub``       - a+-b mod p elementwise           (csrc/addsub.cu)
* ``butterfly``          - one Pease radix-2 NTT stage      (csrc/butterfly.cu)
* ``butterfly_notw``     - the twiddle-free last stage      (csrc/butterfly.cu)
* ``butterfly2``         - two Pease stages in one pass     (csrc/butterfly2.cu)
* ``twiddle_mul3``       - four-step twiddle, one pass      (csrc/twiddle_mul3.cu)
* ``kron_mul``           - tensor product of two vectors    (csrc/kron.cu)
* ``zm_butterfly``       - zeta / Moebius, many bits a pass (csrc/zm.cu);
  ``zm_bitrev_pad`` is the same kernel with the encode's bit reversal and
  zero padding in its last store
* ``fold_codeword``      - FRI fold                         (csrc/fold.cu)
* ``fold_commit_leaves`` - FRI fold + pair-leaf SHA-256     (csrc/fold_commit.cu)

``mul``, ``add`` and ``sub`` index elements with 32 bits; every other kernel
indexes with 64 bits and launches one thread per element (or per group of
elements) in blocks of 256, so its wrapper raises above ``_MAX_ELEMENTS``
threads as well.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import stats
from . import ops


def _check_field(name: str, t: torch.Tensor, device=None, contiguous=True) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != torch.int32 or t.dim() < 1 or t.shape[-1] != 4:
        raise ValueError(
            f"{name}: expected an int32 field tensor of shape S+(4,), got "
            f"{t.dtype} {tuple(t.shape)}"
        )
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(kernel: str, symbol: str, device: torch.device, *args) -> None:
    """Enqueue one kernel on PyTorch's current stream of ``device``."""
    from .. import _build

    fn = _build.lib()[symbol]
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(*args, device.index if device.index is not None else torch.cuda.current_device(), stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch (cudaError {rc})")
    stats.bump("launch." + kernel)


# ---------------------------------------------------------------------------
# mul, add, sub: elementwise over strided operands
# ---------------------------------------------------------------------------

_MAX_ELEMENTS = (1 << 32) - 1024  # the kernels index elements with 32 bits


def _check_count(kernel: str, n: int) -> None:
    if n > _MAX_ELEMENTS:
        raise ValueError(f"{kernel}: {n} threads exceed the launch's 32-bit block count")


def _element_strides(t: torch.Tensor):
    """Strides of the value dims in elements, or None when the tensor's
    elements are not whole aligned 16-byte units."""
    st = t.stride()
    if st[-1] != 1 or t.data_ptr() % 16 or any(s % 4 for s in st[:-1]):
        return None
    return [s // 4 for s in st[:-1]]


def collapse_dims(shape, strides):
    """Merge neighbouring value dims that every operand walks contiguously.

    ``shape``: the value shape; ``strides``: one list of element strides per
    operand (0 for a broadcast dim).  Returns (dims, strides) with size-1
    dims dropped; two dims merge when, for every operand, the outer stride
    equals the inner stride times the inner size.
    """
    dims, out = [], [[] for _ in strides]
    for d, size in enumerate(shape):
        if size == 1:
            continue
        cur = [s[d] for s in strides]
        if dims and all(o[-1] == c * size for o, c in zip(out, cur)):
            dims[-1] *= size
            for o, c in zip(out, cur):
                o[-1] = c
        else:
            dims.append(size)
            for o, c in zip(out, cur):
                o.append(c)
    return dims, out


def _elementwise(kernel: str, plain, a: torch.Tensor, b: torch.Tensor, out: Optional[torch.Tensor]):
    _check_field(f"{kernel}: a", a, contiguous=False)
    _check_field(f"{kernel}: b", b, device=a.device, contiguous=False)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if out is not None:
        _check_field(f"{kernel}: out", out, device=a.device, contiguous=False)
        if out.shape != shape:
            raise ValueError(f"{kernel}: out has shape {tuple(out.shape)}, expected {tuple(shape)}")
    if a.device.type == "cpu":
        res = plain(a, b)
        if out is None:
            return res
        out.copy_(res)
        return out
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=a.device)
    n = out.numel() // 4
    if n == 0:
        return out
    if n > _MAX_ELEMENTS:
        raise ValueError(f"{kernel}: {n} elements exceed the kernel's 32-bit index")
    a, b = a.expand(shape), b.expand(shape)
    so = _element_strides(out)
    if so is None:
        raise ValueError(f"{kernel}: out must hold whole 16-byte-aligned elements")
    sa, sb = _element_strides(a), _element_strides(b)
    dims = None
    if sa is not None and sb is not None:
        dims, (ca, cb, co) = collapse_dims(shape[:-1], [sa, sb, so])
    if dims is None or len(dims) > 3:
        # not expressible in three strided dims: materialise the operands
        a, b = a.contiguous(), b.contiguous()
        dims, (ca, cb, co) = collapse_dims(
            shape[:-1], [_element_strides(a), _element_strides(b), so]
        )
        if len(dims) > 3:
            raise ValueError(f"{kernel}: out has more than three strided dims")
    pad = 3 - len(dims)
    dims = [1] * pad + dims
    strides = (ctypes.c_int64 * 9)(*([0] * pad + ca), *([0] * pad + cb), *([0] * pad + co))
    _launch(kernel, "mlt_" + kernel, a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(),
            n, dims[1], dims[2], strides)
    return out


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod p in tensor code: schoolbook product over 8x8 16-bit
    limbs (column sums < 2^35 in int64 lanes), then the sparse-modulus
    folds of ``ops._reduce_wide16``.  Broadcasts like any tensor op."""
    al, bl = ops._split16(a), ops._split16(b)
    cols = [None] * 15
    for i in range(8):
        for j in range(8):
            prod = al[i] * bl[j]
            cols[i + j] = prod if cols[i + j] is None else cols[i + j] + prod
    t, _ = ops._carry_normalize(cols, 16)  # product < 2^256: final carry 0
    return ops._join16(ops._reduce_wide16(t))


def mul(a: torch.Tensor, b: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(a * b) mod p, elementwise with broadcasting over the value shape.
    Operands are read through their strides: a broadcast or sliced operand
    is not copied.  ``out`` may be a strided view and may alias ``a``."""
    return _elementwise("mul", mul_plain, a, b, out)


def add(a: torch.Tensor, b: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(a + b) mod p, elementwise; same operand rules as :func:`mul`."""
    return _elementwise("add", ops.add_plain, a, b, out)


def sub(a: torch.Tensor, b: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(a - b) mod p, elementwise; same operand rules as :func:`mul`."""
    return _elementwise("sub", ops.sub_plain, a, b, out)


# ---------------------------------------------------------------------------
# butterfly, butterfly_notw: one Pease DIF stage
# ---------------------------------------------------------------------------


def _row_batches(name: str, t: torch.Tensor):
    """(batch, H, C, batch stride in elements) of an (H, C, 4) or
    (batch, H, C, 4) field tensor whose batch entries are each contiguous -
    the row halves of a contiguous (batch, 2H, C, 4) tensor qualify."""
    _check_field(name, t, contiguous=False)
    if t.dim() == 3:
        t = t.unsqueeze(0)
    if t.dim() != 4:
        raise ValueError(f"{name}: expected (H, C, 4) or (batch, H, C, 4), got {tuple(t.shape)}")
    batch, H, C, _ = t.shape
    st = t.stride()
    inner_ok = t.numel() == 0 or (st[3] == 1 and st[2] == 4 and (H == 1 or st[1] == 4 * C))
    if not inner_ok or (batch > 1 and st[0] % 4) or t.data_ptr() % 16:
        raise ValueError(f"{name}: each batch entry must be contiguous and 16-byte aligned")
    return batch, H, C, (st[0] // 4 if batch > 1 else H * C)


def _stage_args(kernel: str, u: torch.Tensor, v: torch.Tensor):
    batch, H, C, stride = _row_batches(f"{kernel}: u", u)
    if v.shape != u.shape or v.device != u.device or _row_batches(f"{kernel}: v", v)[3] != stride:
        raise ValueError(
            f"{kernel}: v must match u in shape, device and batch stride, got "
            f"{tuple(u.shape)} and {tuple(v.shape)}"
        )
    out = torch.empty(u.shape[:-2] + (2, C, 4), dtype=torch.int32, device=u.device)
    _check_count(kernel, batch * H * C)
    return batch, H, C, stride, out


def butterfly_plain(u: torch.Tensor, v: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    p = ops.add_plain(u, v)
    q = mul_plain(ops.sub_plain(u, v), tw.unsqueeze(1))
    return torch.stack([p, q], dim=-3)


def butterfly(u: torch.Tensor, v: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """One constant-geometry radix-2 stage.  u, v: (H, C, 4) or
    (batch, H, C, 4); tw: (H, 4), one twiddle per row.  Returns
    (..., H, 2, C, 4) with out[i, 0] = u[i] + v[i] and
    out[i, 1] = (u[i] - v[i]) * tw[i]."""
    batch, H, C, stride, out = _stage_args("butterfly", u, v)
    _check_field("butterfly: tw", tw, device=u.device)
    if tw.shape != (H, 4):
        raise ValueError(f"butterfly: expected tw ({H}, 4), got {tuple(tw.shape)}")
    if u.device.type == "cpu":
        return butterfly_plain(u, v, tw)
    if batch * H * C:
        _launch(
            "butterfly", "mlt_butterfly", u.device,
            u.data_ptr(), v.data_ptr(), tw.data_ptr(), out.data_ptr(), batch, H, C, stride,
        )
    return out


def butterfly_notw_plain(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.stack([ops.add_plain(u, v), ops.sub_plain(u, v)], dim=-3)


def butterfly_notw(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The last stage of a transform, whose twiddles are all 1: shapes as
    :func:`butterfly`, out[i, 0] = u[i] + v[i], out[i, 1] = u[i] - v[i]."""
    batch, H, C, stride, out = _stage_args("butterfly_notw", u, v)
    if u.device.type == "cpu":
        return butterfly_notw_plain(u, v)
    if batch * H * C:
        _launch(
            "butterfly_notw", "mlt_butterfly_notw", u.device,
            u.data_ptr(), v.data_ptr(), out.data_ptr(), batch, H, C, stride,
        )
    return out


# ---------------------------------------------------------------------------
# butterfly2: two Pease DIF stages in one pass
# ---------------------------------------------------------------------------


def stage_exp(s: int, r, half: int):
    """Twiddle exponent of row ``r`` (an int or an index tensor) in stage
    ``s`` of a Pease transform over 2*half rows."""
    return ((r >> s) & ((half - 1) >> s)) << s


def butterfly2_plain(x: torch.Tensor, pows: torch.Tensor, ps: int) -> torch.Tensor:
    M = x.shape[-3]
    Q, half = M // 4, M // 2
    i = torch.arange(Q, dtype=torch.int64, device=x.device)
    ta, tb, tc, td = (
        pows[stage_exp(s, r, half)].unsqueeze(1)
        for s, r in ((2 * ps, i), (2 * ps, i + Q), (2 * ps + 1, 2 * i), (2 * ps + 1, 2 * i + 1))
    )
    x0, x1, x2, x3 = (x[..., k * Q : (k + 1) * Q, :, :] for k in range(4))
    A, C = ops.add_plain(x0, x2), ops.add_plain(x1, x3)
    Bta = mul_plain(ops.sub_plain(x0, x2), ta)
    Dtb = mul_plain(ops.sub_plain(x1, x3), tb)
    z = [
        ops.add_plain(A, C), mul_plain(ops.sub_plain(A, C), tc),
        ops.add_plain(Bta, Dtb), mul_plain(ops.sub_plain(Bta, Dtb), td),
    ]
    return torch.stack(z, dim=-3).reshape(x.shape)


def butterfly2(x: torch.Tensor, pows: torch.Tensor, ps: int) -> torch.Tensor:
    """Stages 2*ps and 2*ps+1 of the Pease transform along the row axis of
    x, (M, C, 4) or (batch, M, C, 4) with M a power of two >= 4, in one pass:
    the same values as two :func:`butterfly` stages.  ``pows``: (>= M/2, 4)
    first-half powers of the M-domain root, possibly a strided view of a
    longer table; the kernel computes each row's four twiddle exponents
    itself and reads them from it."""
    _check_field("butterfly2: x", x)
    _check_field("butterfly2: pows", pows, device=x.device, contiguous=False)
    if x.dim() not in (3, 4) or pows.dim() != 2:
        raise ValueError(f"butterfly2: bad shapes {tuple(x.shape)}, {tuple(pows.shape)}")
    M, C = x.shape[-3], x.shape[-2]
    batch = x.shape[0] if x.dim() == 4 else 1
    log_m = M.bit_length() - 1
    if M < 4 or 1 << log_m != M or not 0 <= 2 * ps + 1 < log_m:
        raise ValueError(f"butterfly2: M = {M} rows have no stages {2 * ps}, {2 * ps + 1}")
    strides = _element_strides(pows)
    if pows.shape[0] < M // 2 or strides is None:
        raise ValueError("butterfly2: pows must hold M/2 whole 16-byte-aligned elements")
    if x.device.type == "cpu":
        return butterfly2_plain(x, pows, ps)
    out = torch.empty_like(x)
    n = batch * (M // 4) * C
    _check_count("butterfly2", n)
    if n:
        _launch(
            "butterfly2", "mlt_butterfly2", x.device,
            x.data_ptr(), pows.data_ptr(), out.data_ptr(), batch, M, C, ps, strides[0],
        )
    return out


# ---------------------------------------------------------------------------
# twiddle_mul3: the twiddle step of the four-step transform
# ---------------------------------------------------------------------------


def twiddle_mul3_plain(F: torch.Tensor, Tc: torch.Tensor, Tf: torch.Tensor) -> torch.Tensor:
    A, B = F.shape[-3], F.shape[-2]
    S = Tf.shape[0]
    Fr = F.reshape(F.shape[:-3] + (A // S, S, B, 4))
    return mul_plain(mul_plain(Fr, Tc.unsqueeze(1)), Tf).reshape(F.shape)


def twiddle_mul3(F: torch.Tensor, Tc: torch.Tensor, Tf: torch.Tensor) -> torch.Tensor:
    """G[a, b] = F[a, b] * Tc[a // S, b] * Tf[a % S, b] in one pass.  F:
    (A, B, 4) or (batch, A, B, 4); Tc: (A/S, B, 4); Tf: (S, B, 4), S a power
    of two (``ntt._twiddle_factors``)."""
    _check_field("twiddle_mul3: F", F)
    _check_field("twiddle_mul3: Tc", Tc, device=F.device)
    _check_field("twiddle_mul3: Tf", Tf, device=F.device)
    if F.dim() not in (3, 4) or Tc.dim() != 3 or Tf.dim() != 3:
        raise ValueError("twiddle_mul3: expected F (A, B, 4) or (batch, A, B, 4) and 3-d factors")
    A, B = F.shape[-3], F.shape[-2]
    S = Tf.shape[0]
    if S < 1 or S & (S - 1) or A % S or Tf.shape != (S, B, 4) or Tc.shape != (A // S, B, 4):
        raise ValueError(
            f"twiddle_mul3: factors {tuple(Tc.shape)}, {tuple(Tf.shape)} do not fit F {tuple(F.shape)}"
        )
    if F.device.type == "cpu":
        return twiddle_mul3_plain(F, Tc, Tf)
    out = torch.empty_like(F)
    batch = F.shape[0] if F.dim() == 4 else 1
    _check_count("twiddle_mul3", batch * A * B)
    if batch * A * B:
        _launch(
            "twiddle_mul3", "mlt_twiddle_mul3", F.device,
            F.data_ptr(), Tc.data_ptr(), Tf.data_ptr(), out.data_ptr(), batch, A, B,
            S.bit_length() - 1,
        )
    return out


# ---------------------------------------------------------------------------
# kron_mul: tensor product
# ---------------------------------------------------------------------------


_KRON_SLAB = 1024  # columns of b a launch keeps in registers (4 per thread)


def kron_mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = b.shape[0]
    return mul_plain(a.unsqueeze(-2), b).reshape(a.shape[:-2] + (a.shape[-2] * n, 4))


def kron_mul(a: torch.Tensor, b: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[..., i * n + j] = a[..., i] * b[j].  a: (m, 4) or (batch, m, 4);
    b: (n, 4); returns (..., m * n, 4), written into ``out`` when given (a
    contiguous tensor of that shape).  A batch is one product of its
    batch * m rows with b."""
    _check_field("kron_mul: a", a)
    _check_field("kron_mul: b", b, device=a.device)
    if a.dim() not in (2, 3) or b.dim() != 2:
        raise ValueError(f"kron_mul: bad shapes {tuple(a.shape)}, {tuple(b.shape)}")
    m, n = a.numel() // 4, b.shape[0]
    shape = a.shape[:-2] + (a.shape[-2] * n, 4)
    if out is not None:
        _check_field("kron_mul: out", out, device=a.device)
        if out.shape != shape:
            raise ValueError(f"kron_mul: out has shape {tuple(out.shape)}, expected {tuple(shape)}")
    if a.device.type == "cpu":
        res = kron_mul_plain(a, b)
        if out is None:
            return res
        out.copy_(res)
        return out
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=a.device)
    # the kernel keeps up to _KRON_SLAB columns of b in registers: a wider b
    # goes in slabs, each writing its columns of every row
    for j0 in range(0, n if m else 0, _KRON_SLAB):
        _launch("kron_mul", "mlt_kron_tiles", a.device, a.data_ptr(), b.data_ptr() + 16 * j0,
                out.data_ptr() + 16 * j0, m, min(_KRON_SLAB, n - j0), n)
    return out


# ---------------------------------------------------------------------------
# zm_butterfly: zeta / Moebius transform, many index bits per pass
# ---------------------------------------------------------------------------

_ZM_TILE_BITS = 13  # the kernel's larger shared-memory tile: 2^13 elements, 144 KiB with padding
_ZM_MIN_RUN_BITS = 2  # later passes keep runs of 2^2 adjacent elements (64 bytes)
_ZM_MIN_LATER_BITS = 3  # and take at least 3 bits (the kernel wants w <= tile_bits - 3)


def zm_tile_bits(bits: int) -> int:
    """The tile a transform over ``bits`` index bits runs with: 2^13
    elements (one block a multiprocessor) where that saves a pass over device
    memory - 13 bits, and 23 or 24, which are 13 + 10 or 11 - and else 2^12
    (two blocks a multiprocessor, whose loads, butterflies and stores
    overlap): measured faster at 10 x 2^22, slower at 2^24."""
    small = _ZM_TILE_BITS - 1
    return small if len(zm_passes(bits, small)) == len(zm_passes(bits, _ZM_TILE_BITS)) else _ZM_TILE_BITS


def zm_passes(bits: int, tile_bits: Optional[int] = None):
    """The (first bit d, bit count c, log2 run width w) of each kernel pass
    of a transform over ``bits`` index bits: the low ``tile_bits`` bits as
    tiles of consecutive elements, then up to ``tile_bits - 2`` bits a pass
    as tiles of 2^c rows, 2^d elements apart, by 2^w = 2^(tile_bits - c)
    adjacent elements.  ``tile_bits``: 12 or 13, by default what
    :func:`zm_tile_bits` picks for this size."""
    if tile_bits is None:
        tile_bits = zm_tile_bits(bits)
    counts, left = [], bits
    while left:
        counts.append(min(tile_bits - _ZM_MIN_RUN_BITS if counts else tile_bits, left))
        left -= counts[-1]
    # a later pass takes at least 3 bits (its rows then split evenly over the
    # block's threads): it borrows them from the pass before it
    if len(counts) > 1 and counts[-1] < _ZM_MIN_LATER_BITS:
        counts[-2] -= _ZM_MIN_LATER_BITS - counts[-1]
        counts[-1] = _ZM_MIN_LATER_BITS
    passes, d = [], 0
    for c in counts:
        passes.append((d, c, tile_bits - c if d else 0))
        d += c
    return passes


def zm_butterfly_plain(x: torch.Tensor, add: bool) -> torch.Tensor:
    n = x.shape[-2]
    op = ops.add_plain if add else ops.sub_plain
    x = x.clone()
    lead = x.shape[:-2]
    for i in range(n.bit_length() - 1):
        w = x.view(lead + (n >> (i + 1), 2, 1 << i, 4))
        w[..., 1, :, :] = op(w[..., 1, :, :], w[..., 0, :, :])
    return x


def zm_bitrev_pad_plain(x: torch.Tensor, add: bool, log_blowup: int) -> torch.Tensor:
    """Plain version of :func:`zm_bitrev_pad`: the transform, a bit-reversal
    gather, and a copy into a zeroed tensor of the padded length."""
    from ..mle import bit_reverse

    y = bit_reverse(zm_butterfly_plain(x, add))
    n = x.shape[-2]
    out = torch.zeros(x.shape[:-2] + (n << log_blowup, 4), dtype=torch.int32, device=x.device)
    out[..., :n, :] = y
    return out


def _check_zm(name: str, x: torch.Tensor) -> int:
    _check_field(f"{name}: x", x)
    if x.dim() not in (2, 3):
        raise ValueError(f"{name}: expected (n, 4) or (batch, n, 4), got {tuple(x.shape)}")
    n = x.shape[-2]
    bits = n.bit_length() - 1
    if n < 1 or 1 << bits != n:
        raise ValueError(f"{name}: size must be a power of two")
    _check_count(name, x.numel() // 4)
    return bits


def _zm_launches(x: torch.Tensor, add: bool, out: torch.Tensor, reverse: bool,
                 tile_bits: Optional[int] = None) -> None:
    """Run the passes of one transform of contiguous ``x`` into ``out``: the
    first pass reads ``x``, later passes run in place on what it wrote; with
    ``reverse`` the last pass stores element i of each transform at
    bitrev(i) of ``out``'s (longer) value axis."""
    n, total = x.shape[-2], x.numel() // 4
    bits = n.bit_length() - 1
    if tile_bits is None:
        tile_bits = zm_tile_bits(bits)
    passes = zm_passes(bits, tile_bits)
    work = torch.empty_like(x) if reverse and len(passes) > 1 else out
    src = x
    for k, (d, c, log_w) in enumerate(passes):
        last = reverse and k == len(passes) - 1
        dst = out if last else work
        _launch("zm_butterfly", "mlt_zm_tiles", x.device, src.data_ptr(), dst.data_ptr(), total,
                d, c, log_w, int(add), bits if last else 0, out.shape[-2] if last else 0, tile_bits)
        src = dst


def zm_butterfly(x: torch.Tensor, add: bool) -> torch.Tensor:
    """hi <- hi + lo (``add``: zeta transform) or hi <- hi - lo (Moebius
    transform) for EVERY bit of the value index of x, (n, 4) or
    (batch, n, 4) with n a power of two.  Returns a new tensor; the first
    kernel pass writes it, so ``x`` is not copied first."""
    bits = _check_zm("zm_butterfly", x)
    if x.device.type == "cpu":
        return zm_butterfly_plain(x, add)
    if bits == 0 or x.numel() == 0:
        return x.clone()
    out = torch.empty_like(x)
    _zm_launches(x, add, out, reverse=False)
    return out


def zm_bitrev_pad(x: torch.Tensor, add: bool, log_blowup: int) -> torch.Tensor:
    """The transform of :func:`zm_butterfly`, bit-reversed along the value
    axis and zero-padded to ``n << log_blowup`` values, in the kernel's own
    last store: (..., n, 4) -> (..., n << log_blowup, 4) with
    out[..., bitrev(i), :] = transform(x)[..., i, :] and zeros above n."""
    bits = _check_zm("zm_bitrev_pad", x)
    if not 0 <= log_blowup <= 8:
        raise ValueError(f"zm_bitrev_pad: log_blowup {log_blowup} out of range")
    if x.device.type == "cpu":
        return zm_bitrev_pad_plain(x, add, log_blowup)
    n = x.shape[-2]
    out = torch.empty(x.shape[:-2] + (n << log_blowup, 4), dtype=torch.int32, device=x.device)
    if log_blowup:
        out[..., n:, :].zero_()
    if bits == 0 or x.numel() == 0:
        out[..., :n, :] = x
        return out
    _zm_launches(x, add, out, reverse=True)
    return out


# ---------------------------------------------------------------------------
# fold_codeword, fold_commit_leaves: the FRI fold, alone and fused with the
# SHA-256 of the pair leaves
# ---------------------------------------------------------------------------


def _check_fold(kernel: str, code, tw_table, tw_stride: int, rh, multiple: int) -> None:
    _check_field(f"{kernel}: code", code)
    _check_field(f"{kernel}: tw_table", tw_table, device=code.device)
    _check_field(f"{kernel}: rh", rh, device=code.device)
    m = code.shape[0]
    if code.dim() != 2 or tw_table.dim() != 2 or m < multiple or m % multiple:
        raise ValueError(f"{kernel}: bad shapes {tuple(code.shape)}, {tuple(tw_table.shape)}")
    if tw_stride < 1 or (m // 2 - 1) * tw_stride >= tw_table.shape[0]:
        raise ValueError(f"{kernel}: twiddle table too short for this stride")
    if rh.shape != (4,):
        raise ValueError(f"{kernel}: rh must be one (4,) field element, got {tuple(rh.shape)}")
    _check_count(kernel, m // 2)


def fold_codeword_plain(code, tw_table, tw_stride: int, rh: torch.Tensor) -> torch.Tensor:
    half = code.shape[0] // 2
    a, b = code[:half], code[half:]
    tw = tw_table[::tw_stride][:half]
    even = ops.half(ops.add_plain(a, b))
    odd = mul_plain(ops.sub_plain(a, b), tw)
    return ops.add_plain(even, mul_plain(rh, odd))


def fold_codeword(code: torch.Tensor, tw_table: torch.Tensor, tw_stride: int, rh: torch.Tensor) -> torch.Tensor:
    """One FRI fold: code (m, 4), m even -> (m/2, 4),

        nxt[i] = half(a+b) + (a-b) * tw[i] * rh,  a = code[i], b = code[i+m/2]

    with ``tw_table``, ``tw_stride`` and ``rh`` as in
    :func:`fold_commit_leaves`."""
    _check_fold("fold_codeword", code, tw_table, tw_stride, rh, 2)
    if code.device.type == "cpu":
        return fold_codeword_plain(code, tw_table, tw_stride, rh)
    m = code.shape[0]
    nxt = torch.empty((m // 2, 4), dtype=torch.int32, device=code.device)
    _launch(
        "fold_codeword", "mlt_fold", code.device,
        code.data_ptr(), tw_table.data_ptr(), nxt.data_ptr(), m, tw_stride, rh.data_ptr(),
    )
    return nxt


def fold_commit_leaves_plain(code, tw_table, tw_stride: int, rh: torch.Tensor):
    from ..sha256_cuda import leaf_hashes_plain

    nxt = fold_codeword_plain(code, tw_table, tw_stride, rh)
    return nxt, leaf_hashes_plain(nxt.view(2, nxt.shape[0] // 2, 4))


def fold_commit_leaves(code: torch.Tensor, tw_table: torch.Tensor, tw_stride: int, rh: torch.Tensor):
    """One FRI fold and the Merkle leaf level of the result, fused.

    code: (m, 4), m a multiple of 4.  ``tw_table``: (T, 4) powers of the
    inverse domain generator; the fold's twiddle i is
    ``tw_table[i * tw_stride]``.  ``rh``: r/2 mod p (the fold challenge times
    2^-1) as a canonical (4,) field element on the codeword's device - the
    kernel reads it there, so a challenge drawn on the device needs no copy
    to the host.  Returns

        nxt[i]  = half(a+b) + (a-b) * tw[i] * rh,  a = code[i], b = code[i+m/2]
        digs[i] = SHA-256(le_bytes(nxt[i]) || le_bytes(nxt[i + m/4]))

    as ((m/2, 4) int32, (m/4, 8) int32 big-endian digest words).
    """
    _check_fold("fold_commit_leaves", code, tw_table, tw_stride, rh, 4)
    if code.device.type == "cpu":
        return fold_commit_leaves_plain(code, tw_table, tw_stride, rh)
    m = code.shape[0]
    nxt = torch.empty((m // 2, 4), dtype=torch.int32, device=code.device)
    digs = torch.empty((m // 4, 8), dtype=torch.int32, device=code.device)
    _launch(
        "fold_commit_leaves", "mlt_fold_commit", code.device,
        code.data_ptr(), tw_table.data_ptr(), nxt.data_ptr(), digs.data_ptr(), m, tw_stride, rh.data_ptr(),
    )
    return nxt, digs
