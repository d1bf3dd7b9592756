"""Hand-written CUDA kernels for the field hot paths, with their wrappers,
plain PyTorch versions and launch counters.

Counterpart of the JAX package's ``field/pallas_ops.py``.  Each wrapper
validates its inputs and then lets the DEVICE OF THE TENSOR decide: a CUDA
tensor launches the kernel (or raises - there is no fallback), a CPU tensor
runs the plain version, which repeats the same arithmetic in tensor code.
``launch_counts()`` says how many times each kernel was enqueued.

Kernels (sources under ``csrc/``):

* ``mul``                - a*b mod p elementwise            (csrc/mul.cu)
* ``add``, ``sub``       - a+-b mod p elementwise           (csrc/addsub.cu)
* ``butterfly``          - one Pease radix-2 NTT stage      (csrc/butterfly.cu)
* ``fold_commit_leaves`` - FRI fold + pair-leaf SHA-256     (csrc/fold_commit.cu)
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import ops
from .scalar import P

_LAUNCHES = {"mul": 0, "add": 0, "sub": 0, "butterfly": 0, "fold_commit_leaves": 0}


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


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
    _LAUNCHES[kernel] += 1


# ---------------------------------------------------------------------------
# mul, add, sub: elementwise over strided operands
# ---------------------------------------------------------------------------

_MAX_ELEMENTS = (1 << 32) - 1024  # the kernels index elements with 32 bits


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
# butterfly: one Pease DIF stage
# ---------------------------------------------------------------------------


def butterfly_plain(u: torch.Tensor, v: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    p = ops.add_plain(u, v)
    q = mul_plain(ops.sub_plain(u, v), tw.unsqueeze(1))
    return torch.stack([p, q], dim=1)


def butterfly(u: torch.Tensor, v: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """One constant-geometry radix-2 stage.  u, v: (H, C, 4); tw: (H, 4),
    one twiddle per row.  Returns (H, 2, C, 4) with
    out[i, 0] = u[i] + v[i] and out[i, 1] = (u[i] - v[i]) * tw[i]."""
    _check_field("butterfly: u", u)
    _check_field("butterfly: v", v, device=u.device)
    _check_field("butterfly: tw", tw, device=u.device)
    if u.dim() != 3 or v.shape != u.shape or tw.shape != (u.shape[0], 4):
        raise ValueError(
            f"butterfly: expected u, v (H, C, 4) and tw (H, 4), got "
            f"{tuple(u.shape)}, {tuple(v.shape)}, {tuple(tw.shape)}"
        )
    if u.device.type == "cpu":
        return butterfly_plain(u, v, tw)
    H, C = u.shape[0], u.shape[1]
    out = torch.empty((H, 2, C, 4), dtype=torch.int32, device=u.device)
    if H * C:
        _launch(
            "butterfly", "mlt_butterfly", u.device,
            u.data_ptr(), v.data_ptr(), tw.data_ptr(), out.data_ptr(), H, C,
        )
    return out


# ---------------------------------------------------------------------------
# fold_commit_leaves: FRI fold + SHA-256 of the pair leaves
# ---------------------------------------------------------------------------


def _fold_plain(code, tw_table, tw_stride: int, rh: int) -> torch.Tensor:
    from . import limbs

    half = code.shape[0] // 2
    a, b = code[:half], code[half:]
    tw = tw_table[::tw_stride][:half]
    even = ops.half(ops.add_plain(a, b))
    odd = mul_plain(ops.sub_plain(a, b), tw)
    rhl = limbs.pack_int(rh, device=code.device)
    return ops.add_plain(even, mul_plain(rhl, odd))


def fold_commit_leaves_plain(code, tw_table, tw_stride: int, rh: int):
    from ..sha256 import limbs_to_words
    from ..sha256_cuda import sha256_words_plain

    nxt = _fold_plain(code, tw_table, tw_stride, rh)
    q = nxt.shape[0] // 2
    msg = torch.cat([limbs_to_words(nxt[:q]), limbs_to_words(nxt[q:])], dim=-1)
    return nxt, sha256_words_plain(msg)


def fold_commit_leaves(code: torch.Tensor, tw_table: torch.Tensor, tw_stride: int, rh: int):
    """One FRI fold and the Merkle leaf level of the result, fused.

    code: (m, 4), m a multiple of 4.  ``tw_table``: (T, 4) powers of the
    inverse domain generator; the fold's twiddle i is
    ``tw_table[i * tw_stride]``.  ``rh``: the integer r/2 mod p (the fold
    challenge times 2^-1, one host multiply).  Returns

        nxt[i]  = half(a+b) + (a-b) * tw[i] * rh,  a = code[i], b = code[i+m/2]
        digs[i] = SHA-256(le_bytes(nxt[i]) || le_bytes(nxt[i + m/4]))

    as ((m/2, 4) int32, (m/4, 8) int32 big-endian digest words).
    """
    _check_field("fold_commit_leaves: code", code)
    _check_field("fold_commit_leaves: tw_table", tw_table, device=code.device)
    m = code.shape[0]
    if code.dim() != 2 or tw_table.dim() != 2 or m < 4 or m % 4:
        raise ValueError(f"fold_commit_leaves: bad shapes {tuple(code.shape)}, {tuple(tw_table.shape)}")
    if tw_stride < 1 or (m // 2 - 1) * tw_stride >= tw_table.shape[0]:
        raise ValueError("fold_commit_leaves: twiddle table too short for this stride")
    if not 0 <= rh < P:
        raise ValueError("fold_commit_leaves: rh must be a canonical residue")
    if code.device.type == "cpu":
        return fold_commit_leaves_plain(code, tw_table, tw_stride, rh)
    nxt = torch.empty((m // 2, 4), dtype=torch.int32, device=code.device)
    digs = torch.empty((m // 4, 8), dtype=torch.int32, device=code.device)
    _launch(
        "fold_commit_leaves", "mlt_fold_commit", code.device,
        code.data_ptr(), tw_table.data_ptr(), nxt.data_ptr(), digs.data_ptr(),
        m, tw_stride, rh & 0xFFFFFFFFFFFFFFFF, rh >> 64,
    )
    return nxt, digs
