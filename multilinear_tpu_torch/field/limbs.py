"""Limb packing for GF(p) elements as PyTorch tensors.

ELEMENT LAYOUT OF THE PORT: a field tensor of value-shape ``S`` is a
``torch.int32`` tensor of shape ``S + (4,)`` holding the four 32-bit
little-endian limbs of one element contiguously (limb 0 least
significant; the int32 is the two's-complement bit pattern of the
unsigned limb).  Canonical tensors hold values in [0, p).

Why: 16 bytes per element is one ``uint4`` load per CUDA thread, and the
raw bytes ARE the wire format (16 little-endian bytes of the canonical
residue, quirk Q9) - serialization and the Merkle leaf message are views.
``torch.int32`` rather than ``torch.uint32`` because PyTorch's CPU kernels
implement no add, shift or compare for uint32; the plain arithmetic in
:mod:`.ops` widens to int64 lanes.

The JAX package's layout - ``(8,) + S`` uint32 planes of 16-bit limbs - is
a TPU lane layout and is not carried over; :func:`from_jax_limbs` /
:func:`to_jax_limbs` convert, so the same polynomial, codeword or table can
be handed to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .scalar import Fp, P

NLIMBS = 4
LIMB_BITS = 32
LIMB_MASK = (1 << LIMB_BITS) - 1


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``.  To a card it goes through pinned memory
    with a non-blocking copy: a copy from pageable memory would make the host
    wait for the card's queue to drain."""
    device = torch.device(device)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _u32_to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr, dtype=np.uint32)
    return to_device(torch.from_numpy(arr.view(np.int32).copy()), device)


def _tensor_to_u32(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def pack_int(v: int, device="cpu") -> torch.Tensor:
    """Pack one integer (reduced mod p) into a (4,) int32 limb tensor."""
    v %= P
    arr = np.array([(v >> (32 * i)) & LIMB_MASK for i in range(NLIMBS)], dtype=np.uint32)
    return _u32_to_tensor(arr, device)


def pack_scalar(x, device="cpu") -> torch.Tensor:
    return pack_int(x.v if isinstance(x, Fp) else int(x), device)


def pack_ints(vs, shape=None, device="cpu") -> torch.Tensor:
    """Pack an iterable of ints/Fp into an (N, 4) limb tensor (or shape+(4,)).

    A numpy uint64 array takes a fully vectorized path; anything else goes
    through exact object-array arithmetic.
    """
    if isinstance(vs, np.ndarray) and vs.dtype == np.uint64:
        small = vs.reshape(-1)
        out = np.zeros((small.shape[0], NLIMBS), dtype=np.uint32)
        out[:, 0] = (small & np.uint64(LIMB_MASK)).astype(np.uint32)
        out[:, 1] = (small >> np.uint64(32)).astype(np.uint32)
    else:
        vals = [(v.v if isinstance(v, Fp) else int(v)) % P for v in vs]
        arr = np.array(vals, dtype=object)
        out = np.empty((len(vals), NLIMBS), dtype=np.uint32)
        for i in range(NLIMBS):
            out[:, i] = ((arr >> (32 * i)) & LIMB_MASK).astype(np.uint32)
    if shape is not None:
        out = out.reshape(tuple(shape) + (NLIMBS,))
    return _u32_to_tensor(out, device)


def unpack_int(t: torch.Tensor) -> int:
    """Unpack a (4,) limb tensor into an int."""
    limbs = _tensor_to_u32(t).reshape(NLIMBS)
    return sum(int(limbs[i]) << (32 * i) for i in range(NLIMBS))


def unpack_ints(t) -> np.ndarray:
    """Unpack an S+(4,) limb tensor (or uint32 ndarray) into an object
    ndarray of Python ints of shape S."""
    limbs = _tensor_to_u32(t) if isinstance(t, torch.Tensor) else np.asarray(t, np.uint32)
    flat = limbs.reshape(-1, NLIMBS)
    vals = np.zeros(flat.shape[0], dtype=object)
    for i in range(NLIMBS - 1, -1, -1):
        vals = (vals << 32) | flat[:, i].astype(object)
    return vals.reshape(limbs.shape[:-1])


def unpack_fps(t: torch.Tensor):
    return [Fp(int(v)) for v in unpack_ints(t).reshape(-1)]


def to_le_bytes(t: torch.Tensor) -> bytes:
    """Serialize an S+(4,) limb tensor to concatenated 16-LE-byte encodings,
    elements in C-order of the value shape (reference src/field.rs:33-38).
    In this layout that is the tensor's own memory, little-endian."""
    return _tensor_to_u32(t).astype("<u4").tobytes()


def from_le_bytes(b: bytes, shape=None, device="cpu") -> torch.Tensor:
    """Inverse of :func:`to_le_bytes`."""
    out = np.frombuffer(b, dtype="<u4").astype(np.uint32).reshape(-1, NLIMBS)
    if shape is not None:
        out = out.reshape(tuple(shape) + (NLIMBS,))
    return _u32_to_tensor(out, device)


def from_jax_limbs(a, device="cpu") -> torch.Tensor:
    """``(8,) + S`` uint32 array of 16-bit limbs (the JAX package's layout)
    -> ``S + (4,)`` int32 tensor of 32-bit limbs (this port's layout).

    This pair of functions is what carries state across the two packages:
    the system has no weights, its state is limb arrays.
    """
    a = np.asarray(a, dtype=np.uint32)
    assert a.shape[0] == 8, "expected the (8,)+S layout of 16-bit limbs"
    out = a[0::2] | (a[1::2] << np.uint32(16))  # (4,) + S
    return _u32_to_tensor(np.moveaxis(out, 0, -1), device)


def to_jax_limbs(t: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`from_jax_limbs`: S+(4,) int32 -> (8,)+S uint32."""
    w = np.moveaxis(_tensor_to_u32(t), -1, 0)  # (4,) + S
    out = np.empty((8,) + w.shape[1:], dtype=np.uint32)
    out[0::2] = w & np.uint32(0xFFFF)
    out[1::2] = w >> np.uint32(16)
    return out
