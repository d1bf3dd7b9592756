"""The Fiat-Shamir transcript on the prover's device.

Counterpart of the JAX package's ``device_transcript.py``.  The host
transcript (:mod:`.transcript`) is the protocol's source of truth; its
midstate hops INTO a small device tensor before the rounds of a prove, the
rounds absorb their roots and round polynomials and draw their challenges
there (:func:`round_scalars`, one launch of ``csrc/round_scalars.cu`` a
round), and afterwards the host replays the same absorbs and checks the
digest the device computed.  No round waits for the host.

State: one int32 tensor of ``STATE_WORDS`` = 26 words - 8 SHA-256 chaining
words, the 64-byte partial block as 16 big-endian words (zero at and past
the fill), the fill in bytes and the total length in bytes.  Any byte
fill is taken: any midstate hops, whatever the host absorbed before (the
JAX package's device transcript takes word-aligned midstates only).  The
kernels absorb whole 32-bit words, shifted into place when the fill is not
a multiple of 4.

The standalone sumcheck (``sumcheck.DeviceSumcheckRounds``) has rounds of
its own schedule - no roots, any total degree, interpolation through
V^-1 - and a second entry of the same kernel source,
:func:`sumcheck_round_scalars`.  Its plain version takes any degree; the
kernel (one block) takes any degree whose round fits in a block's shared
memory (:func:`sumcheck_degree_limit`, in the thousands on an H100).

The functions here are plain Python over that tensor - what the CPU runs,
and what the kernels are held against.  ``round_scalars`` and
``sumcheck_round_scalars`` are the kernels' wrappers: a CUDA tensor launches
the kernel (or raises; each launch is counted in ``stats`` under
``launch.`` and the kernel's name), a CPU tensor runs the ``*_plain`` version.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np
import torch

from . import stats
from .field import limbs, ops
from .field.scalar import P, TWO_INV
from .transcript import Sha256Midstate, Transcript

STATE_WORDS = 26
_FILL, _TOTAL = 24, 25

class TranscriptMismatch(RuntimeError):
    """The host's replay of the device's absorbs does not reach the digest
    the device computed."""


# ---------------------------------------------------------------------------
# the state tensor
# ---------------------------------------------------------------------------


def _pack(mid: Sha256Midstate, device) -> torch.Tensor:
    if mid.total >= 1 << 32:
        raise ValueError("a device transcript holds at most 2^32 - 1 absorbed bytes")
    words = mid.st + list(struct.unpack(">16I", mid.buf.ljust(64, b"\0"))) + [len(mid.buf), mid.total]
    return limbs.to_device(torch.from_numpy(np.array(words, dtype=np.uint32).view(np.int32)), device)


def _unpack(state: torch.Tensor) -> Sha256Midstate:
    w = state.detach().cpu().numpy().view(np.uint32).tolist()
    fill = w[_FILL]
    return Sha256Midstate(w[:8], struct.pack(">16I", *w[8:24])[:fill], w[_TOTAL])


def fresh_state(device="cpu") -> torch.Tensor:
    """The state of an empty transcript."""
    return _pack(Sha256Midstate(), device)


def state_from_host(transcript: Transcript, device="cpu") -> torch.Tensor:
    """Export a host transcript's midstate into a device state; the copy to
    a card does not make the host wait."""
    return _pack(Sha256Midstate(*transcript.export_state()), device)


def state_to_host(state: torch.Tensor) -> Transcript:
    """A host transcript that continues from a device state."""
    return Transcript.import_state(*_unpack(state).export())


def absorb(state: torch.Tensor, data) -> torch.Tensor:
    """A new state with ``data`` (bytes, or a uint8 tensor) absorbed."""
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy().tobytes()
    mid = _unpack(state)
    mid.update(data)
    return _pack(mid, state.device)


def absorb_field(state: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Absorb one (4,) field element as its 16 little-endian bytes (Q9)."""
    return absorb(state, limbs.to_le_bytes(x))


def absorb_words(state: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
    """Absorb int32 words as their big-endian bytes (a root's digest words)."""
    return absorb(state, words.detach().cpu().numpy().astype(">u4").tobytes())


def digest(state: torch.Tensor) -> bytes:
    """32 digest bytes of a finalized clone; the state does not advance (Q1)."""
    return _unpack(state).digest()


def challenge(state: torch.Tensor) -> torch.Tensor:
    """next_challenge: the first 16 digest bytes as a little-endian u128, mod
    p, as a (4,) field element on the state's device."""
    return limbs.pack_int(int.from_bytes(digest(state)[:16], "little") % P, device=state.device)


# ---------------------------------------------------------------------------
# one round's scalars: the kernel and its plain version
# ---------------------------------------------------------------------------


def round_scalars_plain(state, scal, digest_out, sums=None, root=None, elem=None, coeffs=None) -> None:
    """What one launch of ``csrc/round_scalars.cu`` does, in place.

    With ``sums`` ((2, 4) int64 unreduced limb sums of s(1), s(2)): absorb
    ``root`` ((8,) digest words) if given, reduce the sums, interpolate
    s0 = prev - s1, c2 = (s2 - 2 s1 + s0) / 2, c1 = s1 - s0 - c2, absorb c1
    and c2, draw r; write c1, c2 into ``coeffs`` (2, 4) and
    prev' = s0 + r (c1 + r c2), r, r / 2 into ``scal`` (3, 4), whose row 0
    holds prev on entry.  With ``elem`` instead: absorb ``elem[0]``.  Both
    write the digest of the new state into ``digest_out`` (8,)."""
    mid = _unpack(state)
    if sums is not None:
        if root is not None:
            mid.update(root.detach().cpu().numpy().astype(">u4").tobytes())
        s1, s2 = (ops.limb_sums_to_int(lanes) for lanes in sums.detach().cpu().tolist())
        s0 = (limbs.unpack_int(scal[0]) - s1) % P
        c2 = (s2 - 2 * s1 + s0) * TWO_INV.v % P
        c1 = (s1 - s0 - c2) % P
        mid.update(c1.to_bytes(16, "little") + c2.to_bytes(16, "little"))
        d = mid.digest()
        r = int.from_bytes(d[:16], "little") % P
        prev = (s0 + r * (c1 + r * c2)) % P
        scal.copy_(limbs.pack_ints([prev, r, r * TWO_INV.v % P]))
        coeffs.copy_(limbs.pack_ints([c1, c2]))
    else:
        mid.update(limbs.to_le_bytes(elem.reshape(-1, 4)[0]))
        d = mid.digest()
    digest_out.copy_(torch.from_numpy(np.frombuffer(d, dtype=">u4").astype(np.uint32).view(np.int32)))
    state.copy_(_pack(mid, "cpu"))


def _check(name: str, t, dtype, shape) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"round_scalars: {name} must be a {dtype} tensor of shape {shape}, got "
                         f"{getattr(t, 'dtype', type(t).__name__)} {tuple(getattr(t, 'shape', ()))}")
    if not t.is_contiguous():
        raise ValueError(f"round_scalars: {name} must be contiguous")


def round_scalars(state: torch.Tensor, scal: torch.Tensor, digest_out: torch.Tensor,
                  sums: Optional[torch.Tensor] = None, root: Optional[torch.Tensor] = None,
                  elem: Optional[torch.Tensor] = None, coeffs: Optional[torch.Tensor] = None) -> None:
    """One round's Fiat-Shamir scalars (or the last element's absorb), in
    place on the device that holds ``state``; arguments as in
    :func:`round_scalars_plain`.  Exactly one of ``sums`` (with ``coeffs``,
    and ``root`` if a tree's root is pending) and ``elem`` is given."""
    if (sums is None) == (elem is None) or (sums is None) != (coeffs is None) or (root is not None and sums is None):
        raise ValueError("round_scalars: give sums and coeffs (and maybe root), or elem alone")
    _check("state", state, torch.int32, (STATE_WORDS,))
    _check("scal", scal, torch.int32, (3, 4))
    _check("digest_out", digest_out, torch.int32, (8,))
    if sums is not None:
        _check("sums", sums, torch.int64, (2, 4))
        _check("coeffs", coeffs, torch.int32, (2, 4))
    if root is not None:
        _check("root", root, torch.int32, (8,))
    if elem is not None:
        if not isinstance(elem, torch.Tensor) or elem.dtype != torch.int32 or elem.dim() != 2 or \
                elem.shape[-1] != 4 or elem.shape[0] < 1 or not elem.is_contiguous():
            raise ValueError("round_scalars: elem must be a contiguous (n, 4) int32 field tensor")
    given = [t for t in (state, scal, digest_out, sums, root, elem, coeffs) if t is not None]
    if any(t.device != state.device for t in given):
        raise ValueError("round_scalars: every tensor must lie on the state's device")
    if state.device.type == "cpu":
        round_scalars_plain(state, scal, digest_out, sums=sums, root=root, elem=elem, coeffs=coeffs)
        return
    if state.device.type != "cuda":
        raise ValueError(f"round_scalars: unsupported device {state.device}")
    from . import _build

    ptr = (lambda t: t.data_ptr() if t is not None else None)
    device = state.device
    rc = _build.lib()["mlt_round_scalars"](
        ptr(state), ptr(root), ptr(elem), ptr(sums), ptr(scal), ptr(coeffs), ptr(digest_out),
        device.index if device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"CUDA kernel round_scalars failed to launch (cudaError {rc})")
    stats.bump("launch.round_scalars")


# ---------------------------------------------------------------------------
# a standalone sumcheck round's scalars: the kernel and its plain version
# ---------------------------------------------------------------------------


def sumcheck_round_scalars_plain(state, prev, digest_out, sums, vinv, coeffs, r_out) -> None:
    """What one launch of ``csrc/round_scalars.cu``'s standalone entry does,
    in place: reduce the d unreduced limb sums ``sums`` ((d, 4) int64) of
    s(1)..s(d), s0 = prev - s1 with prev in ``prev`` ((4,)), the coefficients
    c0 = s0 and c1..cd = rows 1..d of V^-1 (s0..sd) with V^-1 in ``vinv``
    ((d+1, d+1, 4); its row 0 is e0), absorb c1..cd (Q7, Q9), draw r; write
    c1..cd into ``coeffs`` (d, 4), prev' = p(r) into ``prev``, r into
    ``r_out`` (4,) and the digest into ``digest_out`` (8,)."""
    mid = _unpack(state)
    ev = [ops.limb_sums_to_int(lanes) for lanes in sums.detach().cpu().tolist()]
    ev = [(limbs.unpack_int(prev) - ev[0]) % P] + ev
    n = len(ev)
    vi = limbs.unpack_ints(vinv)
    c = [ev[0]] + [sum(int(vi[j, i]) * ev[i] for i in range(n)) % P for j in range(1, n)]
    mid.update(b"".join(x.to_bytes(16, "little") for x in c[1:]))
    d = mid.digest()
    r = int.from_bytes(d[:16], "little") % P
    acc = 0
    for x in reversed(c):
        acc = (acc * r + x) % P
    prev.copy_(limbs.pack_int(acc))
    r_out.copy_(limbs.pack_int(r))
    coeffs.copy_(limbs.pack_ints(c[1:]))
    digest_out.copy_(torch.from_numpy(np.frombuffer(d, dtype=">u4").astype(np.uint32).view(np.int32)))
    state.copy_(_pack(mid, "cpu"))


_DEGREE_LIMITS: dict = {}


def sumcheck_degree_limit(device) -> Optional[int]:
    """The largest total degree :func:`sumcheck_round_scalars` takes on
    ``device``: None (no limit) on the CPU, and on a card the most that one
    block's shared memory holds, 16 (d + 1) bytes of evaluations and as many
    of coefficients (asked of the card once)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _DEGREE_LIMITS:
        from . import _build

        limit = _build.lib()["mlt_sumcheck_max_degree"](index)
        if limit < 1:
            raise RuntimeError(f"the shared memory of card {index} could not be read")
        _DEGREE_LIMITS[index] = limit
    return _DEGREE_LIMITS[index]


def sumcheck_round_scalars(state: torch.Tensor, prev: torch.Tensor, digest_out: torch.Tensor,
                           sums: torch.Tensor, vinv: torch.Tensor, coeffs: torch.Tensor,
                           r_out: torch.Tensor) -> None:
    """One standalone sumcheck round's Fiat-Shamir scalars, in place on the
    device that holds ``state``; arguments as in
    :func:`sumcheck_round_scalars_plain`.  The total degree d is
    ``sums.shape[0]``, at least 1 and at most :func:`sumcheck_degree_limit`
    of the state's device."""
    d = sums.shape[0] if isinstance(sums, torch.Tensor) and sums.dim() == 2 else 0
    if d < 1:
        raise ValueError(f"sumcheck_round_scalars: the total degree must be at least 1, "
                         f"got sums of shape {tuple(getattr(sums, 'shape', ()))}")
    _check("state", state, torch.int32, (STATE_WORDS,))
    _check("prev", prev, torch.int32, (4,))
    _check("digest_out", digest_out, torch.int32, (8,))
    _check("sums", sums, torch.int64, (d, 4))
    _check("vinv", vinv, torch.int32, (d + 1, d + 1, 4))
    _check("coeffs", coeffs, torch.int32, (d, 4))
    _check("r_out", r_out, torch.int32, (4,))
    if any(t.device != state.device for t in (prev, digest_out, sums, vinv, coeffs, r_out)):
        raise ValueError("sumcheck_round_scalars: every tensor must lie on the state's device")
    if state.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sumcheck_round_scalars: unsupported device {state.device}")
    limit = sumcheck_degree_limit(state.device)
    if limit is not None and d > limit:
        raise ValueError(f"sumcheck_round_scalars: a round of total degree {d} needs {32 * (d + 1)} bytes of "
                         f"shared memory; a block of this card holds a round of degree {limit} at most")
    if state.device.type == "cpu":
        sumcheck_round_scalars_plain(state, prev, digest_out, sums, vinv, coeffs, r_out)
        return
    from . import _build

    device = state.device
    rc = _build.lib()["mlt_sumcheck_round_scalars"](
        state.data_ptr(), sums.data_ptr(), vinv.data_ptr(), d, prev.data_ptr(), coeffs.data_ptr(),
        r_out.data_ptr(), digest_out.data_ptr(),
        device.index if device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"CUDA kernel sumcheck_round_scalars failed to launch (cudaError {rc})")
    stats.bump("launch.sumcheck_round_scalars")
