"""Wrappers of the kernels that were redesigned, for comparison only.

``csrc/prev_sha256_words.cu`` (one contiguous message per thread, launched
once per Merkle level), ``csrc/prev_zm.cu`` (a 2^11-element tile run stage
by stage through shared memory, three passes at 2^22-2^24) and
``csrc/prev_kron.cu`` (one thread per output element, a division and two
loads each) stay compiled under their first symbols, and
``csrc/prev_round_scalars.cu`` (the rounds' Fiat-Shamir scalars on one
thread) under symbols of its own, so that ``chip_smoke.py``'s ``routes``
phase can time the routes they served - byte swap + concatenation + message
hash, a launch per tree level, three Moebius passes + gather + padded copy,
the tensor product, a round's scalars - beside the kernels that replaced
them, on the same card in the same run.  ``kron_parts`` launches the
current tensor-product kernel less one part (its stores alone, its
multiplies alone), so that the same phase can show what binds it.  Nothing
else imports this module and no prover path reaches it.  The functions
launch on CUDA tensors only and count no launches.
"""

from __future__ import annotations

import torch

from .sha256_cuda import limbs_to_words


def _call(symbol: str, device: torch.device, *args) -> None:
    from . import _build

    rc = _build.lib()[symbol](
        *args,
        device.index if device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {symbol} failed to launch (cudaError {rc})")


def sha256_words(msg_words: torch.Tensor) -> torch.Tensor:
    """(N, n_words) contiguous big-endian messages -> (N, 8) digests."""
    if msg_words.device.type != "cuda" or not msg_words.is_contiguous():
        raise ValueError("previous_routes.sha256_words: contiguous CUDA tensor expected")
    n, n_words = msg_words.shape
    out = torch.empty((n, 8), dtype=torch.int32, device=msg_words.device)
    _call("mlt_sha256_words", msg_words.device, msg_words.data_ptr(), out.data_ptr(), n, n_words)
    return out


def leaf_hashes(leaf_columns: torch.Tensor) -> torch.Tensor:
    """Byte-swapped copies of the columns, concatenated, then hashed."""
    B = leaf_columns.shape[0]
    msg = torch.cat([limbs_to_words(leaf_columns[b]) for b in range(B)], dim=-1)
    return sha256_words(msg)


def tree_levels(leaf_digests: torch.Tensor):
    """One launch and one allocation per level."""
    levels, cur = [], leaf_digests
    while cur.shape[0] > 1:
        cur = sha256_words(cur.reshape(cur.shape[0] // 2, 16))
        levels.append(cur)
    return levels


def zm_butterfly(x: torch.Tensor, add: bool) -> torch.Tensor:
    """Clone, then 11 + 9 + ... bits a pass in place."""
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError("previous_routes.zm_butterfly: contiguous CUDA tensor expected")
    total, bits = x.numel() // 4, x.shape[-2].bit_length() - 1
    x = x.clone()
    for d, c, log_w in zm_passes(bits):
        _call("mlt_zm", x.device, x.data_ptr(), total, 1 << d, c, log_w, int(add))
    return x


def zm_passes(bits: int):
    """(first bit, bit count, log2 run width) of that kernel's passes: the
    tile's 11 bits first, then up to 9 a pass (rows of >= 4 elements)."""
    passes, d = [], 0
    while d < bits:
        c = min(9 if d else 11, bits - d)
        passes.append((d, c, 11 - c if d else 0))
        d += c
    return passes


def kron_mul(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """out[i * n + j] = a[i] * b[j] for contiguous (m, 4), (n, 4) and
    (m * n, 4) CUDA tensors, one thread per output element."""
    if any(t.device.type != "cuda" or not t.is_contiguous() for t in (a, b, out)):
        raise ValueError("previous_routes.kron_mul: contiguous CUDA tensors expected")
    m, n = a.numel() // 4, b.shape[0]
    if m * n >= 1 << 32:
        raise ValueError("previous_routes.kron_mul: the kernel indexes the output with 32 bits")
    _call("mlt_kron", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n)
    return out


def kron_parts(mode: str, a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``csrc/kron.cu``'s kernel less one part, on contiguous (m, 4), (n, 4),
    (m * n, 4) CUDA tensors with n <= 256: ``mode`` "stores" writes b[j] to
    every out[i * n + j] and multiplies nothing; "multiplies" computes every
    product and stores none (``out`` is left as it was)."""
    if any(t.device.type != "cuda" or not t.is_contiguous() for t in (a, b, out)) or b.shape[0] > 256:
        raise ValueError("previous_routes.kron_parts: contiguous CUDA tensors and n <= 256 expected")
    code = {"stores": 1, "multiplies": 2}[mode]
    _call("mlt_kron_parts", a.device, code, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel() // 4, b.shape[0])
    return out


def round_scalars_one_thread(state: torch.Tensor, scal: torch.Tensor, digest_out: torch.Tensor,
                             sums=None, root=None, elem=None, coeffs=None) -> None:
    """``device_transcript.round_scalars`` on one thread; CUDA tensors that
    the wrapper there has checked."""
    if state.device.type != "cuda":
        raise ValueError("previous_routes.round_scalars_one_thread: CUDA tensors expected")
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    _call("mlt_round_scalars_one_thread", state.device, ptr(state), ptr(root), ptr(elem), ptr(sums), ptr(scal),
          ptr(coeffs), ptr(digest_out))


def _sumcheck_round(symbol: str, state, prev, digest_out, sums, vinv, coeffs, r_out) -> None:
    if state.device.type != "cuda":
        raise ValueError(f"previous_routes: {symbol} takes CUDA tensors")
    _call(symbol, state.device, state.data_ptr(), sums.data_ptr(), vinv.data_ptr(), sums.shape[0],
          prev.data_ptr(), coeffs.data_ptr(), r_out.data_ptr(), digest_out.data_ptr())


def sumcheck_round_scalars_one_thread(state, prev, digest_out, sums, vinv, coeffs, r_out) -> None:
    """``device_transcript.sumcheck_round_scalars`` on one thread (total
    degrees up to 64 in the comparison; CUDA tensors as the wrapper there
    checks them)."""
    _sumcheck_round("mlt_sumcheck_round_scalars_one_thread", state, prev, digest_out, sums, vinv, coeffs, r_out)

