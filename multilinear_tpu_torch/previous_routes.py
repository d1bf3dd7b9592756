"""Wrappers of the two kernels that were redesigned, for comparison only.

``csrc/prev_sha256_words.cu`` (one contiguous message per thread, launched
once per Merkle level) and ``csrc/prev_zm.cu`` (a 2^11-element tile run stage
by stage through shared memory, three passes at 2^22-2^24) stay compiled
under their first symbols so that ``chip_smoke.py``'s ``routes`` phase can
time the routes they served - byte swap + concatenation + message hash, a
launch per tree level, three Moebius passes + gather + padded copy - beside
the kernels that replaced them, on the same card in the same run.  Nothing
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
