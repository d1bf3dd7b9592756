"""Inputs made from ``--seed``: every stream of random numbers is keyed by
the seed and a label (the pool slot, the check), so one slot can be made
again alone and the same seed always gives the same inputs.

Field elements are made on the device by a ``torch.Generator`` in the
program's layout: a (..., 4) int32 tensor of little-endian 32-bit limbs.
"""

from __future__ import annotations

import hashlib
import random
import struct
from typing import List

import torch

from ..reference.field import P


def mix(seed: int, *labels) -> int:
    """A 63-bit number from the seed and labels (any size of seed)."""
    h = hashlib.sha256(repr((int(seed),) + labels).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, *labels, device="cpu") -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(mix(seed, *labels))
    return g


def uniform(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform residues mod p as shape + (4,) int32 limbs.  A top limb of all
    ones, the only one that could reach p (probability 2^-32), is lowered by
    one, so every value is canonical."""
    raw = torch.randint(0, 1 << 32, tuple(shape) + (4,), generator=gen, device=device, dtype=torch.int64)
    top = raw[..., 3]
    raw[..., 3] = torch.where(top == 0xFFFFFFFF, top - 1, top)
    return (raw - ((raw >> 31) << 32)).to(torch.int32)


def point(seed: int, *labels, n: int) -> List[int]:
    """n uniform field elements, on the host."""
    rng = random.Random(mix(seed, *labels))
    out = []
    while len(out) < n:
        v = rng.getrandbits(128)
        if v < P:
            out.append(v)
    return out


def nonce(seed: int, request: int) -> bytes:
    """The bytes a request's transcript starts with: the run's session, then
    the request's number."""
    return struct.pack("<QQ", mix(seed, "session"), request)
