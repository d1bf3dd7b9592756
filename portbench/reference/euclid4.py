"""The constraints of the ``snark-euclid4`` configuration, on plain tensors:
v0^2 + v1^2 - v2^2 = 0 and v0 + v1 - v3 = 0 (degree 2), and the rows that
satisfy them over the whole field, (m^2 - n^2, 2mn, m^2 + n^2, a + b).

Nothing of the program under test is imported or read.
"""

from __future__ import annotations

import torch

from . import field as F

DEGREE = 2


def pythagorean(v, r):
    return F.sub(F.add(F.mul(v[0], v[0]), F.mul(v[1], v[1])), F.mul(v[2], v[2]))


def linear(v, r):
    return F.sub(F.add(v[0], v[1]), v[3])


CONSTRAINTS = [pythagorean, linear]


def rows(m: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(8, 4, h) columns from (8, h) uniform m and n."""
    m2, n2 = F.mul(m, m), F.mul(n, n)
    a, b = F.sub(m2, n2), F.mul(F.add(m, m), n)
    return torch.stack([a, b, F.add(m2, n2), F.add(a, b)], dim=1)
