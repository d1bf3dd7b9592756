"""Reading a profiler's device trace: the intervals in which an operation
ran on the device, their union, the idle gaps between them, and device
time by operation name.

The profiler gives each device operation (a kernel, a copy, a memset) a
start and an end.  Busy time is the length of the UNION of those intervals,
not their sum: the two agree only while one operation runs at a time.

This module imports nothing of the program under test.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple


@dataclass(frozen=True)
class Op:
    name: str
    start: float  # seconds, on the profiler's clock
    end: float


def from_profiler(prof) -> List[Op]:
    """The device operations of a finished ``torch.profiler.profile``."""
    import torch

    ops = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ops.append(Op(e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6))
    ops.sort(key=lambda o: o.start)
    return ops


def union(ops: Sequence[Op]) -> List[Tuple[float, float]]:
    """The busy intervals: overlapping operations merged, in time order."""
    out: List[List[float]] = []
    for o in sorted(ops, key=lambda o: o.start):
        if out and o.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], o.end)
        else:
            out.append([o.start, o.end])
    return [(a, b) for a, b in out]


def busy_seconds(ops: Sequence[Op]) -> float:
    return sum(b - a for a, b in union(ops))


def short_name(name: str) -> str:
    """A kernel's name without its argument list or template arguments."""
    base = re.split(r"[(<]", name.replace("(anonymous namespace)::", ""), maxsplit=1)[0].strip()
    return (base.split()[-1] if base else name)[:80]


def seconds_by_name(ops: Sequence[Op]) -> Dict[str, float]:
    out: Dict[str, float] = defaultdict(float)
    for o in ops:
        out[short_name(o.name)] += o.end - o.start
    return dict(out)


def calls(ops: Sequence[Op], name: str) -> List[Op]:
    """The operations whose short name is ``name``."""
    return [o for o in ops if short_name(o.name) == name]


def idle_gaps(ops: Sequence[Op]) -> Dict[str, float]:
    """Idle time between busy intervals, summed by the operation that ends
    the gap ("before <name>"): the launch the device was waiting for."""
    busy = union(ops)
    starts = sorted(ops, key=lambda o: o.start)
    out: Dict[str, float] = defaultdict(float)
    j = 0
    for (a0, b0), (a1, _) in zip(busy, busy[1:]):
        while j < len(starts) and starts[j].start < a1:
            j += 1
        nxt = starts[j] if j < len(starts) else starts[-1]
        out["before " + short_name(nxt.name)] += a1 - b0
    return dict(out)


def top(d: Dict[str, float], k: int = 10) -> List[List]:
    return [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:k]]
