"""The closed loop: one proof in flight.  Request i proves pool slot
i mod (pool size) with a transcript that starts with its own nonce, so no
two requests have the same proof; the next request starts when the previous
one's proof bytes are on the host.

A workload file's traffic parameters are ``log_n``, the size of a proof
(read by the configuration's adapter), and ``pool``, the inputs made in
set-up and cycled.  What is the same for every cell is set here.
"""

from __future__ import annotations

import math
import random
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Callable, List, Optional

from .inputs import nonce

WARMUP = 2  # proofs made in set-up, before the window
TRACE_PROOFS = 20  # proofs in each traced stretch of a ``--trace 1`` run
CHECK = 1  # proofs of a run that the reference proves again


@dataclass
class Request:
    id: int
    slot: int
    nonce: bytes
    latency: float = 0.0
    blob: Optional[bytes] = None
    error: Optional[str] = None


class Sample:
    """``k`` of the proofs offered, drawn uniformly from all of them by the
    seed's stream (a reservoir), so the window keeps the bytes of those
    alone and not of every proof it made."""

    def __init__(self, rng: random.Random, k: int = CHECK):
        self.rng, self.k, self.seen = rng, k, 0
        self.kept: List[Request] = []

    def offer(self, r: Request) -> None:
        if r.blob is None:
            return
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(r)
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.kept[j].blob, self.kept[j] = None, r
        else:
            r.blob = None


class ClosedLoop:
    def __init__(self, prove: Callable[[int, bytes], bytes], sync: Callable[[], None], pool: int, seed: int):
        self.prove, self.sync, self.pool, self.seed = prove, sync, pool, seed
        self.next_id = 0

    def one(self) -> Request:
        i = self.next_id
        self.next_id += 1
        r = Request(i, i % self.pool, nonce(self.seed, i))
        t0 = time.perf_counter()
        try:
            r.blob = self.prove(r.slot, r.nonce)
            self.sync()
        except Exception:  # a proof that fails is counted, and the loop goes on
            r.error = traceback.format_exc()
            print(f"request {i} failed:\n{r.error}", file=sys.stderr)
        r.latency = time.perf_counter() - t0
        return r

    def window(self, seconds: float, sample: Sample):
        """Requests back to back until ``seconds`` have passed; returns them
        and the window's length, from the first start to the last end."""
        done: List[Request] = []
        start = time.perf_counter()
        while True:
            done.append(self.one())
            sample.offer(done[-1])
            end = time.perf_counter()
            if end - start >= seconds:
                return done, end - start

    def stretch(self, n: int, sample: Sample):
        done: List[Request] = []
        for _ in range(n):
            done.append(self.one())
            sample.offer(done[-1])
        return done


def percentile(values: List[float], q: float) -> float:
    """Nearest rank: the smallest value with at least q of all at or below it."""
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]
