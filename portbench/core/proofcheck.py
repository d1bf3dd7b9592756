"""The check that decides ``correct``: a sample of the run's proofs, drawn
from the seed, proved again by the configuration's plain reference, and
every byte compared, section by section (limit 0: the proof is exact)."""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict

from ..reference.proof import compare
from .traffic import Sample


def compare_sample(cell, sample: Sample) -> Dict[str, dict]:
    totals: Dict[str, int] = {}
    for r in sorted(sample.kept, key=lambda r: r.id):
        t0 = time.perf_counter()
        want = cell.reference(r.slot, r.nonce)
        print(f"reference: request {r.id} proved again in {time.perf_counter() - t0:.3f} s", file=sys.stderr)
        for name, v in compare(r.blob, bytes(want.buf), want.sections()).items():
            totals[name] = totals.get(name, 0) + v
        del want
        gc.collect()
    checks = {"missing_proofs": {"value": sample.k - len(sample.kept), "limit": 0}}
    if "bytes" in totals:
        checks["diff_bytes"] = {"value": totals.pop("bytes"), "limit": 0}
    for name, v in totals.items():
        checks["diff_" + name] = {"value": v, "limit": 0}
    return checks
