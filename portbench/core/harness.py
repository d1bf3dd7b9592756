"""One run of one cell: set-up, the measured window (or, with tracing, the
traced stretches), the check against the plain reference, the result line.

Set-up is everything from the process's start to the first timed proof: the
imports, the card's context, the program's kernels (built into the
program's own build folder inside the checkout on a checkout's first run,
loaded from it afterwards), the pool of inputs made from the seed, and the
cell's warm-up proofs.  The window then runs the closed loop for
``--seconds``.  Once it has closed and the peak memory has been read, the
pool is freed and the reference proves a sample of the window's requests
again, drawn from the seed; every byte of each sampled proof is compared.
"""

from __future__ import annotations

import gc
import json
import random
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import List

from . import devtrace, peaks, spec
from .inputs import mix
from .proofcheck import compare_sample
from .traffic import TRACE_PROOFS, WARMUP, ClosedLoop, Sample, percentile

# top-level modules the process that prints the result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "multilinear_tpu")
GIB = float(1 << 30)


def forbidden_modules() -> List[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


class Device:
    """The card, or (tests only) the CPU."""

    def __init__(self, device: str):
        import torch

        self.torch = torch
        self.cuda = torch.device(device).type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def reset_peak(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()
            self.torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return int(self.torch.cuda.max_memory_allocated()) if self.cuda else 0

    def info(self, chips: int) -> dict:
        if self.cuda:
            return {"platform": "gpu", "kind": self.torch.cuda.get_device_name(0), "count": chips}
        return {"platform": "cpu", "kind": "cpu", "count": 1}

    def release(self) -> None:
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()


def run_cell(workload: dict, config: dict, seed: int, seconds: float, trace: bool, device: str, t0: float,
             base: Path = spec.BENCH) -> dict:
    dev = Device(device)
    adapter = spec.adapter(config, base)
    t_imports = time.perf_counter()
    cell = adapter.Cell(workload, config, seed, device)
    dev.sync()
    t_pool = time.perf_counter()
    loop = ClosedLoop(cell.prove, dev.sync, workload["pool"], seed)
    warm = [loop.one() for _ in range(WARMUP)]
    dev.sync()
    print(f"set-up: {t_imports - t0:.3f} s to the adapter, {t_pool - t_imports:.3f} s the pool, warm-up proofs "
          + ", ".join(f"{r.latency:.3f}" for r in warm) + " s", file=sys.stderr)
    gc.collect()
    gc.freeze()  # the pool and the modules are not scanned again by every collection
    dev.reset_peak()
    setup_s = time.perf_counter() - t0
    sample = Sample(random.Random(mix(seed, "check")))
    if trace:
        requests, metrics, device_extra, breakdown = _traced(workload, base, cell, loop, sample, dev)
        extra = {"breakdown": breakdown}
    else:
        requests, window_s = loop.window(seconds, sample)
        done = [r.latency for r in requests if r.error is None]
        metrics = {"setup_s": {"value": setup_s, "unit": "s"},
                   "peak_device_gib": {"value": dev.peak() / GIB, "unit": "GiB"}}
        if done:  # a rate over all the window's time, a tail of all its proofs
            metrics["prove_s"] = {"value": window_s / len(done), "unit": "s"}
            metrics["prove_s_p95"] = {"value": percentile(done, 0.95), "unit": "s"}
            print(f"window: {len(done)} proofs in {window_s:.3f} s; latency min {min(done):.4f}, median "
                  f"{percentile(done, 0.5):.4f}, p95 {percentile(done, 0.95):.4f}, max {max(done):.4f} s",
                  file=sys.stderr)
        device_extra, extra = {}, {}
    peak = dev.peak()
    failed = sum(r.error is not None for r in warm + requests)
    cell.free()
    dev.release()
    checks = compare_sample(cell, sample)
    checks["failed_proofs"] = {"value": failed, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return {
        "correct": correct,
        "attempted": len(warm) + len(requests),
        "failed": failed,
        "metrics": metrics,
        "device": dict(dev.info(workload["chips"]), memory_peak_bytes=peak, **device_extra),
        **extra,
        "checks": checks,  # last: each number compared, beside its limit
    }


def _traced(workload: dict, base: Path, cell, loop: ClosedLoop, sample: Sample, dev: Device):
    """Two stretches of ``TRACE_PROOFS`` proofs each: one under the profiler
    (device operations; the program's phase timers off, since they
    synchronise), one with the phase timers on and no profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] if dev.cuda else [ProfilerActivity.CPU]
    with profile(activities=activities) as prof:
        dev.sync()
        t_a = time.perf_counter()
        traced = loop.stretch(TRACE_PROOFS, sample)
        dev.sync()
        window_s = time.perf_counter() - t_a
    ops = devtrace.from_profiler(prof) if dev.cuda else []
    del prof
    with cell.phases() as phases:
        timed = loop.stretch(TRACE_PROOFS, sample)
        phases = dict(phases)
    ctx = SimpleNamespace(
        workload=workload, config=cell.config, kind=dev.info(1)["kind"],
        ops=ops, window_s=window_s, proofs=sum(r.error is None for r in traced),
        phases=phases, phase_proofs=sum(r.error is None for r in timed),
    )
    metrics = {}
    for name in spec.metric_names(base):
        reader = spec.metric(name, base)
        value = reader.read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": reader.UNIT}
    busy = devtrace.busy_seconds(ops)
    extra = {"busy_s": busy, "window_s": window_s} if dev.cuda else {}
    breakdown = {"device_ops": devtrace.top(devtrace.seconds_by_name(ops)),
                 "idle_gaps": devtrace.top(devtrace.idle_gaps(ops))}
    return traced + timed, metrics, extra, breakdown


def main(args, t0: float, device: str = None, base: Path = spec.BENCH) -> int:
    """Run one cell and print its result line; the exit code."""
    workload = spec.workload(args.workload, base)
    config = spec.config(workload["config"], base)
    if device is None:
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
            print(f"no card: the cell {workload['name']} needs {workload['chips']} CUDA device(s), "
                  f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
        print(f"card: {peaks.power_limit()}", file=sys.stderr)
    result = run_cell(workload, config, args.seed, args.seconds, bool(args.trace), device, t0, base)
    bad = forbidden_modules()
    if bad:
        print(f"the process holds {', '.join(bad)}: the benchmark may not load JAX or the JAX package",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
