"""Put a cell's device idle time and device operations to the program's
spans, on the card: ``run.py --trace 1`` with one traced stretch more.

    python3 portbench/trace_spans.py --workload <cell> --seed <n>

The run is ``harness.main``'s with ``--trace 1``: set-up, ``_traced``'s two
stretches and its metrics, the check against the reference, the result
line.  After ``_traced``'s two stretches it runs a third of as many proofs,
under a profile with CPU and CUDA activity and inside a ``spans.STRETCH``
annotation, and reads it with ``core/spans.py``; the result line holds that
under ``breakdown.spans``: idle ms a proof by layer (with and without
``spans.align``), device operations a round, the checks of the attribution,
``on_cost`` (the stretch's mean latency against the first stretch's, less
1) and ``span_off_ns`` (an unobserved span: its two flag tests).  The third
stretch's proofs join the sample that the reference checks.  A change to
the benchmark that gives ``harness._traced`` this stretch deletes this file.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import timeit  # noqa: E402
from contextlib import contextmanager  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.core import harness  # noqa: E402


def _span_stretch(dev, loop, sample):
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from portbench.core import spans

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.cuda else [])
    with profile(activities=activities) as prof:
        dev.sync()
        t = time.perf_counter()
        with record_function(spans.STRETCH):
            done = loop.stretch(harness.TRACE_PROOFS, sample)
            dev.sync()
        wall = time.perf_counter() - t
    t = time.perf_counter()
    trace = spans.from_profiler(prof)
    proofs = sum(r.error is None for r in done)
    return done, {"wall_s": wall, "proofs": proofs, "read_s": time.perf_counter() - t,
                  **spans.summary(trace, proofs)}


def _span_off_ns() -> float:
    from multilinear_tpu_torch.utils import span

    def unobserved():
        with span("round"):
            pass

    reps = 100_000
    return 1e9 * min(timeit.repeat(unobserved, number=reps, repeat=5)) / reps


def _mean_latency(requests) -> float:
    done = [r.latency for r in requests if r.error is None]
    return sum(done) / len(done)


@contextmanager
def span_stretch_added():
    """``harness._traced`` followed by the span stretch, while open."""
    traced = harness._traced

    def with_spans(workload, base, cell, loop, sample, dev):
        requests, metrics, extra, breakdown = traced(workload, base, cell, loop, sample, dev)
        done, out = _span_stretch(dev, loop, sample)
        out["on_cost"] = _mean_latency(done) / _mean_latency(requests[:harness.TRACE_PROOFS]) - 1
        out["span_off_ns"] = _span_off_ns()
        return requests + done, metrics, extra, dict(breakdown, spans=out)

    harness._traced = with_spans
    try:
        yield
    finally:
        harness._traced = traced


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="the cell: a file workloads/<cell>.json")
    p.add_argument("--seed", type=int, required=True, help="makes the inputs and picks the proofs checked")
    args = p.parse_args(argv)
    args.seconds, args.trace = 0.0, 1
    with span_stretch_added():
        return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
