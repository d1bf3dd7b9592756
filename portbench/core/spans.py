"""The program's spans in a profiler's trace, and the device's idle time and
its operations put to them.

The program opens a ``record_function`` range at each layer of a prove
(``multilinear_tpu_torch.utils.span``).  Under a profile with CPU and CUDA
activity each range is a user annotation on the host, on the same clock as
the device operations; the profiler also records, for each device operation,
the host call that launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``,
...), under the same correlation id.  So:

* every instant of the stretch in which no operation ran on the device is
  put to the outermost LAYER span open on the host at that instant, or to
  ``outside`` where none is (the harness between proofs): the parts sum to
  the stretch's idle time;
* every device operation is put to the innermost span open when its launch
  began, or to ``outside``.

The device's timestamps are not always on the host's clock: on an H100 they
can drift from it by up to 120 ms a second and jump back, so that operations
read as starting up to 53 ms before their launch, or up to 250 ms after it.  ``align`` reads the offset near each
launch from the operations that found the device idle and moves the
operations by it, and ``summary`` gives the idle time by layer with and
without that move.

The profile's own device-side copies of the annotations
(``gpu_user_annotation``) are neither busy time nor operations.  This module
imports nothing of the program under test.
"""

from __future__ import annotations

from bisect import bisect_right
from collections import Counter, defaultdict, deque
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from . import devtrace

# the program's layer spans, by the name of the layer they belong to
LAYERS = {"encode": "encode", "commit_l0": "commit", "commit_batch": "commit", "tables": "tables",
          "snark_tables": "tables", "rounds": "rounds", "sumcheck_rounds": "sumcheck_rounds",
          "queries": "queries", "serialize": "serialize"}
OUTSIDE = "outside"
# the annotation a caller opens around the traced stretch: the window
STRETCH = "portbench.stretch"
# the spans of one round, by the layer span that holds them
ROUNDS = {"rounds": "round", "sumcheck_rounds": "sumcheck_round"}
# ``align`` reads the device clock's offset at a launch from the launches this near it (s)
ALIGN_S = 0.01


@dataclass(frozen=True)
class Span:
    name: str
    start: float  # seconds, on the profiler's clock
    end: float
    parent: Optional[int]  # index of the enclosing span


@dataclass(frozen=True)
class DeviceOp:
    name: str
    start: float
    end: float
    launch: Optional[float]  # start of the host call that launched it, or None if the trace has none


@dataclass(frozen=True)
class Trace:
    spans: List[Span]
    ops: List[DeviceOp]
    window: Tuple[float, float]


def nest(marks: Iterable[Tuple[str, float, float]]) -> List[Span]:
    """(name, start, end) ranges of one thread, in start order, each with
    the index of the innermost range that holds it."""
    out: List[Span] = []
    open_: List[int] = []
    for name, a, b in sorted(marks, key=lambda m: (m[1], -m[2])):
        while open_ and out[open_[-1]].end <= a:
            open_.pop()
        out.append(Span(name, a, b, open_[-1] if open_ else None))
        open_.append(len(out) - 1)
    return out


def from_profiler(prof) -> Trace:
    """The spans, the device operations with their launches, and the window
    (the ``STRETCH`` annotation) of a finished ``torch.profiler.profile``
    with CPU and CUDA activity.  Reads the raw events: building
    ``prof.events()``' tree for a stretch takes longer than the stretch."""
    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()  # times from here: seconds since the epoch in a double lose the nanoseconds
    marks, ops, launches = [], [], {}
    for e in results.events():
        kind, a = e.device_type(), (e.start_ns() - t0) * 1e-9
        if e.is_user_annotation():
            if kind == cpu:
                marks.append((e.name(), a, (e.end_ns() - t0) * 1e-9))
        elif kind == cuda:
            ops.append((e.name(), a, (e.end_ns() - t0) * 1e-9, e.correlation_id()))
        elif kind == cpu and e.name().startswith("cu"):  # CUDA API calls: cudaLaunchKernel, cuLaunchKernel, ...
            launches[e.correlation_id()] = a
    windows = [(a, b) for name, a, b in marks if name == STRETCH]
    if len(windows) != 1:
        raise ValueError(f"the trace holds {len(windows)} {STRETCH!r} annotations, not one")
    spans = nest(m for m in marks if m[0] != STRETCH)
    return Trace(spans, sorted((DeviceOp(n, a, b, launches.get(c)) for n, a, b, c in ops), key=lambda o: o.start),
                 windows[0])


def layer_intervals(spans: Sequence[Span]) -> List[Tuple[float, float, str]]:
    """The outermost layer spans as (start, end, layer), in time order and
    made disjoint (a span that starts inside the previous one is cut to
    start where it ends)."""
    out: List[Tuple[float, float, str]] = []
    for s in spans:
        if s.name not in LAYERS or _has_layer_ancestor(spans, s):
            continue
        a = max(s.start, out[-1][1]) if out else s.start
        if a < s.end:
            out.append((a, s.end, LAYERS[s.name]))
    return out


def _has_layer_ancestor(spans: Sequence[Span], s: Span) -> bool:
    p = s.parent
    while p is not None:
        if spans[p].name in LAYERS:
            return True
        p = spans[p].parent
    return False


def idle_intervals(ops: Sequence[DeviceOp], window: Tuple[float, float]) -> List[Tuple[float, float]]:
    """The window less the union of the device's operations."""
    t0, t1 = window
    out, at = [], t0
    for a, b in devtrace.union([o for o in ops if o.end > t0 and o.start < t1]):
        if a > at:
            out.append((at, min(a, t1)))
        at = max(at, b)
    if at < t1:
        out.append((at, t1))
    return out


def idle_by_layer(spans: Sequence[Span], ops: Sequence[DeviceOp], window: Tuple[float, float]) -> Dict[str, float]:
    """Idle seconds of the window by layer (``LAYERS``' values and
    ``OUTSIDE``): each idle instant goes to the outermost layer span open at
    that instant, or to ``OUTSIDE``."""
    layers = layer_intervals(spans)
    out: Dict[str, float] = defaultdict(float)
    j = 0
    for a, b in idle_intervals(ops, window):
        while j < len(layers) and layers[j][1] <= a:
            j += 1
        at, k = a, j
        while k < len(layers) and layers[k][0] < b:
            la, lb, name = layers[k]
            if la > at:
                out[OUTSIDE] += la - at
            lo, hi = max(la, at), min(lb, b)
            out[name] += hi - lo
            at = hi
            k += 1
        if at < b:
            out[OUTSIDE] += b - at
    return dict(out)


def gaps_by_launch(spans: Sequence[Span], ops: Sequence[DeviceOp], window: Tuple[float, float]) -> Dict[str, float]:
    """Idle seconds of the window by the operation that ends each gap and
    the innermost span its launch came from ("<span> before <operation>";
    ``OUTSIDE`` for no span, "end" for the gap that closes the window): what
    the host was doing while the device waited for that operation."""
    starts = [s.start for s in spans]
    by_start = sorted(ops, key=lambda o: o.start)
    firsts = [o.start for o in by_start]
    out: Dict[str, float] = defaultdict(float)
    for a, b in idle_intervals(ops, window):
        j = bisect_right(firsts, b - 1e-12)
        if j == len(by_start) or b >= window[1]:
            out["end"] += b - a
            continue
        o = by_start[j]
        i = None if o.launch is None else innermost(spans, starts, o.launch)
        out[f"{OUTSIDE if i is None else spans[i].name} before {devtrace.short_name(o.name)}"] += b - a
    return dict(out)


def innermost(spans: Sequence[Span], starts: List[float], t: float) -> Optional[int]:
    """The index of the innermost span open at ``t`` (spans in start order,
    properly nested; ``starts`` their starts), or None."""
    i = bisect_right(starts, t) - 1
    while i is not None and i >= 0:
        if spans[i].end >= t:
            return i
        i = spans[i].parent
    return None


def ops_by_span(spans: Sequence[Span], ops: Sequence[DeviceOp]) -> Dict[str, int]:
    """Device operations by the name of the innermost span open when their
    launch began (``OUTSIDE``: none, or no launch in the trace)."""
    starts = [s.start for s in spans]
    out: Counter = Counter()
    for o in ops:
        i = None if o.launch is None else innermost(spans, starts, o.launch)
        out[OUTSIDE if i is None else spans[i].name] += 1
    return dict(out)


def align(ops: Sequence[DeviceOp]) -> Tuple[List[DeviceOp], List[float]]:
    """The device operations moved onto the host's clock, and each move (s).
    An operation that finds the device idle starts a few microseconds after
    its launch, and most do (the device idles most of the time), so the
    least start - launch among the operations launched within ``ALIGN_S`` of
    an operation's launch reads the device clock's offset there, early or
    late.  Each operation is moved by minus that, keeping its length, so
    none starts before its launch; one without a launch stays.  It errs
    where the offset drifts, by the drift over ``ALIGN_S`` and over the
    operation's wait in the queue; late by the change for operations
    within ``ALIGN_S`` of a step of the offset; and early where no operation
    within ``ALIGN_S`` found the device idle."""
    launched = sorted((o for o in ops if o.launch is not None), key=lambda o: o.launch)
    lags = [o.start - o.launch for o in launched]
    out, moves = [o for o in ops if o.launch is None], []
    least: deque = deque()  # indices of the launches within ALIGN_S, their lags rising
    j = 0
    for o in launched:
        while j < len(launched) and launched[j].launch <= o.launch + ALIGN_S:
            while least and lags[least[-1]] >= lags[j]:
                least.pop()
            least.append(j)
            j += 1
        while launched[least[0]].launch < o.launch - ALIGN_S:
            least.popleft()
        d = -lags[least[0]]
        out.append(DeviceOp(o.name, o.start + d, o.end + d, o.launch))
        moves.append(d)
    return sorted(out, key=lambda o: o.start), moves


def _idle(spans: Sequence[Span], ops: Sequence[DeviceOp], window: Tuple[float, float]):
    """The operations that run in the window, the idle seconds by layer, and the busy seconds."""
    t0, t1 = window
    inside = [o for o in ops if o.end > t0 and o.start < t1]
    busy = devtrace.busy_seconds([devtrace.Op(o.name, max(o.start, t0), min(o.end, t1)) for o in inside])
    return inside, idle_by_layer(spans, inside, window), busy


def _quantiles(values: List[float], qs: Sequence[float]) -> List[float]:
    s = sorted(values)
    return [s[int(q * (len(s) - 1))] for q in qs] if s else []


def summary(trace: Trace, proofs: int) -> dict:
    """The per-layer readings of one traced stretch of ``proofs`` proofs:
    ``idle_ms`` (ms a proof, by layer, after ``align``; a layer whose spans
    the trace lacks is left out), ``idle_ms_unaligned`` (the same on the
    device's own timestamps), ``launches_per_round`` (device operations
    launched in a round span per such span, by the layer span that holds the
    rounds), ``ops_by_span``, ``span_ms`` (the host's ms a proof in the spans
    of each name, children included), ``gaps_ms`` (the largest parts of
    ``gaps_by_launch``, ms a proof), and the numbers that check the
    attribution: the idle parts against the idle time, the operations put
    somewhere against those the stretch launched, and the device clock's
    departure from the host's (operations that start before their launch,
    quantiles of start - launch, and of ``align``'s moves)."""
    spans, (t0, t1) = trace.spans, trace.window
    ops, moves = align(trace.ops)
    inside, idle, busy = _idle(spans, ops, trace.window)
    raw_idle = _idle(spans, trace.ops, trace.window)[1]
    seen = {LAYERS[s.name] for s in spans if s.name in LAYERS} | {OUTSIDE}
    # the stretch's operations are those it launched (the host's clock), wherever the device ran them
    launched = [o for o in ops if o.launch is not None and t0 <= o.launch <= t1]
    by_span = ops_by_span(spans, launched)
    names = Counter(s.name for s in spans)
    lags = [1e6 * (o.start - o.launch) for o in trace.ops if o.launch is not None]
    return {
        "idle_ms": {k: 1e3 * idle.get(k, 0.0) / proofs for k in sorted(seen)},
        "idle_ms_unaligned": {k: 1e3 * raw_idle.get(k, 0.0) / proofs for k in sorted(seen)},
        "launches_per_round": {layer: by_span.get(r, 0) / names[r] for layer, r in ROUNDS.items() if names[r]},
        "ops_by_span": dict(sorted(by_span.items())),
        "span_ms": {n: 1e3 * sum(x.end - x.start for x in spans if x.name == n) / proofs for n in sorted(names)},
        "gaps_ms": [[k, 1e3 * v / proofs] for k, v in devtrace.top(gaps_by_launch(spans, inside, trace.window), 8)],
        "checks": {
            "window_s": t1 - t0, "busy_s": busy, "idle_s": t1 - t0 - busy, "idle_parts_s": sum(idle.values()),
            "ops_in_trace": len(ops), "ops": len(launched), "ops_attributed": sum(by_span.values()),
            "ops_launched_outside": [[devtrace.short_name(o.name), o.launch - t0, o.start - t0] for o in ops
                                     if o.launch is not None and not t0 <= o.launch <= t1][:3],
            "ops_without_launch": sum(o.launch is None for o in inside),
            "ops_before_launch": sum(lag < 0 for lag in lags),
            "launch_lag_us": _quantiles(lags, (0, 0.01, 0.1, 0.5, 0.9, 1)),
            "align_us": _quantiles([1e6 * m for m in moves], (0, 0.01, 0.5, 0.99, 1)),
            "spans": dict(sorted(names.items())),
        },
    }
