"""The attribution of ``core/spans.py`` on made-up traces, and one traced
stretch of each cell on the CPU at 2^4 through ``trace_spans.py``."""

import time
from types import SimpleNamespace

import pytest

from portbench.core import spans, spec
from portbench.core.spans import OUTSIDE, DeviceOp, Trace

CELLS = ["pcs.seg2p24", "snark-euclid4.shard2p22"]


def _op(a, b, launch=None, name="k"):
    return DeviceOp(name, a, b, launch)


def test_nesting_by_containment():
    s = spans.nest([("rounds", 2.0, 6.0), ("proof", 0.0, 10.0), ("round", 2.0, 3.0), ("round", 3.0, 4.0),
                    ("queries", 7.0, 9.0)])
    assert [(x.name, s[x.parent].name if x.parent is not None else None) for x in s] == [
        ("proof", None), ("rounds", "proof"), ("round", "rounds"), ("round", "rounds"), ("queries", "proof")]


def test_the_idle_partition_sums_to_the_idle_time():
    s = spans.nest([("proof", 1.0, 9.0), ("encode", 1.0, 3.0), ("rounds", 3.0, 6.0), ("queries", 6.0, 8.5),
                    ("serialize", 9.5, 10.0)])
    ops = [_op(1.5, 2.0), _op(4.0, 5.0), _op(4.5, 5.5), _op(8.0, 9.2)]
    idle = spans.idle_by_layer(s, ops, (0.0, 10.0))
    busy = 0.5 + 1.5 + 1.2
    assert sum(idle.values()) == pytest.approx(10.0 - busy)
    assert idle == pytest.approx({"encode": 1.5, "rounds": 1.5, "queries": 2.0, "serialize": 0.5,
                                  OUTSIDE: 1.0 + 0.3})


def test_a_device_annotation_is_neither_busy_time_nor_a_launch():
    """A CUDA-typed user annotation (``gpu_user_annotation``) of a profile
    with CPU and CUDA activity: read as neither."""
    torch = pytest.importorskip("torch")
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    class Event:
        def __init__(self, name, kind, a, b, corr, ua=False):
            self.v = dict(name=name, kind=kind, a=a, b=b, corr=corr, ua=ua)

        def name(self):
            return self.v["name"]

        def device_type(self):
            return self.v["kind"]

        def start_ns(self):
            return self.v["a"]

        def end_ns(self):
            return self.v["b"]

        def correlation_id(self):
            return self.v["corr"]

        def is_user_annotation(self):
            return self.v["ua"]

    events = [Event(spans.STRETCH, cpu, 1000, 9000, 1, True), Event("rounds", cpu, 2000, 6000, 2, True),
              Event("rounds", cuda, 2500, 8000, 2, True),  # the device's copy of the span
              Event("cudaLaunchKernel", cpu, 2100, 2200, 77), Event("kern", cuda, 3000, 4000, 77),
              Event("aten::mul", cpu, 2050, 2300, 77)]  # an operator whose id is the launch's
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: events, trace_start_ns=lambda: 1000)))
    trace = spans.from_profiler(prof)
    assert [o.name for o in trace.ops] == ["kern"] and trace.ops[0].launch == pytest.approx(1.1e-6)
    assert [s.name for s in trace.spans] == ["rounds"] and trace.window == pytest.approx((0.0, 8e-6))
    out = spans.summary(trace, proofs=1)
    assert out["checks"]["busy_s"] == pytest.approx(1e-6) and out["checks"]["ops"] == 1
    assert out["ops_by_span"] == {"rounds": 1}
    assert out["checks"]["idle_parts_s"] == pytest.approx(7e-6)


def test_a_launch_outside_every_span_goes_outside():
    s = spans.nest([("proof", 0.0, 5.0), ("encode", 0.0, 2.0)])
    ops = [_op(1.0, 1.5, launch=0.5), _op(6.0, 7.0, launch=5.5), _op(8.0, 9.0, launch=None)]
    assert spans.ops_by_span(s, ops) == {"encode": 1, OUTSIDE: 2}


def test_nested_spans_give_idle_to_the_outer_layer_and_launches_to_the_inner_span():
    s = spans.nest([("proof", 0.0, 10.0), ("queries", 1.0, 9.0), ("open", 2.0, 4.0),
                    ("rounds", 9.0, 10.0), ("round", 9.0, 9.5), ("round", 9.5, 10.0)])
    ops = [_op(2.5, 3.0, launch=2.2), _op(5.0, 6.0, launch=4.5), _op(9.2, 9.3, launch=9.1),
           _op(9.6, 9.7, launch=9.55), _op(9.8, 9.9, launch=9.6)]
    idle = spans.idle_by_layer(s, ops, (0.0, 10.0))
    assert set(idle) == {"queries", "rounds", OUTSIDE} and idle[OUTSIDE] == pytest.approx(1.0)
    assert spans.ops_by_span(s, ops) == {"open": 1, "queries": 1, "round": 3}
    out = spans.summary(Trace(s, ops, (0.0, 10.0)), proofs=1)
    assert out["launches_per_round"] == {"rounds": 1.5}
    assert out["checks"]["ops_attributed"] == out["checks"]["ops"] == 5
    assert out["checks"]["ops_before_launch"] == 0
    assert set(out["idle_ms"]) == {"queries", "rounds", OUTSIDE}
    assert sum(out["idle_ms"].values()) == pytest.approx(1e3 * out["checks"]["idle_s"])
    # each gap by the operation that ends it and the span that launched it
    assert spans.gaps_by_launch(s, ops, (0.0, 10.0)) == pytest.approx(
        {"open before k": 2.5, "queries before k": 2.0, "round before k": 3.2 + 0.3 + 0.1, "end": 0.1})


def _device(offset, launches, length=0.001, wait=5e-6):
    """Operations launched at ``launches`` onto one queue, each starting
    ``wait`` after its launch or the end of the one before, read by a device
    clock ``offset(t)`` ahead of the host's."""
    ops, free = [], 0.0
    for t in launches:
        a = max(t + wait, free)
        free = a + length
        ops.append(_op(a - offset(a), free - offset(a), launch=t))
    return ops


@pytest.mark.parametrize("offset, drift, step", [(lambda t: 0.0, 0.0, None), (lambda t: 0.03 * t, 0.03, None),
                                                 (lambda t: -0.12 * t, 0.12, None),
                                                 (lambda t: 0.02 if t > 0.5 else 0.0, 0.0, 0.5)])
def test_align_puts_the_operations_back_on_the_host_clock(offset, drift, step):
    """The device clock early or late, a drift or a step: the operations go
    back to where they ran, less the launch latency and the drift over
    ALIGN_S and over their wait in the queue (the burst: up to 10 ms), but
    for those launched within ALIGN_S before the step."""
    launches = [0.002 * i for i in range(500)]  # 1 ms of work every 2 ms
    launches[100:110] = [0.2 + 1e-4 * i for i in range(10)]  # a burst: 10 ms of work queued in 1 ms
    truth = _device(lambda t: 0.0, launches)
    moved, moves = spans.align(_device(offset, launches))
    assert len(moves) == 500 and all(o.start >= o.launch for o in moved)
    err = [abs(m.start - t.start) for m, t in zip(sorted(moved, key=lambda o: o.launch), truth)
           if step is None or not step - spans.ALIGN_S <= t.start <= step]
    assert len(err) >= 490 and max(err) <= 5e-6 + drift * (spans.ALIGN_S + 0.01) + 1e-9


def test_the_summary_gives_the_idle_time_with_and_without_align():
    s = spans.nest([("proof", 0.0, 1.0), ("rounds", 0.0, 0.5), ("queries", 0.5, 1.0)])
    ops = [_op(0.40, 0.45, launch=0.55)]  # read 150 ms before its launch in queries
    out = spans.summary(Trace(s, ops, (0.0, 1.0)), proofs=1)
    assert out["idle_ms"] == pytest.approx({"rounds": 500.0, "queries": 450.0, OUTSIDE: 0.0})
    assert out["idle_ms_unaligned"] == pytest.approx({"rounds": 450.0, "queries": 500.0, OUTSIDE: 0.0})
    assert out["checks"]["ops_before_launch"] == 1 and out["checks"]["align_us"][-1] == pytest.approx(1.5e5)
    assert out["checks"]["launch_lag_us"][0] == pytest.approx(-1.5e5)


@pytest.mark.parametrize("cell", CELLS)
def test_a_span_stretch_on_the_cpu(cell, monkeypatch):
    from portbench import trace_spans
    from portbench.core import harness

    monkeypatch.setattr(harness, "WARMUP", 1)
    monkeypatch.setattr(harness, "TRACE_PROOFS", 2)
    wl = spec.workload(cell)
    wl.update(log_n=4, pool=2)
    with trace_spans.span_stretch_added():
        out = harness.run_cell(wl, spec.config(wl["config"]), 2**31 + 7, 0.0, True, "cpu", time.perf_counter())
    assert out["failed"] == 0 and out["attempted"] == 1 + 3 * 2 and out["correct"], out["checks"]
    assert harness._traced.__name__ == "_traced"  # put back
    s = out["breakdown"]["spans"]
    layers = {"encode", "commit", "tables", "rounds", "queries", "serialize", OUTSIDE}
    if cell.startswith("snark"):
        layers.add("sumcheck_rounds")
        assert s["checks"]["spans"]["sumcheck_round"] == 2 * 4
    assert set(s["idle_ms"]) == set(s["idle_ms_unaligned"]) == layers
    assert s["checks"]["spans"]["round"] == 2 * 4 and s["checks"]["spans"]["proof"] == 2
    assert sum(s["idle_ms"].values()) == pytest.approx(1e3 * s["checks"]["window_s"] / 2)
    assert s["checks"]["ops"] == 0 and s["span_off_ns"] > 0 and s["on_cost"] > -1
    assert "phase_ms.queries" in out["metrics"]
