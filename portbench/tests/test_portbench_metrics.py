"""The frozen arithmetic of the device trace, of each per-layer metric and
of the traffic's statistics, on made-up traces and requests."""

from types import SimpleNamespace

import pytest

from portbench.core import devtrace, peaks, spec
import random

from portbench.core.traffic import Request, Sample, percentile

K = "NVIDIA H100 80GB HBM3"


def _op(name, a, b):
    return devtrace.Op(name, a, b)


def _ctx(ops=(), window_s=1.0, proofs=2, phases=None, phase_proofs=2, log_n=24, columns=None):
    config = {"log_blowup": 1}
    if columns:
        config["columns"] = columns
    return SimpleNamespace(workload={"log_n": log_n}, config=config, kind=K, ops=list(ops), window_s=window_s,
                           proofs=proofs, phases=phases or {}, phase_proofs=phase_proofs)


def test_busy_time_is_a_union_not_a_sum():
    ops = [_op("a", 0.0, 1.0), _op("b", 0.5, 1.5), _op("c", 2.0, 2.5)]
    assert devtrace.union(ops) == [(0.0, 1.5), (2.0, 2.5)]
    assert devtrace.busy_seconds(ops) == pytest.approx(2.0)
    assert devtrace.idle_gaps(ops) == {"before c": pytest.approx(0.5)}


def test_short_names():
    assert devtrace.short_name("butterfly2_kernel(void const*, long long)") == "butterfly2_kernel"
    assert devtrace.short_name("void at::native::vectorized_elementwise_kernel<4, F>(int)") == \
        "at::native::vectorized_elementwise_kernel"
    assert devtrace.short_name("void at::native::(anonymous namespace)::CatArrayBatchedCopy<int>(x)") == \
        "at::native::CatArrayBatchedCopy"
    assert devtrace.short_name("Memcpy HtoD (Pageable -> Device)") == "HtoD"


def test_idle_share_and_launches():
    ops = [_op("k(int)", 0.0, 0.1), _op("k(int)", 0.3, 0.5)]
    assert spec.metric("device_idle_share").read(_ctx(ops, window_s=1.0)) == pytest.approx(70.0)
    assert spec.metric("launches_per_proof").read(_ctx(ops, proofs=2)) == pytest.approx(1.0)
    assert spec.metric("device_idle_share").read(_ctx()) is None
    assert spec.metric("launches_per_proof").read(_ctx()) is None


@pytest.mark.parametrize("log_n,columns,bytes_per_call", [(24, None, 2 * 16 * 2**25), (22, 4, 2 * 16 * 4 * 2**23)])
def test_butterfly2_roofline_counts_one_pass_over_the_codewords(log_n, columns, bytes_per_call):
    reader = spec.metric("butterfly2_roofline")
    ctx = _ctx(log_n=log_n, columns=columns)
    assert reader.bytes_per_call(ctx.workload, ctx.config) == bytes_per_call
    least = bytes_per_call / 3.35e12
    ops = [_op("butterfly2_kernel(x)", 0.0, 2 * least), _op("butterfly_kernel(x)", 0.0, 5.0),
           _op("butterfly2_kernel(x)", 1.0, 1.0 + 2 * least)]
    assert reader.read(_ctx(ops, log_n=log_n, columns=columns)) == pytest.approx(50.0)
    assert reader.read(_ctx([_op("butterfly_kernel(x)", 0, 1)])) is None
    assert peaks.hbm_bytes_per_s(K) == 3.35e12
    with pytest.raises(ValueError):
        peaks.hbm_bytes_per_s("another card")


def test_phase_metrics_are_ms_per_proof():
    phases = {"queries": 0.2, "encode": 0.02, "commit_l0": 0.01, "commit_batch": 0.03, "rounds": 0.1}
    ctx = _ctx(phases=phases, phase_proofs=4)
    assert spec.metric("phase_ms.queries").read(ctx) == pytest.approx(50.0)
    assert spec.metric("phase_ms.encode").read(ctx) == pytest.approx(5.0)
    assert spec.metric("phase_ms.commit").read(ctx) == pytest.approx(10.0)
    assert spec.metric("phase_ms.rounds").read(ctx) == pytest.approx(25.0)
    assert spec.metric("phase_ms.sumcheck_rounds").read(ctx) is None


def test_p95_is_the_nearest_rank():
    values = [float(i) for i in range(1, 201)]
    assert percentile(values, 0.95) == 190.0
    assert percentile([3.0], 0.95) == 3.0


def _offered(seed, n, k=1):
    sample = Sample(random.Random(seed), k)
    requests = [Request(i, i % 4, b"", blob=bytes([i % 256])) for i in range(n)]
    for r in requests:
        sample.offer(r)
    sample.offer(Request(n, 0, b"", error="failed"))  # a failed proof is never drawn
    return sample, requests


def test_the_sample_keeps_the_bytes_of_its_draws_alone():
    sample, requests = _offered(7, 50, k=3)
    assert sample.seen == 50 and len(sample.kept) == 3
    assert [r for r in requests if r.blob is not None] == sorted(sample.kept, key=lambda r: r.id)
    again, _ = _offered(7, 50, k=3)
    assert [r.id for r in again.kept] == [r.id for r in sample.kept]


def test_the_sample_draws_every_request_alike():
    counts = [0] * 8
    for seed in range(4000):
        counts[_offered(seed, 8)[0].kept[0].id] += 1
    assert min(counts) > 400 and max(counts) < 600
