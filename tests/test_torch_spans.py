"""The prover's spans (``utils.span``) and its one counter registry
(``stats``), on the CPU at 2^10.

Under a ``torch.profiler`` profile each span is a user annotation, nested as
the prove nests them; under ``collect_phases`` the phase spans fill the same
keys as before; with neither, a span enters nothing.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multilinear_tpu_torch import sha256_cuda, stats, utils
from multilinear_tpu_torch import device_transcript as dtr
from multilinear_tpu_torch.batched_pcs import BatchedPCSClaim, BatchedPCSProof
from multilinear_tpu_torch.config import ProverConfig
from multilinear_tpu_torch.field import cuda_ops, limbs
from multilinear_tpu_torch.field.scalar import Fp, P
from multilinear_tpu_torch.mle import evaluate_evals_host
from multilinear_tpu_torch.pcs import PCSProof
from multilinear_tpu_torch.serialize import batched_pcs_proof_to_bytes, pcs_proof_to_bytes, snark_proof_to_bytes
from multilinear_tpu_torch.system import ConstraintSet, System, Trace, WitnessLayout
from multilinear_tpu_torch.testdata import SNARK_CONSTRAINTS, snark_golden_columns
from multilinear_tpu_torch.transcript import Transcript

CPU = ProverConfig(device="cpu")
LOG_N = 10


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(16), "little") % P for _ in range(n)]


def _pcs():
    evals = limbs.pack_ints(_ints(1 << LOG_N, 1))
    pt = [Fp(v) for v in _ints(LOG_N, 2)]
    return PCSProof.prove(pt, evaluate_evals_host(evals, pt), evals, Transcript(), CPU)


def _batched():
    polys = limbs.pack_ints(_ints(3 << LOG_N, 3), shape=(3, 1 << LOG_N))
    pt = [Fp(v) for v in _ints(LOG_N, 4)]
    claim = BatchedPCSClaim(pt, [evaluate_evals_host(polys[j], pt) for j in range(3)])
    return BatchedPCSProof.prove(claim, polys, Transcript(), CPU)


def _snark():
    cols = snark_golden_columns("pythagorean", LOG_N, 5)
    trace = Trace.from_columns(torch.stack([limbs.pack_ints(c) for c in cols]))
    constraints, degree = SNARK_CONSTRAINTS["pythagorean"]
    t = Transcript()
    return System.prover(t, ConstraintSet(constraints, degree), WitnessLayout(columns=4), trace, CPU).prove_snark(t)


PROVES = {"pcs": (_pcs, pcs_proof_to_bytes), "batched": (_batched, batched_pcs_proof_to_bytes),
          "snark": (_snark, snark_proof_to_bytes)}

PCS_LAYERS = ["encode", "commit_l0", "tables", "rounds", "queries"]
BATCHED_LAYERS = ["encode", "commit_batch", "tables", "rounds", "rounds", "queries"]


def _traced(fn):
    """The spans ``fn`` opened under a CPU profile: (name, parent name or
    None), in the order they opened.  Read from the profiler's raw events:
    building ``prof.events()``' tree for every operator of a CPU prove takes
    minutes."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    marks = sorted((e.start_ns(), -e.end_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CPU)
    out, open_ = [], []
    for start, neg_end, name in marks:
        while open_ and open_[-1][0] <= start:
            open_.pop()
        out.append((name, open_[-1][1] if open_ else None))
        open_.append((-neg_end, name))
    return out


_SPANS = {}


def _spans(kind):
    """The spans of one prove and its serialization, under the profiler and
    ``collect_phases`` at once (traced once a module), and the phases."""
    if kind not in _SPANS:
        prove, to_bytes = PROVES[kind]
        with utils.collect_phases() as phases:
            _SPANS[kind] = _traced(lambda: to_bytes(prove())), dict(phases)
    return _SPANS[kind]


def _children(spans, parent):
    return [name for name, p in spans if p == parent]


@pytest.mark.parametrize("kind", ["pcs", "batched", "snark"])
def test_a_prove_records_its_spans_nested(kind):
    spans, _ = _spans(kind)
    assert _children(spans, None) == ["proof", "serialize"]
    layers = _children(spans, "proof")
    if kind == "pcs":
        assert layers == PCS_LAYERS
    elif kind == "batched":
        assert layers == BATCHED_LAYERS
    else:
        assert layers == ["snark_tables", "sumcheck_rounds"] + BATCHED_LAYERS
        assert _children(spans, "sumcheck_rounds") == ["sumcheck_round"] * LOG_N + ["replay"]
    # one PCS round a variable; the batched round 0 runs in the constructor's
    # ``rounds``, the others in run_rounds', which ends in the one replay
    assert _children(spans, "rounds") == ["round"] * LOG_N + ["replay"]
    assert _children(spans, "queries") == ["open"]
    assert _children(spans, "serialize") == []
    assert {name for name, _ in spans} <= utils.PHASES | {"proof", "round", "sumcheck_round", "replay", "open",
                                                         "serialize"}


@pytest.mark.parametrize("kind", ["pcs", "batched", "snark"])
def test_serialize_is_a_span_of_its_own(kind):
    prove, to_bytes = PROVES[kind]
    proof = prove()
    assert _traced(lambda: to_bytes(proof)) == [("serialize", None)]


def test_spans_enter_nothing_when_nothing_listens(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for prove, to_bytes in PROVES.values():
        to_bytes(prove())
    with utils.span("encode"), utils.span("round"):
        pass


@pytest.mark.parametrize("kind,keys", [
    ("pcs", {"encode", "commit_l0", "tables", "rounds", "queries"}),
    ("batched", {"encode", "commit_batch", "tables", "rounds", "queries"}),
    ("snark", {"snark_tables", "sumcheck_rounds", "encode", "commit_batch", "tables", "rounds", "queries"}),
])
def test_collect_phases_keeps_its_keys(kind, keys):
    prove, to_bytes = PROVES[kind]
    with utils.collect_phases() as phases:
        to_bytes(prove())
    assert set(phases) == keys and all(v >= 0 for v in phases.values())


@pytest.mark.parametrize("kind,layers", [("pcs", PCS_LAYERS), ("batched", BATCHED_LAYERS)])
def test_phases_and_profiler_together(kind, layers):
    """Both listeners at once: the phases fill and the spans are recorded."""
    spans, phases = _spans(kind)
    assert set(phases) == set(layers)
    assert _children(spans, "proof") == layers


class _FakeStream:
    cuda_stream = 0


@pytest.mark.parametrize("module,kernel,symbol", [
    (cuda_ops, "butterfly2", "mlt_butterfly2"),
    (sha256_cuda, "merkle_levels", "mlt_merkle_levels"),
    (sha256_cuda, "open_gather", "mlt_open_gather"),
])
def test_launches_are_counted_in_stats(monkeypatch, module, kernel, symbol):
    from multilinear_tpu_torch import _build

    called = []
    monkeypatch.setattr(_build, "lib", lambda: {symbol: lambda *args: called.append(args) or 0})
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    stats.reset()
    for _ in range(3):
        module._launch(kernel, symbol, torch.device("cuda", 0), 7)
    assert stats.counts() == {"launch." + kernel: 3} and len(called) == 3
    stats.reset()
    assert stats.counts() == {}


def test_one_counter_registry():
    for module in (cuda_ops, sha256_cuda, dtr):
        assert not hasattr(module, "_LAUNCHES")
        assert not hasattr(module, "launch_counts") and not hasattr(module, "reset_launch_counts")
    assert not hasattr(utils, "PhaseTimer")
