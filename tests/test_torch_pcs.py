"""The PCS slice of the PyTorch port held against the JAX package, end to end.

The same evaluations and point, made from a numpy seed, go through
``multilinear_tpu.pcs.PCSProof.prove`` and the port's (its plain versions, on
CPU tensors).  Everything compared is integers and bytes: every comparison is
exact.  At these sizes the JAX prover takes its host-native route, so no
large XLA program is compiled.
"""

import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from multilinear_tpu.field import limbs as jlimbs
from multilinear_tpu.field.scalar import Fp as JFp
from multilinear_tpu.pcs import PCSProof as JPCSProof
from multilinear_tpu.serialize import pcs_proof_from_bytes as j_from_bytes
from multilinear_tpu.serialize import pcs_proof_to_bytes as j_to_bytes
from multilinear_tpu.transcript import Transcript as JTranscript

from multilinear_tpu_torch import composition as cmp
from multilinear_tpu_torch import stats
from multilinear_tpu_torch.batched_pcs import BatchedPCSClaim, BatchedPCSProof
from multilinear_tpu_torch.config import ProverConfig
from multilinear_tpu_torch.field import limbs, ops
from multilinear_tpu_torch.field.scalar import Fp, P
from multilinear_tpu_torch.fri import FriError
from multilinear_tpu_torch.mle import evaluate_evals_host
from multilinear_tpu_torch.pcs import PCSProof, PCSProverSession
from multilinear_tpu_torch.serialize import batched_pcs_proof_to_bytes, pcs_proof_from_bytes, pcs_proof_to_bytes
from multilinear_tpu_torch.testdata import batched_pcs_golden_inputs, pcs_golden_inputs
from multilinear_tpu_torch.transcript import Transcript

CPU = ProverConfig(device="cpu", debug_checks=True)
TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "multilinear_tpu_torch",
                        "testdata")
GOLDEN = os.path.join(TESTDATA, "pcs_golden.json")
BATCHED_GOLDEN = os.path.join(TESTDATA, "batched_pcs_golden.json")


def _case(n_vars: int, seed: int):
    """(jax limb array (8, 2^n), point as ints) from a numpy seed."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(16), "little") % P for _ in range(1 << n_vars)]
    point = [int.from_bytes(rng.bytes(16), "little") % P for _ in range(n_vars)]
    return jlimbs.pack_ints(vals), point


def _port_prove(jax_limbs, point, config=CPU):
    evals = limbs.from_jax_limbs(jax_limbs)
    pt = [Fp(v) for v in point]
    out = evaluate_evals_host(evals, pt)
    return PCSProof.prove(pt, out, evals, Transcript(), config), out


def _jax_prove(jax_limbs, point, out_v):
    pt = [JFp(v) for v in point]
    return JPCSProof.prove(pt, JFp(out_v), jnp.asarray(jax_limbs), JTranscript())


_PROOFS = {}


def _both(n_vars):
    if n_vars not in _PROOFS:
        jl, point = _case(n_vars, 100 + n_vars)
        proof, out = _port_prove(jl, point)
        _PROOFS[n_vars] = (pcs_proof_to_bytes(proof), j_to_bytes(_jax_prove(jl, point, out.v)))
    return _PROOFS[n_vars]


@pytest.mark.parametrize("n_vars", [6, 8, 10])
def test_proof_bytes_identical(n_vars):
    port_bytes, jax_bytes = _both(n_vars)
    assert port_bytes == jax_bytes


@pytest.mark.parametrize("n_vars", [6, 8, 10])
def test_each_verifies_the_others_proof(n_vars):
    port_bytes, jax_bytes = _both(n_vars)
    pcs_proof_from_bytes(jax_bytes).verify(Transcript())
    j_from_bytes(port_bytes).verify(JTranscript())


@pytest.mark.parametrize("n_vars", [1, 2, 3])
def test_tiny_sizes_prove_and_verify(n_vars):
    """The end of the fold chain: codewords shorter than a warp, the last
    fold committing nothing."""
    jl, point = _case(n_vars, 7 + n_vars)
    proof, out = _port_prove(jl, point)
    assert len(proof.fri_proof.commitments) == n_vars
    port_bytes = pcs_proof_to_bytes(proof)
    pcs_proof_from_bytes(port_bytes).verify(Transcript())
    assert port_bytes == j_to_bytes(_jax_prove(jl, point, out.v))


@pytest.mark.parametrize("where", ["commitment", "query", "sumcheck", "output"])
def test_corrupted_bytes_raise(where):
    port_bytes, _ = _both(6)
    pos = {
        "commitment": 8 + 5,  # inside the first root
        "query": len(port_bytes) // 2,
        "sumcheck": len(port_bytes) - 16 * (6 + 1) - 8 - 20,  # a round coefficient
        "output": len(port_bytes) - 3,
    }[where]
    bad = bytearray(port_bytes)
    bad[pos] ^= 0x01
    with pytest.raises((FriError, ValueError)):
        pcs_proof_from_bytes(bytes(bad)).verify(Transcript())


def test_truncated_and_trailing_bytes_raise():
    port_bytes, _ = _both(6)
    with pytest.raises((ValueError, Exception)):
        pcs_proof_from_bytes(port_bytes[:-1])
    with pytest.raises(ValueError):
        pcs_proof_from_bytes(port_bytes + b"\0")


def test_wrong_claim_is_rejected():
    jl, point = _case(6, 106)
    evals = limbs.from_jax_limbs(jl)
    pt = [Fp(v) for v in point]
    wrong = evaluate_evals_host(evals, pt) + Fp(1)
    proof = PCSProof.prove(pt, wrong, evals, Transcript(), CPU)
    with pytest.raises(FriError):
        proof.verify(Transcript())


def test_session_in_stages_equals_one_shot():
    jl, point = _case(6, 106)
    evals = limbs.from_jax_limbs(jl)
    pt = [Fp(v) for v in point]
    out = evaluate_evals_host(evals, pt)
    s = PCSProverSession(pt, out, evals, Transcript(), CPU)
    assert s.run_rounds(2) == 2
    assert s.run_rounds(1) == 1
    assert s.run_rounds() == 3
    assert pcs_proof_to_bytes(s.finish()) == _both(6)[0]


def test_one_host_copy_per_round(monkeypatch):
    """The rounds copy nothing to the host: their Fiat-Shamir runs on the
    prover's device.  A prove makes two copies in all - the end of the
    rounds (round polynomials, roots, the last fold's two elements, the
    device transcript's digest) and the query openings.  Every copy of the
    prover goes through ``stats.fetch``; count the calls."""
    want = _both(6)[0]
    jl, point = _case(6, 106)
    evals = limbs.from_jax_limbs(jl)
    pt = [Fp(v) for v in point]
    out = evaluate_evals_host(evals, pt)
    shapes = []
    real = stats.fetch

    def counting(t):
        shapes.append(tuple(t.shape))
        return real(t)

    monkeypatch.setattr(stats, "fetch", counting)
    s = PCSProverSession(pt, out, evals, Transcript(), CPU)
    assert s.launch_rounds() == 6
    assert shapes == [], "a round copied to the host"
    s.run_rounds()
    # 6 polynomials (8 words each), 6 roots (8), 2 elements (8), the digest (8)
    assert shapes == [(6 * 8 + 6 * 8 + 8 + 8,)]
    assert pcs_proof_to_bytes(s.finish()) == want
    assert len(shapes) == 2, shapes


@pytest.mark.parametrize("prior", [b"abc", b"x" * 61, bytes(range(69))])
def test_proof_after_an_unaligned_prior_absorb_matches_jax(prior):
    """The transcript hops to the device at any byte fill: a prover whose
    transcript absorbed 3, 61 or 69 bytes first gives the JAX package's
    bytes (whose device rounds take word-aligned midstates only)."""
    jl, point = _case(6, 106)
    evals = limbs.from_jax_limbs(jl)
    pt = [Fp(v) for v in point]
    out = evaluate_evals_host(evals, pt)
    tr, jtr = Transcript(), JTranscript()
    tr.absorb(prior)
    jtr.absorb(prior)
    port_bytes = pcs_proof_to_bytes(PCSProof.prove(pt, out, evals, tr, CPU))
    jax_bytes = j_to_bytes(JPCSProof.prove([JFp(v) for v in point], JFp(out.v), jnp.asarray(jl), jtr))
    assert port_bytes == jax_bytes
    assert tr.random() == jtr.random()
    vtr = Transcript()
    vtr.absorb(prior)
    pcs_proof_from_bytes(port_bytes).verify(vtr)


def test_phase_split_marks_each_phase_once():
    """encode, commit_l0, tables, rounds, queries - commit_l0 marked once."""
    from multilinear_tpu_torch import utils

    jl, point = _case(3, 10)
    marks = []
    real_exit = utils.span.__exit__

    def spy(self, *exc):
        if self.name in utils.PHASES:
            marks.append(self.name)
        real_exit(self, *exc)

    utils.span.__exit__ = spy
    try:
        with utils.collect_phases() as phases:
            _port_prove(jl, point)
    finally:
        utils.span.__exit__ = real_exit
    assert marks == ["encode", "commit_l0", "tables", "rounds", "queries"]
    assert sorted(phases) == sorted(marks) and all(v >= 0 for v in phases.values())
    with utils.collect_phases() as again:
        pass
    assert again == {}


def test_golden_digest_matches_both_packages():
    """The fixture chip_smoke.py checks on the card: SHA-256 of the proof
    bytes at log_n = 10 for inputs made by ``testdata.pcs_golden_inputs``.
    Recomputed here from the JAX package, so the fixture cannot rot."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    vals, point = pcs_golden_inputs(golden["log_n"], golden["seed"])
    jl = jlimbs.pack_ints(vals)
    proof, out = _port_prove(jl, point, ProverConfig(device="cpu"))
    port_bytes = pcs_proof_to_bytes(proof)
    jax_bytes = j_to_bytes(_jax_prove(jl, point, out.v))
    assert out.v == int(golden["output"])
    assert len(port_bytes) == golden["proof_bytes"]
    assert hashlib.sha256(jax_bytes).hexdigest() == golden["sha256"]
    assert hashlib.sha256(port_bytes).hexdigest() == golden["sha256"]


def _golden(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _golden_pcs_session():
    """A session of the golden PCS fixture (``GOLDEN``) on the CPU."""
    golden = _golden(GOLDEN)
    vals, point = pcs_golden_inputs(golden["log_n"], golden["seed"])
    return PCSProverSession([Fp(v) for v in point], Fp(int(golden["output"])), limbs.pack_ints(vals),
                            Transcript(), CPU)


def _prove_golden(kind: str, tmp_path):
    """The golden fixture of ``kind`` proved on the CPU: "pcs" in one shot,
    "batched" (the batched fixture), "resumed" (the PCS saved after 4
    rounds, dropped, resumed from the file).  Returns (proof bytes, rounds,
    the fixture)."""
    if kind == "batched":
        golden = _golden(BATCHED_GOLDEN)
        B, log_n = golden["n_polys"], golden["log_n"]
        polys, point = batched_pcs_golden_inputs(B, log_n, golden["seed"])
        claim = BatchedPCSClaim([Fp(v) for v in point], [Fp(int(o)) for o in golden["outputs"]])
        proof = BatchedPCSProof.prove(claim, limbs.pack_ints([v for p in polys for v in p], shape=(B, 1 << log_n)),
                                      Transcript(), CPU)
        return batched_pcs_proof_to_bytes(proof), log_n, golden
    golden = _golden(GOLDEN)
    session = _golden_pcs_session()
    if kind == "resumed":
        assert session.run_rounds(4) == 4
        path = str(tmp_path / "pcs")
        session.save(path)
        session = PCSProverSession.resume(path, CPU)
    session.run_rounds()
    return pcs_proof_to_bytes(session.finish()), golden["log_n"], golden


@pytest.mark.parametrize("kind", ["pcs", "batched", "resumed"])
def test_every_pcs_round_takes_the_sums_kernel_route(kind, tmp_path, monkeypatch):
    """A PCS prove, a batched PCS prove and a saved-then-resumed PCS session
    run each round's sums as the identity program on the route of
    ``composition.round_sums`` (here the kernel's plain version): one
    ``sumcheck_rounds_fused`` a round, none on the loop over the field's
    add, sub and mul, and the golden fixture's bytes."""
    loops = []
    sums_loop = cmp._sums_loop
    monkeypatch.setattr(cmp, "_sums_loop", lambda *args: loops.append(args[-1]) or sums_loop(*args))
    stats.reset()
    blob, rounds, golden = _prove_golden(kind, tmp_path)
    assert stats.counts().get("sumcheck_rounds_fused", 0) == rounds
    assert loops == [cmp._PLAIN] * rounds
    assert len(blob) == golden["proof_bytes"]
    assert hashlib.sha256(blob).hexdigest() == golden["sha256"]


def test_a_pcs_round_wider_than_a_block_proves_the_same_bytes(monkeypatch):
    """With ``composition.max_slots`` patched to 0 the identity program is
    wider than a block, and every round's sums take the loop over the
    field's add, sub and mul: no round on the kernel route, the golden
    fixture's bytes."""
    loops = []
    sums_loop = cmp._sums_loop
    monkeypatch.setattr(cmp, "_sums_loop", lambda *args: loops.append(args[-1]) or sums_loop(*args))
    monkeypatch.setattr(cmp, "max_slots", lambda device: 0)
    golden = _golden(GOLDEN)
    stats.reset()
    session = _golden_pcs_session()
    session.run_rounds()
    blob = pcs_proof_to_bytes(session.finish())
    assert stats.counts().get("sumcheck_rounds_fused", 0) == 0
    assert loops == [(ops.add, ops.sub, ops.mul)] * golden["log_n"]
    assert hashlib.sha256(blob).hexdigest() == golden["sha256"]
