"""The batched slice of the PyTorch port - batched FRI and the batched PCS -
held against the JAX package end to end.

The same polynomials and point, made from a numpy seed, go through
``multilinear_tpu.batched_pcs.BatchedPCSProof.prove`` and the port's (its
plain versions, on CPU tensors).  Everything compared is integers and bytes:
every comparison is exact.  At these sizes the JAX prover takes its
host-native route, so no large XLA program is compiled.
"""

import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

import golden_model as gm
from multilinear_tpu import ntt as jntt
from multilinear_tpu.batched_fri import BatchedFriProof as JBatchedFriProof
from multilinear_tpu.batched_pcs import BatchedPCSClaim as JClaim
from multilinear_tpu.batched_pcs import BatchedPCSProof as JBatchedPCSProof
from multilinear_tpu.field import limbs as jlimbs
from multilinear_tpu.field.scalar import Fp as JFp
from multilinear_tpu.serialize import batched_fri_proof_to_bytes as j_bfri_to_bytes
from multilinear_tpu.serialize import batched_pcs_proof_from_bytes as j_from_bytes
from multilinear_tpu.serialize import batched_pcs_proof_to_bytes as j_to_bytes
from multilinear_tpu.serialize import fri_proof_to_bytes as j_fri_to_bytes
from multilinear_tpu.fri import FriProof as JFriProof
from multilinear_tpu.transcript import Transcript as JTranscript

from multilinear_tpu_torch import ntt, stats
from multilinear_tpu_torch.batched_fri import BatchedFriProof, _fingerprint_codes, fingerprint
from multilinear_tpu_torch.batched_pcs import BatchedPCSClaim, BatchedPCSProof, BatchedPCSProverSession
from multilinear_tpu_torch.config import NUM_QUERIES, ProverConfig
from multilinear_tpu_torch.field import limbs
from multilinear_tpu_torch.field.scalar import Fp, P
from multilinear_tpu_torch.fri import FriError, FriProof
from multilinear_tpu_torch.mle import evaluate_evals_host
from multilinear_tpu_torch.serialize import (
    batched_fri_proof_from_bytes,
    batched_fri_proof_to_bytes,
    batched_pcs_proof_from_bytes,
    batched_pcs_proof_to_bytes,
    fri_proof_from_bytes,
    fri_proof_to_bytes,
)
from multilinear_tpu_torch.testdata import batched_pcs_golden_inputs
from multilinear_tpu_torch.transcript import Transcript

CPU = ProverConfig(device="cpu", debug_checks=True)
GOLDEN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "multilinear_tpu_torch", "testdata", "batched_pcs_golden.json",
)
CASES = [(1, 4), (5, 7), (10, 6), (3, 10)]  # (polynomials, variables)


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(16), "little") % P for _ in range(n)]


def _case(B: int, n_vars: int, seed: int):
    """(jax limb array (8, B, 2^n), point as ints) from a numpy seed."""
    return jlimbs.pack_ints(_ints(B << n_vars, seed), shape=(B, 1 << n_vars)), _ints(n_vars, seed + 1)


def _port_prove(jax_limbs, point, config=CPU, transcript=None):
    polys = limbs.from_jax_limbs(jax_limbs)
    pt = [Fp(v) for v in point]
    outs = [evaluate_evals_host(polys[j], pt) for j in range(polys.shape[0])]
    proof = BatchedPCSProof.prove(BatchedPCSClaim(pt, outs), polys, transcript or Transcript(), config)
    return proof, outs


def _jax_prove(jax_limbs, point, outs):
    claim = JClaim([JFp(v) for v in point], [JFp(o.v) for o in outs])
    return JBatchedPCSProof.prove(claim, jnp.asarray(jax_limbs), JTranscript())


_PROOFS = {}


def _both(B, n_vars):
    if (B, n_vars) not in _PROOFS:
        jl, point = _case(B, n_vars, 300 + 16 * B + n_vars)
        proof, outs = _port_prove(jl, point)
        _PROOFS[B, n_vars] = (batched_pcs_proof_to_bytes(proof), j_to_bytes(_jax_prove(jl, point, outs)))
    return _PROOFS[B, n_vars]


@pytest.mark.parametrize("B,n_vars", CASES)
def test_proof_bytes_identical(B, n_vars):
    port_bytes, jax_bytes = _both(B, n_vars)
    assert port_bytes == jax_bytes


@pytest.mark.parametrize("B,n_vars", CASES)
def test_each_verifies_the_others_proof(B, n_vars):
    port_bytes, jax_bytes = _both(B, n_vars)
    proof = batched_pcs_proof_from_bytes(jax_bytes)
    proof.verify(Transcript())
    assert len(proof.fri_proof.commitments) == n_vars - 1, "the batch tree is not a fold layer"
    assert len(proof.claim.outputs) == B
    j_from_bytes(port_bytes).verify(JTranscript())
    assert batched_pcs_proof_to_bytes(proof) == jax_bytes


@pytest.mark.parametrize("B,n_vars", [(1, 1), (3, 1), (2, 2), (10, 2)])
def test_tiny_sizes_prove_and_verify(B, n_vars):
    """n = 1: the batched fold is also the last fold and commits nothing."""
    jl, point = _case(B, n_vars, 40 + B + n_vars)
    proof, outs = _port_prove(jl, point)
    assert len(proof.fri_proof.commitments) == n_vars - 1
    port_bytes = batched_pcs_proof_to_bytes(proof)
    batched_pcs_proof_from_bytes(port_bytes).verify(Transcript())
    assert port_bytes == j_to_bytes(_jax_prove(jl, point, outs))


def test_transcript_matches_the_golden_model():
    """Batch root, fold roots, round polynomials, last element and the final
    transcript state equal the scalar golden model's."""
    B, n_vars = 3, 5
    jl, point = _case(B, n_vars, 77)
    transcript = Transcript()
    proof, _ = _port_prove(jl, point, transcript=transcript)
    g_polys = [[int(v) for v in row] for row in limbs.unpack_ints(limbs.from_jax_limbs(jl))]
    batch_root, roots, pols, last_elem, final_state = gm.batched_pcs_prove(
        point, g_polys, gm.GoldenTranscript()
    )
    assert proof.fri_proof.batch_commitment == batch_root
    assert proof.fri_proof.commitments == roots
    assert [[c.v for c in p.nonzero_coeffs] for p in proof.sumcheck_polynomials] == pols
    assert proof.fri_proof.last_elem.v == last_elem
    assert proof.fri_proof.last_random == final_state
    assert transcript.random() == final_state


@pytest.mark.parametrize("where", ["batch_commitment", "commitment", "query", "sumcheck", "output"])
def test_corrupted_bytes_raise(where):
    B, n_vars = 5, 7
    port_bytes, _ = _both(B, n_vars)
    tail = 8 + 16 * n_vars + 8 + 16 * B  # inputs and outputs, each with its length
    pos = {
        "batch_commitment": 5,
        "commitment": 32 + 8 + 5,  # inside the first fold root
        "query": len(port_bytes) // 2,
        "sumcheck": len(port_bytes) - tail - 20,  # a round coefficient
        "output": len(port_bytes) - 3,
    }[where]
    bad = bytearray(port_bytes)
    bad[pos] ^= 0x01
    with pytest.raises((FriError, ValueError)):
        batched_pcs_proof_from_bytes(bytes(bad)).verify(Transcript())


def test_truncated_and_trailing_bytes_raise():
    port_bytes, _ = _both(5, 7)
    with pytest.raises((ValueError, Exception)):
        batched_pcs_proof_from_bytes(port_bytes[:-1])
    with pytest.raises((ValueError, Exception)):
        batched_pcs_proof_from_bytes(port_bytes[: len(port_bytes) // 3])
    with pytest.raises(ValueError):
        batched_pcs_proof_from_bytes(port_bytes + b"\0")


def test_wrong_output_is_rejected():
    jl, point = _case(3, 5, 9)
    polys = limbs.from_jax_limbs(jl)
    pt = [Fp(v) for v in point]
    outs = [evaluate_evals_host(polys[j], pt) for j in range(3)]
    outs[1] = outs[1] + Fp(1)
    proof = BatchedPCSProof.prove(BatchedPCSClaim(pt, outs), polys, Transcript(), CPU)
    with pytest.raises(FriError):
        proof.verify(Transcript())


def test_hostile_proof_shapes_are_rejected():
    port_bytes, _ = _both(5, 7)
    proof = batched_pcs_proof_from_bytes(port_bytes)
    proof.fri_proof.queries = proof.fri_proof.queries[:-1]
    with pytest.raises(FriError):
        proof.verify(Transcript())
    proof = batched_pcs_proof_from_bytes(port_bytes)
    proof.sumcheck_polynomials[2].nonzero_coeffs.append(Fp(0))
    with pytest.raises(FriError):
        proof.verify(Transcript())
    proof = batched_pcs_proof_from_bytes(port_bytes)
    proof.fri_proof.commitments.pop()
    with pytest.raises(FriError):
        proof.verify(Transcript())


def test_session_in_stages_equals_one_shot():
    B, n_vars = 5, 7
    jl, point = _case(B, n_vars, 300 + 16 * B + n_vars)
    polys = limbs.from_jax_limbs(jl)
    pt = [Fp(v) for v in point]
    outs = [evaluate_evals_host(polys[j], pt) for j in range(B)]
    s = BatchedPCSProverSession(BatchedPCSClaim(pt, outs), polys, Transcript(), CPU)
    assert s.k == 1, "round 0 runs in the constructor"
    with pytest.raises(RuntimeError):
        s.finish()
    assert s.run_rounds(2) == 2
    assert s.run_rounds() == n_vars - 3
    assert s.run_rounds() == 0
    assert batched_pcs_proof_to_bytes(s.finish()) == _both(B, n_vars)[0]


def test_host_copies_of_a_batched_prove(monkeypatch):
    """One copy for the batch root (fingerprint_r depends on it), ONE at the
    end of the rounds (every round polynomial and fold root, the last fold's
    two elements and the device transcript's digest), and ONE for all
    openings of the batch tree and the inner layers.  Round 0, which runs in
    the session's constructor, copies nothing: the end of the rounds
    replays it."""
    B, n_vars = 3, 5
    jl, point = _case(B, n_vars, 9)
    shapes = []
    real = stats.fetch

    def counting(t):
        shapes.append(tuple(t.shape))
        return real(t)

    monkeypatch.setattr(stats, "fetch", counting)
    _port_prove(jl, point, ProverConfig(device="cpu"))
    # n polynomials (8 words), n - 1 fold roots (8), 2 elements (8), digest (8)
    assert shapes[0] == (8,)
    assert shapes[1] == (8 * n_vars + 8 * (n_vars - 1) + 8 + 8,)
    assert len(shapes) == 3, shapes


def test_phase_split_of_a_batched_prove():
    from multilinear_tpu_torch import utils

    jl, point = _case(2, 3, 10)
    with utils.collect_phases() as phases:
        _port_prove(jl, point)
    assert sorted(phases) == ["commit_batch", "encode", "queries", "rounds", "tables"]


def test_rejects_mismatched_inputs():
    polys = limbs.pack_ints(_ints(8, 1), shape=(2, 4))
    pt = [Fp(1), Fp(2)]
    with pytest.raises(ValueError):
        BatchedPCSProof.prove(BatchedPCSClaim(pt, [Fp(0)]), polys, Transcript(), CPU)
    with pytest.raises(ValueError):
        BatchedPCSProof.prove(BatchedPCSClaim(pt[:1], [Fp(0), Fp(0)]), polys, Transcript(), CPU)
    with pytest.raises(ValueError):
        BatchedPCSProof.prove(BatchedPCSClaim(pt, [Fp(0), Fp(0)]), polys[0], Transcript(), CPU)


# -- batched FRI and the standalone FRI codec ---------------------------------------


def test_fingerprint_horner_order():
    """Quirk Q6: the first item gets the highest power of r."""
    assert fingerprint(Fp(10), [Fp(1), Fp(2), Fp(3)]) == Fp(123)
    codes = limbs.pack_ints([1, 5, 2, 6, 3, 7], shape=(3, 2))
    got = [int(v) for v in limbs.unpack_ints(_fingerprint_codes(codes, limbs.pack_scalar(Fp(10))))]
    assert got == [123, 567]
    assert [int(v) for v in limbs.unpack_ints(codes).reshape(-1)] == [1, 5, 2, 6, 3, 7]


def _codes(B, log_n, seed):
    j = jlimbs.pack_ints(_ints(B << log_n, seed), shape=(B, 1 << log_n))
    jcodes = jntt.reed_solomon(jnp.asarray(j))
    return jcodes, ntt.reed_solomon(limbs.from_jax_limbs(j))


@pytest.mark.parametrize("B,log_n", [(1, 4), (4, 6)])
def test_batched_fri_matches_jax(B, log_n):
    """One code at 2^4 and four at 2^6, the reference's own test shapes."""
    jcodes, codes = _codes(B, log_n, 50 + B)
    proof = BatchedFriProof.prove(codes, Transcript())
    assert len(proof.queries) == NUM_QUERIES and len(proof.commitments) == log_n - 1
    proof.verify()
    blob = batched_fri_proof_to_bytes(proof)
    assert blob == j_bfri_to_bytes(JBatchedFriProof.prove(jcodes, JTranscript()))
    back = batched_fri_proof_from_bytes(blob)
    back.verify()
    assert batched_fri_proof_to_bytes(back) == blob


def test_batched_fri_rejects_corruption():
    _, codes = _codes(3, 5, 60)
    blob = batched_fri_proof_to_bytes(BatchedFriProof.prove(codes, Transcript()))
    for pos in (7, len(blob) // 2, len(blob) - 40):
        bad = bytearray(blob)
        bad[pos] ^= 0x01
        with pytest.raises((FriError, ValueError)):
            batched_fri_proof_from_bytes(bytes(bad)).verify()
    with pytest.raises((ValueError, Exception)):
        batched_fri_proof_from_bytes(blob[:-5])
    with pytest.raises(ValueError):
        batched_fri_proof_from_bytes(blob + b"\0")


def test_batched_fri_rejects_a_non_codeword():
    _, codes = _codes(2, 4, 61)
    codes[1, 3, 0] ^= 1
    with pytest.raises(FriError):
        BatchedFriProof.prove(codes, Transcript())


def test_fri_proof_codec_matches_jax():
    jcodes, codes = _codes(1, 5, 62)
    proof = FriProof.prove(codes[0].contiguous(), Transcript())
    blob = fri_proof_to_bytes(proof)
    assert blob == j_fri_to_bytes(JFriProof.prove(jcodes[:, 0], JTranscript()))
    fri_proof_from_bytes(blob).verify()
    with pytest.raises(ValueError):
        fri_proof_from_bytes(blob + b"\0")
    bad = bytearray(blob)
    bad[len(bad) // 2] ^= 1
    with pytest.raises((FriError, ValueError)):
        fri_proof_from_bytes(bytes(bad)).verify()


# -- the fixture the on-card smoke script checks ------------------------------------


def test_golden_digest_matches_both_packages():
    """SHA-256 of the batched proof bytes for inputs made by
    ``testdata.batched_pcs_golden_inputs``.  Recomputed here from the JAX
    package, so the fixture cannot rot."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    B, log_n = golden["n_polys"], golden["log_n"]
    polys, point = batched_pcs_golden_inputs(B, log_n, golden["seed"])
    jl = jlimbs.pack_ints([v for p in polys for v in p], shape=(B, 1 << log_n))
    proof, outs = _port_prove(jl, point, ProverConfig(device="cpu"))
    port_bytes = batched_pcs_proof_to_bytes(proof)
    jax_bytes = j_to_bytes(_jax_prove(jl, point, outs))
    assert [str(o.v) for o in outs] == golden["outputs"]
    assert len(port_bytes) == golden["proof_bytes"]
    assert hashlib.sha256(jax_bytes).hexdigest() == golden["sha256"]
    assert hashlib.sha256(port_bytes).hexdigest() == golden["sha256"]
