"""FRI and the PCS sumcheck pieces of the PyTorch port held against the JAX
package.  Exact comparisons.

``fold_commit_leaves`` runs its plain version here (CPU tensors); it is
compared with the JAX package's separate fold and Merkle commit on the same
codeword, which is what the fused TPU kernel is pinned to as well.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilinear_tpu import fri as jfri
from multilinear_tpu import ntt as jntt
from multilinear_tpu import sumcheck as jsc
from multilinear_tpu.field import limbs as jlimbs
from multilinear_tpu.field.scalar import TWO_INV as JTWO_INV
from multilinear_tpu.field.scalar import Fp as JFp
from multilinear_tpu.mle import delta_subtables as j_delta_subtables
from multilinear_tpu.transcript import Transcript as JTranscript

from multilinear_tpu_torch import device_transcript, fri, ntt, pcs, sha256, sumcheck
from multilinear_tpu_torch.config import NUM_QUERIES
from multilinear_tpu_torch.field import cuda_ops, limbs, ops
from multilinear_tpu_torch.field.scalar import P, Fp
from multilinear_tpu_torch.transcript import Transcript


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(16), "little") % P for _ in range(n)]


def _same(t: torch.Tensor, jarr) -> bool:
    return np.array_equal(limbs.to_jax_limbs(t), np.asarray(jarr))


def _codeword(log_n, seed):
    """An RS codeword of length 2^(log_n+1) in both layouts."""
    j = jlimbs.pack_ints(_ints(1 << log_n, seed))
    code = np.asarray(jntt.reed_solomon(jnp.asarray(j)))
    return jnp.asarray(code), limbs.from_jax_limbs(code)


@pytest.mark.parametrize("log_n,k", [(5, 0), (5, 2), (7, 1)])
def test_fold_commit_leaves_matches_jax_fold_then_commit(log_n, k):
    """Round k folds a codeword that is already 2^k times shorter than the
    domain the twiddle table was built for."""
    jcode, code = _codeword(log_n, seed=log_n)
    log_domain = log_n + 1 + k
    r = Fp(_ints(1, 99 + k)[0])
    m = code.shape[0]
    nxt, digs = cuda_ops.fold_commit_leaves(
        code, ntt.inv_gen_pows(log_domain, "cpu"), 1 << k, fri._rh_limbs(r, "cpu")
    )
    jtw = jntt.inv_gen_pows(log_domain)[:, :: 1 << k][:, : m // 2]
    jnxt = jfri._fold_codeword(
        jcode, jtw, jnp.asarray(jlimbs.pack_scalar(JFp(r.v))), jnp.asarray(jlimbs.pack_scalar(JTWO_INV))
    )
    assert nxt.shape == (m // 2, 4) and digs.shape == (m // 4, 8)
    assert _same(nxt, jnxt)
    jtree = jfri._commit_code(jnxt)
    assert np.array_equal(digs.numpy().view(np.uint32), np.asarray(jtree.layers[0]).T)
    nxt2, layers = fri._fold_and_commit(code, ntt.inv_gen_pows(log_domain, "cpu"), k, fri._rh_limbs(r, "cpu"))
    assert torch.equal(nxt2, nxt)
    assert sha256.digests_to_bytes(layers[-1])[0].tobytes() == jtree.root_bytes()


def test_fold_commit_leaves_smallest_codeword():
    """m = 4: one leaf, the fold that ends the chain."""
    vals = _ints(4, 5)
    tw = _ints(2, 6)
    rh = _ints(1, 7)[0]
    nxt, digs = cuda_ops.fold_commit_leaves(limbs.pack_ints(vals), limbs.pack_ints(tw), 1, limbs.pack_int(rh))
    inv2 = pow(2, -1, P)
    want = [((vals[j] + vals[j + 2]) * inv2 + (vals[j] - vals[j + 2]) * tw[j] * rh) % P for j in range(2)]
    assert [int(v) for v in limbs.unpack_ints(nxt)] == want
    msg = want[0].to_bytes(16, "little") + want[1].to_bytes(16, "little")
    assert sha256.digests_to_bytes(digs)[0].tobytes() == hashlib.sha256(msg).digest()


def test_fold_commit_wrapper_rejects_bad_input():
    code = limbs.pack_ints(_ints(8, 1))
    tw = limbs.pack_ints(_ints(4, 2))
    rh = limbs.pack_int(5)
    with pytest.raises(ValueError):
        cuda_ops.fold_commit_leaves(code[:6], tw, 1, rh)  # not a multiple of 4
    with pytest.raises(ValueError):
        cuda_ops.fold_commit_leaves(code, tw, 2, rh)  # table too short for the stride
    with pytest.raises(ValueError):
        cuda_ops.fold_commit_leaves(code, tw, 1, limbs.pack_ints([5, 6]))  # not one element
    with pytest.raises((ValueError, TypeError)):
        cuda_ops.fold_commit_leaves(code, tw, 1, 5)  # a host integer: rh lies on the device
    with pytest.raises(ValueError):
        cuda_ops.fold_commit_leaves(code.to(torch.int64), tw, 1, rh)


@pytest.mark.parametrize("log_n", [2, 6])
def test_fri_prover_roots_match_jax(log_n):
    jcode, code = _codeword(log_n, seed=20 + log_n)
    tr, jtr = Transcript(), JTranscript()
    data = fri.FriProverData.fold(code, tr)
    jdata = jfri.FriProverData.fold(jcode, jtr)
    assert len(data.trees) == log_n
    assert data.fold_roots() == jdata.fold_roots()
    assert data.last_element.v == jdata.last_element.v
    assert tr.random() == jtr.random()


def test_fri_proof_round_trip_and_jax_agreement():
    jcode, code = _codeword(6, seed=31)
    proof = fri.FriProof.prove(code, Transcript())
    assert len(proof.queries) == NUM_QUERIES
    proof.verify()
    jproof = jfri.FriProof.prove(jcode, JTranscript())
    assert proof.commitments == jproof.commitments
    assert proof.last_elem.v == jproof.last_elem.v
    assert proof.last_random == jproof.last_random
    for q, jq in zip(proof.queries, jproof.queries):
        for p, jp in zip(q.paths, jq.paths):
            assert [v.v for v in p.values] == [v.v for v in jp.values]
            assert p.path == [(bytes(s), int(d)) for s, d in jp.path]


def test_fri_rejects_a_non_codeword_and_a_tampered_proof():
    with pytest.raises(fri.FriError):
        fri.FriProverData.fold(limbs.pack_ints(_ints(64, 8)), Transcript())
    _, code = _codeword(4, seed=9)
    proof = fri.FriProof.prove(code, Transcript())
    proof.last_elem = proof.last_elem + Fp(1)
    with pytest.raises(fri.FriError):
        proof.verify()


def test_fri_debug_checks_catch_a_non_canonical_codeword():
    _, code = _codeword(3, seed=9)
    bad = code.clone()
    bad[1] = torch.tensor([-1, -1, -1, -1], dtype=torch.int32)
    with pytest.raises(fri.FriError):
        fri.FriProverData.init(bad, Transcript(), debug_checks=True)


@pytest.mark.parametrize("n_vars", [1, 2, 9])
def test_pcs_tables_partial_sums_and_fold_match_jax(n_vars):
    """The PCS round's sums - the identity program run by ``program_sums``
    into a zeroed (2, 4) row, as ``pcs.DeviceRounds`` runs them - and the
    table fold, against the JAX package's."""
    h = 1 << n_vars
    j = jlimbs.pack_ints(_ints(h, 50 + n_vars))
    evals = limbs.from_jax_limbs(j)
    pts = _ints(n_vars, 60 + n_vars)
    tables = sumcheck.SumcheckTables.for_pcs([Fp(p) for p in pts], evals, debug_checks=True)
    jdata = jsc._pack_tables_kernel(jnp.asarray(j), j_delta_subtables([JFp(p) for p in pts]))
    assert _same(tables.data, jdata)  # (2, h, 4) vs (8, 2, h)
    jsums = jsc._partial_sums_kernel(jdata, jnp.zeros((0, 8), jnp.uint32), 2, jsc.identity_composition)
    row = torch.zeros((2, 4), dtype=torch.int64)
    raw = tables.program_sums(pcs.IDENTITY, None, 2, row)  # unreduced int64 limb sums, reduced by the caller
    assert raw.shape == (2, 4) and raw.dtype == torch.int64
    assert _same(ops.reduce_limb_sums(raw), jsums)
    # s(1) is the sum over the upper half of the table
    ev, dl = limbs.unpack_ints(tables.data[0]), limbs.unpack_ints(tables.data[1])
    s1 = sum(int(ev[i]) * int(dl[i]) for i in range(h // 2, h)) % P
    assert ops.limb_sums_to_int(raw[0].tolist()) == s1
    r = Fp(_ints(1, 70)[0])
    tables.fold(limbs.pack_scalar(r))
    assert tables.height == h // 2
    assert _same(tables.data, jsc._fold_kernel(jdata, jnp.asarray(jlimbs.pack_scalar(JFp(r.v)))))


def test_round_poly_wire_format_and_transcript_schedule():
    """Degree 2, constant coefficient stripped (Q7), coefficients absorbed
    before the challenge is drawn - by the round-scalars function the
    rounds run on the prover's device."""
    prev = Fp(1234567)
    s1, s2 = Fp(99), Fp(P - 5)
    tr = Transcript()
    state = device_transcript.state_from_host(tr)
    scal = limbs.pack_ints([prev, 0, 0])
    coeffs, digest = torch.zeros((2, 4), dtype=torch.int32), torch.zeros(8, dtype=torch.int32)
    sums = torch.tensor([[s1.v, 0, 0, 0], [s2.v & 0xFFFFFFFF, s2.v >> 32 & 0xFFFFFFFF,
                                           s2.v >> 64 & 0xFFFFFFFF, s2.v >> 96]], dtype=torch.int64)
    device_transcript.round_scalars(state, scal, digest, sums=sums, coeffs=coeffs)
    pol = sumcheck.SumcheckPoly(limbs.unpack_fps(coeffs))
    new_sum, r, _ = limbs.unpack_fps(scal)
    assert len(pol.nonzero_coeffs) == 2
    full = pol.to_polynomial(prev)
    assert full.evaluate(Fp(0)) + full.evaluate(Fp(1)) == prev
    assert full.evaluate(Fp(1)) == s1 and full.evaluate(Fp(2)) == s2
    ref = Transcript()
    pol.absorb_into(ref)
    assert r == ref.next_challenge() and new_sum == full.evaluate(r)
    assert device_transcript.digest(state) == ref.random() == sha256.digest_to_bytes(digest.numpy())
