"""Checkpoint / resume of the port's three prover sessions, held against the
JAX package's uninterrupted proofs.

A session saved mid-proof (``save``), dropped, and resumed from the file
(``resume``) must make the proof bytes that the JAX package makes for the
same inputs without a break, and the proof must verify.  The same cases as
the JAX package's ``tests/test_checkpoint.py`` (mid-proof, tables at full
size, a path without ``.npz``, batched, SNARK in both phases at widths 1 and
4), and three edge cases: a save right after the batched constructor (round
0 launched, not replayed), a save after the last round and before
``finish``, and a damaged payload, which must not resume.  The port runs on
CPU tensors (its kernels' plain versions); every comparison is exact.  At
these sizes the JAX prover takes its host routes.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from multilinear_tpu import system as jsys
from multilinear_tpu.batched_pcs import BatchedPCSClaim as JClaim
from multilinear_tpu.batched_pcs import BatchedPCSProof as JBatchedPCSProof
from multilinear_tpu.field import limbs as jlimbs
from multilinear_tpu.field.scalar import Fp as JFp
from multilinear_tpu.pcs import PCSProof as JPCSProof
from multilinear_tpu.serialize import batched_pcs_proof_to_bytes as j_batched_to_bytes
from multilinear_tpu.serialize import pcs_proof_to_bytes as j_pcs_to_bytes
from multilinear_tpu.serialize import snark_proof_to_bytes as j_snark_to_bytes
from multilinear_tpu.transcript import Transcript as JTranscript

from multilinear_tpu_torch import checkpoint, stats
from multilinear_tpu_torch import system as psys
from multilinear_tpu_torch.batched_pcs import BatchedPCSClaim, BatchedPCSProverSession
from multilinear_tpu_torch.config import ProverConfig
from multilinear_tpu_torch.field import limbs
from multilinear_tpu_torch.field.scalar import Fp, P
from multilinear_tpu_torch.merkle import MerkleRootMismatch
from multilinear_tpu_torch.mle import evaluate_evals_host
from multilinear_tpu_torch.pcs import PCSProverSession
from multilinear_tpu_torch.serialize import (
    batched_pcs_proof_to_bytes,
    pcs_proof_from_bytes,
    pcs_proof_to_bytes,
    snark_proof_from_bytes,
    snark_proof_to_bytes,
)
from multilinear_tpu_torch.transcript import Transcript

CPU = ProverConfig(device="cpu", debug_checks=True)


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(16), "little") % P for _ in range(n)]


# -- plain PCS -------------------------------------------------------------------


def _pcs_case(n_vars: int, seed: int):
    """(port evals, point, output, the JAX package's uninterrupted proof bytes)."""
    vals, point = _ints(1 << n_vars, seed), _ints(n_vars, seed + 1)
    evals = limbs.pack_ints(vals)
    pt = [Fp(v) for v in point]
    out = evaluate_evals_host(evals, pt)
    ref = JPCSProof.prove([JFp(v) for v in point], JFp(out.v), jnp.asarray(jlimbs.pack_ints(vals)), JTranscript())
    return evals, pt, out, j_pcs_to_bytes(ref)


def _finish_pcs(path, rounds_done: int) -> bytes:
    resumed = PCSProverSession.resume(path, CPU)
    assert resumed.k == rounds_done
    assert resumed.tables.data.device.type == "cpu"
    resumed.run_rounds()
    proof = resumed.finish()
    proof.verify(Transcript())
    return pcs_proof_to_bytes(proof)


def test_resume_mid_proof_identical(tmp_path):
    evals, pt, out, want = _pcs_case(8, 10)
    session = PCSProverSession(pt, out, evals, Transcript(), CPU)
    session.run_rounds(max_rounds=3)
    path = str(tmp_path / "mid.npz")
    session.save(path)
    del session
    assert _finish_pcs(path, 3) == want


def test_resume_with_device_tables(tmp_path):
    """Saved with rounds launched on the tables' device and not replayed yet:
    the save replays them first.  Resumed onto the config's device."""
    evals, pt, out, want = _pcs_case(7, 20)
    session = PCSProverSession(pt, out, evals, Transcript(), CPU)
    assert session.launch_rounds(2) == 2 and session.pols == []
    path = str(tmp_path / "dev.npz")
    session.save(path)
    assert len(session.pols) == 2
    assert _finish_pcs(path, 2) == want


def test_save_resume_without_npz_suffix(tmp_path):
    evals, pt, out, want = _pcs_case(6, 30)
    session = PCSProverSession(pt, out, evals, Transcript(), CPU)
    session.run_rounds(max_rounds=2)
    session.save(str(tmp_path / "noext"))
    assert (tmp_path / "noext.npz").exists() and (tmp_path / "noext.npz.claim").exists()
    assert _finish_pcs(str(tmp_path / "noext"), 2) == want


def test_resumed_rounds_copy_once(tmp_path, monkeypatch):
    """A resumed session's rounds copy nothing to the host; the copy that
    ends them and the queries are the only two, as in a prove."""
    evals, pt, out, want = _pcs_case(6, 40)
    session = PCSProverSession(pt, out, evals, Transcript(), CPU)
    session.run_rounds(3)
    path = str(tmp_path / "copies.npz")
    session.save(path)
    resumed = PCSProverSession.resume(path, CPU)
    shapes = []
    real = stats.fetch
    monkeypatch.setattr(stats, "fetch", lambda t: shapes.append(tuple(t.shape)) or real(t))
    assert resumed.launch_rounds() == 3 and shapes == []
    resumed.run_rounds()
    assert pcs_proof_to_bytes(resumed.finish()) == want
    assert len(shapes) == 2, shapes


# -- batched PCS -----------------------------------------------------------------


def _batched_case(B: int, n_vars: int, seed: int):
    """(port polys, claim, the JAX package's uninterrupted proof bytes)."""
    vals, point = _ints(B << n_vars, seed), _ints(n_vars, seed + 1)
    polys = limbs.pack_ints(vals, shape=(B, 1 << n_vars))
    pt = [Fp(v) for v in point]
    outs = [evaluate_evals_host(polys[j], pt) for j in range(B)]
    ref = JBatchedPCSProof.prove(JClaim([JFp(v) for v in point], [JFp(o.v) for o in outs]),
                                 jnp.asarray(jlimbs.pack_ints(vals, shape=(B, 1 << n_vars))), JTranscript())
    return polys, BatchedPCSClaim(pt, outs), j_batched_to_bytes(ref)


def _finish_batched(path, rounds_done: int) -> bytes:
    resumed = BatchedPCSProverSession.resume(path, CPU)
    assert resumed.k == rounds_done
    resumed.run_rounds()
    proof = resumed.finish()
    proof.verify(Transcript())
    return batched_pcs_proof_to_bytes(proof)


def test_batched_pcs_resume_mid_proof_identical(tmp_path):
    polys, claim, want = _batched_case(3, 6, 50)
    session = BatchedPCSProverSession(claim, polys, Transcript(), CPU)
    assert session.k == 1  # round 0 (the batched fold) runs at construction
    session.run_rounds(max_rounds=2)
    path = str(tmp_path / "batched.npz")
    session.save(path)
    del session
    assert _finish_batched(path, 3) == want


def test_batched_pcs_resume_with_device_tables(tmp_path):
    polys, claim, want = _batched_case(2, 7, 60)
    session = BatchedPCSProverSession(claim, polys, Transcript(), CPU)
    session.launch_rounds(2)
    path = str(tmp_path / "batched_dev.npz")
    session.save(path)
    assert _finish_batched(path, 3) == want


def test_batched_save_right_after_the_constructor(tmp_path):
    """Round 0 was launched by the constructor and never replayed: the save
    replays it."""
    polys, claim, want = _batched_case(4, 5, 70)
    session = BatchedPCSProverSession(claim, polys, Transcript(), CPU)
    assert session.pols == []
    path = str(tmp_path / "round0.npz")
    session.save(path)
    assert len(session.pols) == 1
    assert _finish_batched(path, 1) == want


@pytest.mark.parametrize("kind", ["pcs", "batched"])
def test_save_after_the_last_round_before_finish(tmp_path, kind):
    """Every round ran (the last element too): the resumed session only
    draws and opens the queries."""
    path = str(tmp_path / "last.npz")
    if kind == "pcs":
        evals, pt, out, want = _pcs_case(5, 80)
        session = PCSProverSession(pt, out, evals, Transcript(), CPU)
        session.launch_rounds()
        session.save(path)
        assert _finish_pcs(path, 5) == want
    else:
        polys, claim, want = _batched_case(3, 5, 90)
        session = BatchedPCSProverSession(claim, polys, Transcript(), CPU)
        session.launch_rounds()
        session.save(path)
        assert _finish_batched(path, 5) == want


@pytest.mark.parametrize("key", ["tree1_cols", "btree_cols"])
def test_a_damaged_payload_does_not_resume(tmp_path, key):
    """A tree rebuilt from a payload that is not the committed one reaches
    another root: resume raises instead of proving from it."""
    polys, claim, _ = _batched_case(2, 6, 100)
    session = BatchedPCSProverSession(claim, polys, Transcript(), CPU)
    session.run_rounds(2)
    path = str(tmp_path / "bad.npz")
    session.save(path)
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k].copy() for k in z.files}
    arrays[key].reshape(-1)[5] ^= 1
    np.savez(path, **arrays)
    with pytest.raises(MerkleRootMismatch):
        BatchedPCSProverSession.resume(path, CPU)


def test_a_checkpoint_of_another_kind_is_refused(tmp_path):
    evals, pt, out, _ = _pcs_case(4, 110)
    session = PCSProverSession(pt, out, evals, Transcript(), CPU)
    path = str(tmp_path / "pcs.npz")
    session.save(path)
    assert checkpoint.checkpoint_kind(path) == "pcs"
    with pytest.raises(ValueError):
        checkpoint.load_batched_pcs_state(path)


# -- SNARK sessions (both phases) --------------------------------------------------


def _snark_fixture(width: int, fp):
    """The JAX package's fixture of tests/test_checkpoint.py: (constraints,
    layout, row-major values), for the package whose field class is ``fp``."""
    log_n = 6
    base = np.arange(1 << log_n, dtype=np.uint64)
    pkg = jsys if fp is JFp else psys
    if width == 1:
        cols = [(base * 7 + 3) % 97]
        cs = pkg.ConstraintSet(constraints=[lambda v, r: v[0] - v[0]], degree=1)
    else:
        a, b = (base * 3 + 1) % 97, (base * 4 + 2) % 97
        cols = [a, b, a * b, a + b]
        cs = pkg.ConstraintSet(constraints=[lambda v, r: v[0] * v[1] - v[2], lambda v, r: v[0] + v[1] - v[3]],
                               degree=2)
    return cs, pkg.WitnessLayout(columns=width), cols


@pytest.mark.parametrize("width", [1, 4])
def test_snark_session_resume_both_phases(tmp_path, width):
    """Saved once mid trace-sumcheck and once mid-PCS: the final proof is
    the JAX package's uninterrupted prove_snark, byte for byte, and
    verifies."""
    jcs, jlayout, cols = _snark_fixture(width, JFp)
    jtrace = jsys.Trace.from_columns(cols)
    jt = JTranscript()
    want = j_snark_to_bytes(jsys.System.prover(jt, jcs, jlayout, jtrace).prove_snark(jt))

    cs, layout, _ = _snark_fixture(width, Fp)
    trace = psys.trace_from_jax_columns(np.asarray(jtrace.columns_device()), "cpu")
    sess = psys.SnarkProverSession(Transcript(), cs, layout, trace, config=CPU)
    sess.run_sumcheck_rounds(max_rounds=3)
    p1 = str(tmp_path / "snark_sc.npz")
    sess.save(p1)
    del sess

    r1 = psys.SnarkProverSession.resume(p1, cs, layout, CPU)
    assert r1.rounds.k == 3 and len(r1.pols) == 3
    r1.run_sumcheck_rounds()
    r1.start_pcs()
    r1.run_pcs_rounds(max_rounds=2)
    p2 = str(tmp_path / "snark_pcs.npz")
    r1.save(p2)
    del r1

    r2 = psys.SnarkProverSession.resume(p2, cs, layout, CPU)
    blob = snark_proof_to_bytes(r2.finish())
    assert blob == want
    vt = Transcript()
    psys.System.verifier(vt, cs, layout, psys.Commitment(), 6).verify_snark(vt, snark_proof_from_bytes(blob))


def test_snark_saved_after_its_last_sumcheck_round(tmp_path):
    """The sumcheck ended and the PCS has not started: the outputs come back
    from the file, and the PCS opens them."""
    jcs, jlayout, cols = _snark_fixture(4, JFp)
    jtrace = jsys.Trace.from_columns(cols)
    jt = JTranscript()
    want = j_snark_to_bytes(jsys.System.prover(jt, jcs, jlayout, jtrace).prove_snark(jt))
    cs, layout, _ = _snark_fixture(4, Fp)
    trace = psys.trace_from_jax_columns(np.asarray(jtrace.columns_device()), "cpu")
    sess = psys.SnarkProverSession(Transcript(), cs, layout, trace, config=CPU)
    sess.launch_sumcheck_rounds()
    path = str(tmp_path / "sc_end.npz")
    sess.save(path)
    resumed = psys.SnarkProverSession.resume(path, cs, layout, CPU)
    assert resumed.rounds.outputs is not None
    assert snark_proof_to_bytes(resumed.finish()) == want


def test_a_resumed_session_saves_again(tmp_path):
    """Checkpoints chain: a resumed session runs a round, is saved and
    resumed once more, and still makes the uninterrupted proof."""
    evals, pt, out, want = _pcs_case(6, 120)
    session = PCSProverSession(pt, out, evals, Transcript(), CPU)
    session.run_rounds(1)
    first, second = str(tmp_path / "first.npz"), str(tmp_path / "second.npz")
    session.save(first)
    resumed = PCSProverSession.resume(first, CPU)
    resumed.launch_rounds(2)
    resumed.save(second)
    blob = _finish_pcs(second, 3)
    assert blob == want
    pcs_proof_from_bytes(blob).verify(Transcript())
