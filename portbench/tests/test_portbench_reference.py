"""The plain reference against the program's proof bytes at small sizes on
the CPU, byte for byte, and the comparison's verdict on a flipped byte."""

import hashlib
import random

import pytest
import torch

from portbench.core import inputs
from portbench.reference import euclid4
from portbench.reference import field as F
from portbench.reference import pcs as ref_pcs
from portbench.reference import sha256 as ref_sha
from portbench.reference import snark as ref_snark
from portbench.reference.proof import compare
from portbench.reference.transcript import Transcript as RefTranscript

P = F.P
EDGES = [0, 1, 2, P - 1, P - 2, F.C, F.C + 1, 2**64 - 1, 2**64, 2**127, P // 2, (P + 1) // 2, 2**93, 2**96 - 1,
         P - F.C, 2**128 - 2**96 - 1]


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_field_matches_python_integers(op):
    rng = random.Random(op)
    a = [rng.randrange(P) for _ in range(500)] + [x for x in EDGES for _ in EDGES]
    b = [rng.randrange(P) for _ in range(500)] + [y for _ in EDGES for y in EDGES]
    want = {"add": lambda x, y: (x + y) % P, "sub": lambda x, y: (x - y) % P, "mul": lambda x, y: x * y % P}[op]
    got = F.to_ints(getattr(F, op)(F.from_ints(a), F.from_ints(b)))
    assert got == [want(x, y) for x, y in zip(a, b)]


def test_limb_layouts_and_bytes_round_trip():
    vals = EDGES + [random.Random(1).randrange(P) for _ in range(40)]
    x = F.from_ints(vals)
    assert torch.equal(F.from_u32_limbs(F.to_u32_limbs(x)), x)
    assert F.to_bytes(x) == b"".join(v.to_bytes(16, "little") for v in vals)
    assert F.sum_mod(x) == sum(vals) % P


def test_sha256_and_trees_match_hashlib():
    vals = [random.Random(2).randrange(P) for _ in range(64)]
    x = F.from_ints(vals)
    leaf = [hashlib.sha256(vals[i].to_bytes(16, "little") + vals[i + 32].to_bytes(16, "little")).digest()
            for i in range(32)]
    got = ref_sha.words_to_bytes(ref_sha.leaf_digests([x[:, :32], x[:, 32:]]))
    assert [g.tobytes() for g in got] == leaf
    level = leaf
    while len(level) > 1:
        level = [hashlib.sha256(level[i] + level[i + 1]).digest() for i in range(0, len(level), 2)]
    old = ref_sha.HOST_LEVEL
    try:
        for host_level in (1, 4, 1 << 12):  # device levels, mixed, host only
            ref_sha.HOST_LEVEL = host_level
            tree = ref_sha.Tree(ref_sha.leaf_digests([x[:, :32], x[:, 32:]]))
            assert tree.root() == level[0]
            assert tree.siblings([5])[0][0] == leaf[4]
    finally:
        ref_sha.HOST_LEVEL = old


def _port_pcs(evals, pt, out, nonce):
    from multilinear_tpu_torch.config import ProverConfig
    from multilinear_tpu_torch.field.scalar import Fp
    from multilinear_tpu_torch.pcs import PCSProof
    from multilinear_tpu_torch.serialize import pcs_proof_to_bytes
    from multilinear_tpu_torch.transcript import Transcript

    t = Transcript()
    t.absorb(nonce)
    return pcs_proof_to_bytes(PCSProof.prove([Fp(v) for v in pt], Fp(out), evals, t, ProverConfig(device="cpu")))


@pytest.mark.parametrize("log_n", [1, 3, 6])
def test_pcs_reference_equals_the_program_byte_for_byte(log_n):
    evals = inputs.uniform(inputs.generator(3, log_n, device="cpu"), (1 << log_n,), "cpu")
    pt = inputs.point(3, log_n, n=log_n)
    ev = F.from_u32_limbs(evals)
    out = ref_pcs.mle_eval(ev, pt)
    nonce = inputs.nonce(3, log_n)
    blob = _port_pcs(evals, pt, out, nonce)
    t = RefTranscript()
    t.absorb(nonce)
    want = ref_pcs.prove(ev, pt, out, t)
    diff = compare(blob, bytes(want.buf), want.sections())
    assert diff["bytes"] == 0 and len(blob) == len(want.buf), diff
    assert [name for name, _, _ in want.sections()] == ["commitments", "queries", "last", "rounds", "claim"]


def test_snark_reference_equals_the_program_byte_for_byte():
    from multilinear_tpu_torch.config import ProverConfig
    from multilinear_tpu_torch.serialize import snark_proof_to_bytes
    from multilinear_tpu_torch.system import ConstraintSet, System, Trace, WitnessLayout
    from multilinear_tpu_torch.transcript import Transcript

    h = 1 << 6
    gen = inputs.generator(4, device="cpu")
    cols = euclid4.rows(F.from_u32_limbs(inputs.uniform(gen, (h,), "cpu")),
                        F.from_u32_limbs(inputs.uniform(gen, (h,), "cpu")))
    cs = ConstraintSet([lambda v, r: v[0] * v[0] + v[1] * v[1] - v[2] * v[2], lambda v, r: v[0] + v[1] - v[3]], 2)
    t = Transcript()
    t.absorb(b"request")
    trace = Trace.from_columns(F.to_u32_limbs(cols))
    blob = snark_proof_to_bytes(System.prover(t, cs, WitnessLayout(columns=4), trace,
                                              ProverConfig(device="cpu")).prove_snark(t))
    rt = RefTranscript()
    rt.absorb(b"request")
    want = ref_snark.prove(cols, euclid4.CONSTRAINTS, euclid4.DEGREE, rt)
    diff = compare(blob, bytes(want.buf), want.sections())
    assert diff["bytes"] == 0 and len(blob) == len(want.buf), diff


def test_a_flipped_byte_is_counted_in_its_section():
    ev = F.from_ints(list(range(3, 3 + 16)))
    pt = [5, 6, 7, 8]
    t = RefTranscript()
    want = ref_pcs.prove(ev, pt, ref_pcs.mle_eval(ev, pt), t)
    good = bytes(want.buf)
    for name, start, end in want.sections():
        bad = bytearray(good)
        bad[(start + end) // 2] ^= 1
        diff = compare(bytes(bad), good, want.sections())
        assert diff["bytes"] == 1 and diff[name] == 1, (name, diff)
    short = compare(good[:-5], good, want.sections())
    assert short["bytes"] == 5 and short["claim"] == 5
    assert compare(good + b"x", good, want.sections())["bytes"] == 1
