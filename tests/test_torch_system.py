"""The constraint-system slice of the PyTorch port held against the JAX package.

``multilinear_tpu_torch.system`` (Expr, ConstraintSet, Trace, System, the
SNARK) and the general half of ``multilinear_tpu_torch.sumcheck`` run here
on CPU tensors, through the plain versions of their kernels - the standalone
round's Fiat-Shamir through ``device_transcript.sumcheck_round_scalars_plain``.
The same traces, made from a numpy seed or taken from the JAX package's own
tests, go through both packages.  Everything compared is field elements and
bytes: every comparison is exact.  At these heights the JAX prover takes its
host routes (tables, rounds and PCS), so no large XLA program is compiled.
"""

import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilinear_tpu import sumcheck as jsc
from multilinear_tpu import system as jsys
from multilinear_tpu.field import limbs as jlimbs
from multilinear_tpu.field.scalar import Fp as JFp
from multilinear_tpu.mle import evaluate_evals as j_evaluate_evals
from multilinear_tpu.mle import mask_scalar as j_mask_scalar
from multilinear_tpu.poly import PolynomialEvals as JPolynomialEvals
from multilinear_tpu.serialize import snark_proof_from_bytes as j_from_bytes
from multilinear_tpu.serialize import snark_proof_to_bytes as j_to_bytes
from multilinear_tpu.transcript import Transcript as JTranscript

from multilinear_tpu_torch import composition as cmp
from multilinear_tpu_torch import device_transcript as dtr
from multilinear_tpu_torch import stats
from multilinear_tpu_torch import sumcheck as psc
from multilinear_tpu_torch import system as psys
from multilinear_tpu_torch.config import ProverConfig
from multilinear_tpu_torch.field import limbs, ops
from multilinear_tpu_torch.field.scalar import Fp, P
from multilinear_tpu_torch.fri import FriError
from multilinear_tpu_torch.mle import evaluate_evals, mask_scalar
from multilinear_tpu_torch.serialize import snark_proof_from_bytes, snark_proof_to_bytes
from multilinear_tpu_torch.testdata import SNARK_CONSTRAINTS, snark_golden_columns
from multilinear_tpu_torch.transcript import Transcript

CPU = ProverConfig(device="cpu", debug_checks=True)
GOLDEN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "multilinear_tpu_torch", "testdata", "snark_golden.json",
)
K = 45 * 2**40 - 1
EDGES = [0, 1, 2, P - 1, P - 2, K, K + 1, 2**64, P // 2]

# the reference's Pythagorean trace (tests/test_batched_snark.py:153-176)
PYTHAGOREAN = [
    3, 4, 5, 7, 5, 12, 13, 17, 8, 15, 17, 23, 7, 24, 25, 31,
    20, 21, 29, 41, 12, 35, 37, 47, 9, 40, 41, 49, 28, 45, 53, 73,
    11, 60, 61, 71, 16, 63, 65, 79, 33, 56, 65, 89, 48, 55, 73, 103,
    13, 84, 85, 97, 36, 77, 85, 113, 39, 80, 89, 119, 65, 72, 97, 137,
]
# the reference snark_test's column (tests/test_batched_snark.py:113-118)
SNARK_TEST_COLUMN = [3, 5, 8, 7, 20, 12, 9, 28, 11, 16, 33, 48, 13, 36, 39, 65]


def _constraint_sets(fp):
    """{name: (constraints, degree, width, randoms)}; ``fp`` is the host
    field class of the package whose values the constraints will meet."""
    return {
        "trivial": ([lambda v, r: v[0] - v[0]], 1, 1, 0),
        "zero": ([lambda v, r: fp(0)], 1, 1, 0),
        "pythagorean": (SNARK_CONSTRAINTS["pythagorean"][0], 2, 4, 0),
        # reads the trace randoms, int constants and a constant-only term
        "randoms": ([lambda v, r: v[0] * v[1] * r[0] - r[1] * 3,
                     lambda v, r: (v[1] - 7) * r[1] + r[0] * r[1]], 2, 2, 2),
        # not satisfied by a random trace; three constraints, two mask bits
        "cubic": ([lambda v, r: v[0] * v[1] * v[2] - v[0] + 5,
                   lambda v, r: v[2] * v[2] * v[1],
                   lambda v, r: -v[1]], 3, 3, 0),
    }


def _random_columns(width: int, log_n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [[int.from_bytes(rng.bytes(16), "little") % P for _ in range(1 << log_n)] for _ in range(width)]


def _rows(name: str, width: int, log_n: int):
    """Row-major trace values of each constraint set: satisfied where the
    set can be (Pythagorean rows, any column for the trivial ones), random
    otherwise."""
    if name == "pythagorean":
        reps = ((1 << log_n) * 4) // len(PYTHAGOREAN)
        return PYTHAGOREAN * reps
    cols = _random_columns(width, log_n, 40 + log_n + width)
    return [cols[j][i] for i in range(1 << log_n) for j in range(width)]


def _systems(name: str, rows, width: int, transcripts):
    """(JAX prover, port prover) over the same rows and constraint set."""
    jcs, jdeg, _, randoms = _constraint_sets(JFp)[name]
    pcs_, pdeg, _, _ = _constraint_sets(Fp)[name]
    jt, pt = transcripts
    jtrace = jsys.Trace(rows, width)
    ptrace = psys.trace_from_jax_columns(np.asarray(jtrace.columns_device()), "cpu")
    jprover = jsys.System.prover(jt, jsys.ConstraintSet(jcs, jdeg),
                                 jsys.WitnessLayout(columns=width, randoms=randoms), jtrace)
    pprover = psys.System.prover(pt, psys.ConstraintSet(pcs_, pdeg),
                                 psys.WitnessLayout(columns=width, randoms=randoms), ptrace, CPU)
    return jprover, pprover


def _fps(t: torch.Tensor):
    return [int(v) for v in limbs.unpack_ints(t).reshape(-1)]


# ---------------------------------------------------------------------------
# one expression: its program (the prover) against host Fp (the verifier)
# ---------------------------------------------------------------------------

_FA_OPS = {
    "fa + fa": lambda a, b: a + b,
    "fa - fa": lambda a, b: a - b,
    "fa * fa": lambda a, b: a * b,
    "-fa": lambda a, b: -a,
    "Fp * fa": lambda a, b: Fp(K) * a,
    "int - fa": lambda a, b: 5 - a,
    "fa + int, fa * Fp": lambda a, b: (a + (P - 1)) * Fp(2**64),
    "negative int * fa": lambda a, b: -3 * a,
    "expression": lambda a, b: a * a + b * b - (a - b) * 7,
}
# the field's add, sub and mul, which run the plain versions on a CPU tensor
_PRIMS = (ops.add, ops.sub, ops.mul)


def _run_elementwise(program: cmp.Program, columns) -> torch.Tensor:
    """``program`` run by ``composition.evaluate`` over whole columns of
    values (each element a point), its constants read from the program
    packed on the columns' device."""
    on = program.on(columns[0].device)
    consts = on[cmp.HEADER_WORDS : cmp.HEADER_WORDS + 4 * len(program.consts)].view(-1, 4)
    return cmp.evaluate(program, [columns[c] for c in program.cols], list(consts), _PRIMS)


@pytest.mark.parametrize("op", sorted(_FA_OPS))
def test_fa_matches_host_fp(op):
    """One expression traced to a program and run elementwise by
    ``composition.evaluate`` (the prover), and called over host Fp (the
    verifier): equal element by element, on random values and the edges."""
    rng = np.random.default_rng(11)
    xs = EDGES + [int.from_bytes(rng.bytes(16), "little") % P for _ in range(40)]
    ys = list(reversed(EDGES)) + [int.from_bytes(rng.bytes(16), "little") % P for _ in range(40)]
    fn = _FA_OPS[op]
    program = cmp.trace(lambda cols: fn(cols[0], cols[1]), 2, None)
    got = _run_elementwise(program, [limbs.pack_ints(xs), limbs.pack_ints(ys)])
    assert got.shape == (len(xs), 4)
    assert _fps(got) == [fn(Fp(x), Fp(y)).v for x, y in zip(xs, ys)]


def test_fa_constant_is_packed_once_and_read_broadcast():
    """A constant is packed once into its program, however often the
    composition uses it, and the program is copied to a device once
    (``Program.on``); every point reads the constant broadcast.  An operand
    outside the field's contract raises."""
    program = cmp.trace(lambda cols: cols[0] * 1234567 + 1234567 * cols[0] - 1234567, 1, None)
    assert program.consts == (1234567,)
    on = program.on("cpu")
    assert program.on(torch.device("cpu")) is on
    assert _fps(on[cmp.HEADER_WORDS : cmp.HEADER_WORDS + 4]) == [1234567]
    got = _run_elementwise(program, [limbs.pack_ints(list(range(8)))])
    assert _fps(got) == [(2 * i * 1234567 - 1234567) % P for i in range(8)]
    with pytest.raises(TypeError):
        cmp.trace(lambda cols: cols[0] * 1.5, 1, None)


# ---------------------------------------------------------------------------
# tables, masks, evaluations, V^-1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width,log_n", [(1, 3), (4, 7)])
def test_for_trace_tables_match_jax(width, log_n):
    cols = _random_columns(width, log_n, 7 * width + log_n)
    flat = [v for c in cols for v in c]
    row_ch = [int.from_bytes(bytes([i + 1]) * 16, "little") % P for i in range(log_n)]
    jt = jsc.SumcheckTables.for_trace([JFp(v) for v in row_ch],
                                      jnp.asarray(jlimbs.pack_ints(flat, shape=(width, 1 << log_n))))
    pt = psc.SumcheckTables.for_trace([Fp(v) for v in row_ch], limbs.pack_ints(flat, shape=(width, 1 << log_n)))
    assert pt.data.shape == (width + 1, 1 << log_n, 4)
    for j in range(width):
        assert limbs.to_le_bytes(pt.data[j]) == jt.host_matrix[j].tobytes()
    assert limbs.to_le_bytes(pt.data[width]) == jt.host_delta.tobytes()


def test_mask_scalar_matches_jax():
    pts = [Fp(3), Fp(P - 5), Fp(K)]
    jpts = [JFp(x.v) for x in pts]
    for n_vars in range(4):
        for index in range(1 << n_vars):
            assert mask_scalar(index, n_vars, pts).v == j_mask_scalar(index, n_vars, jpts).v


def test_batched_evaluate_evals_matches_jax():
    cols = _random_columns(3, 6, 77)
    flat = [v for c in cols for v in c]
    pts = [Fp(v) for v in _random_columns(1, 3, 78)[0][:6]]
    got = evaluate_evals(limbs.pack_ints(flat, shape=(3, 64)), pts)
    want = j_evaluate_evals(jnp.asarray(jlimbs.pack_ints(flat, shape=(3, 64))), [JFp(x.v) for x in pts])
    assert got.shape == (3, 4)
    assert _fps(got) == [int(v) for v in jlimbs.unpack_ints(np.asarray(want))]


@pytest.mark.parametrize("n", range(2, 10))
def test_vandermonde_inverse_matches_jax(n):
    got = psc.vandermonde_inv(n, torch.device("cpu"))
    want = limbs.from_jax_limbs(np.moveaxis(np.asarray(jsc._vandermonde_inv_limbs(n)), -1, 0))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the constraint round's sums
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["trivial", "zero", "pythagorean", "randoms", "cubic", "constant"])
def test_partial_sums_match_jax_host(name):
    """The tables' program sums (the composition traced once, then run at
    every point), reduced on the host, equal the JAX package's host partial
    sums for the same tables and aux."""
    if name == "constant":  # an aux-free composition that is a host scalar
        constraints, degree, width, randoms = None, 0, 2, 0
        jcomp, pcomp, jaux, paux = (lambda cols: JFp(9)), (lambda cols: Fp(9)), None, None
    else:
        jcs, degree, width, randoms = _constraint_sets(JFp)[name]
        pcs_ = _constraint_sets(Fp)[name][0]
        jcomp = jsys.ConstraintSet(jcs, degree).composition_fn()
        pcomp = psys.ConstraintSet(pcs_, degree).composition_fn()
        aux = [int.from_bytes(bytes([5 + i]) * 16, "little") % P for i in range(randoms + len(jcs))]
        jaux = [JFp(v) for v in aux]
        paux = limbs.pack_ints(aux)
    log_n = 5
    cols = _random_columns(width, log_n, 99 + width)
    flat = [v for c in cols for v in c]
    row_ch = [int.from_bytes(bytes([9 + i]) * 16, "little") % P for i in range(log_n)]
    jt = jsc.SumcheckTables.for_trace([JFp(v) for v in row_ch],
                                      jnp.asarray(jlimbs.pack_ints(flat, shape=(width, 1 << log_n))))
    pt = psc.SumcheckTables.for_trace([Fp(v) for v in row_ch], limbs.pack_ints(flat, shape=(width, 1 << log_n)))
    want = jt._partial_sums_host(jcomp, degree + 1, jaux)
    program = cmp.trace(pcomp, width, None if paux is None else len(paux))
    got = pt.program_sums(program, paux, degree + 1, torch.zeros((degree + 1, 4), dtype=torch.int64))
    assert got.dtype == torch.int64 and got.shape == (degree + 1, 4)
    assert [ops.limb_sums_to_int(lanes) for lanes in got.tolist()] == [int(v) % P for v in want]


# ---------------------------------------------------------------------------
# the composition traced to a program, and the round that runs it
# ---------------------------------------------------------------------------


def _both_tables(width: int, log_n: int, seed: int):
    """The same random trace tables in both packages: (JAX, port).  At
    these heights the JAX package keeps its tables on the host."""
    flat = [v for c in _random_columns(width, log_n, seed) for v in c]
    row_ch = [int.from_bytes(bytes([9 + i]) * 16, "little") % P for i in range(log_n)]
    jt = jsc.SumcheckTables.for_trace([JFp(v) for v in row_ch],
                                      jnp.asarray(jlimbs.pack_ints(flat, shape=(width, 1 << log_n))))
    pt = psc.SumcheckTables.for_trace([Fp(v) for v in row_ch], limbs.pack_ints(flat, shape=(width, 1 << log_n)))
    return jt, pt


def _aux_ints(n: int):
    return [int.from_bytes(bytes([5 + i]) * 16, "little") % P for i in range(n)]


def _program_sums(pt: psc.SumcheckTables, comp, width: int, aux, degree: int):
    """The port's sums of a round: ``comp`` traced once, run by the tables'
    route, reduced on the host."""
    program = cmp.trace(comp, width, None if aux is None else len(aux))
    assert program is cmp.trace(comp, width, None if aux is None else len(aux))  # traced once
    got = pt.program_sums(program, None if aux is None else limbs.pack_ints(aux), degree,
                          torch.zeros((degree, 4), dtype=torch.int64))
    return [ops.limb_sums_to_int(lanes) for lanes in got.tolist()]


@pytest.mark.parametrize("name", ["trivial", "zero", "pythagorean", "randoms", "cubic", "constant"])
def test_traced_program_equals_the_eager_composition(name):
    """The composition traced once and run by the plain version of
    ``sumcheck_sums`` over random tables gives the sums of the JAX
    package's device partial sums, which call the same composition at
    every point (``pythagorean`` is the benchmark's euclid4 set;
    ``constant`` returns a host scalar)."""
    if name == "constant":
        jcomp, comp, degree, width, aux = (lambda cols: JFp(9)), (lambda cols: Fp(9)), 1, 2, None
    else:
        jcs, degree, width, randoms = _constraint_sets(JFp)[name]
        jcomp = jsys.ConstraintSet(jcs, degree).composition_fn()
        comp = psys.ConstraintSet(_constraint_sets(Fp)[name][0], degree).composition_fn()
        aux = _aux_ints(randoms + len(jcs))
    _, pt = _both_tables(width, 5, 199 + width)
    jdata = jnp.asarray(limbs.to_jax_limbs(pt.data))
    with jax.disable_jit():  # op by op: no XLA program of the whole composition is compiled
        want = jsc._partial_sums_kernel(jdata, jsc._aux_limbs_arr(None if aux is None else [JFp(v) for v in aux]),
                                        degree + 1, jcomp)
    got = _program_sums(pt, comp, width, aux, degree + 1)
    assert got == [int(v) for v in jlimbs.unpack_ints(np.asarray(want))]


def _every_instruction(e: int, fp=Fp):
    """A composition of degree e in column 0 that reads columns, aux
    scalars, int and ``fp`` constants through +, -, * and unary -."""

    def comp(cols, aux):
        acc = cols[0]
        for _ in range(e - 1):
            acc = acc * cols[0]
        return (acc - 3 * cols[1]) * aux[0] + (-cols[2]) * fp(K) + aux[1] * aux[0] - 7 + (5 - cols[1])

    return comp


@pytest.mark.parametrize("log_n,total_degree", [(4, 1), (6, 2), (10, 3), (5, 18)])
def test_fused_round_equals_the_eager_round(log_n, total_degree):
    """A round of the tables - the program's sums, then ``tables.fold`` -
    gives the JAX package's partial sums and ``_fold_kernel``'s bytes; the
    18-degree case's points take five passes of the kernel's four."""
    e = max(total_degree - 1, 1)
    jt, pt = _both_tables(3, log_n, 300 + log_n)
    jdata = jnp.asarray(limbs.to_jax_limbs(pt.data))
    aux = _aux_ints(2)
    want = jt._partial_sums_host(_every_instruction(e, JFp), total_degree, [JFp(v) for v in aux])
    assert _program_sums(pt, _every_instruction(e), 3, aux, total_degree) == [int(v) % P for v in want]
    r = _aux_ints(3)[2]
    pt.fold(limbs.pack_int(r))
    assert pt.height == 1 << (log_n - 1)
    assert np.array_equal(limbs.to_jax_limbs(pt.data),
                          np.asarray(jsc._fold_kernel(jdata, jnp.asarray(jlimbs.pack_scalar(JFp(r))))))


def test_program_slots_are_reused():
    """A temporary's slot is free after its last read: x^17 - x holds one
    temporary beside its column, whatever its length."""
    program = cmp.trace(_power_constraint(18), 1, 0)
    assert len(program.instrs) == 17 and program.n_temps == 1 and program.slots(18) == 3


@pytest.mark.parametrize("expr,slots", [(lambda v, r: v[0] * v[1] + v[2] + v[3] - v[4], 11),
                                        (lambda v, r: v[0] * v[1] + v[2] * v[3] - v[4], 12)])
def test_program_slots_either_side_of_the_default_shared_memory(expr, slots):
    """A masked degree-2 constraint over 5 columns holds 11 or 12 slots at
    d = 3: at 256 threads 44 or 48 KiB of dynamic shared memory beside the
    kernel's 1 KiB of static, either side of the default 48 KiB (the card's
    smoke runs both); the round's sums equal the JAX package's host partial
    sums."""
    comp = psys.ConstraintSet([expr], 2).composition_fn()
    assert cmp.trace(comp, 5, 1).slots(3) == slots
    jt, pt = _both_tables(5, 4, 500 + slots)
    aux = _aux_ints(1)
    want = jt._partial_sums_host(jsys.ConstraintSet([expr], 2).composition_fn(), 3, [JFp(v) for v in aux])
    assert _program_sums(pt, comp, 5, aux, 3) == [int(v) % P for v in want]


@pytest.mark.parametrize("expr", ["power", "division", "tensor", "returns None"])
def test_a_composition_outside_the_contract_raises(expr):
    bad = {"power": lambda v, r: v[0] ** 2, "division": lambda v, r: v[0] / 2, "tensor": lambda v, r: v[0].a,
           "returns None": lambda v, r: None}[expr]
    with pytest.raises(TypeError):
        cmp.trace(lambda cols, aux: bad(cols, aux), 1, 0)


@pytest.mark.parametrize("name,slot_limit", [("pythagorean", None), ("cubic", None), ("pythagorean", 3)])
def test_fused_rounds_are_counted(monkeypatch, name, slot_limit):
    """``sumcheck_rounds_fused`` reads one a round whose program fits the
    device's limit; a program with more slots than the limit (forced to 0
    for the second prover) takes the loop over the field's add, sub and mul
    instead, to the same polynomials."""
    _, _, width, _ = _constraint_sets(Fp)[name]
    log_n = 4
    loops = []
    sums_loop = cmp._sums_loop
    monkeypatch.setattr(cmp, "_sums_loop", lambda *args: loops.append(args[-1]) or sums_loop(*args))
    pt = Transcript()
    _, pprover = _systems(name, _rows(name, width, log_n), width, (JTranscript(), pt))
    monkeypatch.setattr(cmp, "max_slots", lambda device: slot_limit)
    stats.reset()
    pols, _ = pprover.compute_sumcheck_polynomials(pt, pprover.build_tables(), Fp(0))
    assert stats.counts().get("sumcheck_rounds_fused", 0) == (log_n if slot_limit is None else 0)
    qt = Transcript()
    _, qprover = _systems(name, _rows(name, width, log_n), width, (JTranscript(), qt))
    monkeypatch.setattr(cmp, "max_slots", lambda device: 0)  # wider than a block
    del loops[:]
    want, _ = qprover.compute_sumcheck_polynomials(qt, qprover.build_tables(), Fp(0))
    assert loops == [(ops.add, ops.sub, ops.mul)] * log_n
    assert [[c.v for c in p.nonzero_coeffs] for p in pols] == [[c.v for c in p.nonzero_coeffs] for p in want]


# ---------------------------------------------------------------------------
# the standalone round's plain version against the host schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("degree", [*range(1, 9), 17, 33, 64])
def test_sumcheck_round_plain_matches_host_schedule(degree):
    """Over seeded midstates at every fill 0-63 (and one to two blocks
    absorbed before; above degree 8, where the host's interpolation takes
    a good part of a second, the fills 1-3 and 61-63: each unaligned fill
    % 4 near a block's start and near its end): reduce, s0 = prev - s1, interpolate
    (the host's Lagrange form), absorb c1..cd, draw r, prev' = p(r) - the
    host ``Transcript`` schedule of the JAX package's ``round_poly``."""
    rng = np.random.default_rng(500 + degree)
    vinv = psc.vandermonde_inv(degree + 1, torch.device("cpu"))
    for fill in (range(64) if degree <= 8 else (1, 2, 3, 61, 62, 63)):
        prior = rng.bytes(fill + 64 * (fill % 3))
        host, jhost = Transcript(), JTranscript()
        host.absorb(prior)
        jhost.absorb(prior)
        prev = (0, P - 1, int.from_bytes(rng.bytes(16), "little") % P)[fill % 3]
        lanes = rng.integers(0, (1 << 63) if fill % 2 else (1 << 40), size=(degree, 4), dtype=np.uint64)
        sums = torch.from_numpy(lanes.astype(np.int64))
        state = dtr.state_from_host(host)
        prev_t, r_t = limbs.pack_int(prev), torch.zeros(4, dtype=torch.int32)
        digest = torch.zeros(8, dtype=torch.int32)
        coeffs = torch.zeros((degree, 4), dtype=torch.int32)
        dtr.sumcheck_round_scalars(state, prev_t, digest, sums, vinv, coeffs, r_t)

        evals = [JFp(ops.limb_sums_to_int(row)) for row in lanes.astype(object).tolist()]
        pol = JPolynomialEvals([JFp(prev) - evals[0]] + evals).interpolate()
        for c in pol.coeffs[1:]:
            jhost.absorb(c.to_bytes())
        r = jhost.next_challenge()
        assert _fps(coeffs) == [c.v for c in pol.coeffs[1:]]
        assert _fps(prev_t) == [pol.evaluate(r).v] and _fps(r_t) == [r.v]
        assert bytes(np.asarray(digest.numpy().view(np.uint32), ">u4").tobytes()) == jhost.random()
        assert dtr.state_to_host(state).random() == jhost.random()


def test_degree_above_the_cap_raises(monkeypatch):
    """The one cap on a round's total degree is what a card's shared memory
    holds (``dtr.sumcheck_degree_limit``; the CPU has none): a degree above
    the device's limit raises in the wrapper and in the round loop, and so
    does a degree below 1."""
    assert dtr.sumcheck_degree_limit("cpu") is None

    def call(d):
        dtr.sumcheck_round_scalars(dtr.fresh_state(), torch.zeros(4, dtype=torch.int32),
                                   torch.zeros(8, dtype=torch.int32), torch.zeros((d, 4), dtype=torch.int64),
                                   torch.zeros((d + 1, d + 1, 4), dtype=torch.int32),
                                   torch.zeros((d, 4), dtype=torch.int32), torch.zeros(4, dtype=torch.int32))

    tables = psc.SumcheckTables.for_trace([Fp(3)], limbs.pack_ints([1, 2], shape=(1, 2)))
    with pytest.raises(ValueError):
        call(0)
    with pytest.raises(ValueError):
        psc.DeviceSumcheckRounds(Transcript(), tables, psc.identity_composition, 0, Fp(0))
    call(17)  # above the cap of earlier versions: no limit on the CPU
    monkeypatch.setattr(dtr, "sumcheck_degree_limit", lambda device: 16)
    with pytest.raises(ValueError):
        call(17)
    with pytest.raises(ValueError):
        psc.DeviceSumcheckRounds(Transcript(), tables, psc.identity_composition, 17, Fp(0))


def test_wrapper_raises_for_a_tensor_on_an_unknown_device():
    meta = dict(dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        dtr.sumcheck_round_scalars(torch.zeros(26, **meta), torch.zeros(4, **meta), torch.zeros(8, **meta),
                                   torch.zeros((3, 4), dtype=torch.int64, device="meta"),
                                   torch.zeros((4, 4, 4), **meta), torch.zeros((3, 4), **meta),
                                   torch.zeros(4, **meta))


# ---------------------------------------------------------------------------
# the standalone sumcheck: round polynomials and randoms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["trivial", "pythagorean", "randoms", "cubic"])
def test_compute_all_rounds_matches_jax(name):
    _, _, width, _ = _constraint_sets(Fp)[name]
    log_n = 5
    jt, pt = JTranscript(), Transcript()
    jprover, pprover = _systems(name, _rows(name, width, log_n), width, (jt, pt))
    jpols, jrs = jprover.compute_sumcheck_polynomials(jt, jprover.build_tables(), JFp(0))
    ppols, prs = pprover.compute_sumcheck_polynomials(pt, pprover.build_tables(), Fp(0))
    assert [[c.v for c in p.nonzero_coeffs] for p in ppols] == [[c.v for c in p.nonzero_coeffs] for p in jpols]
    assert [r.v for r in prs] == [r.v for r in jrs]
    assert pt.random() == jt.random()
    if name in ("trivial", "pythagorean"):  # satisfied: the prover's debug check passes
        t = Transcript()
        _systems(name, _rows(name, width, log_n), width, (JTranscript(), t))
        pprover.verify_sumcheck_debug(t, ppols, Fp(0))


# total degrees above the cap of 16 that the standalone round once had
HIGH_DEGREES = [17, 20, 33]


def _power_constraint(total_degree: int):
    """x^e - x with e = total_degree - 1 (the delta factor adds one): zero on
    a column of bits, non-zero at every extension point of a round."""
    e = total_degree - 1

    def constraint(v, r):
        acc = v[0]
        for _ in range(e - 1):
            acc = acc * v[0]
        return acc - v[0]

    return constraint


def _high_degree_systems(total_degree: int, rows, transcripts):
    jt, pt = transcripts
    c = _power_constraint(total_degree)
    jtrace = jsys.Trace(rows, 1)
    ptrace = psys.trace_from_jax_columns(np.asarray(jtrace.columns_device()), "cpu")
    return (jsys.System.prover(jt, jsys.ConstraintSet([c], total_degree - 1), jsys.WitnessLayout(columns=1), jtrace),
            psys.System.prover(pt, psys.ConstraintSet([c], total_degree - 1), psys.WitnessLayout(columns=1), ptrace,
                               CPU))


@pytest.mark.parametrize("total_degree", HIGH_DEGREES)
def test_compute_all_rounds_above_the_old_cap_matches_jax(total_degree):
    rows = _random_columns(1, 4, 70 + total_degree)[0]
    jt, pt = JTranscript(), Transcript()
    jprover, pprover = _high_degree_systems(total_degree, rows, (jt, pt))
    jpols, jrs = jprover.compute_sumcheck_polynomials(jt, jprover.build_tables(), JFp(0))
    ppols, prs = pprover.compute_sumcheck_polynomials(pt, pprover.build_tables(), Fp(0))
    assert all(len(p.nonzero_coeffs) == total_degree for p in ppols)
    assert [[c.v for c in p.nonzero_coeffs] for p in ppols] == [[c.v for c in p.nonzero_coeffs] for p in jpols]
    assert [r.v for r in prs] == [r.v for r in jrs]
    assert pt.random() == jt.random()


@pytest.mark.parametrize("total_degree", HIGH_DEGREES)
def test_snark_above_the_old_cap_matches_jax(total_degree):
    """A SNARK whose constraint has degree total_degree - 1, over a column
    of bits that satisfies it: byte-identical to the JAX package's, and it
    verifies."""
    log_n = 5
    rows = [int(b) for b in np.random.default_rng(80 + total_degree).integers(0, 2, size=1 << log_n)]
    jt, pt = JTranscript(), Transcript()
    jprover, pprover = _high_degree_systems(total_degree, rows, (jt, pt))
    blob = snark_proof_to_bytes(pprover.prove_snark(pt))
    assert blob == j_to_bytes(jprover.prove_snark(jt))
    vt = Transcript()
    cs = psys.ConstraintSet([_power_constraint(total_degree)], total_degree - 1)
    psys.System.verifier(vt, cs, psys.WitnessLayout(columns=1), psys.Commitment(), log_n).verify_snark(
        vt, snark_proof_from_bytes(blob))


def test_debug_checks_refuse_a_non_canonical_trace():
    """With ``debug_checks`` the trace columns are checked where they enter
    the sumcheck, as the JAX package's ``debug_guard`` checks the fold's
    input: a limb pattern of p or more raises."""
    cols = limbs.pack_ints([1, 2, 3, 4], shape=(1, 4))
    cols[0, 2] = torch.tensor([-1, -1, -1, -1], dtype=torch.int32)  # 2^128 - 1 >= p
    with pytest.raises(ValueError):
        psc.SumcheckTables.for_trace([Fp(3), Fp(5)], cols, debug_checks=True)
    psc.SumcheckTables.for_trace([Fp(3), Fp(5)], cols, debug_checks=False)


def test_challenge_set_quirk_q2():
    """Every challenge of the set is one element, the JAX package's."""
    jt, pt = JTranscript(), Transcript()
    jprover, pprover = _systems("randoms", _rows("randoms", 2, 4), 2, (jt, pt))
    ch = pprover.challenges
    values = {x.v for x in ch.row + ch.trace + ch.constraint}
    assert len(values) == 1 and len(ch.row) == 4 and len(ch.trace) == 2 and len(ch.constraint) == 1
    assert values == {x.v for x in jprover.challenges.row}
    assert [m.v for m in pprover.constraint_mask] == [m.v for m in jprover.constraint_mask]


# ---------------------------------------------------------------------------
# SNARK proofs: bytes, cross-verification, rejection
# ---------------------------------------------------------------------------

_PROOFS = {}


def _golden(kind: str) -> dict:
    with open(GOLDEN) as f:
        return json.load(f)[kind]


def _case(case: str):
    """(name of the constraint set, width, log_n, row-major values)."""
    if case == "width1 2^8":
        return "zero", 1, 8, SNARK_TEST_COLUMN * 16
    if case == "pythagorean 2^6":
        return "pythagorean", 4, 6, PYTHAGOREAN * 4
    kind = {"golden width1 2^10": "width1", "golden pythagorean 2^6": "pythagorean"}[case]
    g = _golden(kind)
    cols = snark_golden_columns(kind, g["log_n"], g["seed"])
    rows = [cols[j][i] for i in range(1 << g["log_n"]) for j in range(len(cols))]
    return ("trivial" if kind == "width1" else "pythagorean"), len(cols), g["log_n"], rows


def _both(case: str):
    """(port bytes, JAX bytes) of one SNARK case, proved once per module."""
    if case not in _PROOFS:
        name, width, log_n, rows = _case(case)
        jt, pt = JTranscript(), Transcript()
        jprover, pprover = _systems(name, rows, width, (jt, pt))
        _PROOFS[case] = (snark_proof_to_bytes(pprover.prove_snark(pt)), j_to_bytes(jprover.prove_snark(jt)))
    return _PROOFS[case]


def _verifier(case: str, transcript):
    name, width, log_n, _ = _case(case)
    cons, degree, _, randoms = _constraint_sets(Fp)[name]
    return psys.System.verifier(transcript, psys.ConstraintSet(cons, degree),
                                psys.WitnessLayout(columns=width, randoms=randoms), psys.Commitment(), log_n)


def _verify(case: str, blob: bytes) -> None:
    t = Transcript()
    _verifier(case, t).verify_snark(t, snark_proof_from_bytes(blob))


CASES = ["width1 2^8", "golden width1 2^10", "pythagorean 2^6"]


@pytest.mark.parametrize("case", CASES)
def test_snark_bytes_identical(case):
    port_bytes, jax_bytes = _both(case)
    assert port_bytes == jax_bytes


@pytest.mark.parametrize("case", CASES)
def test_each_verifies_the_others_snark(case):
    port_bytes, jax_bytes = _both(case)
    _verify(case, jax_bytes)
    name, width, log_n, _ = _case(case)
    jcons, degree, _, randoms = _constraint_sets(JFp)[name]
    jt = JTranscript()
    jsys.System.verifier(jt, jsys.ConstraintSet(jcons, degree), jsys.WitnessLayout(columns=width, randoms=randoms),
                         jsys.Commitment(), log_n).verify_snark(jt, j_from_bytes(port_bytes))


def _tampered(what: str) -> bytes:
    blob = _both("pythagorean 2^6")[0]
    if what == "flipped byte":
        bad = bytearray(blob)
        bad[len(bad) // 2] ^= 0x01
        return bytes(bad)
    if what == "truncated":
        return blob[:-1]
    if what == "trailing byte":
        return blob + b"\0"
    if what == "bad tag":
        tag = 8 + 6 * (8 + 3 * 16) + 8 + 4 * 16 + 16  # round polynomials, outputs, sum
        assert blob[tag] == 1
        return blob[:tag] + b"\x02" + blob[tag + 1:]
    proof = snark_proof_from_bytes(blob)
    if what == "output":
        proof.outputs[1] = proof.outputs[1] + Fp(1)
    elif what == "round coefficient":
        proof.sumcheck_polynomials[2].nonzero_coeffs[0] += Fp(1)
    elif what == "over-degree round polynomial":
        for p in proof.sumcheck_polynomials:
            p.nonzero_coeffs.append(Fp(0))
    return snark_proof_to_bytes(proof)


@pytest.mark.parametrize("what", ["output", "round coefficient", "over-degree round polynomial", "flipped byte",
                                  "truncated", "trailing byte", "bad tag"])
def test_tampered_snark_is_rejected(what):
    with pytest.raises((ValueError, FriError)):
        _verify("pythagorean 2^6", _tampered(what))


def test_pcs_claim_must_be_the_sumcheck_point():
    """A PCS proof of another claim is refused even where the sumcheck replay
    passes: the SNARK of one Pythagorean trace with the PCS proof of another."""
    other_rows = [v * 3 % P for v in PYTHAGOREAN * 4]
    pt = Transcript()
    other = _systems("pythagorean", other_rows, 4, (JTranscript(), pt))[1].prove_snark(pt)
    proof = snark_proof_from_bytes(_both("pythagorean 2^6")[0])
    proof.pcs = other.pcs
    t = Transcript()
    with pytest.raises(psys.SnarkError):
        _verifier("pythagorean 2^6", t).verify_snark(t, proof)


@pytest.mark.parametrize("kind", ["width1", "pythagorean"])
def test_golden_digest_matches_both_packages(kind):
    """The fixture chip_smoke.py checks the card's bytes against, recomputed
    here from both packages so that it cannot rot."""
    g = _golden(kind)
    port_bytes, jax_bytes = _both(f"golden {kind} 2^{g['log_n']}")
    assert len(port_bytes) == g["proof_bytes"]
    assert hashlib.sha256(jax_bytes).hexdigest() == g["sha256"]
    assert hashlib.sha256(port_bytes).hexdigest() == g["sha256"]


# ---------------------------------------------------------------------------
# sessions, copies, traces
# ---------------------------------------------------------------------------


def _port_prover(case: str, transcript):
    name, width, _, rows = _case(case)
    return _systems(name, rows, width, (JTranscript(), transcript))[1]


def test_session_in_stages_equals_one_shot():
    name, width, _, rows = _case("pythagorean 2^6")
    cons, degree, _, _ = _constraint_sets(Fp)[name]
    jtrace = jsys.Trace(rows, width)
    trace = psys.trace_from_jax_columns(np.asarray(jtrace.columns_device()), "cpu")
    s = psys.SnarkProverSession(Transcript(), psys.ConstraintSet(cons, degree), psys.WitnessLayout(columns=width),
                                trace, config=CPU)
    assert s.run_sumcheck_rounds(2) == 2
    assert s.launch_sumcheck_rounds(1) == 1
    assert s.run_sumcheck_rounds() == 3
    assert s.run_pcs_rounds(2) == 2
    assert snark_proof_to_bytes(s.finish()) == _both("pythagorean 2^6")[0]


@pytest.mark.parametrize("case,pcs_copies", [("width1 2^8", 2), ("pythagorean 2^6", 3)])
def test_one_host_copy_for_the_sumcheck_phase(monkeypatch, case, pcs_copies):
    """The trace sumcheck copies to the host once, after its last round
    (coefficients, randoms, the folded columns - the outputs - and the device
    transcript's digest); the PCS as many times as on its own.  Every copy of
    the prover goes through ``stats.fetch``; count the calls."""
    shapes = []
    real = stats.fetch

    def counting(t):
        shapes.append(tuple(t.shape))
        return real(t)

    monkeypatch.setattr(stats, "fetch", counting)
    pt = Transcript()
    prover = _port_prover(case, pt)
    name, width, log_n, _ = _case(case)
    degree = _constraint_sets(Fp)[name][1] + 1
    s = psys.SnarkProverSession(pt, None, None, None, system=prover)
    assert s.launch_sumcheck_rounds() == log_n
    assert shapes == [], "a sumcheck round copied to the host"
    s.run_sumcheck_rounds()
    assert shapes == [(log_n * degree * 4 + log_n * 4 + width * 4 + 8,)]
    blob = snark_proof_to_bytes(s.finish())
    assert len(shapes) == 1 + pcs_copies
    assert blob == _both(case)[0]


def test_trace_carried_from_jax():
    rng = np.random.default_rng(3)
    rows = [int.from_bytes(rng.bytes(16), "little") % P for _ in range(3 * 16)]
    jtrace = jsys.Trace(rows, 3)
    trace = psys.trace_from_jax_columns(np.asarray(jtrace.columns_device()), "cpu")
    assert (trace.width, trace.height) == (3, 16)
    assert torch.equal(trace.columns_device(), psys.Trace(rows, 3, "cpu").columns_device())
    assert all(trace.get(i, j).v == jtrace.get(i, j).v for i in (0, 5, 15) for j in range(3))
    pts = [Fp(v) for v in rows[:4]]
    assert [x.v for x in trace.evaluate(pts)] == [x.v for x in jtrace.evaluate([JFp(p.v) for p in pts])]
    cols = [np.asarray(rng.integers(0, 2**63, size=16, dtype=np.uint64)) for _ in range(2)]
    a = psys.Trace.from_columns(cols, "cpu")
    b = psys.Trace([int(cols[j][i]) for i in range(16) for j in range(2)], 2, "cpu")
    assert torch.equal(a.columns_device(), b.columns_device())
    with pytest.raises(ValueError):
        psys.Trace(list(range(12)), 2, "cpu")


@pytest.mark.parametrize("how", ["rows", "numpy columns", "jax columns"])
def test_trace_defaults_to_the_config_device(monkeypatch, how):
    """A trace built without a device goes where ``ProverConfig().device``
    says (the card), as every entry point does; an explicit device wins."""
    asked = []
    real = psys.ProverConfig
    monkeypatch.setattr(psys, "ProverConfig", lambda: asked.append(1) or real(device="cpu"))
    build = {"rows": lambda **kw: psys.Trace([1, 2, 3, 4], 2, **kw),
             "numpy columns": lambda **kw: psys.Trace.from_columns([np.arange(4, dtype=np.uint64)], **kw),
             "jax columns": lambda **kw: psys.trace_from_jax_columns(np.zeros((8, 2, 4), np.uint32), **kw)}[how]
    assert build().columns_device().device.type == "cpu" and asked == [1]
    assert build(device="cpu").columns_device().device.type == "cpu" and asked == [1]
    assert psys.Trace.from_columns(limbs.pack_ints([1, 2], shape=(1, 2))).columns_device().device.type == "cpu"
    assert asked == [1]  # a tensor stays where it is


@pytest.mark.parametrize("what", ["random", "coefficient", "digest"])
def test_replay_refuses_a_device_that_disagrees(what):
    """The host's replay must draw the randoms the device folded with and
    reach the device's digest: a wrong value in any of the three raises."""
    pt = Transcript()
    prover = _port_prover("pythagorean 2^6", pt)
    rounds = psc.DeviceSumcheckRounds(pt, prover.build_tables(), prover.constraints.composition_fn(),
                                      prover.constraints.degree + 1, Fp(0), prover.aux)
    assert rounds.launch() == 6
    target = {"random": rounds.randoms[3], "coefficient": rounds.coeffs[2, 1], "digest": rounds.digest[:4]}[what]
    target[0] ^= 1
    with pytest.raises(dtr.TranscriptMismatch):
        rounds.replay()
