"""The port's smaller entry points held against the JAX package's: the
inverse NTT, evaluation in coefficient form, the two MLE object wrappers,
and the field operations ``mul_small``, ``dot_mod`` and ``pow_const``.

The same values, made from a numpy seed, go through both packages (the port
on CPU tensors, through its kernels' plain versions; the JAX package on the
CPU), and the results are compared as integers: exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilinear_tpu import mle as jmle
from multilinear_tpu import ntt as jntt
from multilinear_tpu.field import limbs as jlimbs
from multilinear_tpu.field import ops as jops
from multilinear_tpu.field.scalar import Fp as JFp

from multilinear_tpu_torch import mle, ntt
from multilinear_tpu_torch.field import limbs, ops
from multilinear_tpu_torch.field.scalar import Fp, P

K = 45 * 2**40 - 1
EDGES = [0, 1, 2, P - 1, P - 2, K, K + 1, 2**64, P // 2]


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(16), "little") % P for _ in range(n)]
    vals[: min(n, len(EDGES))] = EDGES[: min(n, len(EDGES))]
    return vals


def _port(vals, shape=None) -> torch.Tensor:
    return limbs.pack_ints(vals, shape=shape)


def _jax(vals, shape=None):
    return jnp.asarray(jlimbs.pack_ints(vals, shape=shape))


def _same(port: torch.Tensor, jax_arr) -> bool:
    return np.array_equal(limbs.to_jax_limbs(port), np.asarray(jax_arr))


@pytest.mark.parametrize("log_n", [0, 3, 9])
def test_intt_matches_jax(log_n):
    vals = _ints(1 << log_n, 10 + log_n)
    assert _same(ntt.intt(_port(vals)), jntt.intt(_jax(vals)))


@pytest.mark.parametrize("shape", [(16,), (3, 32)])
def test_intt_inverts_ntt(shape):
    x = _port(_ints(int(np.prod(shape)), 20), shape=shape)
    assert torch.equal(ntt.intt(ntt.ntt(x)), x)
    assert torch.equal(ntt.ntt(ntt.intt(x)), x)


@pytest.mark.parametrize("n_vars", [0, 1, 6])
def test_evaluate_coeffs_matches_jax(n_vars):
    vals, point = _ints(1 << n_vars, 30 + n_vars), _ints(n_vars, 40 + n_vars)
    got = mle.evaluate_coeffs(_port(vals), [Fp(v) for v in point])
    want = jmle.evaluate_coeffs(_jax(vals), [JFp(v) for v in point])
    assert _same(got, want)


def test_evaluate_coeffs_of_a_batch():
    vals, point = _ints(3 << 5, 50), [Fp(v) for v in _ints(5, 51)]
    got = limbs.unpack_ints(mle.evaluate_coeffs(_port(vals, shape=(3, 32)), point))
    each = [limbs.unpack_int(mle.evaluate_coeffs(_port(vals[32 * j: 32 * (j + 1)]), point)) for j in range(3)]
    assert [int(v) for v in got] == each


def test_multilinear_polynomial_wrappers_match_jax():
    n_vars = 5
    vals, point = _ints(1 << n_vars, 60), _ints(n_vars, 61)
    pc, jc = mle.MultilinearPolynomial(vals, device="cpu"), jmle.MultilinearPolynomial(vals)
    assert pc.n_vars == jc.n_vars == n_vars
    assert [x.v for x in pc.coefficients()] == [x.v for x in jc.coefficients()]
    assert pc.evaluate([Fp(v) for v in point]).v == jc.evaluate([JFp(v) for v in point]).v
    pe, je = pc.to_evaluation(), jc.to_evaluation()
    assert isinstance(pe, mle.MultilinearPolynomialEvals)
    assert [x.v for x in pe.evaluations()] == [x.v for x in je.evaluations()]
    assert pe.evaluate([Fp(v) for v in point]).v == pc.evaluate([Fp(v) for v in point]).v
    back = pe.to_coefficient()
    assert isinstance(back, mle.MultilinearPolynomial) and torch.equal(back.data, pc.data)
    assert [x.v for x in back.coefficients()] == [x.v for x in je.to_coefficient().coefficients()]


def test_wrappers_take_a_tensor_where_it_lies():
    t = _port(_ints(8, 70))
    assert mle.MultilinearPolynomialEvals(t).data is t
    assert mle.MultilinearPolynomial(t, device="cpu").data.device.type == "cpu"


@pytest.mark.parametrize("k", [0, 1, 45, 2**16 - 1])
def test_mul_small_matches_jax(k):
    vals = _ints(100, 80)
    assert _same(ops.mul_small(_port(vals), k), jops.mul_small(_jax(vals), k))


def test_mul_small_refuses_a_large_constant():
    with pytest.raises(ValueError):
        ops.mul_small(_port([3]), 2**16)


def test_dot_mod_matches_jax():
    a, b = _ints(4 * 64, 90), _ints(4 * 64, 91)
    got = ops.dot_mod(_port(a, shape=(4, 64)), _port(b, shape=(4, 64)), dim=1)
    want = jops.dot_mod(_jax(a, shape=(4, 64)), _jax(b, shape=(4, 64)), axis=2)
    assert _same(got, want)
    got0 = ops.dot_mod(_port(a, shape=(4, 64)), _port(b, shape=(4, 64)), dim=0)
    assert _same(got0, jops.dot_mod(_jax(a, shape=(4, 64)), _jax(b, shape=(4, 64)), axis=1))


@pytest.mark.parametrize("e", [0, 1, 2, 2**64 + 3, P - 2])
def test_pow_const_matches_jax(e):
    vals = _ints(40, 100)
    got = ops.pow_const(_port(vals), e)
    assert _same(got, jops.pow_const(_jax(vals), e))
    assert [int(v) for v in limbs.unpack_ints(got)] == [pow(v, e, P) for v in vals]
