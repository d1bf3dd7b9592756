"""NTT, Reed-Solomon and multilinear transforms of the PyTorch port held
against the JAX package and against direct evaluation.  Exact comparisons.

The port's tensors live on the CPU, so every butterfly stage runs the plain
version of the CUDA kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilinear_tpu import fri as jfri
from multilinear_tpu import mle as jmle
from multilinear_tpu import ntt as jntt
from multilinear_tpu.field import limbs as jlimbs

from multilinear_tpu_torch import fri, mle, ntt
from multilinear_tpu_torch.field import cuda_ops, limbs
from multilinear_tpu_torch.field.scalar import P, Fp, pow2_generator


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(16), "little") % P for _ in range(n)]


def _both(vals):
    j = jlimbs.pack_ints(vals)
    return jnp.asarray(j), limbs.from_jax_limbs(j)


def _same(t: torch.Tensor, jarr) -> bool:
    return np.array_equal(limbs.to_jax_limbs(t), np.asarray(jarr))


def _vals(t):
    return [int(v) for v in limbs.unpack_ints(t).reshape(-1)]


@pytest.mark.parametrize("H,C", [(1, 1), (4, 8), (5, 3)])
def test_butterfly_stage_formulas(H, C):
    """out[i,0] = u[i]+v[i], out[i,1] = (u[i]-v[i])*tw[i], rows interleaved."""
    u, v, tw = _ints(H * C, 1), _ints(H * C, 2), _ints(H, 3)
    out = cuda_ops.butterfly(
        limbs.pack_ints(u, shape=(H, C)), limbs.pack_ints(v, shape=(H, C)), limbs.pack_ints(tw)
    )
    assert out.shape == (H, 2, C, 4)
    got = limbs.unpack_ints(out)
    for i in range(H):
        for c in range(C):
            assert int(got[i, 0, c]) == (u[i * C + c] + v[i * C + c]) % P
            assert int(got[i, 1, c]) == (u[i * C + c] - v[i * C + c]) * tw[i] % P


def test_butterfly_wrapper_rejects_bad_shapes():
    x = limbs.pack_ints(_ints(8, 1), shape=(2, 4))
    with pytest.raises(ValueError):
        cuda_ops.butterfly(x, x, limbs.pack_ints(_ints(3, 2)))
    with pytest.raises(ValueError):
        cuda_ops.butterfly(x, x[:1], limbs.pack_ints(_ints(2, 2)))
    with pytest.raises(ValueError):
        cuda_ops.butterfly(x.transpose(0, 1), x.transpose(0, 1), limbs.pack_ints(_ints(4, 2)))


@pytest.mark.parametrize("log_n", [0, 1, 2, 5])
def test_ntt_is_evaluation_on_the_domain(log_n):
    n = 1 << log_n
    coeffs = _ints(n, 40 + log_n)
    got = _vals(ntt.ntt(limbs.pack_ints(coeffs)))
    g = pow2_generator(log_n).v if log_n else 1
    for i in range(n):
        x = pow(g, i, P)
        assert got[i] == sum(c * pow(x, k, P) for k, c in enumerate(coeffs)) % P


@pytest.mark.parametrize("log_n", [6, 7, 8])
def test_ntt_and_reed_solomon_match_jax(log_n):
    j, t = _both(_ints(1 << log_n, log_n))
    assert _same(ntt.ntt(t), jntt.ntt(j))
    code = ntt.reed_solomon(t)
    assert code.shape == (2 << log_n, 4)
    assert _same(code, jntt.reed_solomon(j))


@pytest.mark.parametrize("log_size", [0, 1, 4, 9])
def test_power_tables_match_jax(log_size):
    assert _same(ntt.gen_pows(log_size, "cpu"), jntt.gen_pows(log_size))
    assert _same(ntt.inv_gen_pows(log_size, "cpu"), jntt.inv_gen_pows(log_size))
    if log_size:
        g = pow2_generator(log_size)
        got = _vals(ntt.gen_pows(log_size, "cpu"))
        assert got == [(g ** i).v for i in range(1 << (log_size - 1))]


@pytest.mark.parametrize("log_n", [1, 6, 8])
def test_moebius_zeta_and_bit_reverse_match_jax(log_n):
    j, t = _both(_ints(1 << log_n, 60 + log_n))
    coeffs = mle.to_coeffs(t)
    assert _same(coeffs, jmle.to_coeffs(j))
    assert torch.equal(mle.to_evals(coeffs), t)
    assert _same(mle.to_evals(t), jmle.to_evals(j))
    assert _same(mle.bit_reverse(t), jmle.bit_reverse(j))
    assert torch.equal(mle.bit_reverse(mle.bit_reverse(t)), t)


def test_to_coeffs_small_case_by_hand():
    # f(x0, x1) with evals [f00, f01, f10, f11], x0 the MSB (quirk Q8)
    e = [3, 10, 20, 45]
    got = _vals(mle.to_coeffs(limbs.pack_ints(e)))
    assert got == [3, 7, 17, (45 - 10 - 20 + 3) % P]


@pytest.mark.parametrize("log_n", [6, 7, 8])
def test_encode_mle_for_fri_matches_jax(log_n):
    j, t = _both(_ints(1 << log_n, 80 + log_n))
    assert _same(fri.encode_mle_for_fri(t), jfri.encode_mle_for_fri(j))


@pytest.mark.parametrize("n_vars", [1, 3, 9, 10])
def test_delta_table_and_evaluation_match_jax(n_vars):
    """9 and 10 variables cross the 8-variable host sub-table boundary, so
    the tensor-product combine (broadcast + mul) runs."""
    pts = _ints(n_vars, 90 + n_vars)
    table = mle.delta_table(pts, "cpu")
    assert _same(table, jmle.delta_table([Fp(p).v for p in pts]))
    if n_vars <= 3:
        want = []
        for i in range(1 << n_vars):
            bits = [(i >> (n_vars - 1 - k)) & 1 for k in range(n_vars)]
            want.append(mle.eq_scalar(pts, bits).v)
        assert _vals(table) == want
    j, t = _both(_ints(1 << n_vars, 95 + n_vars))
    got = mle.evaluate_evals_host(t, pts)
    assert got.v == jmle.evaluate_evals_host(j, pts).v


def test_eq_scalar_on_the_cube():
    assert mle.eq_scalar([0, 1, 1], [0, 1, 1]) == Fp(1)
    assert mle.eq_scalar([0, 1, 1], [0, 0, 1]) == Fp(0)
