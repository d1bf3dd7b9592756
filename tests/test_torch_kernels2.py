"""The six kernels of the encode, table and fold paths - zeta/Moebius group,
tensor product, double and twiddle-free NTT stages, four-step twiddle, FRI
fold - held against the JAX package.  Exact comparisons: all values are
integers.

The port's tensors live on the CPU here, so every wrapper runs the plain
version of its CUDA kernel; the references are the JAX package's jnp forms,
the ones its own tests hold its TPU kernels against.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilinear_tpu import fri as jfri
from multilinear_tpu import mle as jmle
from multilinear_tpu import ntt as jntt
from multilinear_tpu.field import limbs as jlimbs
from multilinear_tpu.field import ops as jops
from multilinear_tpu.field.scalar import TWO_INV as JTWO_INV
from multilinear_tpu.field.scalar import Fp as JFp

from multilinear_tpu_torch import fri, mle, ntt, stats
from multilinear_tpu_torch.config import ProverConfig
from multilinear_tpu_torch.field import cuda_ops, limbs
from multilinear_tpu_torch.field.scalar import P, Fp
from multilinear_tpu_torch.mle import evaluate_evals_host
from multilinear_tpu_torch.pcs import PCSProof
from multilinear_tpu_torch.transcript import Transcript


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(16), "little") % P for _ in range(n)]


def _both(vals, shape=None):
    """The same values as a JAX limb array (8,)+S and a port tensor S+(4,)."""
    j = jlimbs.pack_ints(vals, shape=shape)
    return jnp.asarray(j), limbs.from_jax_limbs(j)


def _same(t: torch.Tensor, jarr) -> bool:
    return np.array_equal(limbs.to_jax_limbs(t), np.asarray(jarr))


# -- layouts ---------------------------------------------------------------------


def test_batch_layout_round_trip():
    """The JAX package's (8, B, n) batch is the port's (B, n, 4)."""
    B, n = 3, 8
    vals = _ints(B * n, 1)
    j = jlimbs.pack_ints(vals, shape=(B, n))
    t = limbs.from_jax_limbs(j)
    assert j.shape == (8, B, n) and t.shape == (B, n, 4)
    assert np.array_equal(limbs.to_jax_limbs(t), j)
    assert [int(v) for v in limbs.unpack_ints(t).reshape(-1)] == vals
    assert [int(v) for v in limbs.unpack_ints(t[1])] == vals[n : 2 * n]


# -- zm_butterfly ------------------------------------------------------------------


@pytest.mark.parametrize("n_vars", range(1, 11))
def test_zm_transforms_match_jax(n_vars):
    j, t = _both(_ints(1 << n_vars, 200 + n_vars))
    coeffs = mle.to_coeffs(t)
    assert _same(coeffs, jmle.to_coeffs(j))
    assert _same(mle.to_evals(t), jmle.to_evals(j))
    assert torch.equal(mle.to_evals(coeffs), t)


def test_zm_transforms_match_jax_on_a_batch():
    j, t = _both(_ints(3 << 6, 211), shape=(3, 1 << 6))
    assert _same(mle.to_coeffs(t), jmle.to_coeffs(j))
    assert _same(mle.to_evals(t), jmle.to_evals(j))
    assert torch.equal(mle.to_coeffs(t)[1], mle.to_coeffs(t[1].contiguous()))
    assert _same(mle.bit_reverse(t), jmle.bit_reverse(j))


def test_zm_input_is_left_untouched():
    t = limbs.pack_ints(_ints(16, 3))
    before = t.clone()
    cuda_ops.zm_butterfly(t, add=False)
    assert torch.equal(t, before)


@pytest.mark.parametrize("bits", [0, 1, 5, 11, 12, 20, 22, 24, 29])
def test_zm_pass_plan_partitions_the_bits(bits):
    """Each pass's tile (2^c rows by 2^log_w adjacent elements) fits the
    kernel's shared tile (2^13 elements where that saves a pass, else 2^12),
    and rows 2^d apart hold at least the tile's width."""
    passes = cuda_ops.zm_passes(bits)
    tile = cuda_ops.zm_tile_bits(bits)
    assert tile == (13 if bits in (13, 24) else 12)
    covered = []
    for d, c, log_w in passes:
        assert c >= 1 and c + log_w <= tile
        assert log_w <= d or log_w == 0
        if d:
            assert log_w >= 2, "runs of at least 64 bytes above the first pass"
            assert c + log_w == tile, "a later pass fills the tile"
        covered += list(range(d, d + c))
    assert covered == list(range(bits))
    assert len(passes) == {24: 2, 22: 2, 11: 1, 12: 1, 29: 3}.get(bits, len(passes))


@pytest.mark.parametrize("bits", range(1, 27))
def test_zm_pass_plan_covers_every_bit_once(bits):
    for tile_bits in (12, 13):
        passes = cuda_ops.zm_passes(bits, tile_bits)
        assert sorted(b for d, c, _ in passes for b in range(d, d + c)) == list(range(bits))
        assert all(c + w <= tile_bits and w <= d for d, c, w in passes)
        assert len(passes) == (1 if bits <= tile_bits else 1 + -(-(bits - tile_bits) // (tile_bits - 2)))
    assert len(cuda_ops.zm_passes(bits)) <= 2 or bits > 24


@pytest.mark.parametrize("n_vars", range(1, 13))
def test_bitrev_pad_mode_is_bit_reverse_of_to_coeffs_zero_padded(n_vars):
    """The mode the encode uses: its plain version equals the port's own
    ``bit_reverse(to_coeffs(x))`` followed by zero padding, and the JAX
    package's ``mle.bit_reverse(mle.to_coeffs(x))``."""
    n = 1 << n_vars
    j, t = _both(_ints(n, 300 + n_vars))
    for log_blowup in (0, 1, 2):
        got = mle.to_coeffs_bitrev_padded(t, log_blowup) if log_blowup == 1 else \
            cuda_ops.zm_bitrev_pad(t, False, log_blowup)
        assert got.shape == (n << log_blowup, 4)
        assert torch.equal(got[:n], mle.bit_reverse(mle.to_coeffs(t)))
        assert not got[n:].any()
        assert torch.equal(got, cuda_ops.zm_bitrev_pad_plain(t, False, log_blowup))
    assert _same(got[:n], jmle.bit_reverse(jmle.to_coeffs(j)))
    zeta = cuda_ops.zm_bitrev_pad(t, True, 1)
    assert torch.equal(zeta[:n], mle.bit_reverse(mle.to_evals(t))) and not zeta[n:].any()


def test_bitrev_pad_mode_on_a_batch_matches_jax():
    j, t = _both(_ints(3 << 6, 311), shape=(3, 1 << 6))
    got = mle.to_coeffs_bitrev_padded(t, 1)
    assert got.shape == (3, 2 << 6, 4) and not got[:, 1 << 6 :].any()
    assert _same(got[:, : 1 << 6].contiguous(), jmle.bit_reverse(jmle.to_coeffs(j)))
    for k in range(3):
        assert torch.equal(got[k], mle.to_coeffs_bitrev_padded(t[k].contiguous(), 1))
    assert torch.equal(ntt.fourstep_transform(got, ntt.pow2_generator(7).v, 7), fri.encode_mle_for_fri(t))
    assert _same(fri.encode_mle_for_fri(t), jntt.reed_solomon(jmle.bit_reverse(jmle.to_coeffs(j))))


def test_bitrev_pad_mode_rejects_bad_arguments():
    x = limbs.pack_ints(_ints(8, 1))
    with pytest.raises(ValueError):
        cuda_ops.zm_bitrev_pad(x[:6].contiguous(), False, 1)
    with pytest.raises(ValueError):
        cuda_ops.zm_bitrev_pad(x, False, -1)
    with pytest.raises(ValueError):
        cuda_ops.zm_bitrev_pad(torch.zeros((8, 4), dtype=torch.int32, device="meta"), False, 1)


# -- kron_mul ----------------------------------------------------------------------


@pytest.mark.parametrize("m,n", [(1, 1), (3, 5), (16, 32)])
def test_kron_mul_matches_jax(m, n):
    ja, a = _both(_ints(m, 10 + m))
    jb, b = _both(_ints(n, 20 + n))
    got = cuda_ops.kron_mul(a, b)
    assert got.shape == (m * n, 4)
    assert _same(got, jmle._kron_mul(ja, jb))
    out = torch.zeros((m * n, 4), dtype=torch.int32)
    assert cuda_ops.kron_mul(a, b, out=out) is out and torch.equal(out, got)
    assert torch.equal(mle._kron_mul(a, b), got)


def test_kron_mul_on_a_batch_is_the_kron_of_each_row():
    a = limbs.pack_ints(_ints(6, 1), shape=(2, 3))
    b = limbs.pack_ints(_ints(4, 2))
    got = cuda_ops.kron_mul(a, b)
    assert got.shape == (2, 12, 4)
    for k in range(2):
        assert torch.equal(got[k], cuda_ops.kron_mul(a[k].contiguous(), b))


# -- butterfly2, butterfly_notw ------------------------------------------------------


def _two_single_stages(x, pows, ps):
    M = x.shape[-3]
    half = M // 2
    i = torch.arange(half, dtype=torch.int64)
    for s in (2 * ps, 2 * ps + 1):
        tw = pows[cuda_ops.stage_exp(s, i, half)]
        x = cuda_ops.butterfly(x[..., :half, :, :], x[..., half:, :, :], tw).reshape(x.shape)
    return x


@pytest.mark.parametrize("log_m,C,batch", [(2, 1, None), (3, 5, None), (4, 3, None), (5, 2, 3)])
def test_butterfly2_is_two_single_stages(log_m, C, batch):
    M = 1 << log_m
    lead = () if batch is None else (batch,)
    x = limbs.pack_ints(_ints(int(np.prod(lead + (M, C))), 30 + log_m), shape=lead + (M, C))
    pows = ntt.gen_pows(log_m, "cpu")
    for ps in range(log_m // 2):
        assert torch.equal(cuda_ops.butterfly2(x, pows, ps), _two_single_stages(x, pows, ps))


def test_butterfly2_reads_a_strided_power_table():
    """The four-step transform hands the kernel a strided view of the big
    domain's table; the twiddles are the same powers."""
    log_m, C = 3, 4
    x = limbs.pack_ints(_ints(8 * C, 41), shape=(8, C))
    big = ntt.gen_pows(log_m + 2, "cpu")  # 16 powers of the 32-domain root
    view = big[::4][:4]  # powers of its 4th power: the 8-domain root
    assert not view.is_contiguous()
    assert torch.equal(view, ntt.gen_pows(log_m, "cpu"))
    assert torch.equal(cuda_ops.butterfly2(x, view, 0), cuda_ops.butterfly2(x, view.contiguous(), 0))


@pytest.mark.parametrize("H,C", [(1, 1), (4, 8), (5, 3)])
def test_butterfly_notw_matches_jnp_form(H, C):
    """(u + v, u - v), rows interleaved: the general stage with twiddles 1."""
    ju, u = _both(_ints(H * C, 50), shape=(H, C))
    jv, v = _both(_ints(H * C, 51), shape=(H, C))
    got = cuda_ops.butterfly_notw(u, v)
    assert got.shape == (H, 2, C, 4)
    want = jnp.stack([jops.add(ju, jv), jops.sub(ju, jv)], axis=2)  # (8, H, 2, C)
    assert _same(got, want)
    assert torch.equal(got, cuda_ops.butterfly(u, v, limbs.pack_ints([1] * H)))


def test_stage_kernels_take_the_row_halves_of_a_batch():
    x = limbs.pack_ints(_ints(3 * 8 * 2, 60), shape=(3, 8, 2))
    u, v = x[:, :4], x[:, 4:]
    assert not u.is_contiguous()
    got = cuda_ops.butterfly_notw(u, v)
    assert got.shape == (3, 4, 2, 2, 4)
    for k in range(3):
        assert torch.equal(got[k], cuda_ops.butterfly_notw(x[k, :4], x[k, 4:]))
    tw = limbs.pack_ints(_ints(4, 61))
    got = cuda_ops.butterfly(u, v, tw)
    for k in range(3):
        assert torch.equal(got[k], cuda_ops.butterfly(x[k, :4], x[k, 4:], tw))


@pytest.mark.parametrize("log_m", range(1, 10))
def test_pease_stages_match_jax(log_m):
    """Odd and even stage counts: 1 is the single-stage kernel alone, 2 one
    double stage, odd counts end in the twiddle-free stage."""
    M, C = 1 << log_m, 3
    j, x = _both(_ints(M * C, 70 + log_m), shape=(M, C))
    stats.reset()
    got = ntt._pease_rows(x, ntt.gen_pows(log_m, "cpu"), log_m)
    assert _same(got, jntt._pease_axis2(j, jntt.gen_pows(log_m), log_m))
    c = stats.counts()
    assert c.get("ntt_single_stages", 0) == (1 if log_m == 1 else 0)
    assert c.get("ntt_double_stages", 0) == (log_m // 2 if log_m > 1 else 0)
    assert c.get("ntt_notw_stages", 0) == (log_m % 2 if log_m > 1 else 0)


# -- twiddle_mul3 --------------------------------------------------------------------


@pytest.mark.parametrize("A,S,B,batch", [(4, 1, 3, None), (8, 2, 4, None), (16, 4, 8, 2)])
def test_twiddle_mul3_matches_two_jnp_multiplies(A, S, B, batch):
    lead = () if batch is None else (batch,)
    jF, F = _both(_ints(int(np.prod(lead + (A, B))), 80), shape=lead + (A, B))
    jTc, Tc = _both(_ints(A // S * B, 81), shape=(A // S, B))
    jTf, Tf = _both(_ints(S * B, 82), shape=(S, B))
    got = cuda_ops.twiddle_mul3(F, Tc, Tf)
    jFr = jF.reshape((8,) + lead + (A // S, S, B))
    jc = jnp.broadcast_to(jTc[:, :, None, :].reshape((8,) + (1,) * len(lead) + (A // S, 1, B)), jFr.shape)
    jf = jnp.broadcast_to(jTf.reshape((8,) + (1,) * len(lead) + (1, S, B)), jFr.shape)
    want = jops.mul(jops.mul(jFr, jc), jf).reshape(jF.shape)
    assert got.shape == F.shape and _same(got, want)


# -- fold_codeword -------------------------------------------------------------------


@pytest.mark.parametrize("log_n,k", [(1, 0), (5, 0), (5, 2), (7, 1)])
def test_fold_codeword_matches_jax(log_n, k):
    j = jlimbs.pack_ints(_ints(1 << log_n, log_n))
    jcode = jntt.reed_solomon(jnp.asarray(j))
    code = limbs.from_jax_limbs(np.asarray(jcode))
    m = code.shape[0]
    log_domain = log_n + 1 + k
    r = Fp(_ints(1, 99 + k)[0])
    inv_pows = ntt.inv_gen_pows(log_domain, "cpu")
    rh = fri._rh_limbs(r, "cpu")
    got = cuda_ops.fold_codeword(code, inv_pows, 1 << k, rh)
    jtw = jntt.inv_gen_pows(log_domain)[:, :: 1 << k][:, : m // 2]
    want = jfri._fold_codeword(
        jcode, jtw, jnp.asarray(jlimbs.pack_scalar(JFp(r.v))), jnp.asarray(jlimbs.pack_scalar(JTWO_INV))
    )
    assert got.shape == (m // 2, 4) and _same(got, want)
    assert torch.equal(fri._fold_codeword(code, inv_pows, k, rh), got)
    if m % 4 == 0:
        assert torch.equal(cuda_ops.fold_commit_leaves(code, inv_pows, 1 << k, rh)[0], got)


def test_the_last_fold_of_a_chain_takes_the_standalone_kernel():
    """n rounds: n - 1 fused folds that commit, one plain fold that ends the
    chain and commits nothing."""
    n = 4
    evals = limbs.pack_ints(_ints(1 << n, 5))
    pt = [Fp(v) for v in _ints(n, 6)]
    stats.reset()
    proof = PCSProof.prove(pt, evaluate_evals_host(evals, pt), evals, Transcript(), ProverConfig(device="cpu"))
    c = stats.counts()
    assert (c["fri_folds_fused"], c["fri_folds_plain"]) == (n - 1, 1)
    assert len(proof.fri_proof.commitments) == n
    proof.verify(Transcript())


# -- the encode on a batch -------------------------------------------------------------


def test_reed_solomon_and_encode_on_a_batch_match_jax():
    j, t = _both(_ints(3 << 6, 90), shape=(3, 1 << 6))
    code = ntt.reed_solomon(t)
    assert code.shape == (3, 2 << 6, 4)
    assert _same(code, jntt.reed_solomon(j))
    assert torch.equal(code[2], ntt.reed_solomon(t[2].contiguous()))
    want = jntt.reed_solomon(jmle.bit_reverse(jmle.to_coeffs(j)))
    assert _same(fri.encode_mle_for_fri(t), want)


@pytest.mark.parametrize("log_n", [1, 2, 3, 4, 5])
def test_batched_ntt_equals_each_transform(log_n):
    t = limbs.pack_ints(_ints(2 << log_n, 95 + log_n), shape=(2, 1 << log_n))
    got = ntt.ntt(t)
    for k in range(2):
        assert torch.equal(got[k], ntt.ntt(t[k].contiguous()))


# -- the wrappers refuse what the kernels do not take ----------------------------------


def test_new_wrappers_reject_bad_arguments():
    x = limbs.pack_ints(_ints(24, 1), shape=(8, 3))
    pows = ntt.gen_pows(3, "cpu")
    with pytest.raises(ValueError):
        cuda_ops.butterfly2(x, pows, 1)  # 8 rows have stages 0..2 only
    with pytest.raises(ValueError):
        cuda_ops.butterfly2(x[:6].contiguous(), pows, 0)  # not a power of two
    with pytest.raises(ValueError):
        cuda_ops.butterfly2(x, pows[:2], 0)  # table too short
    with pytest.raises(ValueError):
        cuda_ops.butterfly2(x.transpose(0, 1), pows, 0)
    with pytest.raises(ValueError):
        cuda_ops.butterfly_notw(x[:4], x[4:7])
    with pytest.raises(ValueError):
        cuda_ops.twiddle_mul3(x, x[:3].contiguous(), x[:2].contiguous())  # S = 2, 3 rows of Tc
    with pytest.raises(ValueError):
        cuda_ops.kron_mul(x[0], x)  # b must be one vector
    with pytest.raises(ValueError):
        cuda_ops.kron_mul(x[0], x[1], out=torch.zeros((8, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        cuda_ops.zm_butterfly(x[:, :, :].reshape(24, 4)[:6].contiguous(), add=True)
    rh = limbs.pack_int(1)
    with pytest.raises(ValueError):
        cuda_ops.fold_codeword(x[0], pows, 1, rh)  # odd length
    with pytest.raises(ValueError):
        cuda_ops.fold_codeword(x.reshape(24, 4)[:8].contiguous(), pows, 2, rh)  # table too short
    with pytest.raises(ValueError):
        cuda_ops.fold_codeword(x.reshape(24, 4)[:8].contiguous(), pows, 1, x[0])  # rh: not one element


def test_new_wrappers_raise_for_a_tensor_on_an_unknown_device():
    """A wrapper takes its plain version only for a CPU tensor."""
    m = torch.zeros((4, 2, 4), dtype=torch.int32, device="meta")
    flat = torch.zeros((8, 4), dtype=torch.int32, device="meta")
    for call in (
        lambda: cuda_ops.butterfly2(m, flat, 0),
        lambda: cuda_ops.butterfly_notw(m[:2], m[2:]),
        lambda: cuda_ops.twiddle_mul3(m, m[:2], m[:2]),
        lambda: cuda_ops.kron_mul(flat, flat),
        lambda: cuda_ops.zm_butterfly(flat, add=True),
        lambda: cuda_ops.fold_codeword(flat, flat, 1, flat[0]),
    ):
        with pytest.raises(ValueError):
            call()
