"""Field arithmetic of the PyTorch port held against the JAX package and
against Python integers mod p.  All comparisons are exact.

The port's tensors live on the CPU here, so ``ops.mul`` runs the plain
version of the CUDA kernel; the kernel itself is compared with that plain
version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilinear_tpu.field import limbs as jlimbs
from multilinear_tpu.field import ops as jops

from multilinear_tpu_torch.field import cuda_ops, limbs, ops
from multilinear_tpu_torch.field.scalar import K_FOLD, P, Fp, batch_inv, pow2_generator

# 0, 1, p-1 and operands whose sums and products reach every branch of the
# reduction: carries out of 128 bits, both folds by K, the +K after the
# second fold, and the final conditional -p
EDGES = [0, 1, 2, P - 1, P - 2, K_FOLD, K_FOLD + 1, P - K_FOLD, 2**64 - 1, 2**64, 2**127,
         P // 2, (P + 1) // 2, (2**128 - 2**93) % P, 2**93, 2**96 - 1]


def _operands(seed=1, n_random=300):
    rng = np.random.default_rng(seed)
    rnd = [int.from_bytes(rng.bytes(16), "little") % P for _ in range(2 * n_random)]
    a = [x for x in EDGES for _ in EDGES] + rnd[:n_random]
    b = [y for _ in EDGES for y in EDGES] + rnd[n_random:]
    return a, b


A_INTS, B_INTS = _operands()


def _both(vals):
    """The same values as a JAX limb array (8, N) and a port tensor (N, 4)."""
    j = jlimbs.pack_ints(vals)
    return jnp.asarray(j), limbs.from_jax_limbs(j)


def _ints(t):
    return [int(v) for v in limbs.unpack_ints(t).reshape(-1)]


BINARY = {
    "add": (ops.add, jops.add, lambda x, y: (x + y) % P),
    "sub": (ops.sub, jops.sub, lambda x, y: (x - y) % P),
    "mul": (ops.mul, jops.mul, lambda x, y: (x * y) % P),
}
UNARY = {
    "neg": (ops.neg, jops.neg, lambda x: (-x) % P),
    "half": (ops.half, jops.half, lambda x: x * pow(2, -1, P) % P),
}


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_op_matches_jax_and_ints(name):
    port_op, jax_op, int_op = BINARY[name]
    ja, ta = _both(A_INTS)
    jb, tb = _both(B_INTS)
    got = port_op(ta, tb)
    assert got.dtype == torch.int32 and got.shape == ta.shape
    assert _ints(got) == [int_op(x, y) for x, y in zip(A_INTS, B_INTS)]
    assert np.array_equal(limbs.to_jax_limbs(got), np.asarray(jax_op(ja, jb)))


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_op_matches_jax_and_ints(name):
    port_op, jax_op, int_op = UNARY[name]
    ja, ta = _both(A_INTS)
    got = port_op(ta)
    assert _ints(got) == [int_op(x) for x in A_INTS]
    assert np.array_equal(limbs.to_jax_limbs(got), np.asarray(jax_op(ja)))


def test_mul_broadcasts_a_scalar_and_a_row():
    _, ta = _both(A_INTS[:12])
    s = limbs.pack_int(EDGES[3])
    assert _ints(ops.mul(ta, s)) == [x * EDGES[3] % P for x in A_INTS[:12]]
    col = ta.reshape(12, 1, 4)
    row = ta[:5].reshape(1, 5, 4)
    want = [x * y % P for x in A_INTS[:12] for y in A_INTS[:5]]
    assert _ints(ops.mul(col, row)) == want


@pytest.mark.parametrize("n", [1, 2, 7, 256, 1000])
def test_sum_mod_matches_jax_and_ints(n):
    vals = (EDGES * (n // len(EDGES) + 1))[:n]
    vals = [P - 1 - (v % 7) for v in vals]  # large terms: the sum wraps many times
    j, t = _both(vals)
    got = ops.sum_mod(t, dim=0)
    assert limbs.unpack_int(got) == sum(vals) % P
    assert np.array_equal(limbs.to_jax_limbs(got), np.asarray(jops.sum_mod(j, axis=1)))


def test_limb_sums_reduce_the_same_on_host_and_device():
    vals = [P - 1 - i for i in range(500)]
    t = limbs.pack_ints(vals)
    raw = ops.sum_limbs(t, dim=0)
    assert raw.dtype == torch.int64 and raw.shape == (4,)
    assert ops.limb_sums_to_int(raw.tolist()) == sum(vals) % P
    assert limbs.unpack_int(ops.reduce_limb_sums(raw)) == sum(vals) % P
    with pytest.raises(ValueError):
        ops.sum_limbs(t, dim=1)


def test_sum_mod_over_an_inner_axis():
    rng = np.random.default_rng(3)
    vals = [int.from_bytes(rng.bytes(16), "little") % P for _ in range(3 * 10)]
    t = limbs.pack_ints(vals, shape=(3, 10))
    got = _ints(ops.sum_mod(t, dim=1))
    assert got == [sum(vals[10 * i : 10 * i + 10]) % P for i in range(3)]


def test_select_zero_mask_broadcast_and_canonical():
    _, ta = _both(A_INTS[:32])
    _, tb = _both(B_INTS[:32])
    mask = ops.is_zero_mask(ta)
    assert mask.tolist() == [x == 0 for x in A_INTS[:32]]
    assert _ints(ops.select(mask, tb, ta)) == [
        y if x == 0 else x for x, y in zip(A_INTS[:32], B_INTS[:32])
    ]
    b = ops.broadcast_scalar(limbs.pack_int(5), (2, 3))
    assert b.shape == (2, 3, 4) and _ints(b) == [5] * 6
    assert ops.is_canonical(ta)
    bad = ta.clone()
    bad[3] = torch.tensor([-1, -1, -1, -1], dtype=torch.int32)  # 2^128 - 1 >= p
    assert not ops.is_canonical(bad)


def test_limb_round_trip_and_layout_conversion():
    vals = EDGES + A_INTS[-50:]
    j = jlimbs.pack_ints(vals)
    t = limbs.from_jax_limbs(j)
    assert t.shape == (len(vals), 4) and t.dtype == torch.int32
    assert _ints(t) == vals
    assert torch.equal(t, limbs.pack_ints(vals))
    assert np.array_equal(limbs.to_jax_limbs(t), j)
    assert limbs.unpack_int(limbs.pack_int(P + 5)) == 5
    assert [f.v for f in limbs.unpack_fps(t[:3])] == vals[:3]
    # a 2-D value shape keeps its C order
    j2 = jlimbs.pack_ints(vals[:12], shape=(3, 4))
    assert _ints(limbs.from_jax_limbs(j2)) == vals[:12]
    assert limbs.from_jax_limbs(j2).shape == (3, 4, 4)


def test_le_bytes_are_the_wire_format():
    vals = EDGES + A_INTS[-20:]
    j = jlimbs.pack_ints(vals)
    t = limbs.from_jax_limbs(j)
    raw = limbs.to_le_bytes(t)
    assert raw == jlimbs.to_le_bytes(j)
    assert raw == b"".join(v.to_bytes(16, "little") for v in vals)
    assert torch.equal(limbs.from_le_bytes(raw), t)


def test_pack_ints_uint64_fast_path():
    small = np.array([0, 1, 2**63, 2**64 - 1], dtype=np.uint64)
    assert _ints(limbs.pack_ints(small)) == [int(v) for v in small]


def _walk(t, shape, dims, strides):
    """Read ``t`` (expanded to shape+(4,)) the way the strided kernels do:
    three collapsed dims, element strides, d2 fastest."""
    pad = 3 - len(dims)
    dims = [1] * pad + list(dims)
    strides = [0] * pad + list(strides)
    view = torch.as_strided(
        t, tuple(dims) + (4,), tuple(4 * s for s in strides) + (1,), t.storage_offset()
    )
    return view.reshape(tuple(shape) + (4,))


@pytest.mark.parametrize("case", ["contiguous", "scalar", "kron", "twiddle", "halves", "moebius"])
def test_collapse_dims_reads_every_operand_in_place(case):
    """The shapes the prover hands the elementwise kernels collapse to at
    most three strided dims, and walking them reads the broadcast values."""
    base = limbs.pack_ints(list(range(1, 1 + 2 * 3 * 4 * 5)))
    if case == "contiguous":
        a, b = base.reshape(6, 20, 4), base.reshape(6, 20, 4)
    elif case == "scalar":
        a, b = base.reshape(6, 20, 4), base[7]
    elif case == "kron":
        a, b = base[:6].reshape(6, 1, 4), base[:20].reshape(1, 20, 4)
    elif case == "twiddle":
        a = base.reshape(2, 3, 20, 4)
        b = base[:40].reshape(2, 1, 20, 4)
    elif case == "halves":
        t = base.reshape(2, 60, 4)
        a, b = t[:, 30:], t[:, :30]
    else:
        w = base.view(15, 2, 4, 4)
        a, b = w[:, 1], w[:, 0]
    shape = torch.broadcast_shapes(a.shape, b.shape)
    ea, eb = a.expand(shape), b.expand(shape)
    sa, sb = cuda_ops._element_strides(ea), cuda_ops._element_strides(eb)
    out_strides = cuda_ops._element_strides(torch.empty(shape, dtype=torch.int32))
    dims, (ca, cb, co) = cuda_ops.collapse_dims(shape[:-1], [sa, sb, out_strides])
    assert len(dims) <= 3
    if case in ("contiguous", "scalar"):
        assert dims == [120]
    n = 1
    for d in dims:
        n *= d
    assert n == ea.numel() // 4
    assert torch.equal(_walk(ea, shape[:-1], dims, ca), ea)
    assert torch.equal(_walk(eb, shape[:-1], dims, cb), eb)


def test_elementwise_out_may_be_a_strided_view_and_alias():
    vals = A_INTS[:24]
    x = limbs.pack_ints(vals)
    w = x.view(3, 2, 4, 4)
    res = ops.sub(w[:, 1], w[:, 0], out=w[:, 1])
    assert res.data_ptr() == w[:, 1].data_ptr()
    got = _ints(x)
    for blk in range(3):
        for c in range(4):
            lo, hi = vals[8 * blk + c], vals[8 * blk + 4 + c]
            assert got[8 * blk + c] == lo and got[8 * blk + 4 + c] == (hi - lo) % P
    with pytest.raises(ValueError):
        ops.add(x, x, out=x[:5])


def test_limb_misaligned_view_is_not_taken_as_elements():
    flat = torch.zeros(41, dtype=torch.int32)
    assert cuda_ops._element_strides(flat[1:].view(10, 4)) is None
    assert cuda_ops._element_strides(flat[:40].view(10, 4)) == [1]


def test_mul_wrapper_rejects_what_the_kernel_does_not_take():
    _, ta = _both(A_INTS[:4])
    with pytest.raises(ValueError):
        cuda_ops.mul(ta.to(torch.int64), ta)
    with pytest.raises(ValueError):
        cuda_ops.mul(ta.reshape(-1), ta.reshape(-1)[:3])
    with pytest.raises(TypeError):
        cuda_ops.mul(np.zeros((4, 4), np.int32), ta)


def test_scalar_copy_agrees_with_the_tensor_ops():
    assert Fp(3) * Fp(P - 1) == Fp(P - 3)
    g = pow2_generator(5)
    assert g ** 32 == Fp(1) and g ** 16 != Fp(1)
    xs = [Fp(v) for v in A_INTS[20:30] if v]
    assert all(x * y == Fp(1) for x, y in zip(xs, batch_inv(xs)))
    with pytest.raises(ZeroDivisionError):
        Fp(1) / Fp(0)
