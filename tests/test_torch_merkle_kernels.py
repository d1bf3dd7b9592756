"""The Merkle hashing of the PyTorch port - leaf payloads hashed where they
lie, every level above them from one call - held against the JAX package
and ``hashlib``.  Digests are integers and bytes: the tolerance is 0.

The port's tensors live on the CPU here, so ``leaf_hashes`` and
``tree_levels`` run the plain versions of their CUDA kernels; the JAX side
runs its jnp SHA-256 (its Pallas kernel is off on the CPU).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilinear_tpu.field import limbs as jlimbs
from multilinear_tpu.merkle import MerkleTree as JMerkleTree
from multilinear_tpu.merkle import _leaf_hashes as j_leaf_hashes
from multilinear_tpu.merkle import _tree_levels as j_tree_levels

from multilinear_tpu_torch import merkle, sha256, sha256_cuda
from multilinear_tpu_torch.field import limbs
from multilinear_tpu_torch.field.scalar import P
from multilinear_tpu_torch.fri import _pair_view
from multilinear_tpu_torch.merkle import MerkleTree


def _field_ints(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(16), "little") % P for _ in range(n)]


def _digests(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)


def _bitrev(n):
    bits = n.bit_length() - 1
    return np.array([int(format(i, f"0{bits}b")[::-1], 2) if bits else 0 for i in range(n)])


def _hashlib_tree(leaf_bytes):
    levels, cur = [], list(leaf_bytes)
    while len(cur) > 1:
        cur = [hashlib.sha256(cur[i] + cur[i + 1]).digest() for i in range(0, len(cur), 2)]
        levels.append(cur)
    return levels


@pytest.mark.parametrize("n", [2, 8, 64])
@pytest.mark.parametrize("B", [1, 2, 3, 20])
def test_leaf_hashes_match_jax_and_hashlib(B, n):
    vals = _field_ints(B * n, seed=100 * B + n)
    j = jlimbs.pack_ints(vals, shape=(B, n))  # (8, B, n)
    t = limbs.from_jax_limbs(j)  # (B, n, 4)
    got = merkle.leaf_hashes(t)
    assert got.shape == (n, 8) and got.dtype == torch.int32
    assert torch.equal(got, merkle.leaf_hashes_plain(t))
    want = np.asarray(j_leaf_hashes(jnp.asarray(j), B))  # (8, n)
    assert np.array_equal(got.numpy().view(np.uint32), want.T)
    got_bytes = sha256.digests_to_bytes(got)
    for i in range(n):
        leaf = b"".join(vals[b * n + i].to_bytes(16, "little") for b in range(B))
        assert got_bytes[i].tobytes() == hashlib.sha256(leaf).digest()


@pytest.mark.parametrize("view", ["pair", "columns", "elements", "pair_in_batch"])
def test_leaf_hashes_read_strided_columns(view):
    """The payload is read through its strides: a pair view of a codeword,
    every other column, every other element, a pair view inside a batch."""
    wide = limbs.pack_ints(_field_ints(4 * 16, seed=7), shape=(4, 16))
    cols = {
        "pair": _pair_view(wide[1]),
        "columns": wide[::2],
        "elements": wide[:2, ::2],
        "pair_in_batch": wide.view(8, 8, 4)[2:4],
    }[view]
    got = sha256.digests_to_bytes(merkle.leaf_hashes(cols))
    ints = limbs.unpack_ints(cols.contiguous())
    for i in range(cols.shape[1]):
        leaf = b"".join(int(ints[b, i]).to_bytes(16, "little") for b in range(cols.shape[0]))
        assert got[i].tobytes() == hashlib.sha256(leaf).digest()


@pytest.mark.parametrize("n_levels", range(1, 12))
def test_tree_levels_match_jax_and_hashlib(n_levels):
    n = 1 << n_levels
    leaf = _digests(n, seed=n_levels)
    t = torch.from_numpy(leaf.view(np.int32).copy())
    levels = merkle.tree_levels(t)
    plain = merkle.tree_levels_plain(t)
    assert len(levels) == n_levels and [lv.shape[0] for lv in levels] == [n >> j for j in range(1, n_levels + 1)]
    assert all(torch.equal(a, b) for a, b in zip(levels, plain))
    # hashlib, every level
    want = _hashlib_tree([row.astype(">u4").tobytes() for row in leaf])
    for lv, w in zip(levels, want):
        assert [d.tobytes() for d in sha256.digests_to_bytes(lv)] == w
    # the JAX package keeps the levels above the leaves in bit-reversed order
    jlevels = j_tree_levels(jnp.asarray(leaf.T.copy()))
    assert len(jlevels) == n_levels
    for lv, jl in zip(levels, jlevels):
        jl = np.asarray(jl).T  # (n_l, 8), bit-reversed
        assert np.array_equal(lv.numpy().view(np.uint32), jl[_bitrev(jl.shape[0])])
    assert np.array_equal(levels[-1].numpy().view(np.uint32)[0], np.asarray(jlevels[-1])[:, 0])


@pytest.mark.parametrize("n_leaves", [1, 2, 512, 1024, 2048, 4096, 1 << 20, 1 << 21, 1 << 24])
def test_levels_plan_writes_every_level_once(n_leaves):
    """Each launch reads the level the one before it ended on and writes at
    most as many levels as its block spans; together they write them all."""
    plan = sha256_cuda.levels_plan(n_leaves)
    bits = n_leaves.bit_length() - 1
    n_in = n_leaves
    for digests, k, per_thread in plan:
        assert digests == n_in and per_thread in (1, 4) and 1 <= k
        assert 1 << k <= min(digests, 512 * per_thread)
        n_in >>= k
    assert n_in == 1 and sum(k for _, k, _ in plan) == bits
    assert len(plan) <= 3
    with pytest.raises(ValueError):
        sha256_cuda.levels_plan(3 * n_leaves)


@pytest.mark.parametrize("B,log_n", [(1, 1), (2, 4), (3, 5), (20, 3), (20, 6)])
def test_commit_and_open_batch_verify_and_match_jax(B, log_n):
    n = 1 << log_n
    vals = _field_ints(B * n, seed=31 * B + log_n)
    j = jlimbs.pack_ints(vals, shape=(B, n))
    tree = MerkleTree.commit(limbs.from_jax_limbs(j))
    jtree = JMerkleTree.commit(jnp.asarray(j))
    assert len(tree.layers) == log_n + 1
    assert tree.root_bytes() == jtree.root_bytes()
    idx = sorted({0, n - 1, n // 2, 1 % n})
    for i, p, jp in zip(idx, tree.open_batch(idx), jtree.open_batch(idx)):
        assert [v.v for v in p.values] == [vals[b * n + i] for b in range(B)]
        assert p.path == [(bytes(s), int(d)) for s, d in jp.path]
        assert p.verify(tree.root_bytes(), i)
        assert not p.verify(tree.root_bytes(), (i + 1) % n) or n == 1


def test_wrappers_reject_what_the_kernels_do_not_take():
    good = torch.zeros((2, 8, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        merkle.leaf_hashes(good.to(torch.int64))
    with pytest.raises(ValueError):
        merkle.leaf_hashes(good[0])
    with pytest.raises(ValueError):
        merkle.leaf_hashes(torch.zeros((2, 8, 4), dtype=torch.int32, device="meta"))
    digests = torch.zeros((8, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        merkle.tree_levels(digests.to(torch.int64))
    with pytest.raises(ValueError):
        merkle.tree_levels(digests[:6])
    with pytest.raises(ValueError):
        merkle.tree_levels(digests.t())
    with pytest.raises(ValueError):
        merkle.tree_levels(torch.zeros((8, 8), dtype=torch.int32, device="meta"))
    assert merkle.tree_levels(digests[:1]) == []
