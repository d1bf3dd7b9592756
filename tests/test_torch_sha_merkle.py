"""SHA-256 and Merkle commitments of the PyTorch port held against the JAX
package and ``hashlib``.  Digests and paths are bytes: comparisons are exact.

On CPU tensors ``sha256_words`` runs the plain version of the CUDA kernel;
the JAX side runs its jnp twin (its Pallas kernel is off on the CPU).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multilinear_tpu import sha256 as jsha
from multilinear_tpu.field import limbs as jlimbs
from multilinear_tpu.merkle import MerkleTree as JMerkleTree

from multilinear_tpu_torch import sha256, sha256_cuda
from multilinear_tpu_torch.field import limbs
from multilinear_tpu_torch.field.scalar import P
from multilinear_tpu_torch.merkle import LEFT, RIGHT, MerklePath, MerkleTree


def _messages(n, n_words, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n, n_words), dtype=np.uint32)


def _field_ints(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(16), "little") % P for _ in range(n)]


@pytest.mark.parametrize("n_words", [8, 16])
def test_sha256_words_matches_jax_and_hashlib(n_words):
    n = 37
    msg = _messages(n, n_words, seed=n_words)
    got = sha256.sha256_words(torch.from_numpy(msg.view(np.int32).copy()))
    assert got.shape == (n, 8) and got.dtype == torch.int32
    got_bytes = sha256.digests_to_bytes(got)
    want_jax = np.asarray(jsha.sha256_words(jnp.asarray(msg.T.copy()), n_words))  # (8, n)
    assert np.array_equal(got.numpy().view(np.uint32), want_jax.T)
    be = msg.astype(">u4")
    for i in range(n):
        assert got_bytes[i].tobytes() == hashlib.sha256(be[i].tobytes()).digest()


@pytest.mark.parametrize("n_words", [1, 13, 14, 29, 32])
def test_sha256_words_padding_at_every_block_boundary(n_words):
    """13 words is the longest one-block message, 14 the shortest two-block."""
    msg = _messages(5, n_words, seed=100 + n_words)
    got = sha256.digests_to_bytes(sha256.sha256_words(torch.from_numpy(msg.view(np.int32).copy())))
    be = msg.astype(">u4")
    assert sha256_cuda.n_blocks(n_words) == (4 * n_words + 9 + 63) // 64
    for i in range(5):
        assert got[i].tobytes() == hashlib.sha256(be[i].tobytes()).digest()


def test_sha256_wrapper_rejects_bad_input():
    good = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        sha256_cuda.sha256_words(good.to(torch.int64))
    with pytest.raises(ValueError):
        sha256_cuda.sha256_words(good.reshape(-1))
    with pytest.raises(ValueError):
        sha256_cuda.sha256_words(torch.zeros((8, 4), dtype=torch.int32).t())


def test_limbs_to_words_is_the_q9_byte_order():
    vals = _field_ints(9, seed=5)
    j = jlimbs.pack_ints(vals)
    t = limbs.from_jax_limbs(j)
    words = sha256.limbs_to_words(t)
    assert words.shape == (9, 4)
    want = np.asarray(jsha.limbs_to_words(jnp.asarray(j)))  # (4, 9)
    assert np.array_equal(words.numpy().view(np.uint32), want.T)
    for i, v in enumerate(vals):
        assert words[i].numpy().view(np.uint32).astype(">u4").tobytes() == v.to_bytes(16, "little")


def test_digest_to_bytes_single():
    d = sha256.sha256_words(torch.zeros((1, 8), dtype=torch.int32))
    assert sha256.digest_to_bytes(d[0]) == hashlib.sha256(b"\0" * 32).digest()


@pytest.mark.parametrize("B,log_n", [(2, 5), (1, 3), (4, 4), (2, 1)])
def test_merkle_root_and_paths_match_jax(B, log_n):
    n = 1 << log_n
    vals = _field_ints(B * n, seed=10 * B + log_n)
    j = jlimbs.pack_ints(vals, shape=(B, n))  # (8, B, n)
    t = limbs.from_jax_limbs(j)  # (B, n, 4)
    tree = MerkleTree.commit(t)
    jtree = JMerkleTree.commit(jnp.asarray(j))
    assert tree.num_leaves == n
    assert tree.root_bytes() == jtree.root_bytes()
    idx = sorted({0, n - 1, n // 2, 1 % n, (n // 3) % n})
    paths = tree.open_batch(idx)
    jpaths = jtree.open_batch(idx)
    for i, p, jp in zip(idx, paths, jpaths):
        assert [v.v for v in p.values] == [v.v for v in jp.values]
        assert [v.v for v in p.values] == [vals[b * n + i] for b in range(B)]
        assert p.path == [(bytes(s), int(d)) for s, d in jp.path]
        assert p.verify(tree.root_bytes(), i)
        assert not p.verify(tree.root_bytes(), i ^ 1)


def test_merkle_root_is_plain_hashlib_tree():
    vals = _field_ints(2 * 8, seed=77)
    t = limbs.pack_ints(vals, shape=(2, 8))
    level = [
        hashlib.sha256(vals[i].to_bytes(16, "little") + vals[8 + i].to_bytes(16, "little")).digest()
        for i in range(8)
    ]
    while len(level) > 1:
        level = [hashlib.sha256(level[i] + level[i + 1]).digest() for i in range(0, len(level), 2)]
    assert MerkleTree.commit(t).root_bytes() == level[0]


def test_open_batch_many_is_one_fetch_and_open_single():
    t1 = MerkleTree.commit(limbs.pack_ints(_field_ints(2 * 16, seed=1), shape=(2, 16)))
    t2 = MerkleTree.commit(limbs.pack_ints(_field_ints(2 * 8, seed=2), shape=(2, 8)))
    out = MerkleTree.open_batch_many([t1, t2], [[3, 9], [5]])
    assert [len(o) for o in out] == [2, 1]
    assert out[0][1].verify(t1.root_bytes(), 9) and out[1][0].verify(t2.root_bytes(), 5)
    assert t1.open(3).path == out[0][0].path


def test_path_verify_rejects_tampering():
    tree = MerkleTree.commit(limbs.pack_ints(_field_ints(2 * 16, seed=4), shape=(2, 16)))
    p = tree.open(6)
    root = tree.root_bytes()
    assert p.verify(root, 6)
    sib, d = p.path[2]
    flipped = MerklePath(p.values, p.path[:2] + [(sib, LEFT if d == RIGHT else RIGHT)] + p.path[3:])
    assert not flipped.verify(root, 6)
    other = MerklePath([p.values[1], p.values[0]], p.path)
    assert not other.verify(root, 6)
    assert not p.verify(hashlib.sha256(root).digest(), 6)
