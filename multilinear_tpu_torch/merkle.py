"""SHA-256 Merkle commitments: device-hashed levels, host path logic.

Capability parity with reference src/merkle_tree/mod.rs (commit, open,
verify; no leaf/node domain separation; Direction-encoded paths whose
directions also re-derive the leaf index on verify):

* the leaf level is hashed from the payload where it lies (``leaf_hashes``:
  no byte-swapped copy, no concatenated messages), and the levels above it
  several to a launch (``tree_levels``), all slices of one allocation;
* the digest levels stay on the device; opening gathers the leaf payloads
  and sibling digests of ALL queries of ALL trees into one tensor, in one
  launch (``open_gather``), so the query phase costs one device->host copy;
  a prover's proof holds them as they came (``fri.OpenedQueries``) and the
  serializer packs them into its bytes without building paths
  (``serialize.pack_queries``);
* path verification is host-side hashlib (it is O(queries * log n)).

Levels are stored in NATURAL order: the children of digest i of level l+1
are digests 2i and 2i+1 of level l.  (The JAX package stores upper levels
bit-reversed to dodge an XLA tiling cost; roots and opened paths are
identical either way.)

Leaf payloads are field-element vectors: a leaf's message bytes are the
concatenated 16-LE-byte encodings of its elements (reference
``ReedSolomonPair`` byte view, src/fri/mod.rs:37-43).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import stats
from .field import limbs
from .field.scalar import Fp
from .sha256 import digests_to_bytes
from .sha256_cuda import leaf_hashes, leaf_hashes_plain, open_gather, tree_levels, tree_levels_plain  # noqa: F401


class MerkleRootMismatch(ValueError):
    """A tree rebuilt from its payload does not reach the root it was saved
    with: the payload is not the one that was committed."""


# Direction encoding, matching the reference enum (src/merkle_tree/mod.rs:13-18):
# the direction tells where the SIBLING sits relative to the path node.
RIGHT = 0  # current index even: sibling is the right child
LEFT = 1  # current index odd:  sibling is the left child


class MerkleTree:
    """Binary SHA-256 tree over a power-of-two number of leaves.

    ``leaf_columns`` is the committed payload, (B, n, 4): B field elements
    per leaf.  ``layers`` are (n_i, 8) digest-word tensors, leaf level first.
    """

    def __init__(self, layers: List[torch.Tensor], leaf_columns: torch.Tensor):
        self.layers = layers
        self.leaf_columns = leaf_columns
        self._root_bytes = None

    @staticmethod
    def commit(leaf_columns: torch.Tensor) -> "MerkleTree":
        B, n, _ = leaf_columns.shape
        assert n & (n - 1) == 0 and n > 0, "leaf count must be a power of two"
        leaf = leaf_hashes(leaf_columns)
        return MerkleTree([leaf] + tree_levels(leaf), leaf_columns)

    @staticmethod
    def rebuild(payloads: Sequence[torch.Tensor], roots: Sequence[bytes]) -> List["MerkleTree"]:
        """Trees committed anew from their leaf payloads (a checkpoint keeps
        the payloads and the roots, not the digest levels), with the same
        kernels as :meth:`commit`.  The rebuilt roots come to the host in ONE
        copy, and each must equal its saved root."""
        return MerkleTree.check_roots([MerkleTree.commit(p) for p in payloads], roots)

    @staticmethod
    def check_roots(trees: Sequence["MerkleTree"], roots: Sequence[bytes]) -> List["MerkleTree"]:
        """``trees`` (rebuilt ones, a sharded tree too) with their roots
        brought to the host in ONE copy; each must equal its saved root."""
        trees = list(trees)
        if not trees:
            return trees
        words = stats.fetch(torch.stack([t.root_words for t in trees]))
        for i, (t, w, root) in enumerate(zip(trees, words, roots)):
            t.set_root_words(w)
            if t.root_bytes() != root:
                raise MerkleRootMismatch(f"tree {i} rebuilt from its payload has root {t.root_bytes().hex()}, "
                                         f"not the saved {root.hex()}")
        return trees

    @property
    def num_leaves(self) -> int:
        return self.layers[0].shape[0]

    def gathered_leaf_columns(self) -> torch.Tensor:
        """The whole leaf payload (B, n, 4) in natural order (a sharded tree
        gathers it from every rank's block)."""
        return self.leaf_columns

    @property
    def root_words(self) -> torch.Tensor:
        """The (8,) root digest words, on the tree's device."""
        return self.layers[-1][0]

    @property
    def has_root_bytes(self) -> bool:
        return self._root_bytes is not None

    def set_root_words(self, words) -> None:
        """Install the root from its (8,) digest words already on the host
        (a caller that fetched them together with other data)."""
        self._root_bytes = digests_to_bytes(np.asarray(words).reshape(1, 8))[0].tobytes()

    def root_bytes(self) -> bytes:
        if self._root_bytes is None:
            self.set_root_words(stats.fetch(self.root_words))
        return self._root_bytes

    # -- opening -------------------------------------------------------------
    @staticmethod
    def gather_many(trees: Sequence["MerkleTree"], idx) -> np.ndarray:
        """The openings of ``trees`` at the query indices ``idx`` (each tree
        at ``idx`` modulo its leaf count), laid out as
        ``sha256_cuda.open_gather`` lays them out, on the host: one launch on
        the card and ONE device->host copy."""
        return stats.fetch(open_gather([(t.leaf_columns, t.layers[:-1]) for t in trees], idx))

    @staticmethod
    def open_batch_many(trees: Sequence["MerkleTree"], idx_lists) -> List[List["MerklePath"]]:
        """Open several trees at many indices each with ONE device->host copy
        (one ``open_gather`` a tree, concatenated on the device)."""
        lists = index_lists(trees, idx_lists)
        flat = torch.cat([open_gather([(t.leaf_columns, t.layers[:-1])], il) for t, il in zip(trees, lists)])
        return paths_from_openings(stats.fetch(flat), opening_shapes(trees), lists)

    def open_batch(self, indices: Sequence[int]) -> List["MerklePath"]:
        return MerkleTree.open_batch_many([self], [indices])[0]

    def open(self, index: int) -> "MerklePath":
        return self.open_batch([index])[0]


def index_lists(trees: Sequence[MerkleTree], idx_lists) -> List[np.ndarray]:
    """Each tree's indices as an int64 array; an index outside its tree
    raises ``IndexError``."""
    lists = [np.asarray(list(il), dtype=np.int64) for il in idx_lists]
    for t, il in zip(trees, lists):
        if il.size and (il.min() < 0 or il.max() >= t.num_leaves):
            raise IndexError(f"a query index outside a tree of {t.num_leaves} leaves")
    return lists


def opening_shapes(trees: Sequence[MerkleTree]) -> List[Tuple[int, int]]:
    """Each tree's (payload columns B, leaf count n): what reading its
    openings needs."""
    return [(t.leaf_columns.shape[0], t.num_leaves) for t in trees]


def paths_from_openings(flat: np.ndarray, shapes, idx_lists) -> List[List["MerklePath"]]:
    """The paths of trees of ``shapes`` (``opening_shapes``), each opened at
    its own indices, from their openings in ``open_gather``'s layout."""
    out, off = [], 0
    for (B, n), il in zip(shapes, idx_lists):
        nq, L = len(il), n.bit_length() - 1
        vals = limbs.unpack_ints(flat[off : off + B * nq * 4].view(np.uint32).reshape(B, nq, 4))
        off += B * nq * 4
        sibs = digests_to_bytes(flat[off : off + L * nq * 8]).reshape(L, nq, 32)
        off += L * nq * 8
        paths = []
        for q in range(nq):
            cur = int(il[q])
            path = []
            for l in range(L):
                path.append((sibs[l, q].tobytes(), RIGHT if cur % 2 == 0 else LEFT))
                cur //= 2
            paths.append(MerklePath([Fp(int(vals[b, q])) for b in range(B)], path))
        out.append(paths)
    return out


@dataclass
class MerklePath:
    """Inclusion path: leaf payload + (sibling digest, direction) per level.

    Matches reference MerkleInclusionPath (src/merkle_tree/mod.rs:20-24);
    ``verify`` recomputes both the root and the index from the directions
    (src/merkle_tree/mod.rs:216-246).
    """

    values: List[Fp]  # the leaf's field elements
    path: List[Tuple[bytes, int]]  # (sibling digest bytes, LEFT/RIGHT)

    def __post_init__(self):
        stats.bump("merkle_paths_built")

    def leaf_bytes(self) -> bytes:
        return b"".join(v.to_bytes() for v in self.values)

    def verify(self, root: bytes, index: int) -> bool:
        h = hashlib.sha256(self.leaf_bytes()).digest()
        computed_index = 0
        for i, (sib, direction) in enumerate(self.path):
            if direction == LEFT:
                computed_index += 1 << i
                h = hashlib.sha256(sib + h).digest()
            else:
                h = hashlib.sha256(h + sib).digest()
        return h == root and computed_index == index
