"""Sharded Merkle trees: each rank hashes a contiguous subtree, every rank
hashes the top log W levels from the W gathered subtree roots.

The leaves arrive in the CYCLIC layout of the prover's rows: a rank's leaf
payload holds the leaves j = r mod W (for a pair tree over a codeword of
length m, leaf j = (code[j], code[j + m/2]), both on rank j mod W), and the
leaf hashes come out in that order - from ``fold_commit_leaves`` for a fold
layer, from ``leaf_hashes`` for layer 0 and the batch tree.  The levels above
pair neighbouring leaves, so the digests are regrouped first: ONE all-to-all
of the leaf digests (32 bytes a leaf) turns the cyclic order into contiguous
blocks of q/W leaves (:func:`regroup_send` / :func:`regroup_recv`), which the
``merkle_levels`` kernel hashes up to one subtree root a rank.  The W roots
are all-gathered (32 bytes each) and hashed up to the root on every rank.

The digest levels are stored in natural order, as ``merkle.MerkleTree``'s,
so an opened path is the unsharded tree's path.  Opening (:func:`gather_many`)
gathers on each rank what it holds - leaf payloads on the leaf's rank, the
sibling digests of the lower levels on the subtree's rank, the top levels on
rank 0, and the replicated trees of a FRI chain's tail on rank 0, all in one
``open_gather`` - with zeros elsewhere, and one all-reduce sums them: every
entry comes from exactly one rank.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .. import stats
from ..merkle import MerklePath, MerkleTree, index_lists, opening_shapes, paths_from_openings
from ..sha256_cuda import open_gather, tree_levels
from . import gather_cyclic


def regroup_send(leaf_digests: torch.Tensor, W: int) -> torch.Tensor:
    """The send buffer of the digest regroup: this rank's cyclic leaf
    digests (q/W, 8) - local t is leaf t W + r - cut into W contiguous
    chunks; chunk r' holds the local t that land in rank r''s contiguous
    block of q/W leaves, t in [r' q/W^2, (r'+1) q/W^2)."""
    n = leaf_digests.shape[0]
    if n % W:
        raise ValueError(f"{n} leaf digests a rank do not regroup over {W} ranks")
    return leaf_digests.reshape(W, n // W, 8)


def regroup_recv(recv: torch.Tensor) -> torch.Tensor:
    """The contiguous (q/W, 8) leaf block from the received (W, q/W^2, 8)
    chunks: chunk s holds leaves t W + s, so leaf order interleaves them."""
    return recv.transpose(0, 1).reshape(-1, 8)


class ShardedMerkleTree(MerkleTree):
    """A Merkle tree whose leaves are spread over the ranks (see the module
    docstring).  ``leaf_columns`` is this rank's (B, q/W, 4) cyclic payload;
    ``layers`` are this rank's subtree levels (leaf block first, its root
    last) and then the replicated levels above the W roots, so that
    ``layers[-1][0]`` is the root and ``len(layers) - 1`` the depth, as in
    the unsharded tree."""

    def __init__(self, local_levels: List[torch.Tensor], roots: torch.Tensor, top: List[torch.Tensor],
                 leaf_columns: torch.Tensor, layout):
        super().__init__(local_levels + top, leaf_columns)
        self.n_local_levels = len(local_levels)
        self.roots = roots  # (W, 8): the level of the subtree roots
        self.layout = layout

    @staticmethod
    def from_cyclic_leaves(leaf_digests: torch.Tensor, leaf_columns: torch.Tensor, layout) -> "ShardedMerkleTree":
        """Commit from this rank's cyclic leaf digests (q/W, 8) and payload."""
        comm = layout.comm
        block = regroup_recv(comm.all_to_all(regroup_send(leaf_digests, layout.world))).contiguous()
        local = [block] + tree_levels(block)
        roots = comm.all_gather(local[-1][0])
        return ShardedMerkleTree(local, roots, tree_levels(roots), leaf_columns, layout)

    @staticmethod
    def commit(leaf_columns: torch.Tensor, layout) -> "ShardedMerkleTree":
        """Hash this rank's cyclic (B, q/W, 4) payload and commit."""
        from ..sha256_cuda import leaf_hashes

        return ShardedMerkleTree.from_cyclic_leaves(leaf_hashes(leaf_columns), leaf_columns, layout)

    @property
    def num_leaves(self) -> int:
        return self.layers[0].shape[0] * self.layout.world

    def gathered_leaf_columns(self) -> torch.Tensor:
        """The whole (B, q, 4) payload in natural order, on every rank (one
        all-gather of the cyclic blocks)."""
        return gather_cyclic(self.leaf_columns, self.layout)

    def _gather(self, idx: torch.Tensor) -> torch.Tensor:
        """As ``sha256_cuda.open_gather`` lays out the whole tree's openings
        at the leaf indices ``idx`` (a device tensor), with zeros where this
        rank does not hold the entry."""
        W, r = self.layout.world, self.layout.rank
        zero = torch.zeros((), dtype=torch.int32, device=idx.device)
        own = (idx % W == r)[None, :, None]
        parts = [torch.where(own, self.leaf_columns[:, idx // W], zero).reshape(-1)]
        cur = idx
        depth = len(self.layers) - 1
        for level in range(depth):
            sib = cur ^ 1
            if level < self.n_local_levels - 1:
                per_rank = self.layers[level].shape[0]
                own = (sib // per_rank == r)[:, None]
                parts.append(torch.where(own, self.layers[level][sib % per_rank], zero).reshape(-1))
            else:
                # the W roots and the levels above them are on every rank
                full = self.roots if level == self.n_local_levels - 1 else self.layers[level]
                got = full[sib] if r == 0 else torch.zeros((sib.shape[0], 8), dtype=torch.int32, device=idx.device)
                parts.append(got.reshape(-1))
            cur = cur >> 1
        return torch.cat(parts)


def _gather(trees: Sequence[MerkleTree], idx: np.ndarray, layout) -> torch.Tensor:
    """What this rank holds of the openings of ``trees`` at ``idx``, in
    ``open_gather``'s layout, zeros elsewhere: a sharded tree's entries on
    the ranks that hold them, the replicated trees all in one ``open_gather``
    on rank 0."""
    dev = trees[0].layers[0].device
    replicated = [t for t in trees if not isinstance(t, ShardedMerkleTree)]
    sizes = [(4 * B + 8 * (n.bit_length() - 1)) * len(idx) for B, n in opening_shapes(replicated)]
    if not replicated:
        rest = iter(())
    elif layout.rank == 0:
        rest = iter(open_gather([(t.leaf_columns, t.layers[:-1]) for t in replicated], idx).split(sizes))
    else:
        rest = iter(torch.zeros(sum(sizes), dtype=torch.int32, device=dev).split(sizes))
    return torch.cat([t._gather(torch.as_tensor(idx & (t.num_leaves - 1), device=dev))
                      if isinstance(t, ShardedMerkleTree) else next(rest) for t in trees])


def gather_many(trees: Sequence[MerkleTree], idx: np.ndarray, layout) -> np.ndarray:
    """``MerkleTree.gather_many`` over sharded and replicated trees: each
    rank gathers what it holds, one all-reduce sums the gathers, ONE
    device->host copy brings them back."""
    return stats.fetch(layout.comm.all_reduce_sum(_gather(trees, np.asarray(idx, dtype=np.int64), layout)))


def open_batch_many(trees: Sequence[MerkleTree], idx_lists, layout) -> List[List[MerklePath]]:
    """``MerkleTree.open_batch_many`` over sharded and replicated trees: one
    gather a tree, one all-reduce and ONE device->host copy."""
    lists = index_lists(trees, idx_lists)
    flat = torch.cat([_gather([t], il, layout) for t, il in zip(trees, lists)])
    return paths_from_openings(stats.fetch(layout.comm.all_reduce_sum(flat)), opening_shapes(trees), lists)
