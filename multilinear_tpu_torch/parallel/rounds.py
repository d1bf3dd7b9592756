"""The sharded prover state: sumcheck tables, FRI layers and the batched
FRI's batch layer, each a rank's cyclic block (see the package docstring).

Counterpart of the JAX package's ``sharded_rounds.make_pcs_round`` /
``make_fri_round`` and their wiring in ``pcs._device_rounds`` and
``fri._device_fri_rounds``.  The round itself is ``pcs.DeviceRounds.round``
unchanged: it asks the tables for the round's sums, launches the same
``round_scalars`` kernel on every rank (the same sums, the same gathered
root, so the same challenge), folds the tables and calls the FRI layer's
``fold_step``.  Per round, a rank:

* sums its block by the single device's route, reduces the sums to
  canonical residues and adds them over the ranks (``comm.exact_sum``: 64
  bytes);
* folds its table block and its codeword block, and hashes the new pair
  leaves (``fold_commit_leaves``), with no traffic: in the cyclic layout the
  pairs (i, i + m/2) and (i, i + m/4) lie on one rank.  The fold's twiddle
  for local t is inv_g^(2^k (t W + r)): the kernel reads a power table of
  inv_g^W, 1/W of the domain's, and r/2 arrives multiplied by inv_g^(2^k r);
* regroups the leaf digests into its contiguous subtree and hashes it, and
  hashes the top levels from the gathered roots (``parallel.merkle``):
  (W - 1)/W of 32 bytes a leaf of its block, and 32 (W - 1) bytes.

A SNARK's trace sumcheck (``sumcheck.DeviceSumcheckRounds`` on
:meth:`ShardedTables.for_trace`) runs the same way: its composition is
elementwise, so each rank runs its program on its block
(``composition.round_sums``, the ``sumcheck_sums`` kernel where the program
fits a block); the d sums cross the ranks (32 d bytes a round), every rank
launches the same ``sumcheck_round_scalars`` and the fold
(``sumcheck_fold``) moves nothing.

**Where sharding stops.**  A round runs sharded while the codeword it folds
has at least 4 W^2 values: its q = m/4 new leaves then give each rank pair
at least one digest to regroup (the JAX package's gate is q >= W).  Below,
the codeword is gathered onto every rank and the rest of the chain runs
there redundantly with the single-device code; the tables likewise once a
rank's block is down to one row.  The tail holds a few dozen values.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import stats
from ..batched_fri import BatchedFriProverData, _fingerprint_codes
from ..config import LOG_BLOWUP
from ..field import cuda_ops, limbs, ops
from ..field.scalar import ONE, Fp, P, pow2_generator
from ..fri import FriError, FriProverData, _pair_view, _rh_limbs
from ..merkle import MerkleTree
from ..mle import factor_subtables
from ..ntt import _pow_table, inv_gen_pows
from ..sumcheck import SumcheckTables, _pack_tables_kernel
from ..transcript import Transcript
from . import ShardLayout, gather_cyclic, to_cyclic
from .merkle import ShardedMerkleTree, gather_many
from .ntt import check_sizes, encode_cyclic


def check_rows(log_n: int, layout: ShardLayout) -> None:
    """Raise unless a 2^log_n-row prove splits over the layout's ranks: a
    rank's block turns cyclic (n >= W^2), the encode splits, the first tree
    regroups (m >= 2 W^2)."""
    w = layout.log_world
    if log_n < 2 * w:
        raise ValueError(f"2^{log_n} rows are too few to prove over {layout.world} ranks")
    check_sizes(log_n, w)


def encode_rows(evals: torch.Tensor, layout: ShardLayout):
    """A rank's contiguous block of evaluations -> (its cyclic block of them,
    its cyclic block of the codeword)."""
    cyc = to_cyclic(evals, layout)
    return cyc, encode_cyclic(cyc, layout)


def batch_to_rows(x: torch.Tensor, layout: ShardLayout) -> torch.Tensor:
    """(B/W, m, 4) whole polynomials or codewords of this rank -> (B, m/W, 4):
    every polynomial's cyclic rows of this rank, ONE all-to-all."""
    Bl, m, _ = x.shape
    W = layout.world
    send = x.view(Bl, m // W, W, 4).permute(2, 0, 1, 3)
    return layout.comm.all_to_all(send).reshape(W * Bl, m // W, 4)


def _eq_factors(points: Sequence[Fp], layout: ShardLayout):
    """The host factors of this rank's delta block: delta[t W + r] =
    eq(points[:N-w], t) * eq(points[N-w:], r).  The rank's factor of the
    last w variables is one scalar, folded into the first factor; the
    tensor product (``kron_mul``) of the others is the block - no rank
    builds the whole table."""
    w, r = layout.log_world, layout.rank
    N = len(points)
    pts = [Fp(p) for p in points]
    s = ONE
    for j in range(N - w, N):
        s = s * (pts[j] if (r >> (N - 1 - j)) & 1 else ONE - pts[j])
    factors = [((ONE - p).v, p.v) for p in pts[: N - w]]
    factors[0] = (factors[0][0] * s.v % P, factors[0][1] * s.v % P)
    return factors


class ShardedTables(SumcheckTables):
    """A rank's cyclic block of the packed (columns || delta) table; the
    height is the whole table's.  ``counter`` is the ``stats`` counter a
    round with sums over the ranks bumps: ``rounds_sharded`` for the PCS,
    ``sc_rounds_sharded`` for a SNARK's trace sumcheck."""

    def __init__(self, data: torch.Tensor, height: int, layout: ShardLayout, debug_checks: bool = False,
                 counter: str = "rounds_sharded"):
        super().__init__(data, height, debug_checks)
        self.layout = layout
        self.counter = counter
        self.sharded = True

    @staticmethod
    def for_pcs(inputs: Sequence[Fp], evals: torch.Tensor, layout: ShardLayout,
                debug_checks: bool = False) -> "ShardedTables":
        """Tables of the claim p(inputs) = output from this rank's cyclic
        block of the evaluations (:func:`_eq_factors`)."""
        if evals.shape[0] * layout.world != 1 << len(inputs):
            raise ValueError("need one input per variable of the MLE")
        data = _pack_tables_kernel(evals, factor_subtables(_eq_factors(inputs, layout), evals.device))
        return ShardedTables(data, 1 << len(inputs), layout, debug_checks)

    @staticmethod
    def for_trace(row_challenges: Sequence[Fp], columns: torch.Tensor, layout: ShardLayout,
                  debug_checks: bool = False) -> "ShardedTables":
        """The counterpart of ``SumcheckTables.for_trace`` from this rank's
        cyclic block (w, h/W, 4) of the trace columns: the packed (w+1, h/W,
        4) block, whose rows are rows t W + r of the single-rank table."""
        if columns.dim() != 3 or columns.shape[-1] != 4:
            raise ValueError(f"trace columns must be a (w, h/W, 4) limb tensor, got {tuple(columns.shape)}")
        if columns.shape[1] * layout.world != 1 << len(row_challenges):
            raise ValueError("need one row challenge per variable of the trace")
        if debug_checks and not ops.is_canonical(columns):
            raise ValueError("non-canonical field element in the trace columns")
        data = _pack_tables_kernel(columns, factor_subtables(_eq_factors(row_challenges, layout), columns.device))
        return ShardedTables(data, 1 << len(row_challenges), layout, debug_checks, "sc_rounds_sharded")

    @staticmethod
    def from_whole(data: torch.Tensor, height: int, layout: ShardLayout, debug_checks: bool = False,
                   counter: str = "rounds_sharded") -> "ShardedTables":
        """This rank's tables from the whole (w+1, height, 4) table of a
        checkpoint: its cyclic block while a block keeps at least two rows,
        else the whole table on every rank, as a round's sums leave it once
        gathered (:meth:`_over_ranks`)."""
        if data.shape[1] >= 2 * layout.world:
            return ShardedTables(layout.cyclic_rows(data), height, layout, debug_checks, counter)
        tables = ShardedTables(data.to(layout.device), height, layout, debug_checks, counter)
        tables.sharded = False
        return tables

    def gathered(self) -> torch.Tensor:
        """The whole table in natural order, on every rank (a collective
        while the table is sharded)."""
        return gather_cyclic(self.data, self.layout) if self.sharded else self.data

    def _over_ranks(self, local_sums, *args) -> torch.Tensor:
        """The round's sums over the whole table: ``local_sums(*args)`` on
        this rank's block (the single device's route), reduced, then added
        over the ranks (``comm.exact_sum``: 32 bytes an evaluation); once a
        block is down to one row, the table is gathered (w+1 rows of W
        values) and the rest runs on the whole table on every rank."""
        if self.sharded and self.data.shape[1] < 2:
            self.data = gather_cyclic(self.data, self.layout)
            self.sharded = False
        local = local_sums(*args)
        if not self.sharded:
            return local
        stats.bump(self.counter)
        before = stats.counts().get("collective_bytes", 0)
        sums = self.layout.comm.exact_sum(local)
        stats.append(self.counter + "_sum_bytes", stats.counts()["collective_bytes"] - before)
        return sums

    def program_sums(self, program, aux, degree: int, out: torch.Tensor) -> torch.Tensor:
        return self._over_ranks(super().program_sums, program, aux, degree, out)


class ShardedFriProverData(FriProverData):
    """The FRI layers of a rank: its cyclic block of the current codeword,
    one :class:`ShardedMerkleTree` a sharded layer, plain trees in the tail.
    Each round appends the collective bytes this rank sent since the last
    (or since :meth:`mark_bytes`) to ``stats``' ``round_collective_bytes``."""

    def __init__(self, layout: ShardLayout, log_domain: int, debug_checks: bool = False):
        super().__init__()
        self.layout = layout
        self.debug_checks = debug_checks
        self._log_domain = log_domain
        W, r = layout.world, layout.rank
        inv_g = pow2_generator(log_domain).inv().v
        dev = layout.device
        # U[t] = inv_g^(W t) for the local folds, and inv_g^(2^k r) a round
        self._inv_pows = _pow_table(pow(inv_g, W, P), log_domain - 1 - layout.log_world, dev)
        self._rank_tw = limbs.pack_ints([pow(inv_g, r << k, P) for k in range(log_domain)], device=dev)
        self.sharded = True
        self._tail_k = 0
        self._bytes_mark = 0

    @staticmethod
    def init(code: torch.Tensor, layout: ShardLayout, transcript: Optional[Transcript],
             debug_checks: bool = False) -> "ShardedFriProverData":
        """Commit to this rank's cyclic block of the initial codeword."""
        m = code.shape[0] * layout.world
        if m < 2 * layout.world ** 2 or m & (m - 1):
            raise ValueError(f"a codeword of {m} values is too short to commit over {layout.world} ranks")
        data = ShardedFriProverData(layout, m.bit_length() - 1, debug_checks)
        data._current = code
        data._guard(code, "codeword")
        tree = ShardedMerkleTree.commit(_pair_view(code), layout)
        data.trees.append(tree)
        if transcript is not None:
            transcript.absorb(tree.root_bytes())
        return data

    def mark_bytes(self) -> None:
        self._bytes_mark = stats.counts().get("collective_bytes", 0)

    def _record_round(self) -> None:
        now = stats.counts().get("collective_bytes", 0)
        stats.append("round_collective_bytes", now - self._bytes_mark)
        self._bytes_mark = now

    def _gather_tail(self, k: int) -> None:
        self._current = gather_cyclic(self._current, self.layout)
        self.sharded = False
        self._tail_k = k
        self._inv_pows = inv_gen_pows(self._log_domain - k, self._current.device)

    def fold_step(self, k: int, rh: torch.Tensor) -> None:
        """``FriProverData.fold_step`` on the rank's block, or in the tail on
        the gathered codeword."""
        W = self.layout.world
        m = self._current.shape[0] * (W if self.sharded else 1)
        blowup = 1 << LOG_BLOWUP
        if m <= blowup:
            return
        if self.sharded and m < 4 * W * W:
            self._gather_tail(k)
        code = self._current
        if self.sharded:
            stats.bump("fri_folds_fused")
            stats.bump("fri_rounds_sharded")
            nxt, digs = cuda_ops.fold_commit_leaves(code, self._inv_pows, 1 << k, ops.mul(rh, self._rank_tw[k]))
            self.push(nxt, ShardedMerkleTree.from_cyclic_leaves(digs, _pair_view(nxt), self.layout))
        else:
            # the tail's twiddles are those of its own domain
            super().fold_step(k - self._tail_k, rh)
        self._record_round()

    @staticmethod
    def fold(code: torch.Tensor, transcript: Transcript, layout: ShardLayout) -> "ShardedFriProverData":
        """The standalone FRI's init + rounds (challenges drawn on the host),
        from this rank's cyclic block of the codeword."""
        data = ShardedFriProverData.init(code, layout, transcript)
        data.mark_bytes()
        for k in range(data._log_domain - LOG_BLOWUP):
            data.fold_step(k, _rh_limbs(transcript.next_challenge(), code.device))
            data.absorb_fold(transcript)
        return data

    def gather_openings(self, trees, idx):
        return gather_many(trees, idx, self.layout)

    @staticmethod
    def resume(payloads: Sequence[torch.Tensor], roots: Sequence[bytes], log_domain: int,
               last_element: Optional[Fp], layout: ShardLayout, debug_checks: bool = False) -> "ShardedFriProverData":
        """This rank's FRI layers from a checkpoint's whole pair payloads
        (natural order, host or device) and roots, as :meth:`fold_step` left
        them: a layer of at least 2 W^2 values was made on the blocks (its
        cyclic block, its tree rebuilt over the ranks), a smaller one in the
        gathered tail (whole on every rank).  ONE copy brings every rebuilt
        root back; a root that differs raises ``MerkleRootMismatch``."""
        data = ShardedFriProverData(layout, log_domain, debug_checks)
        W = layout.world
        trees = []
        for p in payloads:
            if 2 * p.shape[1] >= 2 * W * W:
                trees.append(ShardedMerkleTree.commit(layout.cyclic_rows(p), layout))
            else:
                trees.append(MerkleTree.commit(p.to(layout.device)))
        data.trees = MerkleTree.check_roots(trees, roots)
        if last_element is not None:
            data.last_element = last_element
        elif data.trees:
            data._current = data.trees[-1].leaf_columns.reshape(-1, 4)
            if not isinstance(data.trees[-1], ShardedMerkleTree):
                # the tail began at the round that folded a codeword of
                # fewer than 4 W^2 values: 2^(log_domain - k) < 4 W^2
                k = log_domain - 2 * layout.log_world - 1
                data.sharded = False
                data._tail_k = k
                data._inv_pows = inv_gen_pows(log_domain - k, data._current.device)
        return data


class ShardedBatchedFriProverData(BatchedFriProverData):
    """The batched FRI over ranks that each hold the same rows of all B
    codewords (their cyclic blocks): the batch tree and the fingerprint are
    per row, and the first fold and every later one are the sharded plain
    folds."""

    def __init__(self, batch_tree, fingerprint_r: Fp, codes: Optional[torch.Tensor],
                 fri_data: "ShardedFriProverData"):
        """``codes``: the rows the first fold consumes (None once it has, as
        in a resumed session); ``fri_data``: the plain layers that follow."""
        self.batch_tree = batch_tree
        self.fingerprint_r = fingerprint_r
        self.fingerprint_limbs = limbs.pack_scalar(fingerprint_r, fri_data.layout.device)
        self.fri_data = fri_data
        self._codes = codes

    @staticmethod
    def init(rows: torch.Tensor, transcript: Transcript, layout: ShardLayout,
             debug_checks: bool = False) -> "ShardedBatchedFriProverData":
        """``rows``: this rank's cyclic blocks (B, m/W, 4) of the B codewords
        (``batch_to_rows`` of whole codewords, or the row-sharded encode).
        The batch commit, its root (one copy), fingerprint_r."""
        if debug_checks and not ops.is_canonical(rows):
            raise FriError("non-canonical field element in codewords")
        B, ml, _ = rows.shape
        tree = ShardedMerkleTree.commit(rows.contiguous().view(2 * B, ml // 2, 4), layout)
        transcript.absorb(tree.root_bytes())
        fingerprint_r = transcript.next_challenge()
        transcript.absorb(fingerprint_r.to_bytes())
        m = ml * layout.world
        return ShardedBatchedFriProverData(tree, fingerprint_r, rows,
                                           ShardedFriProverData(layout, m.bit_length() - 1, debug_checks))

    def batched_fold_step(self, rh: torch.Tensor) -> None:
        """The first fold: this rank's rows' fingerprints, then the sharded
        plain fold of round 0 (fold and pair-leaf hashes fused: the same
        values as the single device's fold, then commit)."""
        codes, self._codes = self._codes, None
        if codes is None:
            raise RuntimeError("the batched fold step runs once")
        fri = self.fri_data
        fri._current = _fingerprint_codes(codes, self.fingerprint_limbs)
        fri.fold_step(0, rh)
