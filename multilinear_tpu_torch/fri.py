"""FRI low-degree test: device fold + Merkle commit, host queries.

Protocol parity with reference src/fri/mod.rs: pair leaves
(value = p(g^i), minus_value = p(-g^i) = p(g^{i+n/2})), the fold
next(x^2) = ((p(x)+p(-x)) + r*(p(x)-p(-x))*g^{-i*2^k}) / 2, one Merkle root
absorbed per layer, 128 transcript-drawn query indices with 8-LE-byte
absorption (quirk Q5), and the redundant ``last_random`` transcript
fingerprint checked at the end.

Every fold step that commits is one launch of the fused
``fold_commit_leaves`` kernel (fold + leaf hashes) followed by the
``merkle_levels`` launches of the tree above them (up to eleven levels a
launch); the last fold of a chain, which
commits nothing, is one launch of ``fold_codeword``.  The codeword stays on
the device down to its last two elements: the kernels mask their own ragged
edge, so there is no host tail.  Queries gather all 128 openings of all
layers in one launch and one device->host copy; the proof holds them as
they came, and the serializer packs them into its query section.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from . import stats
from .config import LOG_BLOWUP, NUM_QUERIES
from .field import cuda_ops, limbs, ops
from .field.scalar import Fp, P, TWO_INV, pow2_generator
from .merkle import MerklePath, MerkleTree, opening_shapes, paths_from_openings, tree_levels
from .mle import to_coeffs_bitrev_padded
from .ntt import fourstep_transform, inv_gen_pows
from .transcript import Transcript


class FriError(Exception):
    pass


def _rh_limbs(r: Fp, device) -> torch.Tensor:
    """r * 2^{-1} as a (4,) field element on ``device``: ONE host multiply,
    for a challenge drawn on the host (the PCS rounds draw theirs on the
    device, where ``round_scalars`` writes r/2 beside r).

    The fold ((a+b) + r*(a-b)*tw) / 2 is computed as
    half(a+b) + (a-b)*tw*(r/2): the division by two becomes a multiply-free
    shift-add and the r and 1/2 scalars collapse into one factor.
    """
    return limbs.pack_scalar(Fp(r) * TWO_INV, device)


def _fold_codeword(code: torch.Tensor, inv_pows: torch.Tensor, k: int, rh: torch.Tensor) -> torch.Tensor:
    """Fold ``code`` (m, 4) at FRI round k with ``rh`` = r/2 on its device: (m/2, 4)."""
    stats.bump("fri_folds_plain")
    return cuda_ops.fold_codeword(code, inv_pows, 1 << k, rh)


def _fold_and_commit(code: torch.Tensor, inv_pows: torch.Tensor, k: int, rh: torch.Tensor):
    """Fold ``code`` (m, 4) at FRI round k with ``rh`` = r/2 and hash every
    Merkle level of the result.  Returns (folded (m/2, 4), layers) with the
    leaf-digest level first; the pair leaves are (nxt[i], nxt[i + m/4])."""
    stats.bump("fri_folds_fused")
    nxt, leaf = cuda_ops.fold_commit_leaves(code, inv_pows, 1 << k, rh)
    return nxt, [leaf] + tree_levels(leaf)


def _pair_view(code: torch.Tensor) -> torch.Tensor:
    """(m, 4) codeword -> (2, m/2, 4) pair-leaf payload, zero copy: leaf i
    holds code[i] and code[i + m/2] (reference commit_rs_code,
    src/fri/mod.rs:46-56)."""
    return code.view(2, code.shape[0] // 2, 4)


class FriProverData:
    """Prover state: the current codeword and one Merkle tree per fold layer."""

    def __init__(self):
        self.trees: List[MerkleTree] = []
        self.last_element: Optional[Fp] = None
        # the last fold's 2^LOG_BLOWUP elements on the device, until the host
        # has checked them and set last_element
        self.final: Optional[torch.Tensor] = None
        self._log_domain: int = 0
        self._current: Optional[torch.Tensor] = None  # (m, 4) on the device
        self._inv_pows: Optional[torch.Tensor] = None  # the fold twiddles of the whole chain
        self.debug_checks = False

    @staticmethod
    def init(code: torch.Tensor, transcript: Optional[Transcript], debug_checks: bool = False) -> "FriProverData":
        """Commit to the initial codeword; absorb the root when a transcript
        is given (a prover that runs its rounds' Fiat-Shamir on the device
        passes None and leaves ``trees[0]``'s root to the first round)."""
        n = code.shape[0]
        if n < 4 or n & (n - 1):
            raise ValueError("codeword length must be a power of two >= 4")
        data = FriProverData()
        data.debug_checks = debug_checks
        data._log_domain = n.bit_length() - 1
        data._current = code
        data._guard(code, "codeword")
        # the twiddle table is built here, not in the first round: building
        # it packs host scalars, and the rounds copy nothing from the host
        data._inv_pows = inv_gen_pows(data._log_domain, code.device)
        tree = MerkleTree.commit(_pair_view(code))
        data.trees.append(tree)
        if transcript is not None:
            transcript.absorb(tree.root_bytes())
        return data

    def _guard(self, t: torch.Tensor, what: str) -> None:
        if self.debug_checks and not ops.is_canonical(t):
            raise FriError(f"non-canonical field element in {what}")

    def push(self, nxt: torch.Tensor, tree: Optional[MerkleTree]) -> None:
        """Make the folded codeword ``nxt`` current: a committed layer with
        its ``tree``, or (tree None) the end of the chain, whose
        ``2^LOG_BLOWUP`` elements wait in ``final`` for the host's check."""
        self._guard(nxt, "folded codeword")
        self._current = nxt
        if tree is None:
            self.final = nxt
        else:
            self.trees.append(tree)

    def fold_step(self, k: int, rh: torch.Tensor) -> None:
        """Fold the current codeword with ``rh`` = r/2 (a (4,) field element
        on the codeword's device); commit, or end the chain.

        Reference fold_step (src/fri/mod.rs:79-134); the tail-indexed
        inverse twiddle gen_pows[len - i*2^k] equals inv_gen^(i*2^k), read
        by the kernel as ``inv_pows[i << k]``.  The last fold leaves
        ``2^LOG_BLOWUP`` equal elements and commits nothing.  Nothing is
        absorbed here: the caller absorbs the new root or the last element,
        on the host (:meth:`absorb_fold`) or on the device.
        """
        code = self._current
        m = code.shape[0]
        blowup = 1 << LOG_BLOWUP
        if m <= blowup:
            return
        if m // 2 == blowup:
            self.push(_fold_codeword(code, self._inv_pows, k, rh), None)
            return
        nxt, layers = _fold_and_commit(code, self._inv_pows, k, rh)
        self.push(nxt, MerkleTree(layers, _pair_view(nxt)))

    def set_last_element(self, values) -> None:
        """Check the last fold's elements (host integers): all must be equal."""
        first = int(values[0])
        if any(int(v) != first for v in values):
            raise FriError("not an RS code")
        self.last_element = Fp(first)
        self.final = None

    def absorb_fold(self, transcript: Transcript) -> None:
        """Host Fiat-Shamir after a fold: absorb the new layer's root, or
        check and absorb the last element (one copy each)."""
        if self.final is not None:
            self.set_last_element(limbs.unpack_ints(stats.fetch(self.final)))
            transcript.absorb(self.last_element.to_bytes())
        else:
            transcript.absorb(self.trees[-1].root_bytes())

    @staticmethod
    def fold(code: torch.Tensor, transcript: Transcript) -> "FriProverData":
        """init + all fold rounds, drawing one challenge per round on the
        host (reference src/fri/mod.rs:136-145)."""
        data = FriProverData.init(code, transcript)
        for k in range(data._log_domain - LOG_BLOWUP):
            data.fold_step(k, _rh_limbs(transcript.next_challenge(), code.device))
            data.absorb_fold(transcript)
        assert data.last_element is not None
        return data

    def fold_roots(self) -> List[bytes]:
        """Every layer's root (the provers have fetched them all by now)."""
        return [t.root_bytes() for t in self.trees]

    def gather_openings(self, trees: Sequence[MerkleTree], idx: np.ndarray) -> np.ndarray:
        """The openings of ``trees`` at the query indices ``idx``, each tree
        at ``idx`` modulo its leaf count - a layer's index halves with its
        domain (reference open_query_at, src/fri/mod.rs:154-174) - on the
        host in ONE device->host copy (``MerkleTree.gather_many``; a sharded
        prover gathers over its ranks)."""
        return MerkleTree.gather_many(trees, idx)

    def open_queries(self, indices: Sequence[int]) -> "OpenedQueries":
        """The query proofs of ``indices`` (:class:`OpenedQueries`): the
        openings of all layers, in ONE device->host copy."""
        idx = np.asarray(indices, dtype=np.int64)
        return OpenedQueries(self.gather_openings(self.trees, idx), opening_shapes(self.trees), idx, QueryProof)


def _layer_inv_gens(gen: Fp, n_layers: int) -> List[Fp]:
    """[gen^(-2^i) for i in range(n_layers)]: ONE inversion, then squarings."""
    inv = gen.inv()
    out = [inv]
    for _ in range(n_layers - 1):
        inv = inv * inv
        out.append(inv)
    return out


@dataclass
class QueryProof:
    """One Merkle pair-path per fold layer (reference QueryProof)."""

    paths: List[MerklePath]

    def verify(
        self,
        commitments: Sequence[bytes],
        last_element: Fp,
        n: int,
        index: int,
        gen: Fp,
        random_elements: Sequence[Fp],
        inv_gens: Sequence[Fp] = None,
    ) -> None:
        """Walk the layers recomputing the fold (reference src/fri/mod.rs:183-237).

        ``n`` is the pair count of layer 0 (codeword/2); ``gen`` the full-
        domain generator.  Raises FriError on mismatch.

        ``inv_gens``: optional per-layer INVERSE generators (inv_gens[i] =
        gen^(-2^i)), shared across the queries by ``verify_queries``.  The
        reference divides by 2*gen^index per layer; with the inverse
        generator the identical value is TWO_INV * inv_gen_i^index, needing
        one inversion per proof.
        """
        if len(self.paths) != len(commitments):
            raise FriError("wrong number of paths")
        if inv_gens is None:
            inv_gens = _layer_inv_gens(gen, len(commitments))
        # raw canonical ints mod p: exact Python arithmetic, no wrapper churn
        two_inv = TWO_INV.v
        inv_gens_v = [g.v for g in inv_gens]
        randoms_v = [r.v for r in random_elements]
        last_v = last_element.v
        current_n = n
        current_index = index
        for i, (path, root) in enumerate(zip(self.paths, commitments)):
            if len(path.values) != 2:
                raise FriError(f"layer {i} leaf is not a pair")
            if not path.verify(root, current_index):
                raise FriError(f"inclusion path failed at layer {i}")
            value, minus_value = path.values[0].v, path.values[1].v
            even = (value + minus_value) * two_inv % P
            odd = (value - minus_value) * two_inv * pow(inv_gens_v[i], current_index, P) % P
            folded = (even + randoms_v[i] * odd) % P
            if i == len(self.paths) - 1:
                if last_v != folded:
                    raise FriError(f"query mismatch at last layer {i}")
                break
            next_index = current_index % (current_n // 2)
            next_path = self.paths[i + 1]
            if len(next_path.values) != 2:
                raise FriError(f"layer {i + 1} leaf is not a pair")
            next_value = (
                next_path.values[0].v if next_index == current_index else next_path.values[1].v
            )
            if next_value != folded:
                raise FriError(f"query mismatch at layer {i}")
            current_n //= 2
            current_index = next_index


class OpenedQueries(Sequence):
    """A prover's query proofs, held as its trees' fetched openings
    (``MerkleTree.gather_many``'s layout, tree t of ``shapes`` at ``idx``
    modulo its leaf count).  While untouched the serializer packs them
    straight into the proof's bytes (``serialize.pack_queries``).  Read as a
    sequence, the query proofs are built once, ``build`` making one from a
    query's path in each tree (``stats``' ``merkle_paths_built`` counts
    the paths); from then on the serializer writes those objects, so a proof
    changed in place serialises what it holds."""

    def __init__(self, openings: np.ndarray, shapes, idx: np.ndarray, build: Callable[[list], object]):
        self.openings, self.shapes, self.idx = openings, shapes, idx
        self._build = build
        self._built = None

    @property
    def untouched(self) -> bool:
        return self._built is None

    def _list(self) -> list:
        if self._built is None:
            paths = paths_from_openings(self.openings, self.shapes, [self.idx & (n - 1) for _, n in self.shapes])
            self._built = [self._build([p[q] for p in paths]) for q in range(len(self.idx))]
        return self._built

    def __len__(self) -> int:
        return len(self.idx)

    def __getitem__(self, i):
        return self._list()[i]

    def __iter__(self):
        return iter(self._list())

    def __add__(self, other) -> list:
        return self._list() + list(other)

    def __eq__(self, other) -> bool:
        return isinstance(other, (list, OpenedQueries)) and self._list() == list(other)

    __hash__ = None


def draw_query_indices(transcript: Transcript, n_pairs: int, count: int) -> List[int]:
    """Draw ``count`` query indices below ``n_pairs``, absorbing each as it
    is drawn (reference src/fri/mod.rs:269-273)."""
    indices = []
    for _ in range(count):
        idx = transcript.random_index(n_pairs)
        transcript.absorb_index(idx)
        indices.append(idx)
    return indices


@dataclass
class FriProof:
    """commitments + queries + final constant + transcript fingerprint
    (reference FriProof, src/fri/mod.rs:240-248)."""

    commitments: List[bytes]
    queries: Sequence[QueryProof]  # a prover's: OpenedQueries
    last_elem: Fp
    last_random: bytes

    @staticmethod
    def prove(code: torch.Tensor, transcript: Transcript, layout=None) -> "FriProof":
        """Fold + 128 transcript-drawn queries (reference src/fri/mod.rs:261-285).
        With a ``parallel.ShardLayout``, ``code`` is this rank's contiguous
        block of the codeword (``layout.shard_rows``) and every rank returns
        the same proof."""
        if layout is None:
            data = FriProverData.fold(code, transcript)
            m = code.shape[0]
        else:
            from .parallel import to_cyclic
            from .parallel.rounds import ShardedFriProverData

            data = ShardedFriProverData.fold(to_cyclic(code.to(layout.device), layout), transcript, layout)
            m = code.shape[0] * layout.world
        indices = draw_query_indices(transcript, m // 2, NUM_QUERIES)
        queries = data.open_queries(indices)
        return FriProof(
            commitments=data.fold_roots(),
            queries=queries,
            last_elem=data.last_element,
            last_random=transcript.random(),
        )

    def verify(self) -> None:
        """Standalone verification with a fresh transcript
        (reference src/fri/mod.rs:311-340)."""
        if len(self.queries) != NUM_QUERIES:
            raise FriError("wrong number of queries")
        transcript = Transcript()
        random_elements = []
        for root in self.commitments:
            transcript.absorb(root)
            random_elements.append(transcript.next_challenge())
        transcript.absorb(self.last_elem.to_bytes())
        self.verify_queries(transcript, random_elements)

    def verify_queries(self, transcript: Transcript, random_elements: Sequence[Fp]) -> None:
        if not self.commitments:
            raise FriError("no commitments")
        log_domain_size = len(self.commitments) + LOG_BLOWUP
        if log_domain_size > 40:
            raise FriError("domain exceeds the field's two-adicity")
        gen = pow2_generator(log_domain_size)
        inv_gens = _layer_inv_gens(gen, len(self.commitments))
        n = (1 << log_domain_size) // 2
        indices = draw_query_indices(transcript, n, len(self.queries))
        for query, idx in zip(self.queries, indices):
            query.verify(
                self.commitments, self.last_elem, n, idx, gen, random_elements, inv_gens=inv_gens
            )
        if self.last_random != transcript.random():
            raise FriError("incompatible last_random transcript fingerprint")


def encode_mle_for_fri(evals: torch.Tensor) -> torch.Tensor:
    """eval form -> bit-reversed coefficient form -> RS codeword, for one
    (2^n, 4) MLE or a (B, 2^n, 4) batch in one pass.

    The coefficient bit-reversal aligns FRI's even/odd low-bit split with
    sumcheck's MSB top/bottom-half fold (reference
    multilinear_pcs.rs:101-107, Q8).  The Moebius kernel's last pass writes
    the coefficients bit-reversed into the zero-padded tensor that the
    transform over the codeword's domain reads: the same values as
    ``reed_solomon(bit_reverse(to_coeffs(evals)))``.
    """
    log_m = evals.shape[-2].bit_length() - 1 + LOG_BLOWUP
    # the padded tensor is handed on without a name here, so that the
    # transform's first step can free it
    return fourstep_transform(to_coeffs_bitrev_padded(evals, LOG_BLOWUP), pow2_generator(log_m).v, log_m)
