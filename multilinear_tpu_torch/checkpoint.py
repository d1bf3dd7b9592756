"""Checkpoint / resume of the prover sessions.

A prover that is preempted at 2^24 and above must not start again from
nothing.  A session saved at a round boundary is one UNCOMPRESSED ``.npz``
file - numpy arrays and one JSON ``meta`` array, read back with
``allow_pickle=False`` (no pickle anywhere) - and a session resumed from it,
on the same card or another, makes the same proof bytes as an uninterrupted
prove.  Covered: the plain PCS (``pcs.PCSProverSession``), the batched PCS
(``batched_pcs.BatchedPCSProverSession``) and the SNARK
(``system.SnarkProverSession``: the trace sumcheck here, its PCS phase
through the PCS sessions).  The format is this package's own; it does not
read the JAX package's checkpoints.

What a file holds: the host transcript's midstate (8 chaining words, the
partial block, the length), the round counter, the round polynomials and the
running sum; the sumcheck tables (the packed (w+1, h, 4) tensor); every FRI
layer's codeword - its tree's leaf payload - and its root; for the batched
PCS the batch tree's payload (the B codewords, which the queries open) and
``fingerprint_r``; for the SNARK's sumcheck the trace columns, the drawn
challenges, the randoms and the claimed sum.

The digest levels of the trees are NOT stored: they are as large as the
payload they hash (a 2^24 PCS holds 1 GiB of codewords and as much again of
digests), and the commit kernels rebuild a tree from its payload in a few
milliseconds on the card.  Resume rebuilds every tree and checks the root it
reaches against the saved one (``merkle.MerkleRootMismatch`` on a
difference): a damaged payload cannot resume.  Uniform 128-bit residues do
not compress, so the arrays are stored as they are.

A sharded session (``parallel.ShardLayout``) writes the file the
single-rank session writes at the same round: every rank's cyclic blocks of
the tables and of each layer's payload are gathered in natural order (the
counterpart of the JAX package's gathering ``np.asarray``), rank 0 writes
it - on many hosts, to rank 0's disk - and every rank returns after a
barrier.  Any such file resumes on one rank, or over W ranks with a layout:
each rank then keeps its cyclic blocks and rebuilds its subtrees.
"""

from __future__ import annotations

import contextlib
import json
from typing import List, Optional

import numpy as np
import torch

from . import stats
from .batched_fri import BatchedFriProverData
from .field import limbs
from .field.scalar import Fp
from .fri import FriProverData
from .merkle import MerkleTree
from .ntt import inv_gen_pows
from .sumcheck import SumcheckPoly, SumcheckTables
from .transcript import Transcript


def normalize_ckpt_path(path: str) -> str:
    """``np.savez`` appends '.npz' when missing; normalize once so that save,
    load and the sidecar files all agree on the file name."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def _device(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def is_writer(layout) -> bool:
    """Whether this process writes the files of a save: a single rank, or
    rank 0 of a sharded session."""
    return layout is None or layout.rank == 0


def barrier(layout) -> None:
    """A sharded save returns on every rank once rank 0 has written."""
    if layout is not None:
        layout.comm.barrier()


def _put(store: dict, key: str, t: torch.Tensor, layout) -> None:
    """``t``, whole and in natural order, under ``key``: copied to the host
    by the writing rank only."""
    if is_writer(layout):
        store[key] = stats.fetch(t)


def pols_to_meta(pols: List[SumcheckPoly]) -> list:
    return [[c.v for c in p.nonzero_coeffs] for p in pols]


def pols_from_meta(rows) -> List[SumcheckPoly]:
    return [SumcheckPoly([Fp(int(c)) for c in cs]) for cs in rows]


# -- parts ---------------------------------------------------------------------


def _store_transcript(store: dict, meta: dict, transcript: Transcript) -> None:
    st, buf, total = transcript.export_state()
    store["tr_st"] = np.array(st, dtype=np.uint32)
    store["tr_buf"] = np.frombuffer(bytes(buf), dtype=np.uint8).copy()
    meta["tr_total"] = total


def _load_transcript(z, meta) -> Transcript:
    return Transcript.import_state([int(x) for x in z["tr_st"]], z["tr_buf"].tobytes(), meta["tr_total"])


def _store_tables(store: dict, meta: dict, tables: SumcheckTables, layout) -> None:
    meta["tables_height"] = tables.height
    _put(store, "sc_data", tables.gathered(), layout)


def _load_tables(z, meta, device, debug_checks: bool, layout=None,
                 counter: str = "rounds_sharded") -> SumcheckTables:
    if layout is None:
        return SumcheckTables(_device(z["sc_data"], device), meta["tables_height"], debug_checks)
    from .parallel.rounds import ShardedTables

    return ShardedTables.from_whole(torch.from_numpy(z["sc_data"]), meta["tables_height"], layout, debug_checks,
                                    counter)


def _store_tree(store: dict, key: str, tree: MerkleTree, layout) -> str:
    """The tree's whole leaf payload under ``key``; returns its root as hex."""
    _put(store, key, tree.gathered_leaf_columns(), layout)
    return tree.root_bytes().hex()


def _store_fri(store: dict, meta: dict, fri_data: FriProverData, layout) -> None:
    if fri_data.final is not None:
        raise RuntimeError("the last fold's elements are not replayed yet: replay before saving")
    meta["fri_log_domain"] = fri_data._log_domain
    meta["fri_last_element"] = None if fri_data.last_element is None else fri_data.last_element.v
    meta["fri_roots"] = [_store_tree(store, f"tree{i}_cols", t, layout) for i, t in enumerate(fri_data.trees)]


def _load_fri(z, meta, device, debug_checks: bool, layout=None) -> FriProverData:
    """The FRI state with its trees rebuilt from their payloads.  While the
    chain runs, the current codeword is the newest tree's payload."""
    roots = [bytes.fromhex(r) for r in meta["fri_roots"]]
    last = None if meta["fri_last_element"] is None else Fp(int(meta["fri_last_element"]))
    if layout is not None:
        from .parallel.rounds import ShardedFriProverData

        return ShardedFriProverData.resume([torch.from_numpy(z[f"tree{i}_cols"]) for i in range(len(roots))],
                                           roots, meta["fri_log_domain"], last, layout, debug_checks)
    fri_data = FriProverData()
    fri_data.debug_checks = debug_checks
    fri_data._log_domain = meta["fri_log_domain"]
    fri_data._inv_pows = inv_gen_pows(fri_data._log_domain, device)
    fri_data.trees = MerkleTree.rebuild([_device(z[f"tree{i}_cols"], device) for i in range(len(roots))], roots)
    if last is not None:
        fri_data.last_element = last
    elif fri_data.trees:
        fri_data._current = fri_data.trees[-1].leaf_columns.reshape(-1, 4)
    return fri_data


def _store_core(store, meta, tables, fri_data, transcript, round_k, previous_sum, pols, layout) -> None:
    meta["round_k"] = round_k
    meta["previous_sum"] = Fp(previous_sum).v
    meta["pols"] = pols_to_meta(pols)
    _store_transcript(store, meta, transcript)
    _store_tables(store, meta, tables, layout)
    _store_fri(store, meta, fri_data, layout)


def _load_core(z, meta, device, debug_checks: bool, layout=None):
    return (_load_tables(z, meta, device, debug_checks, layout), _load_fri(z, meta, device, debug_checks, layout),
            _load_transcript(z, meta), meta["round_k"], Fp(int(meta["previous_sum"])), pols_from_meta(meta["pols"]))


def _finalize(path: str, store: dict, meta: dict, layout) -> None:
    """Write the file (the writing rank only; the caller's sidecars and
    :func:`barrier` follow)."""
    if is_writer(layout):
        store["meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        np.savez(normalize_ckpt_path(path), **store)


@contextlib.contextmanager
def _open(path: str, kind: Optional[str] = None):
    """(arrays, meta) of the checkpoint at ``path``; with ``kind``, a file of
    another kind raises."""
    path = normalize_ckpt_path(path)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if kind is not None and meta.get("kind") != kind:
            raise ValueError(f"{path} holds a {meta.get('kind')!r} checkpoint, not {kind!r}")
        yield z, meta


def checkpoint_kind(path: str) -> str:
    """"pcs", "batched_pcs" or "snark_sumcheck": what ``path`` holds."""
    with _open(path) as (_, meta):
        return meta["kind"]


# -- plain PCS -------------------------------------------------------------------


def save_pcs_state(path: str, tables: SumcheckTables, fri_data: FriProverData, transcript: Transcript,
                   round_k: int, previous_sum: Fp, pols: List[SumcheckPoly], layout=None) -> None:
    """With a ``layout``, a collective: every rank calls it, rank 0 writes."""
    store, meta = {}, {"kind": "pcs"}
    _store_core(store, meta, tables, fri_data, transcript, round_k, previous_sum, pols, layout)
    _finalize(path, store, meta, layout)


def load_pcs_state(path: str, device="cpu", debug_checks: bool = False, layout=None):
    """Returns (tables, fri_data, transcript, round_k, previous_sum, pols),
    the tensors on ``device`` and the trees rebuilt; with a ``layout``, this
    rank's share on the layout's device (a collective)."""
    with _open(path, "pcs") as (z, meta):
        return _load_core(z, meta, device, debug_checks, layout)


# -- batched PCS -----------------------------------------------------------------


def save_batched_pcs_state(path: str, tables: SumcheckTables, bfri, transcript: Transcript, round_k: int,
                           previous_sum: Fp, pols: List[SumcheckPoly], layout=None) -> None:
    """``bfri``: a ``BatchedFriProverData`` after round 0 (its batched fold
    has consumed the codewords; the batch tree's payload is what is left of
    them).  With a ``layout``, a collective: every rank calls it, rank 0
    writes."""
    store, meta = {}, {"kind": "batched_pcs"}
    _store_core(store, meta, tables, bfri.fri_data, transcript, round_k, previous_sum, pols, layout)
    meta["fingerprint_r"] = bfri.fingerprint_r.v
    meta["batch_root"] = _store_tree(store, "btree_cols", bfri.batch_tree, layout)
    _finalize(path, store, meta, layout)


def load_batched_pcs_state(path: str, device="cpu", debug_checks: bool = False, layout=None):
    """Returns (tables, bfri, transcript, round_k, previous_sum, pols); with a
    ``layout``, this rank's share in the row layout (a collective)."""
    with _open(path, "batched_pcs") as (z, meta):
        tables, fri_data, transcript, round_k, prev, pols = _load_core(z, meta, device, debug_checks, layout)
        fingerprint_r = Fp(int(meta["fingerprint_r"]))
        root = [bytes.fromhex(meta["batch_root"])]
        if layout is None:
            bfri = BatchedFriProverData.__new__(BatchedFriProverData)
            bfri.batch_tree = MerkleTree.rebuild([_device(z["btree_cols"], device)], root)[0]
            bfri.fingerprint_r = fingerprint_r
            bfri.fingerprint_limbs = limbs.pack_scalar(fingerprint_r, device)
            bfri.fri_data = fri_data
            bfri._codes = None  # round 0 consumed them before any save
        else:
            from .parallel.merkle import ShardedMerkleTree
            from .parallel.rounds import ShardedBatchedFriProverData

            tree = ShardedMerkleTree.commit(layout.cyclic_rows(torch.from_numpy(z["btree_cols"])), layout)
            bfri = ShardedBatchedFriProverData(MerkleTree.check_roots([tree], root)[0], fingerprint_r, None, fri_data)
        return tables, bfri, transcript, round_k, prev, pols


# -- SNARK: the trace sumcheck (its PCS phase is saved by the PCS sessions) --------


def save_snark_sumcheck_state(path: str, trace_columns: torch.Tensor, tables: SumcheckTables,
                              transcript: Transcript, round_k: int, previous_sum: Fp, pols: List[SumcheckPoly],
                              randoms: List[Fp], challenges, sum_value: Fp,
                              outputs: Optional[List[Fp]] = None, layout=None) -> None:
    """``challenges``: the ``system.ChallengeSet``; ``outputs``: the columns
    at the randoms once the last round is replayed, else None.  With a
    ``layout``, a collective: ``trace_columns`` is the whole trace (the
    caller gathers it), every rank calls it, rank 0 writes."""
    store, meta = {}, {"kind": "snark_sumcheck"}
    meta["round_k"] = round_k
    meta["previous_sum"] = Fp(previous_sum).v
    meta["pols"] = pols_to_meta(pols)
    meta["randoms"] = [r.v for r in randoms]
    meta["sum_value"] = Fp(sum_value).v
    meta["outputs"] = None if outputs is None else [x.v for x in outputs]
    meta["challenges"] = {"row": [c.v for c in challenges.row], "trace": [c.v for c in challenges.trace],
                          "constraint": [c.v for c in challenges.constraint]}
    _store_transcript(store, meta, transcript)
    _store_tables(store, meta, tables, layout)
    _put(store, "trace_cols", trace_columns, layout)
    _finalize(path, store, meta, layout)


def load_snark_sumcheck_state(path: str, device="cpu", debug_checks: bool = False, layout=None):
    """Returns (trace_columns, tables, transcript, round_k, previous_sum, pols,
    randoms, challenges as {"row", "trace", "constraint": [Fp]}, sum_value,
    outputs or None); with a ``layout``, the trace columns are this rank's
    contiguous block and the tables its share (a collective)."""
    with _open(path, "snark_sumcheck") as (z, m):
        outputs = None if m["outputs"] is None else [Fp(int(v)) for v in m["outputs"]]
        if layout is None:
            cols = _device(z["trace_cols"], device)
        else:
            cols = layout.shard_rows(torch.from_numpy(z["trace_cols"]))
        return (cols, _load_tables(z, m, device, debug_checks, layout, "sc_rounds_sharded"),
                _load_transcript(z, m), m["round_k"], Fp(int(m["previous_sum"])), pols_from_meta(m["pols"]),
                [Fp(int(r)) for r in m["randoms"]],
                {k: [Fp(int(v)) for v in vs] for k, vs in m["challenges"].items()},
                Fp(int(m["sum_value"])), outputs)
