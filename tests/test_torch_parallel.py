"""Sharded proving of the PyTorch port over ``torch.distributed`` (gloo, CPU
processes) held against the single-rank port and the JAX package.

One group of W gloo processes per W (2 and 4) runs every case inside
``tests/torch_parallel_worker.py``, so process start-up is paid twice; both
groups start when the module's fixture does and run while this process
builds the references.  Everything compared is bytes and field residues:
every comparison is exact.  The JAX proves stay on their host route (at most
4096 rows); the JAX four-step transform is ``multilinear_tpu.ntt.ntt``.  The
sessions the ranks save half way are held against the single-rank session's
file of the same round, array by array, and resumed both over the ranks and
here on one rank.
"""

import hashlib
import json
import os
import random
import socket
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest

from multilinear_tpu.batched_pcs import BatchedPCSClaim as JClaim
from multilinear_tpu.batched_pcs import BatchedPCSProof as JBatchedPCSProof
from multilinear_tpu.field.scalar import Fp as JFp
from multilinear_tpu.fri import FriProof as JFriProof
from multilinear_tpu.ntt import ntt as jax_ntt
from multilinear_tpu.pcs import PCSProof as JPCSProof
from multilinear_tpu.serialize import batched_pcs_proof_to_bytes as j_batched_to_bytes
from multilinear_tpu.serialize import fri_proof_to_bytes as j_fri_to_bytes
from multilinear_tpu.serialize import pcs_proof_to_bytes as j_pcs_to_bytes
from multilinear_tpu.serialize import snark_proof_to_bytes as j_snark_to_bytes
from multilinear_tpu.system import ConstraintSet as JConstraintSet
from multilinear_tpu.system import System as JSystem
from multilinear_tpu.system import Trace as JTrace
from multilinear_tpu.system import WitnessLayout as JWitnessLayout
from multilinear_tpu.transcript import Transcript as JTranscript

import torch
import torch_parallel_worker as worker
from multilinear_tpu_torch.batched_pcs import BatchedPCSClaim, BatchedPCSProof, BatchedPCSProverSession
from multilinear_tpu_torch.field import limbs
from multilinear_tpu_torch.field.scalar import Fp, P
from multilinear_tpu_torch.fri import FriProof, _pair_view
from multilinear_tpu_torch.merkle import MerkleTree
from multilinear_tpu_torch.parallel import ShardLayout, contiguous_to_cyclic_send, cyclic_from_recv
from multilinear_tpu_torch.parallel.rounds import ShardedTables
from multilinear_tpu_torch.parallel.comm import canonical_lanes
from multilinear_tpu_torch.parallel.merkle import regroup_recv, regroup_send
from multilinear_tpu_torch.pcs import PCSProof
from multilinear_tpu_torch.serialize import (
    batched_pcs_proof_to_bytes, fri_proof_to_bytes, pcs_proof_to_bytes, snark_proof_to_bytes,
)
from multilinear_tpu_torch.sumcheck import SumcheckTables
from multilinear_tpu_torch.transcript import Transcript

WORLDS = (2, 4)
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# JAX digests of the cases where the JAX prove would leave its host route
with open(os.path.join(ROOT, "multilinear_tpu_torch", "testdata", "parallel_golden.json")) as _f:
    GOLDEN = json.load(_f)
WORKER_TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


@pytest.fixture(scope="module")
def ranks():
    """{W: [rank 0's results, ..., rank W-1's]} from one gloo group per W,
    and the references, built while the ranks run.  The ranks' saved
    sessions stay in ``refs["dirs"][W]`` while the module's tests run."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory(prefix="mlt_parallel_") as tmp:
        procs = {}
        for W in WORLDS:
            out = os.path.join(tmp, f"w{W}")
            os.makedirs(out)
            port = _free_port()
            procs[W] = []
            for r in range(W):
                with open(os.path.join(out, f"rank{r}.err"), "w") as err:
                    procs[W].append(subprocess.Popen([sys.executable, WORKER, str(r), str(W), str(port), out],
                                                     cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=err))
        results = {}
        try:
            refs = _references(os.path.join(tmp, "single"))
            refs["dirs"] = {W: os.path.join(tmp, f"w{W}") for W in WORLDS}
            for W, ps in procs.items():
                out = os.path.join(tmp, f"w{W}")
                for r, p in enumerate(ps):
                    p.wait(timeout=WORKER_TIMEOUT_S)
                    err = _read(os.path.join(out, f"rank{r}.err"))
                    assert p.returncode == 0, f"rank {r} of {W} failed:\n{err[-4000:]}"
                results[W] = [json.loads(_read(os.path.join(out, f"rank{r}.json"))) for r in range(W)]
        finally:
            for ps in procs.values():
                for p in ps:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
        yield results, refs


def _jax(t):
    return jnp.asarray(limbs.to_jax_limbs(t))


def _jax_snark(name: str) -> bytes:
    """The JAX package's single-device ``prove_snark`` of a worker case (its
    host route at 2^10 rows); the constraints are the worker's, which use
    nothing but + and - of the column values."""
    constraints, degree, cols = worker.inputs(name)
    transcript = JTranscript()
    prover = JSystem.prover(transcript, JConstraintSet(constraints, degree), JWitnessLayout(columns=cols.shape[0]),
                            JTrace.from_columns(_jax(cols)))
    return j_snark_to_bytes(prover.prove_snark(transcript))


def _references(single_dir: str) -> dict:
    """The single-rank port's bytes and the JAX package's (or its recorded
    digest, where its prove would compile device programs), per case; the
    single-rank session of each checkpoint case saved where the ranks save
    theirs, in ``single_dir``."""
    refs = {}
    for n in worker.PCS_LOG_N:
        evals, point, output = worker.inputs(f"pcs{n}")
        port = pcs_proof_to_bytes(PCSProof.prove(point, output, evals, Transcript(), worker.CPU))
        if f"pcs{n}" in GOLDEN:
            jax_sha = GOLDEN[f"pcs{n}"]["sha256"]
        else:
            jax_sha = hashlib.sha256(j_pcs_to_bytes(JPCSProof.prove(
                [JFp(p.v) for p in point], JFp(output.v), _jax(evals), JTranscript()))).hexdigest()
        refs[f"pcs{n}"] = (port, jax_sha)
    code = worker.inputs("fri")
    refs["fri"] = (fri_proof_to_bytes(FriProof.prove(code, Transcript())),
                   j_fri_to_bytes(JFriProof.prove(_jax(code), JTranscript())))
    for B, n in worker.BATCHED:
        polys, claim = worker.inputs(f"batched{B}x{n}")
        port = batched_pcs_proof_to_bytes(BatchedPCSProof.prove(claim, polys, Transcript(), worker.CPU))
        jclaim = JClaim([JFp(p.v) for p in claim.inputs], [JFp(o.v) for o in claim.outputs])
        jax = j_batched_to_bytes(JBatchedPCSProof.prove(jclaim, _jax(polys), JTranscript()))
        refs[f"batched{B}x{n}"] = (port, jax)
    x = worker.inputs("ntt")
    refs["ntt"] = limbs.from_jax_limbs(np.asarray(jax_ntt(_jax(x))))
    for name in worker.SNARKS:
        refs[name] = (snark_proof_to_bytes(worker.snark_prove(name, worker.CPU)), _jax_snark(name))
    os.makedirs(single_dir)
    for case, _, _ in worker.CHECKPOINTS:
        build, advance, _, _, _ = worker.checkpoint_session(case, worker.CPU)
        session = build()
        advance(session)
        session.save(os.path.join(single_dir, f"{case}.npz"))
    refs["single_dir"] = single_dir
    return refs


@pytest.mark.parametrize("W", WORLDS)
@pytest.mark.parametrize("n", worker.PCS_LOG_N)
def test_row_sharded_pcs_bytes_equal_single_rank_and_jax(ranks, W, n):
    got, refs = ranks
    port, jax_sha = refs[f"pcs{n}"]
    assert hashlib.sha256(port).hexdigest() == jax_sha
    for rank in got[W]:
        assert bytes.fromhex(rank[f"pcs{n}"]) == port


@pytest.mark.parametrize("W", WORLDS)
def test_standalone_fri_bytes_equal_single_rank_and_jax(ranks, W):
    got, refs = ranks
    port, jax = refs["fri"]
    assert port == jax
    for rank in got[W]:
        assert bytes.fromhex(rank["fri"]) == port


@pytest.mark.parametrize("W", WORLDS)
@pytest.mark.parametrize("B", [b for b, _ in worker.BATCHED])
def test_batch_sharded_batched_pcs_bytes_equal_single_rank_and_jax(ranks, W, B):
    got, refs = ranks
    name = next(f"batched{b}x{n}" for b, n in worker.BATCHED if b == B)
    port, jax = refs[name]
    assert port == jax
    for rank in got[W]:
        assert bytes.fromhex(rank[name]) == port


@pytest.mark.parametrize("W", WORLDS)
def test_sharded_fourstep_transform_equals_jax_ntt(ranks, W):
    got, refs = ranks
    want = limbs.to_le_bytes(refs["ntt"]).hex()
    for rank in got[W]:
        assert rank["ntt"] == want


@pytest.mark.parametrize("W", WORLDS)
def test_sharded_merkle_root_and_openings_equal_the_whole_tree(ranks, W):
    got, _ = ranks
    tree = MerkleTree.commit(_pair_view(worker.inputs("merkle")))
    want = worker._paths(tree.open_batch(list(worker.MERKLE_INDICES)))
    for rank in got[W]:
        assert rank["merkle"]["root"] == tree.root_bytes().hex()
        assert rank["merkle"]["paths"] == want


@pytest.mark.parametrize("W", WORLDS)
def test_stats_show_that_the_sharded_rounds_ran(ranks, W):
    """A sharded test must not prove unsharded without notice: the counters
    of every rank show sharded PCS rounds, sharded folds and collectives."""
    got, _ = ranks
    for rank in got[W]:
        for n in worker.PCS_LOG_N:
            s = rank[f"pcs{n}:stats"]
            assert s["rounds_sharded"] >= n - 2 and s["fri_rounds_sharded"] >= n - 4
            assert s["collectives"] > 0 and s["collective_bytes"] > 0
        assert rank["gather_rows"]
        assert rank["fri:stats"]["fri_rounds_sharded"] > 0
        assert all(rank[f"batched{B}x{n}:stats"]["rounds_sharded"] > 0 for B, n in worker.BATCHED)


@pytest.mark.parametrize("W", WORLDS)
@pytest.mark.parametrize("name", worker.SNARKS)
def test_row_sharded_snark_bytes_equal_single_rank_and_jax(ranks, W, name):
    """The SNARK of tests/test_parallel.py:199 (4 columns) and a width-1
    SNARK: every rank's proof is the single-rank port's and the JAX
    package's single-device proof, byte for byte."""
    got, refs = ranks
    port, jax = refs[name]
    assert port == jax
    for rank in got[W]:
        assert bytes.fromhex(rank[name]) == port


@pytest.mark.parametrize("W", WORLDS)
def test_stats_show_that_the_sharded_snark_rounds_ran(ranks, W):
    """A sharded SNARK must not prove unsharded without notice: every rank
    ran its trace-sumcheck rounds and its PCS rounds on its block, and took
    one device's route for the sums of every round: the SNARK_LOG_N rounds
    of the trace sumcheck and the SNARK_LOG_N of its PCS (the tail rounds
    run on every rank)."""
    got, _ = ranks
    for rank in got[W]:
        for name in worker.SNARKS:
            s = rank[f"{name}:stats"]
            assert s["sc_rounds_sharded"] >= worker.SNARK_LOG_N - 2, s
            assert s["sumcheck_rounds_fused"] == 2 * worker.SNARK_LOG_N, s
            assert s["rounds_sharded"] >= worker.SNARK_LOG_N - 2 and s["fri_rounds_sharded"] > 0, s


def _arrays(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _sidecars(path: str) -> dict:
    out = {}
    for ext in (".claim", ".snark"):
        if os.path.exists(path + ext):
            with open(path + ext) as f:
                out[ext] = json.load(f)
    return out


CASES = [c for c, _, _ in worker.CHECKPOINTS]


def _uninterrupted(refs, case: str) -> bytes:
    return refs[dict((c, p) for c, p, _ in worker.CHECKPOINTS)[case]][0]


@pytest.mark.parametrize("W", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_save_writes_the_single_rank_file(ranks, W, case):
    """A sharded session saved half way writes the file the single-rank
    session writes at the same round: the same keys, arrays equal element
    for element, the same sidecars."""
    _, refs = ranks
    want = os.path.join(refs["single_dir"], f"{case}.npz")
    path = os.path.join(refs["dirs"][W], f"{case}.npz")
    a, b = _arrays(path), _arrays(want)
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert _sidecars(path) == _sidecars(want)


@pytest.mark.parametrize("W", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_checkpoint_resumed_over_the_ranks_gives_the_uninterrupted_proof(ranks, W, case):
    """The file a sharded session saved, resumed over the same ranks (in the
    workers), finishes with the uninterrupted proof's bytes."""
    got, refs = ranks
    for rank in got[W]:
        assert bytes.fromhex(rank[case]) == _uninterrupted(refs, case)


@pytest.mark.parametrize("case", CASES)
def test_sharded_checkpoint_resumed_on_one_rank_gives_the_uninterrupted_proof(ranks, case):
    """The file four ranks saved, resumed here on one rank, finishes with
    the uninterrupted proof's bytes (the two-rank file is the same file:
    ``test_sharded_save_writes_the_single_rank_file``)."""
    _, refs = ranks
    _, _, finish, resume, to_bytes = worker.checkpoint_session(case, worker.CPU)
    assert to_bytes(finish(resume(os.path.join(refs["dirs"][4], f"{case}.npz"), None))) == _uninterrupted(refs, case)


@pytest.mark.parametrize("W", WORLDS)
def test_trace_tables_block_is_the_single_rank_tables_rows(W):
    """``ShardedTables.for_trace`` of rank r's cyclic block of the columns
    is rows t W + r of the single-rank packed table, delta row included."""
    cols = worker.inputs("snark4")[2]
    challenges = [Fp(3 + 7 * i) for i in range(worker.SNARK_LOG_N)]
    whole = SumcheckTables.for_trace(challenges, cols).data
    for r in range(W):
        layout = ShardLayout(world=W, rank=r, device="cpu", backend="gloo")
        block = ShardedTables.for_trace(challenges, layout.cyclic_rows(cols), layout)
        assert block.height == 1 << worker.SNARK_LOG_N and block.counter == "sc_rounds_sharded"
        assert torch.equal(block.data, whole[:, r::W])


def test_batched_block_of_neither_mode_raises():
    """Over W ranks the batched PCS takes (B/W, 2^n, 4) whole polynomials or
    (B, 2^n/W, 4) rows; any other block raises before any collective."""
    polys, claim = worker.inputs("batched4x8")
    layout = ShardLayout(world=4, rank=1, device="cpu", backend="gloo")
    for bad in (polys[:, :128], polys[:2], polys[:3, :64]):
        with pytest.raises(ValueError, match="whole polynomials .* or .* rows"):
            BatchedPCSProverSession(claim, bad, Transcript(), worker.CPU, layout)
    ten = BatchedPCSClaim(claim.inputs, claim.outputs * 2 + claim.outputs[:2])
    with pytest.raises(ValueError, match="splits evenly"):
        BatchedPCSProverSession(ten, torch.zeros((2, 256, 4), dtype=torch.int32), Transcript(), worker.CPU, layout)


@pytest.mark.parametrize("W", WORLDS)
def test_exact_sum_over_ranks_of_lanes_near_2_63(ranks, W):
    got, _ = ranks
    lanes = worker.inputs("lanes")
    for j in range(3):
        want = sum(sum(v << (32 * i) for i, v in enumerate(lanes[r][j])) for r in range(W)) % P
        for rank in got[W]:
            assert sum(v << (32 * i) for i, v in enumerate(rank["lanes"][j])) % P == want
            assert all(0 <= v < W << 32 for v in rank["lanes"][j])


# -- in-process cases: the index maps and the reducer --------------------------------


def _exchange(sends):
    """A simulated all-to-all: rank r receives chunk r of every rank's send."""
    return [torch.stack([s[r] for s in sends]) for r in range(len(sends))]


@pytest.mark.parametrize("W", WORLDS)
def test_regroup_index_maps(W):
    """Contiguous -> cyclic rows, and cyclic leaf digests -> contiguous
    subtrees, on index-valued tensors: every element lands where its index
    says."""
    n = 16 * W
    rows = torch.arange(n, dtype=torch.int32)[:, None].repeat(1, 4)
    blocks = rows.view(W, n // W, 4)
    cyc = [cyclic_from_recv(r) for r in _exchange([contiguous_to_cyclic_send(b, W) for b in blocks])]
    for r in range(W):
        assert torch.equal(cyc[r][:, 0], torch.arange(r, n, W, dtype=torch.int32))
    q = 4 * W * W
    leaves = torch.arange(q, dtype=torch.int32)[:, None].repeat(1, 8)
    sends = [regroup_send(leaves[r::W].contiguous(), W) for r in range(W)]
    blocks = [regroup_recv(x) for x in _exchange(sends)]
    assert torch.equal(torch.cat(blocks), leaves)


def _int(lanes) -> int:
    return sum(int(v) << (32 * i) for i, v in enumerate(lanes))


def test_canonical_lanes_near_2_63_and_a_two_rank_sum():
    """Per-rank lanes at the most 2^31 - 1 rows can give, and at 2^63 - 1:
    each rank's reduced residue, and the int64 sum of two ranks' residues,
    equal Python integers mod p."""
    rng = random.Random(7)
    tops = (worker.LANES_NEAR_2_63, 2**63 - 1)
    ranks = [[[top - rng.randrange(2**40) for _ in range(4)] for top in tops for _ in range(4)] for _ in range(2)]
    reduced = [canonical_lanes(torch.tensor(r, dtype=torch.int64)) for r in ranks]
    for r, red in zip(ranks, reduced):
        for lanes, got in zip(r, red.tolist()):
            assert _int(got) == _int(lanes) % P and all(0 <= v < 1 << 32 for v in got)
    summed = reduced[0] + reduced[1]
    for j, got in enumerate(summed.tolist()):
        assert _int(got) % P == (_int(ranks[0][j]) + _int(ranks[1][j])) % P


def test_exact_sum_through_a_world_size_one_gloo_group():
    import torch.distributed as dist

    if dist.is_initialized():
        pytest.skip("a process group is already live in this process")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0, world_size=1)
    try:
        layout = ShardLayout(world=1, rank=0, device="cpu", backend="gloo")
        lanes = worker.inputs("lanes")[0]
        got = layout.comm.exact_sum(torch.tensor(lanes, dtype=torch.int64)).tolist()
        for want, g in zip(lanes, got):
            assert _int(g) == _int(want) % P
    finally:
        dist.destroy_process_group()


def test_layouts_refuse_what_they_cannot_split():
    layout = ShardLayout(world=4, rank=1, device="cpu", backend="gloo")
    with pytest.raises(ValueError, match="does not split evenly"):
        layout.shard_batch(torch.zeros((10, 8, 4), dtype=torch.int32))
    assert layout.shard_batch(torch.arange(8 * 2 * 4, dtype=torch.int32).view(8, 2, 4))[0, 0, 0] == 16
    assert torch.equal(layout.shard_rows(torch.arange(64, dtype=torch.int32).view(16, 4))[:, 0],
                       torch.tensor([16, 20, 24, 28], dtype=torch.int32))
    with pytest.raises(ValueError, match="power of two"):
        ShardLayout(world=3, rank=0, device="cpu", backend="gloo").shard_rows(torch.zeros((12, 4), dtype=torch.int32))


def test_importing_the_parallel_package_starts_nothing():
    probe = ("import torch.distributed as dist, sys\n"
             "import multilinear_tpu_torch.parallel.multihost, multilinear_tpu_torch.parallel.rounds\n"
             "from multilinear_tpu_torch import _build\n"
             "assert not dist.is_initialized() and _build._fns is None\n"
             "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'multilinear_tpu')]\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


# -- the collective span, the NVLink reader's bytes, global indices ------------

PCS_PHASES = {"encode", "commit_l0", "tables", "rounds", "queries"}


@pytest.mark.parametrize("W", WORLDS)
def test_sharded_prove_records_the_collective_phase_and_span(ranks, W):
    got, _ = ranks
    for rank in got[W]:
        traced = rank["pcs10:traced"]
        phases = traced["phases"]
        assert set(phases) == PCS_PHASES | {"collective"}
        # nested in the layers' phases, whose times include it
        assert 0 < phases["collective"] <= sum(phases[p] for p in PCS_PHASES)
        coll = [outer for name, outer in traced["spans"] if name == "collective"]
        assert len(coll) == traced["collectives"] > 0
        assert all(outer[0] == "proof" and "collective" not in outer for outer in coll)
        assert {outer[1] for outer in coll} == {"encode", "commit_l0", "rounds", "queries"}


@pytest.mark.parametrize("W", WORLDS)
@pytest.mark.parametrize("n", worker.PCS_LOG_N)
def test_nvlink_roofline_bytes_are_the_bytes_rank0_counts(ranks, W, n):
    from portbench.core import spec

    got, _ = ranks
    counted = got[W][0][f"pcs{n}:stats"]["collective_bytes"]
    assert spec.metric("nvlink_roofline").proof_bytes(n, W, 128) == counted


class _Level:
    """A tree level of ``n`` nodes that holds nothing: node i reads as i in
    each of its ``width`` words.  Indexing checks the indices and keeps them."""

    device = torch.device("cpu")

    def __init__(self, n: int, width: int, seen: list):
        self.shape, self.seen = (n, width), seen

    def __getitem__(self, key):
        i = key[1] if isinstance(key, tuple) else key
        assert i.dtype == torch.int64 and int(i.min()) >= 0 and int(i.max()) < self.shape[0]
        self.seen.append(i)
        got = i[:, None].expand(-1, self.shape[1]).to(torch.int32)
        return got[None] if isinstance(key, tuple) else got


@pytest.mark.parametrize("W", WORLDS)
@pytest.mark.parametrize("which", ["first", "last"])
def test_sharded_openings_place_global_positions_of_2p29_and_2p30(W, which):
    """The openings of a 2^30-leaf sharded tree at leaves near 2^29 and 2^30
    (a 2^30-value codeword's positions), on a tree whose levels hold nothing:
    each rank reads the leaf and sibling it holds, at its local index."""
    from types import SimpleNamespace

    from multilinear_tpu_torch.parallel.merkle import ShardedMerkleTree, _gather

    depth, r = 30, 0 if which == "first" else W - 1
    seen = []
    tree = ShardedMerkleTree.__new__(ShardedMerkleTree)
    local = [_Level((1 << depth) // W >> level, 8, seen) for level in range(depth - W.bit_length() + 2)]
    top = [_Level(W >> level, 8, seen) for level in range(1, W.bit_length())]
    tree.layers, tree.n_local_levels = local + top, len(local)
    tree.leaf_columns, tree.roots = _Level((1 << depth) // W, 4, seen), _Level(W, 8, seen)
    tree.layout = SimpleNamespace(world=W, rank=r)
    positions = [0, 1, 2**29 - 2, 2**29 - 1, 2**29, 2**29 + 12_345_677, 2**30 - 2, 2**30 - 1]
    got = _gather([tree], np.array(positions, dtype=np.int64), tree.layout)
    nq = len(positions)
    assert got.shape == (nq * 4 + depth * nq * 8,)
    assert got[: nq * 4].view(nq, 4)[:, 0].tolist() == [p // W if p % W == r else 0 for p in positions]
    off = nq * 4
    for level in range(depth):
        sib = [(p >> level) ^ 1 for p in positions]
        per_rank = (1 << (depth - level)) // W
        if level < len(local) - 1:  # the subtrees' levels: the rank that holds the sibling
            want = [s % per_rank if s // per_rank == r else 0 for s in sib]
        else:  # the roots and above: rank 0 alone
            want = sib if r == 0 else [0] * nq
        assert got[off : off + nq * 8].view(nq, 8)[:, 0].tolist() == want, level
        off += nq * 8
    assert max(int(i.max()) for i in seen) < 2**30 // W


def test_query_packing_writes_the_directions_of_leaves_near_2p29():
    from multilinear_tpu_torch.serialize import pack_queries

    n, L, B = 1 << 29, 29, 2
    idx = np.array([0, 1, n - 2, n - 1, 123_456_789, (1 << 28) + 3], dtype=np.int64)
    nq = len(idx)
    blob = pack_queries(np.zeros(B * nq * 4 + L * nq * 8, dtype=np.int32), [(B, n)], idx)
    width = 8 + 8 + 16 * B + 8 + 33 * L
    assert len(blob) == 8 + nq * width
    for q, i in enumerate(idx):
        row = blob[8 + q * width : 8 + (q + 1) * width]
        dirs = [row[8 + 8 + 16 * B + 8 + 33 * level + 32] for level in range(L)]
        assert dirs == [(int(i) >> level) & 1 for level in range(L)]


_STALLED_RANK = """
import sys, time
import torch
from multilinear_tpu_torch.parallel import multihost
multihost.TIMEOUT_S = 3.0
rank, port = int(sys.argv[1]), sys.argv[2]
layout = multihost.init(rank, 2, "tcp://127.0.0.1:" + port, device="cpu")
if rank == 1:
    time.sleep(60)  # alive, and never joins the collective
    sys.exit(0)
t0 = time.monotonic()
try:
    layout.comm.all_reduce_sum(torch.ones(4, dtype=torch.int64))
except RuntimeError:
    print("raised after", time.monotonic() - t0, flush=True)
    sys.exit(3)
sys.exit(0)
"""


def test_a_rank_that_never_joins_ends_the_collective_within_the_timeout():
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", _STALLED_RANK, str(r), port], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        out, err = procs[0].communicate(timeout=120)
        assert procs[0].returncode == 3, err[-2000:]
        assert float(out.split()[-1]) < 30
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
