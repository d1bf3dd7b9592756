"""Sharded proving of the PyTorch port over ``torch.distributed`` (gloo, CPU
processes) held against the single-rank port and the JAX package.

One group of W gloo processes per W (2 and 4) runs every case inside
``tests/torch_parallel_worker.py``, so process start-up is paid twice; both
groups start when the module's fixture does and run while this process
builds the references.  Everything compared is bytes and field residues:
every comparison is exact.  The JAX proves stay on their host route (at most
4096 rows); the JAX four-step transform is ``multilinear_tpu.ntt.ntt``.
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
from multilinear_tpu.transcript import Transcript as JTranscript

import torch
import torch_parallel_worker as worker
from multilinear_tpu_torch.batched_pcs import BatchedPCSProof
from multilinear_tpu_torch.field import limbs
from multilinear_tpu_torch.field.scalar import P
from multilinear_tpu_torch.fri import FriProof, _pair_view
from multilinear_tpu_torch.merkle import MerkleTree
from multilinear_tpu_torch.parallel import ShardLayout, contiguous_to_cyclic_send, cyclic_from_recv
from multilinear_tpu_torch.parallel.comm import canonical_lanes
from multilinear_tpu_torch.parallel.merkle import regroup_recv, regroup_send
from multilinear_tpu_torch.pcs import PCSProof
from multilinear_tpu_torch.serialize import batched_pcs_proof_to_bytes, fri_proof_to_bytes, pcs_proof_to_bytes
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
    and the references, built while the ranks run."""
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
            refs = _references()
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


def _references() -> dict:
    """The single-rank port's bytes and the JAX package's (or its recorded
    digest, where its prove would compile device programs), per case."""
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
