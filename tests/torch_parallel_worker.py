"""One rank of the sharded-proving tests of the PyTorch port (gloo, CPU).

    python tests/torch_parallel_worker.py RANK WORLD PORT OUT_DIR

joins a gloo group of WORLD processes at tcp://127.0.0.1:PORT, runs every
case of ``tests/test_torch_parallel.py`` on its block and writes what it got
to OUT_DIR/rank{RANK}.json.  The inputs come from numpy seeds
(:func:`inputs`), which the test module imports to build the references.
Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multilinear_tpu_torch import stats  # noqa: E402
from multilinear_tpu_torch.batched_pcs import BatchedPCSClaim, BatchedPCSProof  # noqa: E402
from multilinear_tpu_torch.config import ProverConfig  # noqa: E402
from multilinear_tpu_torch.field import limbs  # noqa: E402
from multilinear_tpu_torch.field.scalar import Fp, P  # noqa: E402
from multilinear_tpu_torch.fri import FriProof, _pair_view  # noqa: E402
from multilinear_tpu_torch.mle import evaluate_evals_host  # noqa: E402
from multilinear_tpu_torch.ntt import reed_solomon  # noqa: E402
from multilinear_tpu_torch.pcs import PCSProof  # noqa: E402
from multilinear_tpu_torch.serialize import (  # noqa: E402
    batched_pcs_proof_to_bytes,
    fri_proof_to_bytes,
    pcs_proof_to_bytes,
)
from multilinear_tpu_torch.transcript import Transcript  # noqa: E402

CPU = ProverConfig(device="cpu", debug_checks=True)
PCS_LOG_N = (10, 12)
NTT_LOG_N = 12
FRI_LOG_M = 9
MERKLE_LOG_M = 9
MERKLE_INDICES = (0, 1, 5, 100, 129, 255)
BATCHED = ((4, 8), (8, 8))  # (polynomials, log2 rows)
LANES_NEAR_2_63 = (2**31 - 1) * (2**32 - 1)  # the most ops.sum_limbs gives for 2^31 - 1 rows


def _field(rng, n):
    return limbs.pack_ints([int.from_bytes(rng.bytes(16), "little") % P for _ in range(n)])


def inputs(name):
    """The seeded inputs of one case, as CPU tensors and host ints."""
    if name.startswith("pcs"):
        n = int(name[3:])
        rng = np.random.default_rng(7000 + n)
        evals = _field(rng, 1 << n)
        point = [Fp(int.from_bytes(rng.bytes(16), "little") % P) for _ in range(n)]
        return evals, point, evaluate_evals_host(evals, point)
    if name == "ntt":
        return _field(np.random.default_rng(7100), 1 << NTT_LOG_N)
    if name == "merkle":
        return _field(np.random.default_rng(7150), 1 << MERKLE_LOG_M)
    if name == "fri":
        return reed_solomon(_field(np.random.default_rng(7200), 1 << (FRI_LOG_M - 1)))
    if name.startswith("batched"):
        B, n = (int(v) for v in name[7:].split("x"))
        rng = np.random.default_rng(7300 + B)
        polys = _field(rng, B << n).reshape(B, 1 << n, 4)
        point = [Fp(int.from_bytes(rng.bytes(16), "little") % P) for _ in range(n)]
        return polys, BatchedPCSClaim(point, [evaluate_evals_host(polys[j], point) for j in range(B)])
    if name == "lanes":
        rng = np.random.default_rng(7400)
        return [[[LANES_NEAR_2_63 - int(rng.integers(0, 2**40)) for _ in range(4)] for _ in range(3)]
                for _ in range(4)]  # rank r feeds lanes[r]
    raise KeyError(name)


def _paths(paths):
    return [[[str(v.v) for v in p.values], [[d.hex(), s] for d, s in p.path]] for p in paths]


def run(layout) -> dict:
    from multilinear_tpu_torch.parallel import gather_cyclic
    from multilinear_tpu_torch.parallel.merkle import ShardedMerkleTree, open_batch_many
    from multilinear_tpu_torch.parallel.ntt import fourstep_columns, split
    from multilinear_tpu_torch.field.scalar import pow2_generator

    W, r = layout.world, layout.rank
    out = {}

    def counted(name, fn):
        stats.reset()
        t0 = time.perf_counter()
        out[name] = fn()
        out[name + ":stats"] = stats.counts()
        out[name + ":s"] = time.perf_counter() - t0

    for n in PCS_LOG_N:
        evals, point, output = inputs(f"pcs{n}")
        counted(f"pcs{n}", lambda: pcs_proof_to_bytes(
            PCSProof.prove(point, output, layout.shard_rows(evals), Transcript(), CPU, layout)).hex())

    x = inputs("ntt")
    a, b = split(NTT_LOG_N)
    cols = x.view(1 << a, 1 << b, 4)[:, r * (1 << b) // W : (r + 1) * (1 << b) // W].contiguous()
    counted("ntt", lambda: limbs.to_le_bytes(gather_cyclic(
        fourstep_columns(cols, pow2_generator(NTT_LOG_N).v, NTT_LOG_N, layout), layout)).hex())

    code = inputs("merkle")
    mine = code[r::W].contiguous()  # the cyclic block

    def merkle():
        tree = ShardedMerkleTree.commit(_pair_view(mine), layout)
        paths = open_batch_many([tree], [list(MERKLE_INDICES)], layout)[0]
        return {"root": tree.root_bytes().hex(), "paths": _paths(paths)}

    counted("merkle", merkle)

    code = inputs("fri")
    counted("fri", lambda: fri_proof_to_bytes(FriProof.prove(layout.shard_rows(code), Transcript(), layout)).hex())

    for B, n in BATCHED:
        polys, claim = inputs(f"batched{B}x{n}")
        counted(f"batched{B}x{n}", lambda: batched_pcs_proof_to_bytes(
            BatchedPCSProof.prove(claim, layout.shard_batch(polys), Transcript(), CPU, layout)).hex())

    out["gather_rows"] = torch.equal(layout.gather_rows(layout.shard_rows(x)), x)
    lanes = torch.tensor(inputs("lanes")[r], dtype=torch.int64)
    out["lanes"] = layout.comm.exact_sum(lanes).tolist()
    return out


def main(argv) -> int:
    rank, world, port, out_dir = int(argv[1]), int(argv[2]), int(argv[3]), argv[4]
    torch.set_num_threads(1)
    from multilinear_tpu_torch.parallel import multihost

    layout = multihost.init(rank, world, f"tcp://127.0.0.1:{port}", device="cpu")
    try:
        res = run(layout)
    finally:
        multihost.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
