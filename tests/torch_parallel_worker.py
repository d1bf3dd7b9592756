"""One rank of the sharded-proving tests of the PyTorch port (gloo, CPU).

    python tests/torch_parallel_worker.py RANK WORLD PORT OUT_DIR

joins a gloo group of WORLD processes at tcp://127.0.0.1:PORT, runs every
case of ``tests/test_torch_parallel.py`` on its block and writes what it got
to OUT_DIR/rank{RANK}.json; the sessions it saves half way (:data:`CHECKPOINTS`)
go to OUT_DIR/{case}.npz, written by rank 0.  The inputs come from numpy
seeds (:func:`inputs`), which the test module imports to build the
references.  Imports neither jax nor the JAX package.
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
from multilinear_tpu_torch.batched_pcs import BatchedPCSClaim, BatchedPCSProof, BatchedPCSProverSession  # noqa: E402
from multilinear_tpu_torch.config import ProverConfig  # noqa: E402
from multilinear_tpu_torch.field import limbs  # noqa: E402
from multilinear_tpu_torch.field.scalar import Fp, P  # noqa: E402
from multilinear_tpu_torch.fri import FriProof, _pair_view  # noqa: E402
from multilinear_tpu_torch.mle import evaluate_evals_host  # noqa: E402
from multilinear_tpu_torch.ntt import reed_solomon  # noqa: E402
from multilinear_tpu_torch.pcs import PCSProof, PCSProverSession  # noqa: E402
from multilinear_tpu_torch.serialize import (  # noqa: E402
    batched_pcs_proof_to_bytes,
    fri_proof_to_bytes,
    pcs_proof_to_bytes,
    snark_proof_to_bytes,
)
from multilinear_tpu_torch.system import ConstraintSet, SnarkProverSession, System, Trace, WitnessLayout  # noqa: E402
from multilinear_tpu_torch.transcript import Transcript  # noqa: E402

CPU = ProverConfig(device="cpu", debug_checks=True)
PCS_LOG_N = (10, 12)
NTT_LOG_N = 12
FRI_LOG_M = 9
MERKLE_LOG_M = 9
MERKLE_INDICES = (0, 1, 5, 100, 129, 255)
BATCHED = ((4, 8), (8, 8))  # (polynomials, log2 rows)
LANES_NEAR_2_63 = (2**31 - 1) * (2**32 - 1)  # the most ops.sum_limbs gives for 2^31 - 1 rows
SNARK_LOG_N = 10
SNARKS = ("snark4", "snark1")
# the sessions saved half way: (case, what is proved, how far it runs before the save)
CHECKPOINTS = (("ckpt_pcs", "pcs10", "5 rounds"), ("ckpt_batched_rows", "batched4x8", "3 rounds"),
               ("ckpt_batched_batch", "batched4x8", "3 rounds"), ("ckpt_snark_sumcheck", "snark4", "5 rounds"),
               ("ckpt_snark_pcs", "snark4", "sumcheck + 4 rounds"))


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
    if name == "snark4":
        # tests/test_parallel.py:218-236: c0, c1, v2 = v0, v3 = v0 + v1
        r = np.arange(1 << SNARK_LOG_N, dtype=np.uint64)
        c0, c1 = (3 * r + 1) % 1009, (5 * r + 2) % 1009
        cols = torch.stack([limbs.pack_ints(c) for c in (c0, c1, c0, c0 + c1)])
        return [lambda v, r: v[0] + v[1] - v[3], lambda v, r: v[2] - v[0]], 1, cols
    if name == "snark1":
        # a width-1 trace of uniform residues and the trivial constraint
        cols = _field(np.random.default_rng(7500), 1 << SNARK_LOG_N).reshape(1, -1, 4)
        return [lambda v, r: v[0] - v[0]], 1, cols
    if name == "lanes":
        rng = np.random.default_rng(7400)
        return [[[LANES_NEAR_2_63 - int(rng.integers(0, 2**40)) for _ in range(4)] for _ in range(3)]
                for _ in range(4)]  # rank r feeds lanes[r]
    raise KeyError(name)


def _paths(paths):
    return [[[str(v.v) for v in p.values], [[d.hex(), s] for d, s in p.path]] for p in paths]


def snark_prove(name, config, shard=None):
    """``System.prove_snark`` of case ``name``: the whole trace, or with a
    ``shard`` this rank's block of it."""
    constraints, degree, cols = inputs(name)
    cols = cols if shard is None else shard.shard_rows(cols)
    transcript = Transcript()
    prover = System.prover(transcript, ConstraintSet(constraints, degree), WitnessLayout(columns=cols.shape[0]),
                           Trace.from_columns(cols, config.device), config, shard)
    return prover.prove_snark(transcript)


def _finish_pcs(session):
    session.run_rounds()
    return session.finish()


def _finish_snark(session):
    if session.pcs_session is None:
        session.run_sumcheck_rounds()
    return session.finish()


def checkpoint_session(case, config, layout=None):
    """(build, advance, finish, resume, to_bytes) of a checkpoint case:
    ``build()`` makes the session (with a ``layout``, the rank's),
    ``advance`` runs it to where it is saved, ``resume(path, layout)``
    resumes a file of it and ``finish`` runs the rest."""
    proved = dict((c, p) for c, p, _ in CHECKPOINTS)[case]
    if proved.startswith("pcs"):
        evals, point, output = inputs(proved)
        block = evals if layout is None else layout.shard_rows(evals)
        return (lambda: PCSProverSession(point, output, block, Transcript(), config, layout),
                lambda s: s.run_rounds(5), _finish_pcs,
                lambda path, lay: PCSProverSession.resume(path, config, lay), pcs_proof_to_bytes)
    if proved.startswith("batched"):
        polys, claim = inputs(proved)
        if layout is not None:
            polys = layout.shard_rows(polys) if case.endswith("rows") else layout.shard_batch(polys)
        return (lambda: BatchedPCSProverSession(claim, polys, Transcript(), config, layout),
                lambda s: s.run_rounds(3), _finish_pcs,
                lambda path, lay: BatchedPCSProverSession.resume(path, config, lay), batched_pcs_proof_to_bytes)
    constraints, degree, cols = inputs(proved)
    cs, lay_w = ConstraintSet(constraints, degree), WitnessLayout(columns=cols.shape[0])
    block = cols if layout is None else layout.shard_rows(cols)
    if case.endswith("sumcheck"):
        advance = lambda s: s.run_sumcheck_rounds(5)  # noqa: E731
    else:
        def advance(s):
            s.run_sumcheck_rounds()
            s.run_pcs_rounds(4)
    return (lambda: SnarkProverSession(Transcript(), cs, lay_w, Trace.from_columns(block, config.device),
                                       config=config, shard=layout),
            advance, _finish_snark, lambda path, lay: SnarkProverSession.resume(path, cs, lay_w, config, lay),
            snark_proof_to_bytes)


def run(layout, out_dir: str) -> dict:
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

    for name in SNARKS:
        counted(name, lambda: snark_proof_to_bytes(snark_prove(name, CPU, layout)).hex())

    for case, _, _ in CHECKPOINTS:
        path = os.path.join(out_dir, f"{case}.npz")

        def saved_and_resumed():
            build, advance, finish, resume, to_bytes = checkpoint_session(case, CPU, layout)
            session = build()
            advance(session)
            session.save(path)
            return to_bytes(finish(resume(path, layout))).hex()

        counted(case, saved_and_resumed)

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
        res = run(layout, out_dir)
    finally:
        multihost.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
