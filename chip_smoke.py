#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port: ``python3 chip_smoke.py``.

Needs one NVIDIA card, nvcc and PyTorch built for CUDA; fails without them.
It builds the CUDA kernels from ``multilinear_tpu_torch/csrc``, takes the two
factors of every operation bound from the card and the build (the integer
rate from the card's multiprocessor count and clock, the instruction counts
from the machine code of probe kernels), holds each kernel against its plain
PyTorch version on the card (all values are integers: the tolerance is 0
mismatches) and fails if one reads above 105 % of its bound, then drives the
port's main paths - a PCS prove and verify through ``PCSProof.prove`` /
``PCSProof.verify`` at 2^16, 2^20 and 2^24 evaluations, a batched PCS
prove and verify through ``BatchedPCSProof.prove`` / ``.verify`` at 10 x 2^20
and 10 x 2^22, and the constraint-system SNARK through
``System.prove_snark`` / ``System.verify_snark`` on a width-1 trace of 2^24
rows (W1) and a 4-column Pythagorean trace of 2^22 rows (P4) - checks byte
parity with the CPU path and the golden digests of all three proof types,
and checks that a corrupted proof of each type is rejected.  The rounds of a
prove draw their challenges on the card: the largest prove of each type (and
the sumcheck of each SNARK) also runs its rounds under
``torch.cuda.set_sync_debug_mode("error")``, and a prove that makes more
device->host copies than ``MAX_D2H`` fails.  The ``sharded`` phase proves
the largest PCS over 4 and 2 ranks, the largest batched PCS over 2 ranks and
a 2^20 standalone FRI over 4 ranks, the SNARK paths W1 over 4 ranks and P4
over 2 (``System.prove_snark`` with a ``shard``), each rank a process of this
script (``--sharded-rank``) on card 0 over gloo (NCCL when the host has a
card for every rank); each rank's proof must be the single-rank proof's
bytes.  Two sharded sessions are saved half way - the 2^24 PCS over 4 ranks,
P4 in its sumcheck over 2 - and must write the single-rank session's file,
array for array, and resume, over the ranks and on one rank, to the
uninterrupted proof.

Each phase prints one JSON line.  Near the end come one line
``{"kernels": [...]}`` with every kernel's launches on the driven paths
(counted per path: the counts are set to 0 just before each and read just
after), error, time, plain-version time and bound, then the card's name and
power limit, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import glob
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from multilinear_tpu_torch import _build, fri, merkle, mle, ntt, previous_routes, sha256, sha256_cuda, stats
from multilinear_tpu_torch import device_transcript as dtr
from multilinear_tpu_torch.batched_pcs import BatchedPCSClaim, BatchedPCSProof, BatchedPCSProverSession
from multilinear_tpu_torch.config import NUM_QUERIES, ProverConfig
from multilinear_tpu_torch.field import cuda_ops, limbs, ops
from multilinear_tpu_torch.field.scalar import Fp, P, pow2_generator
from multilinear_tpu_torch.fri import FriError
from multilinear_tpu_torch.mle import evaluate_evals_host
from multilinear_tpu_torch.ntt import clear_caches, inv_gen_pows
from multilinear_tpu_torch.pcs import PCSProof, PCSProverSession
from multilinear_tpu_torch.serialize import (
    batched_pcs_proof_from_bytes,
    batched_pcs_proof_to_bytes,
    fri_proof_to_bytes,
    pcs_proof_from_bytes,
    pcs_proof_to_bytes,
    snark_proof_from_bytes,
    snark_proof_to_bytes,
)
from multilinear_tpu_torch.sumcheck import vandermonde_inv
from multilinear_tpu_torch.system import (
    Commitment, ConstraintSet, SnarkProverSession, System, Trace, WitnessLayout,
)
from multilinear_tpu_torch.testdata import (
    SNARK_CONSTRAINTS, batched_pcs_golden_inputs, pcs_golden_inputs, snark_golden_columns,
)
from multilinear_tpu_torch.transcript import Transcript
from multilinear_tpu_torch.utils import collect_phases

HERE = os.path.dirname(os.path.abspath(__file__))
PCS_LOG_SIZES = (16, 20, 24)
BATCH_POLYS = 10  # the reference batched workload's width
BATCHED_LOG_SIZES = (20, 22)
# The SNARK paths: (label, constraint set of testdata.SNARK_CONSTRAINTS, log2
# rows).  W1 is bench.py's snark metric (the reference snark_test: one column,
# the trivial constraint); P4 is bench.py's sumcheck metric (4 columns,
# Pythagorean triples and a sum column), whose sumcheck a wrong composition
# would break - W1's partial sums are all zero.
SNARK_PATHS = (("snark W1 2^24", "width1", 24), ("snark P4 4 x 2^22", "pythagorean", 22))

# The card's memory rate is the published peak of one H100 SXM (NVIDIA's data
# sheet).  The data sheet has no row for 32-bit integer arithmetic outside the
# tensor cores.  A Hopper multiprocessor has two pipes that take it, each
# good for 64 results a clock: the integer pipe (add, logic, shift, funnel
# shift, compare, select) and the multiply-add pipe (IMAD), which also adds
# and shifts and which the compiler uses for that (IMAD.IADD, IMAD.SHL) to
# take load off the first.  So the rate of one pipe is taken from what the
# card reports - its multiprocessor count and its highest SM clock
# (`integer_rate`) - and an operation bound is the time of the busier pipe
# with the additions put where they fit best (`ops_time_ms`).  The 64 a clock
# is the figure of the table "Throughput of Native Arithmetic Instructions"
# in NVIDIA's CUDA C++ documentation for compute capability 9.0, which gives it
# for 32-bit integer add, subtract, shift, compare and logic and likewise for
# 32-bit integer multiply and multiply-add.
PEAK_BYTES_PER_S = 3.35e12
INT_RESULTS_PER_SM_CLOCK = 64
# A kernel may read at most this share of its bound: a measured time below
# the bound is a fault of the bound.
MAX_BOUND_SHARE = 1.05

# The message-hashing entry is driven, and its kernel held against the plain
# version and timed, at one shape: 2^20 messages of 16 words.
MESSAGES_SHAPE = (1 << 20, 16)
MESSAGES_PATH = "sha256_words entry, 2^20 messages of 16 words"

# Integer instructions of each primitive as a vector (integer pipe only,
# multiply pipe only, either pipe), counted by `count_primitive_ops` in the
# machine code of the probe kernels of csrc/opcount.cu; `PEAK` holds the
# card's rate per pipe.  Both are filled in by main() before any bound is
# computed.
OPS: dict = {}
PEAK: dict = {}

# SASS mnemonics by the pipe that can take them.  Moves (MOV, IMAD.MOV),
# loads, stores, branches and the uniform datapath (U*) are not arithmetic
# the function needs and are left out.
ALU_ONLY = ("LOP3", "LOP", "SHF", "SHR", "PRMT", "LEA", "ISETP", "SEL", "IMNMX", "ICMP", "BREV",
            "POPC", "FLO", "IABS", "BMSK", "SGXT")
EITHER_PIPE = ("IADD3", "IADD", "SHL")  # and IMAD.IADD, IMAD.SHL, IMAD.X of RZ * RZ

KERNELS = {
    "mul": {
        "source": "multilinear_tpu_torch/csrc/mul.cu",
        "replaces": "multilinear_tpu/field/pallas_ops.py:198",
    },
    # add and sub are jnp code in the JAX package, not TPU kernels; the port
    # gives them kernels because eager PyTorch needs ~40 launches for each
    "add": {
        "source": "multilinear_tpu_torch/csrc/addsub.cu",
        "replaces": "multilinear_tpu/field/ops.py:217",
    },
    "sub": {
        "source": "multilinear_tpu_torch/csrc/addsub.cu",
        "replaces": "multilinear_tpu/field/ops.py:230",
    },
    # the TPU's one SHA-256 kernel is three here: messages, Merkle leaves read
    # in place, and several inner Merkle levels a launch
    "sha256_words": {
        "source": "multilinear_tpu_torch/csrc/sha256_words.cu",
        "replaces": "multilinear_tpu/sha256_pallas.py:106",
    },
    "sha256_leaves": {
        "source": "multilinear_tpu_torch/csrc/sha256_leaves.cu",
        "replaces": "multilinear_tpu/sha256_pallas.py:106",
    },
    "merkle_levels": {
        "source": "multilinear_tpu_torch/csrc/merkle_levels.cu",
        "replaces": "multilinear_tpu/sha256_pallas.py:106",
    },
    "zm_butterfly": {
        "source": "multilinear_tpu_torch/csrc/zm.cu",
        "replaces": "multilinear_tpu/field/pallas_ops.py:660",
    },
    "kron_mul": {
        "source": "multilinear_tpu_torch/csrc/kron.cu",
        "replaces": "multilinear_tpu/field/pallas_ops.py:595",
    },
    "butterfly2": {
        "source": "multilinear_tpu_torch/csrc/butterfly2.cu",
        "replaces": "multilinear_tpu/field/pallas_ops.py:445",
    },
    "butterfly_notw": {
        "source": "multilinear_tpu_torch/csrc/butterfly.cu",
        "replaces": "multilinear_tpu/field/pallas_ops.py:477",
    },
    "butterfly": {
        "source": "multilinear_tpu_torch/csrc/butterfly.cu",
        "replaces": "multilinear_tpu/field/pallas_ops.py:346",
    },
    "twiddle_mul3": {
        "source": "multilinear_tpu_torch/csrc/twiddle_mul3.cu",
        "replaces": "multilinear_tpu/field/pallas_ops.py:539",
    },
    "fold_codeword": {
        "source": "multilinear_tpu_torch/csrc/fold.cu",
        "replaces": "multilinear_tpu/field/pallas_ops.py:281",
    },
    "fold_commit_leaves": {
        "source": "multilinear_tpu_torch/csrc/fold_commit.cu",
        "replaces": "multilinear_tpu/field/pallas_ops.py:794",
    },
    # the round's Fiat-Shamir scalars: jnp code inside the TPU's round
    # program (`_round_scalars`, and the root absorb of `_pcs_round_body`),
    # not a TPU kernel; a kernel here so that no round waits for the host
    "round_scalars": {
        "source": "multilinear_tpu_torch/csrc/round_scalars.cu",
        "replaces": "multilinear_tpu/pcs.py:84",
    },
    # a standalone sumcheck round's Fiat-Shamir scalars (the second entry of
    # round_scalars.cu): the jnp scalar tail of `_sc_round_body`, inside the
    # TPU's round program, not a TPU kernel
    "sumcheck_round_scalars": {
        "source": "multilinear_tpu_torch/csrc/round_scalars.cu",
        "replaces": "multilinear_tpu/sumcheck.py:352",
    },
    # the query openings of every tree of a proof: XLA indexing in the JAX
    # package (`_gather_openings_multi`), not a TPU kernel; one launch here
    # where eager PyTorch took three a Merkle level
    "open_gather": {
        "source": "multilinear_tpu_torch/csrc/open_gather.cu",
        "replaces": "multilinear_tpu/merkle.py:230",
    },
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def run_text(cmd) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable: {e}"


def smi_line() -> str:
    return run_text(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])


def smi_mhz(field: str) -> float:
    """A clock of card 0 in MHz, as nvidia-smi reports it."""
    text = run_text(["nvidia-smi", "-i", "0", f"--query-gpu={field}", "--format=csv,noheader,nounits"])
    try:
        return float(text.splitlines()[0])
    except (ValueError, IndexError):
        raise RuntimeError(f"nvidia-smi gave no {field}: {text!r}")


def integer_rate(dev) -> dict:
    """32-bit integer results a second: multiprocessors x 64 x highest SM clock."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = smi_mhz("clocks.max.sm")
    return {"multiprocessors": sms, "max_sm_mhz": mhz,
            "int_ops_per_s": sms * INT_RESULTS_PER_SM_CLOCK * mhz * 1e6}


def clock_under_load(dev) -> dict:
    """The SM clock and power draw the card holds while it runs field
    multiplies back to back (read by nvidia-smi during the run)."""
    rng = np.random.default_rng(5)
    a, b = random_field(rng, (1 << 24,), dev), random_field(rng, (1 << 24,), dev)
    out = torch.empty_like(a)
    for _ in range(2000):  # ~0.6 s of queued work
        cuda_ops.mul(a, b, out=out)
    text = run_text(["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,power.limit",
                     "--format=csv,noheader"])
    torch.cuda.synchronize()
    return {"query": "clocks.sm, clocks.max.sm, power.draw, power.limit", "under_load": text}


def sass_int_ops(lib_path: str) -> dict:
    """{kernel function: {"alu": .., "fma": .., "either": .., "int": their
    sum, "all": instructions, "by_opcode": {...}}} from `cuobjdump -sass` of
    a built library."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([exe, "-sass", lib_path], capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {lib_path}: {res.stderr[-500:]}")
    out, cur = {}, None
    for line in res.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), {"alu": 0, "fma": 0, "either": 0, "int": 0, "all": 0,
                                              "by_opcode": {}})
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)\s*([^;]*);", line)
        if not m or cur is None:
            continue
        op, mods, operands = m.group(1), m.group(2).split(".")[1:], m.group(3)
        cur["all"] += 1
        if op == "IMAD":
            if "MOV" in mods:
                continue
            adds_only = "IADD" in mods or "SHL" in mods or ("X" in mods and ", RZ, RZ," in operands)
            pipe, name = ("either", "IMAD." + mods[0]) if adds_only else ("fma", "IMAD")
        elif op in ALU_ONLY:
            pipe, name = "alu", op
        elif op in EITHER_PIPE:
            pipe, name = "either", op
        else:
            continue
        cur[pipe] += 1
        cur["int"] += 1
        cur["by_opcode"][name] = cur["by_opcode"].get(name, 0) + 1
    return out


def ops_vector(counts: dict) -> np.ndarray:
    return np.array([counts["alu"], counts["fma"], counts["either"]], dtype=np.float64)


def alu_ops(n: float) -> np.ndarray:
    """n instructions that only the integer pipe takes (byte permutes)."""
    return np.array([n, 0.0, 0.0])


def ops_time_ms(ops) -> float:
    """Least time for a vector of (integer pipe, multiply pipe, either)
    instruction counts: the busier pipe, the additions put where they fit."""
    alu, fma, either = (float(v) for v in np.broadcast_to(np.asarray(ops, dtype=np.float64), (3,)))
    return max(alu, fma, (alu + fma + either) / 2) / PEAK["int_ops_per_s"] * 1e3


def count_primitive_ops() -> dict:
    """Integer instructions of one field multiply, add, subtract, halving,
    reduction of four limb sums and of the three SHA-256 block forms: each
    probe kernel of csrc/opcount.cu
    less the frame (loads, stores, index arithmetic) it shares with its
    base kernel."""
    probes = sass_int_ops(_build.library_paths["opcount"])
    need = ("opcount_base", "opcount_mul", "opcount_add", "opcount_sub", "opcount_half", "opcount_lane_sums",
            "opcount_sha_base", "opcount_sha_block", "opcount_sha_half_block", "opcount_sha_table_block")
    missing = [k for k in need if k not in probes]
    if missing:
        raise RuntimeError(f"probe kernels missing from the machine code: {missing}")
    base, sha_base = ops_vector(probes["opcount_base"]), ops_vector(probes["opcount_sha_base"])
    ops_ = {
        "mul": ops_vector(probes["opcount_mul"]) - base,
        "add": ops_vector(probes["opcount_add"]) - base,
        "sub": ops_vector(probes["opcount_sub"]) - base,
        "half": ops_vector(probes["opcount_half"]) - base,
        "lane_sums": ops_vector(probes["opcount_lane_sums"]) - base,
        # 16 message words; 8 message words and the padding of a 32-byte
        # message; a constant block run from its K + W table
        "sha_block": ops_vector(probes["opcount_sha_block"]) - sha_base,
        "sha_half_block": ops_vector(probes["opcount_sha_half_block"]) - sha_base,
        "sha_table_block": ops_vector(probes["opcount_sha_table_block"]) - sha_base,
    }
    if min(v.sum() for v in ops_.values()) <= 0 or min(v.min() for v in ops_.values()) < -4:
        raise RuntimeError(f"implausible instruction counts: {ops_} from {probes}")
    return {"ops": {k: np.maximum(v, 0) for k, v in ops_.items()}, "probes": {k: probes[k] for k in need}}


def sha_message_ops(n_words: int) -> np.ndarray:
    """Integer operations of SHA-256 over one message of ``n_words`` words,
    as the function needs them: full blocks, a half-constant block for the
    32-byte message, a table block where the last block is padding only."""
    full, rest = divmod(n_words, 16)
    if rest == 0:
        return full * OPS["sha_block"] + OPS["sha_table_block"]
    if n_words == 8:
        return OPS["sha_half_block"]
    return (full + (2 if rest > 13 else 1)) * OPS["sha_block"]


def fold_ops() -> np.ndarray:
    """One folded element: half(a + b) + (a - b) * tw * rh."""
    return 2 * OPS["mul"] + 2 * OPS["add"] + OPS["sub"] + OPS["half"]


def node_ops() -> np.ndarray:
    """A Merkle inner node: one full compression and the constant block."""
    return OPS["sha_block"] + OPS["sha_table_block"]


def launch_counts() -> dict:
    """Launches of each hand-written kernel since the last ``reset_counts``."""
    counts = stats.counts()
    return {name: counts.get("launch." + name, 0) for name in KERNELS}


def reset_counts() -> None:
    stats.reset()


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

_K = 45 * 2**40 - 1
# 0, 1, p-1 and values whose products reach every reduction branch: both
# folds carrying, the extra +K after the second fold, the final -p
EDGES = [0, 1, 2, P - 1, P - 2, _K, _K + 1, 2**64 - 1, 2**64, 2**127, P // 2, (P + 1) // 2,
         (2**128 - 2**93) % P, 2**93, 2**96 - 1, P - _K]


def random_field(rng: np.random.Generator, shape, device) -> torch.Tensor:
    """Canonical field tensor shape+(4,): random 32-bit limbs with the top
    limb below 2^31 (so every value is < p), the edge values first."""
    n = int(np.prod(shape))
    raw = rng.integers(0, 2**32, size=(n, 4), dtype=np.uint32)
    raw[:, 3] &= 0x7FFFFFFF
    t = torch.from_numpy(raw.view(np.int32)).to(device)
    k = min(n, len(EDGES))
    t[:k] = limbs.pack_ints(EDGES[:k], device=device)
    return t.reshape(tuple(shape) + (4,))


def edge_pairs(device):
    """All pairs of edge values, as two (len^2, 4) tensors."""
    a = limbs.pack_ints([x for x in EDGES for _ in EDGES], device=device)
    b = limbs.pack_ints([y for _ in EDGES for y in EDGES], device=device)
    return a, b


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls after one warm-up,
    by CUDA events.  The inputs are far larger than the 50 MB L2 cache, so
    every call finds them cold.  One more call is queued before the start
    event, so that the card is busy when it is recorded: the host's time to
    enqueue the first timed call is not counted (for work that the host
    enqueues faster than the card runs it)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, copies: int = 20, reps: int = 5) -> float:
    """Device time of ``fn()`` with the host taken out: ``copies`` calls are
    captured into one CUDA graph and the graph is replayed.  For work of a
    few microseconds, which the host cannot launch as fast as the card runs
    it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(copies):
            fn()
    ms = time_ms(graph.replay, reps) / copies
    del graph
    return ms


def bound(n_bytes: float, n_ops):
    """(ms, "bytes" or "operations"); ``n_ops`` is an instruction vector."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops_time_ms(n_ops)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want) -> dict:
    """Exact comparison of integer tensors (or tuples of them)."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    mismatches, max_err = 0, 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise RuntimeError(f"shape/dtype differ: {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        diff = g.to(torch.int64) - w.to(torch.int64)
        mismatches += int((diff != 0).sum())
        max_err = max(max_err, int(diff.abs().max()) if diff.numel() else 0)
    return {"mismatches": mismatches, "max_abs_err": max_err}


# ---------------------------------------------------------------------------
# the kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernel(name, label, kernel_fn, plain_fn, n_bytes, n_ops, shapes, timed: bool):
    got = kernel_fn()
    torch.cuda.synchronize()
    want = plain_fn()
    res = compare(got, want)
    del got, want
    row = {"kernel": name, "case": label, "shapes": shapes, **res}
    if timed:
        b_ms, b_by = bound(n_bytes, n_ops)
        row["kernel_ms"] = time_ms(kernel_fn, 5)
        row["plain_ms"] = time_ms(plain_fn, 1)
        row["bound_ms"] = b_ms
        row["bound_by"] = b_by
        row["bound_share"] = b_ms / row["kernel_ms"]
        print(json.dumps(row), file=sys.stderr, flush=True)  # kept even if a later case fails
    torch.cuda.empty_cache()
    if res["mismatches"]:
        raise RuntimeError(f"kernel {name} disagrees with its plain version: {row}")
    return row


def kernel_sass(stem: str, name: str) -> dict:
    """The instruction counts (``sass_int_ops``) of the kernel function
    ``name`` (its mangled name, templates included) in a built library."""
    fns = sass_int_ops(_build.library_paths[stem])
    found = [c for f, c in fns.items() if f == name or re.match(rf"_Z{len(name)}{name}", f)]
    if len(found) != 1:
        raise RuntimeError(f"{name}: {len(found)} matching functions in {stem}'s machine code: {sorted(fns)}")
    return found[0]


def sha_chain_ms(blocks: int) -> float:
    """The state-dependent part of ``blocks`` SHA-256 compressions one after
    another, each needing the chaining words of the one before (Fiat-Shamir
    makes a transcript's compressions one chain), at one instruction a
    clock: the 64 rounds of a block run from its K + W table
    (``sha_table_block``).  The message schedule is not on the chain: every
    message word is known before the absorb starts (``sha_schedule_ops``)."""
    return blocks * OPS["sha_table_block"].sum() / (PEAK["max_sm_mhz"] * 1e6) * 1e3


def sha_schedule_ops(blocks: int) -> np.ndarray:
    """The instructions of ``blocks`` compressions that need no chaining
    words - the expansion of W16..W63 and the K + W additions, a full block
    less a table block - which other threads could do beside the chain."""
    return blocks * np.maximum(OPS["sha_block"] - OPS["sha_table_block"], 0)


def transcript_blocks(fill: int, n_bytes: int) -> int:
    """Compressions of absorbing ``n_bytes`` at a fill of ``fill`` bytes and
    of the digest after it (one block, or two when the fill leaves no room
    for the length)."""
    total = fill + n_bytes
    return total // 64 + (1 if total % 64 <= 55 else 2)


def round_bound(n_bytes: float, blocks: int, other_ops) -> tuple:
    """(ms, "bytes" or "operations") of a round kernel, whatever implements
    it: the compressions' rounds as one chain (``sha_chain_ms``) plus every
    other integer instruction of the round - the message schedules
    (``sha_schedule_ops``) among them - at the card's integer rate
    (``ops_time_ms``), or the bytes over the memory rate if that is longer."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = sha_chain_ms(blocks) + ops_time_ms(other_ops + sha_schedule_ops(blocks))
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def one_clock_ms(instructions: float) -> float:
    return instructions / (PEAK["max_sm_mhz"] * 1e6) * 1e3


# A round with a root, the case of every PCS round: its bytes (the state
# read and written, the sums, the root, prev in, three scalars and two
# coefficients out, the digest) and its field operations besides the two
# reductions (s0, c2, c1, prev', r / 2).
ROUND_BYTES = 2 * 104 + 64 + 32 + 16 + 48 + 32 + 32


def round_other_ops() -> np.ndarray:
    return (2 * OPS["lane_sums"] + 2 * OPS["mul"] + 4 * OPS["add"] + 4 * OPS["sub"] + 2 * OPS["half"])


def round_scalars_inputs(dev, rng, case: int):
    """A seeded round: a transcript with case % 64 + 64 (case % 3) bytes
    absorbed, prev at 0 or p - 1 every fifth case, lane sums up to 2^55 - 1,
    2^63, 2^32 or 1 (and at 0 and 2^63 - 1 every seventh), a root unless
    case % 4 == 0, and a last element."""
    lane_cases = ((1 << 55) - 1, 1 << 63, 1 << 32, 1)
    host = Transcript()
    host.absorb(rng.bytes(case % 64 + 64 * (case % 3)))
    state = dtr.state_from_host(host, dev)
    prev = (0, P - 1)[case % 2] if case % 5 == 0 else int.from_bytes(rng.bytes(16), "little") % P
    scal = limbs.pack_ints([prev, 0, 0], device=dev)
    hi = lane_cases[case % 4]
    sums = torch.from_numpy(rng.integers(0, hi, size=(2, 4), dtype=np.uint64).astype(np.int64)).to(dev)
    if case % 7 == 0:
        sums[case % 2].fill_(0 if case % 14 else (1 << 63) - 1)
    root = torch.from_numpy(rng.integers(0, 2**32, size=8, dtype=np.uint32).view(np.int32)).to(dev)
    elem = random_field(rng, (2,), dev)
    return state, scal, sums, (root if case % 4 else None), elem


def launch_round_scalars(fn, dev, state, scal, sums, root, elem, mode):
    """One launch of ``fn`` (the kernel's wrapper, its plain version or a
    kept kernel) on copies of the inputs; returns every output."""
    state, scal = state.clone(), scal.clone()
    digest = torch.zeros(8, dtype=torch.int32, device=dev)
    coeffs = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    if mode == "round":
        fn(state, scal, digest, sums=sums, root=root, coeffs=coeffs)
    else:
        fn(state, scal, digest, elem=elem)
    return state, scal, digest, coeffs


def round_scalars_cases(dev, rng, main: dict) -> list:
    """The round-scalars kernel against its plain version on the card; the
    timed row (main["round_scalars"]) is a round that absorbs a root, the
    case of every PCS round, with its device time from a replayed CUDA graph
    of back-to-back launches.  Its bound is ``round_bound``: the rounds of
    the two or three compressions as one chain at one instruction a clock,
    plus the rest at the card's integer rate; ``one_thread_bound_ms`` is the bound of a
    one-thread implementation (the kept kernel's instructions at one a
    clock), which the one-thread kernel was held to."""
    rows = []
    bad, worst = 0, 0
    for case in range(256):
        args = round_scalars_inputs(dev, rng, case)
        for mode in ("round", "last element"):
            res = compare(launch_round_scalars(dtr.round_scalars, dev, *args, mode),
                          launch_round_scalars(dtr.round_scalars_plain, dev, *args, mode))
            bad += res["mismatches"]
            worst = max(worst, res["max_abs_err"])
    rows.append({"kernel": "round_scalars", "case": "256 seeded states x (round, last element): fills 0-63, "
                 "lanes to 2^63, prev 0 and p-1, with and without a root", "mismatches": bad, "max_abs_err": worst})
    if bad:
        raise RuntimeError(f"kernel round_scalars disagrees with its plain version: {rows[-1]}")

    state, scal, sums, root, elem = round_scalars_inputs(dev, rng, 1)  # a root, a fill of 1 + 64 bytes
    digest = torch.empty(8, dtype=torch.int32, device=dev)
    coeffs = torch.empty((2, 4), dtype=torch.int32, device=dev)
    blocks = transcript_blocks(1, 32 + 32)
    bound_ms, bound_by = round_bound(ROUND_BYTES, blocks, round_other_ops())
    one_thread = kernel_sass("prev_round_scalars", "round_scalars_one_thread_kernel")["all"]
    row = {"kernel": "round_scalars", "case": "main: a round with a root",
           "shapes": [[dtr.STATE_WORDS], [2, 4], [8]], "mismatches": 0, "max_abs_err": worst,
           "kernel_ms": graph_ms(lambda: dtr.round_scalars(state, scal, digest, sums=sums, root=root, coeffs=coeffs),
                                 copies=100),
           "plain_ms": time_ms(lambda: dtr.round_scalars_plain(state, scal, digest, sums=sums, root=root,
                                                                coeffs=coeffs), 5),
           "bound_ms": bound_ms, "bound_by": bound_by, "sha_blocks": blocks,
           "instructions": kernel_sass("round_scalars", "round_scalars_kernel")["all"],
           "one_thread_bound_ms": one_clock_ms(one_thread), "one_thread_instructions": one_thread}
    row["bound_share"] = bound_ms / row["kernel_ms"]
    row["one_thread_bound_share"] = row["one_thread_bound_ms"] / row["kernel_ms"]
    print(json.dumps(row), file=sys.stderr, flush=True)
    main.setdefault("round_scalars", row)
    rows.append(row)
    return rows


def sumcheck_round_instructions(degree: int, fill: int) -> float:
    """The bound of a one-thread implementation of a standalone round (the
    one the one-thread kernel was held to), in instructions at one a clock:
    the d(d+1) multiplies and d^2 additions of rows 1..d of the V^-1 product
    (row 0 is e0: c0 = s0 needs no work), the d multiplies and d additions
    of Horner, s0 = prev - s1, and the SHA-256 compressions of the absorbed
    coefficients and of the digest, at the counts of the `bounds` phase."""
    blocks = transcript_blocks(fill, 16 * degree)
    return float((degree * (degree + 1) + degree) * OPS["mul"].sum() + (degree * degree + degree) * OPS["add"].sum()
                 + OPS["sub"].sum() + blocks * OPS["sha_block"].sum())


def sumcheck_round_bound(degree: int, fill: int) -> tuple:
    """``round_bound`` of a standalone round: V^-1, the sums, the
    coefficients, prev, r, the state and the digest once each; the d(d+1)
    multiplies and d^2 additions of rows 1..d of V^-1, the d multiplies and
    d additions of p(r), the d reductions and s0 besides the chain."""
    n_bytes = 16 * (degree + 1) ** 2 + 32 * degree + 16 * degree + 2 * 16 + 16 + 2 * 104 + 32
    other = (degree * OPS["lane_sums"] + (degree * (degree + 1) + degree) * OPS["mul"]
             + (degree * degree + degree) * OPS["add"] + OPS["sub"])
    return round_bound(n_bytes, transcript_blocks(fill, 16 * degree), other)


# total degrees of the standalone round's checks above the usual ones: the
# cap of 16 that the kernel once had, each side of it, and well past it
HIGH_DEGREES = (3, 16, 17, 33, 64)
# the degrees timed: P4's round (the main row), two past the old cap, and one
# above the block's 256 threads (a seeded random matrix in V^-1's place)
TIMED_DEGREES = (3, 17, 64, 1100)
# above the block's thread count, with a seeded random (d+1, d+1) matrix in
# V^-1's place (the host's Gauss-Jordan inverse is O(d^3) in Python): 1,100,
# and 2,047, the largest degree whose plain version (pure Python over the
# (d+1)^2 products) finishes in a few seconds on the host - about 5.5 s; the
# card's limit, about 7,260, would take some 13 times as long
RANDOM_MATRIX_DEGREES = ((1100, 2), (2047, 1))


def sumcheck_inputs(dev, rng, case: int, degree: int):
    """A seeded standalone round: a transcript with case % 64 + 64 (case % 3)
    bytes absorbed, prev at 0 or p - 1 every fifth case, lane sums up to
    2^55 - 1, 2^63, 2^32 or 1 (one row at 0 or 2^63 - 1 every seventh case),
    and V^-1 for d <= 64, a seeded random matrix in its place above."""
    lane_cases = ((1 << 55) - 1, 1 << 63, 1 << 32, 1)
    host = Transcript()
    host.absorb(rng.bytes(case % 64 + 64 * (case % 3)))
    prev = (0, P - 1)[case % 2] if case % 5 == 0 else int.from_bytes(rng.bytes(16), "little") % P
    sums = torch.from_numpy(rng.integers(0, lane_cases[case % 4], size=(degree, 4),
                                         dtype=np.uint64).astype(np.int64)).to(dev)
    if case % 7 == 0:
        sums[case % degree].fill_(0 if case % 14 else (1 << 63) - 1)
    vinv = vandermonde_inv(degree + 1, dev) if degree <= 64 else full_random_field(rng, (degree + 1, degree + 1), dev)
    return dtr.state_from_host(host, dev), limbs.pack_int(prev, device=dev), sums, vinv


def launch_sumcheck_round(fn, dev, state, prev, sums, vinv):
    """One launch of ``fn`` on copies of the state and prev; every output."""
    state, prev = state.clone(), prev.clone()
    digest = torch.zeros(8, dtype=torch.int32, device=dev)
    coeffs = torch.zeros((sums.shape[0], 4), dtype=torch.int32, device=dev)
    r = torch.zeros(4, dtype=torch.int32, device=dev)
    fn(state, prev, digest, sums, vinv, coeffs, r)
    return state, prev, digest, coeffs, r


def sumcheck_round_at_the_limit(dev, rng) -> dict:
    """The kernel at the card's degree limit, where its plain version would
    take minutes: V^-1's place holds a seeded sparse matrix (row j has one
    nonzero a_j in a seeded column pi(j)), so c_j = a_j ev[pi(j)], and the
    reference is the host's own arithmetic and transcript over those d
    products (an independent reference, not the plain version)."""
    degree = dtr.sumcheck_degree_limit(dev)
    n = degree + 1
    state, prev, sums, _ = sumcheck_inputs(dev, rng, 61, 2)  # a fill of 61 + 64 bytes
    sums = torch.from_numpy(rng.integers(0, 1 << 63, size=(degree, 4), dtype=np.uint64).astype(np.int64)).to(dev)
    cols = rng.permutation(n)[:degree]
    a = full_random_field(rng, (degree,), dev)
    vinv = torch.zeros((n, n, 4), dtype=torch.int32, device=dev)
    vinv[torch.arange(1, n, device=dev), torch.from_numpy(cols).to(dev)] = a
    got = launch_sumcheck_round(dtr.sumcheck_round_scalars, dev, state, prev, sums, vinv)
    torch.cuda.synchronize()
    ev = [ops.limb_sums_to_int(lanes) for lanes in sums.cpu().tolist()]
    ev = [(limbs.unpack_int(prev.cpu()) - ev[0]) % P] + ev
    c = [ev[0]] + [int(x) * ev[int(i)] % P for x, i in zip(limbs.unpack_ints(a.cpu()), cols)]
    want_state = dtr.absorb(state.cpu(), b"".join(x.to_bytes(16, "little") for x in c[1:]))
    d = dtr.digest(want_state)
    r = int.from_bytes(d[:16], "little") % P
    acc = 0
    for x in reversed(c):
        acc = (acc * r + x) % P
    want = (want_state, limbs.pack_int(acc), torch.from_numpy(np.frombuffer(d, dtype=">u4").astype(np.uint32)
                                                               .view(np.int32)), limbs.pack_ints(c[1:]),
            limbs.pack_int(r))
    res = compare(tuple(t.cpu() for t in got), want)
    row = {"kernel": "sumcheck_round_scalars", "case": f"the card's degree limit, {degree}: a seeded sparse matrix "
           "in V^-1's place, against the host's arithmetic and transcript (the plain version would take minutes)",
           "degree": degree, **res,
           "kernel_ms": time_ms(lambda: launch_sumcheck_round(dtr.sumcheck_round_scalars, dev, state, prev, sums,
                                                               vinv), 3),
           "shared_bytes": 32 * n}
    print(json.dumps(row), file=sys.stderr, flush=True)
    del vinv
    torch.cuda.empty_cache()
    return row


def sumcheck_round_scalars_cases(dev, rng, main: dict) -> list:
    """The standalone round mode against its plain version on the card over
    seeded transcript states (fills 0-63, one to three blocks absorbed
    before), total degrees 2-8, ``HIGH_DEGREES`` and
    ``RANDOM_MATRIX_DEGREES``, lane sums to 2^63 - 1 and prev at 0 and
    p - 1, then at the card's degree limit; the timed rows are P4's round
    (degree 3, the main row) and ``TIMED_DEGREES``, each with its device
    time from a replayed CUDA graph of back-to-back launches, its bound
    ``sumcheck_round_bound`` and the one-thread bound of earlier PRs
    (``sumcheck_round_instructions`` at one a clock)."""
    bad, worst, n = 0, 0, 0
    for degree, states in ([(d, 64) for d in range(2, 9)] + [(d, 16) for d in HIGH_DEGREES]
                           + list(RANDOM_MATRIX_DEGREES)):
        for case in range(states):
            args = sumcheck_inputs(dev, rng, case, degree)
            res = compare(launch_sumcheck_round(dtr.sumcheck_round_scalars, dev, *args),
                          launch_sumcheck_round(dtr.sumcheck_round_scalars_plain, dev, *args))
            bad += res["mismatches"]
            worst = max(worst, res["max_abs_err"])
            n += 1
    rows = [{"kernel": "sumcheck_round_scalars", "case": f"{n} launches: 64 seeded states x total degrees 2-8, "
             f"16 x degrees {', '.join(map(str, HIGH_DEGREES))} and, with a seeded random matrix in V^-1's place, "
             + ", ".join(f"{s} x degree {d}" for d, s in RANDOM_MATRIX_DEGREES)
             + "; fills 0-63, lanes to 2^63 - 1, prev 0 and p-1",
             "mismatches": bad, "max_abs_err": worst,
             "degree_limit_of_this_card": dtr.sumcheck_degree_limit(dev)}]
    if bad:
        raise RuntimeError(f"kernel sumcheck_round_scalars disagrees with its plain version: {rows[-1]}")
    rows.append(sumcheck_round_at_the_limit(dev, rng))
    if rows[-1]["mismatches"]:
        raise RuntimeError(f"kernel sumcheck_round_scalars disagrees with the host at its degree limit: {rows[-1]}")

    for degree in TIMED_DEGREES:
        state, prev, sums, vinv = sumcheck_inputs(dev, rng, 1, degree)  # a fill of 1 + 64 bytes
        digest = torch.empty(8, dtype=torch.int32, device=dev)
        coeffs = torch.empty((degree, 4), dtype=torch.int32, device=dev)
        r = torch.empty(4, dtype=torch.int32, device=dev)
        bound_ms, bound_by = sumcheck_round_bound(degree, 1)
        row = {"kernel": "sumcheck_round_scalars",
               "case": "main: a degree-3 round (P4)" if degree == 3 else f"a degree-{degree} round",
               "shapes": [[dtr.STATE_WORDS], [degree, 4], [degree + 1, degree + 1, 4]], "mismatches": 0,
               "max_abs_err": worst,
               "kernel_ms": graph_ms(lambda: dtr.sumcheck_round_scalars(state, prev, digest, sums, vinv, coeffs, r),
                                     copies=100 if degree <= 64 else 10),
               "plain_ms": time_ms(lambda: dtr.sumcheck_round_scalars_plain(state, prev, digest, sums, vinv, coeffs,
                                                                            r), 5 if degree <= 64 else 1),
               "bound_ms": bound_ms, "bound_by": bound_by, "sha_blocks": transcript_blocks(1, 16 * degree),
               "one_thread_bound_ms": one_clock_ms(sumcheck_round_instructions(degree, 1))}
        row["bound_share"] = bound_ms / row["kernel_ms"]
        row["one_thread_bound_share"] = row["one_thread_bound_ms"] / row["kernel_ms"]
        print(json.dumps(row), file=sys.stderr, flush=True)
        main.setdefault("sumcheck_round_scalars" if degree == 3 else f"sumcheck_round_scalars/degree {degree}", row)
        rows.append(row)
        del vinv
    return rows


def kernels_phase(dev) -> dict:
    """Every kernel at the shape the 2^24 prove gives it, at a ragged shape,
    and on the edge values.  Returns {name: timed main-shape row}."""
    rng = np.random.default_rng(20240601)
    rows, main = [], {}

    def run(name, label, kernel_fn, plain_fn, n_bytes=0, n_ops=0, shapes=None, timed=False):
        row = check_kernel(name, label, kernel_fn, plain_fn, n_bytes, n_ops, shapes, timed)
        rows.append(row)
        if timed:
            main.setdefault(name, row)

    # mul: the four-step twiddle pass over the 2^25 codeword
    for label, n, timed in (("main 2^25", 1 << 25, True), ("ragged", 1_000_003, False)):
        a, b = random_field(rng, (n,), dev), random_field(rng, (n,), dev)
        run("mul", label, lambda: cuda_ops.mul(a, b), lambda: cuda_ops.mul_plain(a, b),
            n_bytes=48 * n, n_ops=OPS["mul"] * n, shapes=[[n, 4], [n, 4]], timed=timed)
    a, b = edge_pairs(dev)
    for name, plain in (("mul", cuda_ops.mul_plain), ("add", ops.add_plain), ("sub", ops.sub_plain)):
        kernel = getattr(cuda_ops, name)
        run(name, "edge pairs", lambda: kernel(a, b), lambda: plain(a, b), shapes=[list(a.shape)] * 2)
    # broadcast operands read through their strides: the tensor product of
    # the delta table and the four-step twiddle factor of the 2^25 codeword
    a, b = random_field(rng, (1 << 16, 1), dev), random_field(rng, (1, 1 << 8), dev)
    run("mul", "tensor product 2^16 x 2^8", lambda: cuda_ops.mul(a, b),
        lambda: cuda_ops.mul_plain(a, b), shapes=[list(a.shape), list(b.shape)])
    a, b = random_field(rng, (128, 64, 4096), dev), random_field(rng, (128, 1, 4096), dev)
    run("mul", "twiddle factor (128,64,4096) x (128,1,4096)", lambda: cuda_ops.mul(a, b),
        lambda: cuda_ops.mul_plain(a, b), shapes=[list(a.shape), list(b.shape)])

    # add: the X=2 extension of round 0, on the two halves of the packed
    # (2, 2^24) table; sub: hi - lo on strided halves of 2^24 elements
    n = 1 << 24
    data = random_field(rng, (2, n), dev)
    hi, lo = data[:, n // 2:], data[:, : n // 2]
    run("add", "main halves of (2, 2^24)", lambda: cuda_ops.add(hi, lo), lambda: ops.add_plain(hi, lo),
        n_bytes=48 * n, n_ops=OPS["add"] * n, shapes=[list(hi.shape)] * 2, timed=True)
    w = data[0].view(1 << 11, 2, 1 << 12, 4)
    run("sub", "main strided halves, bit 12 of 2^24", lambda: cuda_ops.sub(w[:, 1], w[:, 0]),
        lambda: ops.sub_plain(w[:, 1], w[:, 0]),
        n_bytes=48 * (n // 2), n_ops=OPS["sub"] * (n // 2), shapes=[list(w[:, 1].shape)] * 2, timed=True)

    def in_place():
        y = data[0].clone()
        wy = y.view(1 << 11, 2, 1 << 12, 4)
        cuda_ops.sub(wy[:, 1], wy[:, 0], out=wy[:, 1])
        return y

    def in_place_plain():
        y = data[0].clone()
        wy = y.view(1 << 11, 2, 1 << 12, 4)
        wy[:, 1] = ops.sub_plain(wy[:, 1], wy[:, 0])
        return y

    run("sub", "strided halves written in place", in_place, in_place_plain, shapes=[list(w[:, 1].shape)] * 2)
    small = random_field(rng, (37, 2, 19), dev)
    run("add", "ragged strided", lambda: cuda_ops.add(small[:, 1], small[:, 0]),
        lambda: ops.add_plain(small[:, 1], small[:, 0]), shapes=[[37, 19, 4]] * 2)
    del a, b, data, hi, lo, w, small

    # butterfly: a two-row sub-transform (all the transforms leave to it), and
    # one stage of the 2^25 four-step transform, timed as the single-stage
    # route the double-stage kernel is compared with
    for label, H, C, timed in (("one stage, H=4096 C=4096", 4096, 4096, True),
                               ("two-row sub-transform of a tiny prove, H=1 C=2", 1, 2, False),
                               ("ragged", 37, 19, False)):
        u, v = random_field(rng, (H, C), dev), random_field(rng, (H, C), dev)
        tw = random_field(rng, (H,), dev)
        run("butterfly", label, lambda: cuda_ops.butterfly(u, v, tw),
            lambda: cuda_ops.butterfly_plain(u, v, tw),
            n_bytes=64 * H * C + 16 * H, n_ops=(OPS["mul"] + OPS["add"] + OPS["sub"]) * H * C,
            shapes=[[H, C, 4], [H, C, 4], [H, 4]], timed=timed)
    del u, v, tw

    # butterfly_notw: the odd 13th stage of the 2^25 transform's column
    # sub-NTT, on the row halves of (8192, 4096); the batched encode's odd
    # 11th stage on the row halves of (10, 2048, 4096)
    for label, shape, timed in (("main, row halves of (8192, 4096)", (8192, 4096), True),
                                ("batched, row halves of (10, 2048, 4096)", (10, 2048, 4096), False),
                                ("ragged batch (3, 74, 19)", (3, 74, 19), False),
                                ("M=2", (2, 1), False)):
        x = random_field(rng, shape, dev)
        H = shape[-2] // 2
        u, v = x[..., :H, :, :], x[..., H:, :, :]
        n = x.numel() // 8
        run("butterfly_notw", label, lambda: cuda_ops.butterfly_notw(u, v),
            lambda: cuda_ops.butterfly_notw_plain(u, v), n_bytes=64 * n, n_ops=(OPS["add"] + OPS["sub"]) * n,
            shapes=[list(u.shape)] * 2, timed=timed)
    u, v = edge_pairs(dev)
    run("butterfly_notw", "edge pairs", lambda: cuda_ops.butterfly_notw(u.view(16, 16, 4), v.view(16, 16, 4)),
        lambda: cuda_ops.butterfly_notw_plain(u.view(16, 16, 4), v.view(16, 16, 4)),
        shapes=[[16, 16, 4]] * 2)
    del x, u, v

    # butterfly2: the first double stage of the 2^25 transform's column
    # sub-NTT (13 stages over 8192 rows), with the power table read through
    # the stride the four-step transform gives it; every double stage of odd
    # and even small transforms; the batched encode's shape
    for label, shape, timed in (("main (8192, 4096)", (8192, 4096), True),
                                ("batched (10, 4096, 2048)", (10, 4096, 2048), False),
                                ("M=4", (4, 1), False), ("M=8 ragged", (8, 19), False),
                                ("M=32 batch", (3, 32, 5), False)):
        x = random_field(rng, shape, dev)
        M, C = shape[-2], shape[-1]
        log_m = M.bit_length() - 1
        stride = 4096 if M == 8192 else 1  # pows[::B] of the 2^25 table
        table = ntt._pow_table(pow2_generator(log_m + stride.bit_length() - 1).v,
                               log_m + stride.bit_length() - 2, dev)
        pows = table[::stride][: M // 2]
        n = x.numel() // 4
        for ps in range(log_m // 2) if M <= 32 else (0, log_m // 2 - 1):
            run("butterfly2", f"{label}, ps={ps}",
                lambda: cuda_ops.butterfly2(x, pows, ps),
                lambda: cuda_ops.butterfly2_plain(x, pows, ps),
                n_bytes=32 * n + 16 * (M // 2), n_ops=(OPS["mul"] + OPS["add"] + OPS["sub"]) * n,
                shapes=[list(x.shape), list(pows.shape)], timed=timed and ps == 0)
    x = limbs.pack_ints(EDGES, device=dev).view(4, 4, 4)
    pows = limbs.pack_ints(EDGES[3:5], device=dev)
    run("butterfly2", "edge values", lambda: cuda_ops.butterfly2(x, pows, 0),
        lambda: cuda_ops.butterfly2_plain(x, pows, 0), shapes=[[4, 4, 4], [2, 4]])
    del x, pows, table
    clear_caches()

    # twiddle_mul3: the twiddle step of the 2^25 transform, and of the
    # batched encode's ten 2^23 transforms
    for label, log_n, batch, timed in (("main (8192, 4096)", 25, None, True),
                                       ("batched (10, 4096, 2048)", 23, 10, False),
                                       ("A=2 B=2 S=1", 2, None, False),
                                       ("A=8 B=4 batch", 5, 3, False)):
        a_bits = (log_n + 1) // 2
        A, B = 1 << a_bits, 1 << (log_n - a_bits)
        Tc, Tf = ntt._twiddle_factors(pow2_generator(log_n).v, log_n, dev)
        F = random_field(rng, ((batch,) if batch else ()) + (A, B), dev)
        n = F.numel() // 4
        run("twiddle_mul3", label, lambda: cuda_ops.twiddle_mul3(F, Tc, Tf),
            lambda: cuda_ops.twiddle_mul3_plain(F, Tc, Tf),
            n_bytes=32 * n + 4 * (Tc.numel() + Tf.numel()), n_ops=2 * OPS["mul"] * n,
            shapes=[list(F.shape), list(Tc.shape), list(Tf.shape)], timed=timed)
    F = limbs.pack_ints(EDGES, device=dev).view(4, 4, 4)
    Tc, Tf = random_field(rng, (2, 4), dev), limbs.pack_ints(EDGES[8:], device=dev).view(2, 4, 4)
    run("twiddle_mul3", "edge values", lambda: cuda_ops.twiddle_mul3(F, Tc, Tf),
        lambda: cuda_ops.twiddle_mul3_plain(F, Tc, Tf), shapes=[[4, 4, 4], [2, 4, 4], [2, 4, 4]])
    del F, Tc, Tf
    clear_caches()

    # kron_mul: the last tensor product of the 2^24 eq table, written into
    # its half of the packed sumcheck table (timed); the first product of
    # every table, 2^8 x 2^8; the batched prove's last, 2^16 x 2^6; a batch;
    # ragged tiles - rows that do not fill a step, one to four columns a
    # thread, b wider than a slab - and the edge values
    kron_cases = (("main 2^16 x 2^8 into out", (1 << 16,), 1 << 8, True, True),
                  ("2^8 x 2^8", (1 << 8,), 1 << 8, False, False),
                  ("2^16 x 2^6 into out", (1 << 16,), 1 << 6, True, False),
                  ("batch (3, 2^10) x 2^6", (3, 1 << 10), 1 << 6, False, False),
                  ("1 x 1", (1,), 1, False, False), ("ragged 7 x 300", (7,), 300, False, False),
                  ("ragged 1000 x 3", (1000,), 3, False, False), ("ragged 37 x 255", (37,), 255, False, False),
                  ("ragged 9 x 600", (9,), 600, False, False), ("slabs 5 x 2500", (5,), 2500, False, False))
    for label, a_shape, n, into_out, timed in kron_cases:
        a, b = random_field(rng, a_shape, dev), random_field(rng, (n,), dev)
        m = a.numel() // 4
        packed = torch.zeros((2,) + a_shape[:-1] + (a_shape[-1] * n, 4), dtype=torch.int32, device=dev)
        run("kron_mul", label, (lambda: cuda_ops.kron_mul(a, b, out=packed[1])) if into_out
            else (lambda: cuda_ops.kron_mul(a, b)), lambda: cuda_ops.kron_mul_plain(a, b),
            n_bytes=16 * (m * n + m + n), n_ops=OPS["mul"] * m * n, shapes=[list(a.shape), [n, 4]], timed=timed)
    a = limbs.pack_ints(EDGES, device=dev)
    run("kron_mul", "edge pairs", lambda: cuda_ops.kron_mul(a, a), lambda: cuda_ops.kron_mul_plain(a, a),
        shapes=[[16, 4]] * 2)
    del a, b, packed

    # zm_butterfly: both directions at every size up to one past the tiles
    # (2^1..2^13 and 2^14; each also with the tile its size does not take),
    # batches that share a tile and that do not, the Moebius transform of
    # 2^22 and 2^24 evaluations (2 passes) and of the batched encode's
    # (10, 2^22); then the same sizes through the mode the encode uses, whose last pass stores bit-reversed into a zero-padded
    # tensor twice as long (the main path's shape: timed as the kernel's row)
    zm_shapes = [((1 << b,), False) for b in range(1, 15)]
    zm_shapes += [((3, 1 << 2), False), ((5, 1 << 12), False), ((1 << 22,), False),
                  ((1 << 24,), True), ((10, 1 << 22), True)]
    for shape, timed in zm_shapes:
        x = random_field(rng, shape, dev)
        n = x.numel() // 4
        bits = shape[-1].bit_length() - 1
        label = " x ".join(f"2^{v.bit_length() - 1}" if v & (v - 1) == 0 else str(v) for v in shape)
        for add in (False, True):
            row = check_kernel(
                "zm_butterfly", f"{label}, {'zeta (add)' if add else 'Moebius (sub)'}",
                lambda: cuda_ops.zm_butterfly(x, add), lambda: cuda_ops.zm_butterfly_plain(x, add),
                32 * n, OPS["add" if add else "sub"] * bits * n // 2, [list(x.shape)], timed and not add)
            rows.append(row)
            if timed and not add:
                main.setdefault(f"zm_butterfly/natural/{label}", row)
        if not timed:  # the tile this size does not take by itself
            other = 25 - cuda_ops.zm_tile_bits(bits)
            for reverse in (False, True):
                def other_tile():
                    out = torch.zeros(x.shape[:-2] + ((2 if reverse else 1) * shape[-1], 4),
                                      dtype=torch.int32, device=dev)
                    cuda_ops._zm_launches(x, False, out, reverse, other)
                    return out
                run("zm_butterfly", f"{label}, Moebius, 2^{other} tile" + (", bit-reversed" if reverse else ""),
                    other_tile, (lambda: cuda_ops.zm_bitrev_pad_plain(x, False, 1)) if reverse
                    else (lambda: cuda_ops.zm_butterfly_plain(x, False)), shapes=[list(x.shape)])
        got = cuda_ops.zm_bitrev_pad(x, False, 1)
        upper_nonzero = int((got[..., shape[-1]:, :] != 0).sum())
        del got
        if upper_nonzero:
            raise RuntimeError(f"zm_bitrev_pad left {upper_nonzero} non-zero limbs above n at {label}")
        row = check_kernel(
            "zm_butterfly", f"{label}, Moebius, bit-reversed into a zero-padded 2n",
            lambda: cuda_ops.zm_bitrev_pad(x, False, 1), lambda: cuda_ops.zm_bitrev_pad_plain(x, False, 1),
            16 * n + 32 * n, OPS["sub"] * bits * n // 2, [list(x.shape)], timed)
        rows.append(row)
        if timed:
            main.setdefault("zm_butterfly", row)
            main.setdefault(f"zm_butterfly/bitrev_pad/{label}", row)
    x = limbs.pack_ints(EDGES, device=dev)
    for add in (False, True):
        run("zm_butterfly", f"edge values, add={add}", lambda: cuda_ops.zm_butterfly(x, add),
            lambda: cuda_ops.zm_butterfly_plain(x, add), shapes=[[16, 4]])
    del x

    # sha256_words: contiguous big-endian messages.  No prover path hashes
    # messages any more (the trees go through the two kernels below); the
    # entry is driven on its own, at the first shape here (`messages_phase`).
    # 16 words ends in the table block, 8 words is the half-constant block,
    # any other width takes the run-time loop.
    sha_cases = (("2^20 x 16 words", *MESSAGES_SHAPE, True),
                 ("2^20 x 8 words", 1 << 20, 8, True),
                 ("ragged 1001 x 13", 1001, 13, False), ("ragged 33 x 30", 33, 30, False),
                 ("ragged 77 x 32", 77, 32, False))
    for label, n, nw, timed in sha_cases:
        msg = torch.from_numpy(
            rng.integers(0, 2**32, size=(n, nw), dtype=np.uint32).view(np.int32)).to(dev)
        row = check_kernel("sha256_words", label, lambda: sha256_cuda.sha256_words(msg),
                           lambda: sha256_cuda.sha256_words_plain(msg),
                           (4 * nw + 32) * n, sha_message_ops(nw) * n, [[n, nw]], timed)
        rows.append(row)
        if timed:
            main.setdefault("sha256_words", row)
            main.setdefault(f"sha256_words/{nw}", row)
    del msg

    # sha256_leaves: the pair leaves of the 2^24 prove's 2^25 codeword
    # (B = 2, 2^24 leaves), the batch tree of the 10 x 2^22 prove (B = 20,
    # 2^22 leaves), run-time widths, ragged counts, and columns that are not
    # contiguous (every other column of a wider payload; every other element)
    leaf_cases = (("main B=2, 2^24 pair leaves", 2, 1 << 24, True),
                  ("batched B=20, 2^22 leaves", 20, 1 << 22, True),
                  ("B=1, 2^20", 1, 1 << 20, False), ("B=3, 2^20", 3, 1 << 20, False),
                  ("B=4, 2^16 (table tail)", 4, 1 << 16, False),
                  ("ragged B=1 x 1001", 1, 1001, False), ("ragged B=2 x 1001", 2, 1001, False),
                  ("ragged B=3 x 77", 3, 77, False), ("ragged B=20 x 333", 20, 333, False))
    for label, B, n, timed in leaf_cases:
        cols = random_field(rng, (B, n), dev)
        ops_leaf = sha_message_ops(4 * B) + alu_ops(4 * B)  # one byte permute per word
        row = check_kernel("sha256_leaves", label, lambda: merkle.leaf_hashes(cols),
                           lambda: merkle.leaf_hashes_plain(cols),
                           (16 * B + 32) * n, ops_leaf * n, [[B, n, 4]], timed)
        rows.append(row)
        if timed:
            main.setdefault("sha256_leaves", row)
            main.setdefault(f"sha256_leaves/{B}", row)
    wide = random_field(rng, (4, 1 << 12), dev)
    for label, view in (("pair view of a codeword", fri._pair_view(wide[1])),
                        ("every other column", wide[::2]), ("every other element", wide[:2, ::2]),
                        ("a pair view inside a batch", wide.view(8, 1 << 11, 4)[2:4])):
        run("sha256_leaves", f"strided: {label}", lambda: merkle.leaf_hashes(view),
            lambda: merkle.leaf_hashes_plain(view), shapes=[list(view.shape), list(view.stride())])
    del cols, wide, view

    # merkle_levels: trees of 1 to 24 levels - one block, exactly one
    # launch's worth (9 narrow, 11 wide), one more - through the default plan
    # and through plans that force either block width; the tree above the
    # 2^24 leaf digests of the 2^24 prove is the timed main shape (3 launches)
    for n_levels in (1, 2, 8, 9, 10, 11, 12, 13, 20, 24):
        leaf = torch.from_numpy(
            rng.integers(0, 2**32, size=(1 << n_levels, 8), dtype=np.uint32).view(np.int32)).to(dev)
        n_nodes = (1 << n_levels) - 1
        timed = n_levels == 24
        row = check_kernel("merkle_levels", f"{n_levels} levels, plan {sha256_cuda.levels_plan(1 << n_levels)}",
                           lambda: tuple(merkle.tree_levels(leaf)), lambda: tuple(merkle.tree_levels_plain(leaf)),
                           32 * (n_nodes + 1) + 32 * n_nodes, node_ops() * n_nodes, [[1 << n_levels, 8]], timed)
        rows.append(row)
        if timed:
            main.setdefault("merkle_levels", row)
        for per_thread, span_bits in ((1, 9), (4, 11)):
            plan = [(1 << b, min(b, span_bits), per_thread) for b in range(n_levels, 0, -span_bits)]
            run("merkle_levels", f"{n_levels} levels, {per_thread} per thread: {plan}",
                lambda: tuple(sha256_cuda._tree_levels_launch(leaf, plan)),
                lambda: tuple(merkle.tree_levels_plain(leaf)), shapes=[[1 << n_levels, 8]])
    # one level alone, 2^24 digests -> 2^23 parents: the shape the message
    # kernel it replaced was timed at
    for per_thread in (1, 4):
        row = check_kernel("merkle_levels", f"one level of 2^23 parents, {per_thread} per thread",
                           lambda: tuple(sha256_cuda._tree_levels_launch(leaf, [(1 << 24, 1, per_thread)])[:1]),
                           lambda: (sha256_cuda.sha256_words_plain(leaf.view(1 << 23, 16)),),
                           96 << 23, node_ops() * (1 << 23), [[1 << 24, 8]], True)
        rows.append(row)
        main[f"merkle_levels/one level/{per_thread}"] = row
    del leaf

    # fold_codeword: round 0 of the 10 x 2^22 batched prove, on the
    # fingerprinted 2^23 codeword; the fold that ends every chain (m = 4).
    # rh lies on the card, where the round's Fiat-Shamir kernel writes it.
    rh = limbs.pack_int(int.from_bytes(rng.bytes(16), "little") % P, device=dev)
    for label, m, log_dom, stride, timed in (("main m=2^23", 1 << 23, 23, 1, True),
                                             ("ragged m=10006", 10006, 16, 4, False),
                                             ("m=4, the end of a chain", 4, 25, 1 << 23, False),
                                             ("m=2", 2, 3, 1, False)):
        code = random_field(rng, (m,), dev)
        tw = inv_gen_pows(log_dom, dev)
        run("fold_codeword", label, lambda: cuda_ops.fold_codeword(code, tw, stride, rh),
            lambda: cuda_ops.fold_codeword_plain(code, tw, stride, rh),
            n_bytes=64 * (m // 2), n_ops=fold_ops() * (m // 2),
            shapes=[[m, 4], list(tw.shape)], timed=timed)
    code, tw = limbs.pack_ints(EDGES, device=dev), limbs.pack_ints(EDGES[:8], device=dev)
    for rh_edge in (0, 1, P - 1, (P + 1) // 2):
        rhe = limbs.pack_int(rh_edge, device=dev)
        run("fold_codeword", f"edge values, rh={rh_edge}", lambda: cuda_ops.fold_codeword(code, tw, 1, rhe),
            lambda: cuda_ops.fold_codeword_plain(code, tw, 1, rhe), shapes=[[16, 4], [8, 4]])

    # fold_commit_leaves: round 0 of the 2^24 prove, on the 2^25 codeword
    for label, m, log_dom, stride, timed in (("main m=2^25", 1 << 25, 25, 1, True),
                                             ("ragged m=10004", 10004, 16, 4, False),
                                             ("m=4", 4, 3, 2, False)):
        code = random_field(rng, (m,), dev)
        tw = inv_gen_pows(log_dom, dev)
        q = m // 4
        run("fold_commit_leaves", label,
            lambda: cuda_ops.fold_commit_leaves(code, tw, stride, rh),
            lambda: cuda_ops.fold_commit_leaves_plain(code, tw, stride, rh),
            n_bytes=q * (4 * 16 + 2 * 16 + 2 * 16 + 32),
            n_ops=q * (2 * fold_ops() + OPS["sha_half_block"] + alu_ops(8)),
            shapes=[[m, 4], list(tw.shape)], timed=timed)
    del code, tw

    # open_gather: the 128 query openings of the 2^24 prove's 24 pair trees
    # (2^24 down to 2 leaves) and of the 4 x 2^22 SNARK's batch tree (B = 8,
    # 2^22 leaves) and its 21 pair trees, against the plain version's
    # per-tree gathers.  Timed alone, its table already on the card, as a
    # replayed CUDA graph (`kernel_ms`); `wrapper_ms` adds the host's table
    # and its copy, as a prove calls it.  Bound: the openings written and
    # the units they are read from (16-byte payloads, 32-byte siblings) at
    # the card's memory rate - a launch's latency is far above it.
    for label, batch, log_pair, n_pair in (("main 2^24 PCS: 24 pair trees", [], 24, 24),
                                           ("4 x 2^22 batched: a batch tree of B=8, 21 pair trees", [(8, 22)], 21, 21)):
        trees = []
        for b, log_leaves in batch + [(2, log_pair - k) for k in range(n_pair)]:
            cols = random_field(rng, (b, 1 << log_leaves), dev)
            leaf = merkle.leaf_hashes(cols)
            trees.append((cols, [leaf] + merkle.tree_levels(leaf)[:-1]))
        idx = rng.integers(0, trees[0][0].shape[1], NUM_QUERIES)
        row = check_kernel("open_gather", label, lambda: sha256_cuda.open_gather(trees, idx),
                           lambda: sha256_cuda.open_gather_plain(trees, idx), 0, 0,
                           [[len(trees), "trees"], [sum(len(lv) for _, lv in trees), "levels"], [NUM_QUERIES, "queries"]],
                           False)
        table, n_segments, n_words = sha256_cuda.open_gather_table(trees, idx)
        on_card, out = torch.from_numpy(table).to(dev), torch.empty(n_words, dtype=torch.int32, device=dev)
        b_ms, b_by = bound(2 * 4 * n_words + table.nbytes, alu_ops(0))
        row.update(kernel_ms=graph_ms(lambda: sha256_cuda._launch("open_gather", "mlt_open_gather", dev,
                                                                  on_card.data_ptr(), len(idx), n_segments,
                                                                  out.data_ptr())),
                   wrapper_ms=time_ms(lambda: sha256_cuda.open_gather(trees, idx), 5),
                   plain_ms=time_ms(lambda: sha256_cuda.open_gather_plain(trees, idx), 1),
                   bound_ms=b_ms, bound_by=b_by, output_bytes=4 * n_words, segments=n_segments)
        row["bound_share"] = b_ms / row["kernel_ms"]
        print(json.dumps(row), file=sys.stderr, flush=True)
        rows.append(row)
        main.setdefault("open_gather", row)
        main[f"open_gather/{label}"] = row
        del trees, cols, leaf, on_card, out
    torch.cuda.empty_cache()

    # round_scalars: seeded transcript states at every fill of a block
    # (0-63 bytes, so the root and the round polynomial land at every
    # offset and the digest takes one or two blocks), lane sums up to 2^55
    # and at 0 and 2^63 - 1, prev at 0 and p - 1, a pending root or none,
    # and the last element's absorb; each launch against its plain version
    rows.extend(round_scalars_cases(dev, rng, main))
    rows.extend(sumcheck_round_scalars_cases(dev, rng, main))
    clear_caches()
    torch.cuda.empty_cache()
    emit("kernels", tolerance="0 mismatches (integers)", cases=rows)
    over = [r for r in rows if r.get("bound_share", 0) > MAX_BOUND_SHARE]
    if over:
        raise RuntimeError(f"kernels read more than {MAX_BOUND_SHARE} of their bound - the bound is at "
                           f"fault: {[(r['kernel'], r['case'], r['bound_share']) for r in over]}")
    return main


# ---------------------------------------------------------------------------
# each new kernel beside the route that stood in for it
# ---------------------------------------------------------------------------


# the standalone rounds the routes phase times: P4's, 17, the degree path's
# (x^17 - x: total degree 18, read by the degree phase) and one well past the
# one-thread kernel's cap of earlier PRs
ROUTE_DEGREES = (3, 17, 18, 64)


def round_kernel_routes(dev) -> list:
    """The round kernels beside the one-thread kernels they replaced
    (``previous_routes``), at the main round of ``round_scalars`` (a root, a
    fill of 1 + 64 bytes) and standalone rounds of ``ROUTE_DEGREES``: the
    outputs held equal, then each timed three times as a replayed CUDA graph
    of 100 launches, the routes in turns (old, new, new, old, old, new)."""
    rng = np.random.default_rng(11)
    rows = []

    def timed(routes: dict, label: str, extra: dict) -> None:
        ms = {name: [] for name in routes}
        for rep in range(3):
            for name in (list(routes) if rep % 2 == 0 else list(routes)[::-1]):
                ms[name].append(graph_ms(routes[name], copies=100))
        old, new = ms["old"], ms["new"]
        row = {"kernel": label, **extra, "old_route": "one thread (prev_round_scalars.cu)", "old_ms": old,
               "new_route": "round_scalars.cu", "new_ms": new,
               "new_over_old": float(np.median(new) / np.median(old)),
               "spread_ms": max(max(old) - min(old), max(new) - min(new))}
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)

    state, scal, sums, root, elem = round_scalars_inputs(dev, rng, 1)
    for mode in ("round", "last element"):
        res = compare(launch_round_scalars(previous_routes.round_scalars_one_thread, dev, state, scal, sums, root,
                                           elem, mode),
                      launch_round_scalars(dtr.round_scalars, dev, state, scal, sums, root, elem, mode))
        if res["mismatches"]:
            raise RuntimeError(f"round_scalars disagrees with the kernel it replaced ({mode}): {res}")
    digest = torch.empty(8, dtype=torch.int32, device=dev)
    coeffs = torch.empty((2, 4), dtype=torch.int32, device=dev)
    timed({"old": lambda: previous_routes.round_scalars_one_thread(state, scal, digest, sums=sums, root=root,
                                                                    coeffs=coeffs),
           "new": lambda: dtr.round_scalars(state, scal, digest, sums=sums, root=root, coeffs=coeffs)},
          "round_scalars", {"case": "main: a round with a root"})
    kernels = {"old": previous_routes.sumcheck_round_scalars_one_thread, "new": dtr.sumcheck_round_scalars}
    for degree in ROUTE_DEGREES:
        state, prev, sums, vinv = sumcheck_inputs(dev, rng, 1, degree)
        res = compare(*(launch_sumcheck_round(fn, dev, state, prev, sums, vinv) for fn in kernels.values()))
        if res["mismatches"]:
            raise RuntimeError(f"sumcheck_round_scalars at degree {degree} disagrees with the kernel it replaced: {res}")
        digest = torch.empty(8, dtype=torch.int32, device=dev)
        coeffs = torch.empty((degree, 4), dtype=torch.int32, device=dev)
        r = torch.empty(4, dtype=torch.int32, device=dev)
        timed({name: (lambda fn=fn: fn(state, prev, digest, sums, vinv, coeffs, r)) for name, fn in kernels.items()},
              "sumcheck_round_scalars", {"case": f"a degree-{degree} round", "degree": degree})
    return rows


def routes_phase(dev, log_n: int = 24, log_b: int = BATCHED_LOG_SIZES[-1]) -> list:
    """Time, at the shapes of the 2^log_n prove, the route through each
    later kernel beside the route that stood in for it before: six composed
    here from the first four kernels (``mul``, ``sub``, ``butterfly``,
    ``fold_commit_leaves``), and the redesigned Merkle hashing and Moebius
    transform beside the kernels they replaced (``previous_routes``); then
    the batched encode as one batch beside a loop over its polynomials, and
    the round kernels beside their one-thread forms (``round_kernel_routes``,
    whose rows it returns).
    ``bound_ms`` is the bytes the new route has to move over the card's
    memory rate."""
    rng = np.random.default_rng(7)
    log_m = log_n + 1
    n, m = 1 << log_n, 1 << log_m
    elem = 16
    rows = []

    def row(kernel, old_route, old_fn, new_route, new_fn, fused_bytes, same=False):
        if same:  # the two routes compute the same function: hold them to it
            res = compare(old_fn(), new_fn())
            if res["mismatches"]:
                raise RuntimeError(f"routes of {kernel} disagree: {old_route} / {new_route}: {res}")
        old_ms, new_ms = time_ms(old_fn, 2), time_ms(new_fn, 2)
        rows.append({"kernel": kernel, "old_route": old_route, "old_ms": old_ms,
                     "new_route": new_route, "new_ms": new_ms,
                     "bound_ms": fused_bytes / PEAK_BYTES_PER_S * 1e3, "gained_ms": old_ms - new_ms})
        torch.cuda.empty_cache()

    x = random_field(rng, (n,), dev)

    def per_bit_sub():
        y = x.clone()
        for i in range(log_n):
            w = y.view(n >> (i + 1), 2, 1 << i, 4)
            cuda_ops.sub(w[:, 1], w[:, 0], out=w[:, 1])
        return y

    passes = len(cuda_ops.zm_passes(log_n))
    row("zm_butterfly", "one sub launch per index bit", per_bit_sub,
        f"mle.to_coeffs: {passes} zm_butterfly passes", lambda: mle.to_coeffs(x), 2 * n * elem)
    subs = mle.delta_subtables([Fp(int.from_bytes(rng.bytes(16), "little")) for _ in range(log_n)], dev)

    def broadcast_mul():
        d = subs[0]
        for t in subs[1:]:
            d = ops.mul(d.reshape(-1, 1, 4), t.reshape(1, -1, 4)).reshape(-1, 4)
        return d

    row("kron_mul", "broadcast operands through mul", broadcast_mul,
        "mle.combine_subtables: kron_mul", lambda: mle.combine_subtables(subs), n * elem)
    # the redesigned tensor product beside the kernel it replaced, at the
    # last products of the 2^log_n and the batched delta tables, written into
    # the packed table's delta row as the prove does
    for label, n_b in ((f"2^{log_n - 8} x 2^8", 1 << 8), (f"2^16 x 2^{log_b - 16}", 1 << (log_b - 16))):
        a_k = random_field(rng, ((n if n_b == 256 else 1 << log_b) // n_b,), dev)
        b_k = random_field(rng, (n_b,), dev)
        packed = torch.empty((2, a_k.shape[0] * n_b, 4), dtype=torch.int32, device=dev)
        res = compare(previous_routes.kron_mul(a_k, b_k, torch.empty_like(packed[1])),
                      cuda_ops.kron_mul(a_k, b_k, out=packed[1]))
        if res["mismatches"]:
            raise RuntimeError(f"kron_mul disagrees with the kernel it replaced at {label}: {res}")
        row("kron_mul", f"{label} into out: one thread per element (prev_kron.cu)",
            lambda: previous_routes.kron_mul(a_k, b_k, packed[1]),
            "persistent row tiles, b in registers (kron.cu)", lambda: cuda_ops.kron_mul(a_k, b_k, out=packed[1]),
            16 * (packed[1].numel() // 4 + a_k.shape[0] + n_b))
        del a_k, b_k, packed
    # what binds the tensor product: the same kernel with its multiplies taken
    # out (the stores alone) and with its stores taken out (the multiplies
    # alone), beside a plain fill of the same output
    a_k, b_k = random_field(rng, (n >> 8,), dev), random_field(rng, (1 << 8,), dev)
    out_k = torch.empty((n, 4), dtype=torch.int32, device=dev)
    previous_routes.kron_parts("stores", a_k, b_k, out_k)
    if not torch.equal(out_k.view(-1, 1 << 8, 4)[-1], b_k):
        raise RuntimeError("kron_parts: the stores-alone kernel did not store b")
    kron_parts = {"shape": [n >> 8, 1 << 8], "bound_ms": 16 * n / PEAK_BYTES_PER_S * 1e3,
                  "fill_ms": time_ms(lambda: out_k.zero_(), 20),
                  "stores_alone_ms": time_ms(lambda: previous_routes.kron_parts("stores", a_k, b_k, out_k), 20),
                  "multiplies_alone_ms": time_ms(
                      lambda: previous_routes.kron_parts("multiplies", a_k, b_k, out_k), 20),
                  "whole_ms": time_ms(lambda: cuda_ops.kron_mul(a_k, b_k, out=out_k), 20)}
    del a_k, b_k, out_k, x, subs

    a = (log_m + 1) // 2
    A, B = 1 << a, 1 << (log_m - a)
    gen_v = pow2_generator(log_m).v
    pows = ntt._pow_table(gen_v, log_m - 1, dev)
    powsA, powsB = pows[::B][: A // 2], pows[::A][: B // 2]
    code = random_field(rng, (m,), dev)

    def single_stages(x, pw, log_rows):
        half = x.shape[0] // 2
        iota = torch.arange(half, dtype=torch.int64, device=dev)
        for t in range(log_rows):
            tw = pw[cuda_ops.stage_exp(t, iota, half)]
            x = cuda_ops.butterfly(x[:half], x[half:], tw).reshape(x.shape)
        return x

    row("butterfly2 + butterfly_notw", "one butterfly launch and one twiddle gather per stage",
        lambda: (single_stages(code.view(A, B, 4), powsA, a),
                 single_stages(code.view(B, A, 4), powsB, log_m - a)),
        "ntt._pease_rows: two stages per launch, twiddles indexed in the kernel",
        lambda: (ntt._pease_rows(code.view(A, B, 4), powsA, a),
                 ntt._pease_rows(code.view(B, A, 4), powsB, log_m - a)),
        ((log_m + 1) // 2) * 2 * m * elem)
    Tc, Tf = ntt._twiddle_factors(gen_v, log_m, dev)
    S = Tf.shape[0]
    Fr = code.view(A // S, S, B, 4)
    row("twiddle_mul3", "two mul passes over Tc and Tf",
        lambda: ops.mul(ops.mul(Fr, Tc.reshape(A // S, 1, B, 4)), Tf.reshape(1, S, B, 4)),
        "one twiddle_mul3 pass", lambda: cuda_ops.twiddle_mul3(code.view(A, B, 4), Tc, Tf),
        2 * m * elem + (Tc.numel() + Tf.numel()) * 4)
    del Fr, Tc, Tf, pows, powsA, powsB

    # the first fold of the batched prove: fold alone, then an ordinary commit
    # of the pair leaves, beside the fused fold + leaf hash and the same
    # upper levels
    half_code = code[: m // 4]
    inv = inv_gen_pows(log_m - 2, dev)
    rh = limbs.pack_int(int.from_bytes(rng.bytes(16), "little") % P, device=dev)

    def fused():
        nxt, leaf = cuda_ops.fold_commit_leaves(half_code, inv, 1, rh)
        return nxt, merkle.tree_levels(leaf)

    def fold_then_commit():
        nxt = cuda_ops.fold_codeword(half_code, inv, 1, rh)
        return nxt, merkle.MerkleTree.commit(fri._pair_view(nxt))

    row("fold_codeword", "fold_commit_leaves + upper tree levels (m = 2^%d)" % (log_m - 2), fused,
        "fold_codeword + MerkleTree.commit of the pair leaves", fold_then_commit,
        (m // 16) * (4 * 16 + 2 * 16 + 2 * 16 + 32))
    del code, half_code, inv
    clear_caches()
    torch.cuda.empty_cache()

    # Merkle hashing: the replaced route (byte-swapped copies, a concatenation,
    # the message kernel; one launch per level) beside the leaves read in
    # place and several levels a launch
    for label, n_cols, log_leaves in ((f"2 x 2^{log_n}", 2, log_n), (f"20 x 2^{log_b}", 20, log_b)):
        cols = random_field(rng, (n_cols, 1 << log_leaves), dev)
        row("sha256_leaves", f"{label}: limbs_to_words + torch.cat + message kernel",
            lambda: previous_routes.leaf_hashes(cols), "leaf_hashes: columns hashed in place",
            lambda: merkle.leaf_hashes(cols), (16 * n_cols + 32) << log_leaves, same=True)
        del cols
    leaf = torch.from_numpy(
        rng.integers(0, 2**32, size=(1 << log_n, 8), dtype=np.uint32).view(np.int32)).to(dev)
    tree_bytes = 64 * ((1 << log_n) - 1) + 32
    row("merkle_levels", f"2^{log_n} leaf digests: one message-kernel launch per level ({log_n})",
        lambda: tuple(previous_routes.tree_levels(leaf)),
        f"tree_levels: {len(sha256_cuda.levels_plan(1 << log_n))} launches", lambda: tuple(merkle.tree_levels(leaf)),
        tree_bytes, same=True)
    narrow = [(1 << b, min(b, 9), 1) for b in range(log_n, 0, -9)]
    wide = [(1 << b, min(b, 11), 4) for b in range(log_n, 0, -11)]
    row("merkle_levels block width", f"512 digests a block, 9 levels a launch ({len(narrow)} launches)",
        lambda: tuple(sha256_cuda._tree_levels_launch(leaf, narrow)),
        f"2048 digests a block, 11 levels a launch ({len(wide)} launches)",
        lambda: tuple(sha256_cuda._tree_levels_launch(leaf, wide)), tree_bytes, same=True)
    # the block widths on the smaller trees of a prove: device time alone
    # (replayed graphs) and as the host launches them
    widths = []
    for bits in range(10, min(23, log_n + 1)):  # no wider than the leaves made above
        sub = leaf[: 1 << bits].contiguous()
        narrow = [(1 << b, min(b, 9), 1) for b in range(bits, 0, -9)]
        wide = [(1 << b, min(b, 11), 4) for b in range(bits, 0, -11)]
        res = compare(tuple(sha256_cuda._tree_levels_launch(sub, narrow)),
                      tuple(sha256_cuda._tree_levels_launch(sub, wide)))
        if res["mismatches"]:
            raise RuntimeError(f"merkle_levels block widths disagree at 2^{bits}: {res}")
        entry = {"log2_leaf_digests": bits, "default_plan": sha256_cuda.levels_plan(1 << bits)}
        for name, plan in (("narrow", narrow), ("wide", wide), ("default", entry["default_plan"])):
            entry[f"{name}_device_ms"] = graph_ms(lambda: sha256_cuda._tree_levels_launch(sub, plan))
            entry[f"{name}_launched_ms"] = time_ms(lambda: sha256_cuda._tree_levels_launch(sub, plan), 50)
        widths.append(entry)
        del sub
    small = leaf[: 1 << 12].contiguous()
    row("merkle_levels, a small tree", "2^12 leaf digests: one message-kernel launch per level (12)",
        lambda: tuple(previous_routes.tree_levels(small)), "tree_levels: 2 launches",
        lambda: tuple(merkle.tree_levels(small)), 64 * ((1 << 12) - 1) + 32, same=True)
    del leaf, small

    # the encode's Moebius step: clone + three passes of the replaced kernel,
    # a bit-reversal gather and a copy into a zeroed tensor, beside the two
    # passes whose last store does the reversal and the padding; and the
    # kernel's two tile sizes
    zm_alone = []

    def previous_encode_input(x):
        y = mle.bit_reverse(previous_routes.zm_butterfly(x, False))
        padded = torch.zeros(x.shape[:-2] + (2 * x.shape[-2], 4), dtype=torch.int32, device=dev)
        padded[..., : x.shape[-2], :] = y
        return padded

    def with_tile(x, tile_bits, reverse):
        out = torch.empty(x.shape[:-2] + ((2 if reverse else 1) * x.shape[-2], 4), dtype=torch.int32, device=dev)
        if reverse:
            out[..., x.shape[-2]:, :].zero_()
        cuda_ops._zm_launches(x, False, out, reverse, tile_bits)
        return out

    for label, shape in ((f"2^{log_n}", (1 << log_n,)), (f"{BATCH_POLYS} x 2^{log_b}", (BATCH_POLYS, 1 << log_b))):
        x = random_field(rng, shape, dev)
        n_el = x.numel() // 4
        bits = shape[-1].bit_length() - 1
        row("zm_butterfly", f"{label}: clone + {len(previous_routes.zm_passes(bits))} passes (2^11 tile)",
            lambda: previous_routes.zm_butterfly(x, False),
            f"zm_butterfly: {len(cuda_ops.zm_passes(bits))} passes, no clone", lambda: cuda_ops.zm_butterfly(x, False),
            32 * n_el, same=True)
        row("zm_butterfly + bit_reverse + pad", f"{label}: previous passes + index_select + padded copy",
            lambda: previous_encode_input(x), "to_coeffs_bitrev_padded: the last pass stores it",
            lambda: mle.to_coeffs_bitrev_padded(x, 1), 48 * n_el, same=True)
        # each pass alone, beside a device copy of the same table: no pass
        # can be faster than that
        out = torch.empty_like(x)
        padded = torch.empty(shape[:-1] + (2 * shape[-1], 4), dtype=torch.int32, device=dev)
        alone = {"shape": list(shape), "device_copy_ms": time_ms(lambda: out.copy_(x), 5), "passes": []}
        for tile_bits in (12, 13):
            for d, c, log_w in cuda_ops.zm_passes(bits, tile_bits):
                for reverse in ((False, True) if d + c == bits else (False,)):
                    ms = time_ms(lambda: cuda_ops._launch(
                        "zm_butterfly", "mlt_zm_tiles", dev, x.data_ptr(), (padded if reverse else out).data_ptr(),
                        n_el, d, c, log_w, 0, bits if reverse else 0, 2 * shape[-1] if reverse else 0, tile_bits), 5)
                    alone["passes"].append({"tile_bits": tile_bits, "first_bit": d, "bits": c, "log2_run": log_w,
                                            "bit_reversed_store": reverse, "ms": ms})
        # the whole transform on tensors at four different places in device
        # memory (each allocation kept while the next is made), with the
        # clock the card holds meanwhile
        held = []
        for _ in range(4):
            xi, oi = x.clone(), torch.empty_like(x)
            held.append((xi, oi))
            ms = time_ms(lambda: cuda_ops._zm_launches(xi, False, oi, False), 10)
            alone.setdefault("whole_at_four_places_ms", []).append(ms)
        for _ in range(300):
            cuda_ops._zm_launches(xi, False, oi, False)
        alone["clocks_meanwhile"] = run_text(["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,clocks.mem,power.draw",
                                              "--format=csv,noheader"])
        torch.cuda.synchronize()
        del held, xi, oi
        zm_alone.append(alone)
        del out, padded
        for reverse in (False, True):
            row("zm_butterfly tile" + (" (bit-reversed store)" if reverse else ""),
                f"{label}: 2^12 tile, {len(cuda_ops.zm_passes(bits, 12))} passes", lambda: with_tile(x, 12, reverse),
                f"2^13 tile, {len(cuda_ops.zm_passes(bits, 13))} passes", lambda: with_tile(x, 13, reverse),
                (48 if reverse else 32) * n_el, same=True)
        del x
    clear_caches()
    torch.cuda.empty_cache()

    # the batched encode: one batch through kernels that carry a batch
    # extent, or one polynomial at a time through the same kernels
    polys = random_field(rng, (BATCH_POLYS, 1 << log_b), dev)
    encode = {}
    for name, fn in (("one_batch", lambda: fri.encode_mle_for_fri(polys)),
                     ("loop_over_polys", lambda: torch.stack([fri.encode_mle_for_fri(q) for q in polys]))):
        fn()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        encode[name] = {"ms": time_ms(fn, 2), "peak_extra_bytes": torch.cuda.max_memory_allocated() - before}
    del polys
    clear_caches()
    torch.cuda.empty_cache()
    round_rows = round_kernel_routes(dev)
    emit("routes", log_n=log_n, routes=rows, kron_parts=kron_parts, merkle_block_widths=widths,
         zm_passes_alone=zm_alone,
         batched_encode={"shape": [BATCH_POLYS, 1 << log_b], **encode}, round_kernels=round_rows)
    return round_rows


# ---------------------------------------------------------------------------
# the main paths
# ---------------------------------------------------------------------------

# launch counts of each driven path: set to 0 just before it, read just after
PATH_LAUNCHES: dict = {}


def seeded_claim(log_n: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    evals = random_field(rng, (1 << log_n,), dev)
    point = [Fp(int.from_bytes(rng.bytes(16), "little")) for _ in range(log_n)]
    return evals, point, evaluate_evals_host(evals, point)


def seeded_batched_claim(n_polys: int, log_n: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    polys = random_field(rng, (n_polys, 1 << log_n), dev)
    point = [Fp(int.from_bytes(rng.bytes(16), "little")) for _ in range(log_n)]
    outputs = [evaluate_evals_host(polys[j], point) for j in range(n_polys)]
    return polys, BatchedPCSClaim(point, outputs)


def timed_prove(prove, to_bytes, from_bytes) -> dict:
    """Drive one path: prove (timed to the end of the device's work),
    serialize, deserialize + verify on the host.  The launch counts are set
    to 0 just before and read just after; ``merkle_paths_built`` is read
    after the serialization, before anything parses the proof."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with collect_phases() as phases:
        t0 = time.perf_counter()
        proof = prove()
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
    d2h = stats.counts().get("d2h_copies", 0)
    proof_bytes = to_bytes(proof)
    paths_built = stats.counts().get("merkle_paths_built", 0)
    digest = hashlib.sha256(proof_bytes).hexdigest()
    gc.collect()  # keep a collection of the prover's garbage out of the verifier's time
    t0 = time.perf_counter()
    from_bytes(proof_bytes).verify(Transcript())
    verify_s = time.perf_counter() - t0
    counts = launch_counts()
    return {
        "proof": proof, "prove_s": prove_s, "verify_s": verify_s, "proof_bytes": len(proof_bytes),
        "proof_sha256": digest,
        "phases_s": dict(phases), "d2h_copies": d2h, "merkle_paths_built": paths_built, "launches": counts,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
    }


# d2h copies a prove may make: the end of the rounds and the query openings,
# and for the batched prove also the batch root that fingerprint_r needs; a
# SNARK prove may make those of its PCS and 2 more (the end of the sumcheck
# rounds, which also brings the outputs)
MAX_D2H = {"pcs": 2, "batched_pcs": 3, "snark": 1}


def rounds_without_sync(session, to_bytes, want_sha256: str) -> dict:
    """Drive a session whose rounds run under
    ``torch.cuda.set_sync_debug_mode("error")``: any call that makes the host
    wait for the card inside ``launch_rounds`` raises.  The copy that ends the
    rounds and the queries run after the mode is reset; the proof must be
    the timed prove's, byte for byte."""
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        launched = session.launch_rounds()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    copies_in_rounds = stats.counts().get("d2h_copies", 0)
    session.run_rounds()
    digest = hashlib.sha256(to_bytes(session.finish())).hexdigest()
    if copies_in_rounds or digest != want_sha256:
        raise RuntimeError(f"rounds under the sync check: {copies_in_rounds} copies, proof {digest} "
                           f"against {want_sha256}")
    return {"sync_debug_mode": "error", "rounds_launched": launched, "d2h_copies_in_rounds": copies_in_rounds,
            "round_scalars_launches": launch_counts()["round_scalars"], "proof_equals_timed_prove": True}


def pcs_phase(dev, log_sizes):
    """PCS prove and verify at each size; the largest is a main path, and
    its rounds are also run once under the sync check.  Returns the
    largest proof's SHA-256 and its peak device bytes."""
    config = ProverConfig(device=str(dev))
    results = []
    for log_n in log_sizes:
        evals, point, output = seeded_claim(log_n, 1000 + log_n, dev)
        res = timed_prove(lambda: PCSProof.prove(point, output, evals, Transcript(), config),
                          pcs_proof_to_bytes, pcs_proof_from_bytes)
        proof = res.pop("proof")
        if len(proof.fri_proof.commitments) != log_n or proof.output != output:
            raise RuntimeError("proof has the wrong shape")
        if res["d2h_copies"] > MAX_D2H["pcs"]:
            raise RuntimeError(f"a 2^{log_n} PCS prove made {res['d2h_copies']} device->host copies")
        if res["merkle_paths_built"]:
            raise RuntimeError(f"a 2^{log_n} PCS prove and its bytes built {res['merkle_paths_built']} paths")
        results.append({"log_n": log_n, **res})
        PATH_LAUNCHES[f"pcs 2^{log_n}"] = res["launches"]
        del proof
        if log_n == log_sizes[-1]:
            results[-1]["rounds_without_sync"] = rounds_without_sync(
                PCSProverSession(point, output, evals, Transcript(), config), pcs_proof_to_bytes,
                res["proof_sha256"])
        del evals
        clear_caches()
        torch.cuda.empty_cache()
    emit("pcs", sizes=results)
    return results[-1]["proof_sha256"], results[-1]["peak_device_bytes"]


def batched_pcs_phase(dev, log_sizes) -> str:
    """Batched PCS prove and verify of BATCH_POLYS polynomials at each size;
    the largest is a main path, and its rounds 1.. are also run once under
    the sync check.  Returns the largest proof's SHA-256."""
    config = ProverConfig(device=str(dev))
    results = []
    for log_n in log_sizes:
        polys, claim = seeded_batched_claim(BATCH_POLYS, log_n, 2000 + log_n, dev)
        res = timed_prove(lambda: BatchedPCSProof.prove(claim, polys, Transcript(), config),
                          batched_pcs_proof_to_bytes, batched_pcs_proof_from_bytes)
        proof = res.pop("proof")
        if (len(proof.fri_proof.commitments) != log_n - 1 or proof.claim.outputs != claim.outputs
                or len(proof.fri_proof.queries[0].batch_path.values) != 2 * BATCH_POLYS):
            raise RuntimeError("batched proof has the wrong shape")
        if res["d2h_copies"] > MAX_D2H["batched_pcs"]:
            raise RuntimeError(f"a {BATCH_POLYS} x 2^{log_n} batched prove made {res['d2h_copies']} "
                               "device->host copies")
        if res["merkle_paths_built"]:
            raise RuntimeError(f"a {BATCH_POLYS} x 2^{log_n} batched prove and its bytes built "
                               f"{res['merkle_paths_built']} paths")
        results.append({"n_polys": BATCH_POLYS, "log_n": log_n, **res})
        PATH_LAUNCHES[f"batched pcs {BATCH_POLYS} x 2^{log_n}"] = res["launches"]
        del proof
        if log_n == log_sizes[-1]:
            results[-1]["rounds_without_sync"] = rounds_without_sync(
                BatchedPCSProverSession(claim, polys, Transcript(), config), batched_pcs_proof_to_bytes,
                res["proof_sha256"])
        del polys
        clear_caches()
        torch.cuda.empty_cache()
    emit("batched_pcs", sizes=results)
    return results[-1]["proof_sha256"]


def full_random_field(rng: np.random.Generator, shape, device) -> torch.Tensor:
    """Field tensor shape+(4,) of uniform 128-bit values (a top limb of all
    ones, the only one that could reach p, is lowered by one)."""
    raw = rng.integers(0, 2**32, size=(int(np.prod(shape)), 4), dtype=np.uint32)
    raw[raw[:, 3] == 0xFFFFFFFF, 3] = 0xFFFFFFFE
    return torch.from_numpy(raw.view(np.int32)).to(device).reshape(tuple(shape) + (4,))


def snark_trace(kind: str, log_n: int, dev) -> Trace:
    """W1 ("width1"): one column of uniform 128-bit residues, numpy seed
    3000 + log_n.  P4 ("pythagorean"): rows a = m^2 - n^2, b = 2mn,
    c = m^2 + n^2, d = a + b from uniform m, n (seed 3100 + log_n), made on the
    card: every row satisfies both constraints, over the whole field."""
    h = 1 << log_n
    if kind == "width1":
        return Trace.from_columns(full_random_field(np.random.default_rng(3000 + log_n), (1, h), dev))
    rng = np.random.default_rng(3100 + log_n)
    m, n = full_random_field(rng, (h,), dev), full_random_field(rng, (h,), dev)
    m2, n2 = ops.mul(m, m), ops.mul(n, n)
    a, b = ops.sub(m2, n2), ops.mul(ops.add(m, m), n)
    return Trace.from_columns(torch.stack([a, b, ops.add(m2, n2), ops.add(a, b)]))


def snark_constraints(kind: str, width: int):
    constraints, degree = SNARK_CONSTRAINTS[kind]
    return ConstraintSet(constraints, degree), WitnessLayout(columns=width)


def snark_prove(kind: str, trace: Trace, config: ProverConfig):
    transcript = Transcript()
    return System.prover(transcript, *snark_constraints(kind, trace.width), trace, config).prove_snark(transcript)


def snark_verify(kind: str, width: int, log_n: int, proof_bytes: bytes) -> None:
    transcript = Transcript()
    verifier = System.verifier(transcript, *snark_constraints(kind, width), Commitment(), log_n)
    verifier.verify_snark(transcript, snark_proof_from_bytes(proof_bytes))


def snark_rounds_without_sync(kind: str, trace: Trace, config: ProverConfig, want_sha256: str) -> dict:
    """Drive a SNARK session whose sumcheck rounds run under
    ``torch.cuda.set_sync_debug_mode("error")``; the copy that ends them
    (with the outputs) and the PCS run after the mode is reset, and the
    proof must be the timed prove's, byte for byte.  The host clock around the rounds is
    the host's issue time: nothing in them waits for the card."""
    session = SnarkProverSession(Transcript(), *snark_constraints(kind, trace.width), trace, config=config)
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        launched = session.launch_sumcheck_rounds()
        issue_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    copies_in_rounds = stats.counts().get("d2h_copies", 0)
    counted = {k: v for k, v in launch_counts().items() if v}
    digest = hashlib.sha256(snark_proof_to_bytes(session.finish())).hexdigest()
    if copies_in_rounds or digest != want_sha256:
        raise RuntimeError(f"SNARK sumcheck under the sync check: {copies_in_rounds} copies, proof {digest} "
                           f"against {want_sha256}")
    return {"sync_debug_mode": "error", "rounds_launched": launched, "d2h_copies_in_rounds": copies_in_rounds,
            "counted_launches_in_rounds": counted,
            "counted_launches_per_round": sum(counted.values()) / launched,
            "host_issue_s_per_round": issue_s / launched, "proof_equals_timed_prove": True}


def snark_phase(dev):
    """Each SNARK path once through ``System.prove_snark`` (timed to the end
    of the card's work) and ``System.verify_snark`` on the host, then its
    sumcheck rounds once more under the sync check.  Returns {path: proof
    SHA-256} and {path: peak device bytes}."""
    config = ProverConfig(device=str(dev))
    results = []
    for label, kind, log_n in SNARK_PATHS:
        trace = snark_trace(kind, log_n, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with collect_phases() as phases:
            t0 = time.perf_counter()
            proof = snark_prove(kind, trace, config)
            torch.cuda.synchronize()
            prove_s = time.perf_counter() - t0
        d2h = stats.counts().get("d2h_copies", 0)
        PATH_LAUNCHES[label] = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        blob = snark_proof_to_bytes(proof)
        paths_built = stats.counts().get("merkle_paths_built", 0)
        if paths_built:
            raise RuntimeError(f"{label}: the prove and its bytes built {paths_built} paths")
        digest = hashlib.sha256(blob).hexdigest()
        gc.collect()  # keep a collection of the prover's garbage out of the verifier's time
        t0 = time.perf_counter()
        snark_verify(kind, trace.width, log_n, blob)
        verify_s = time.perf_counter() - t0
        pcs_kind = "pcs" if trace.width == 1 else "batched_pcs"
        if (len(proof.sumcheck_polynomials) != log_n or len(proof.outputs) != trace.width
                or any(len(p.nonzero_coeffs) != SNARK_CONSTRAINTS[kind][1] + 1 for p in proof.sumcheck_polynomials)
                or (pcs_kind == "pcs") != isinstance(proof.pcs, PCSProof)):
            raise RuntimeError(f"{label}: the proof has the wrong shape")
        limit = MAX_D2H[pcs_kind] + MAX_D2H["snark"]
        if d2h > limit:
            raise RuntimeError(f"{label}: the prove made {d2h} device->host copies, at most {limit} allowed")
        snark_keys = ("snark_tables", "sumcheck_rounds")
        del proof
        results.append({
            "path": label, "width": trace.width, "log_n": log_n, "prove_s": prove_s, "verify_s": verify_s,
            "phases_s": {"tables": phases.get("snark_tables"), "sumcheck_rounds": phases.get("sumcheck_rounds"),
                         "pcs": sum(v for k, v in phases.items() if k not in snark_keys),
                         "pcs_parts": {k: v for k, v in phases.items() if k not in snark_keys}},
            "proof_bytes": len(blob), "proof_sha256": digest, "peak_device_bytes": peak, "d2h_copies": d2h,
            "max_d2h": limit, "merkle_paths_built": paths_built, "launches": PATH_LAUNCHES[label],
            "rounds_without_sync": snark_rounds_without_sync(kind, trace, config, digest),
        })
        del trace
        clear_caches()
        torch.cuda.empty_cache()
    emit("snark", paths=results)
    return {r["path"]: r["proof_sha256"] for r in results}, {r["path"]: r["peak_device_bytes"] for r in results}


def traced_sumcheck_rounds(session):
    """A session's sumcheck rounds alone under the profiler: (rounds, wall
    s, the device's kernels as ``key_averages`` entries)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rounds = session.launch_sumcheck_rounds()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return rounds, wall, [e for e in prof.key_averages() if e.device_time_total > 0 and
                          e.device_type == torch.autograd.DeviceType.CUDA]


# ---------------------------------------------------------------------------
# checkpoint / resume of the three sessions
# ---------------------------------------------------------------------------


def differing_arrays(path: str, want_path: str) -> list:
    """The keys whose arrays (or sidecar files) differ between two saved
    sessions, a key missing from either included.  ``np.savez`` itself is
    not byte-stable, so arrays are compared, not files."""
    differ = []
    with np.load(path, allow_pickle=False) as z, np.load(want_path, allow_pickle=False) as w:
        for k in sorted(set(z.files) | set(w.files)):
            if k not in z.files or k not in w.files:
                differ.append(k)
                continue
            a, b = z[k], w[k]
            if a.dtype != b.dtype or not np.array_equal(a, b):
                differ.append(k)
    for ext in (".claim", ".snark"):
        sides = [p + ext for p in (path, want_path) if os.path.exists(p + ext)]
        if len(sides) == 1 or (len(sides) == 2 and open(sides[0]).read() != open(sides[1]).read()):
            differ.append(ext)
    return differ


def checkpoint_case(label: str, build, advance, launch_rest, resume, to_bytes, verify, want_sha256: str,
                    fresh_process: bool = False, keep: str = None) -> dict:
    """One session saved half way and resumed: ``build`` it, ``advance`` it
    about half way, save it into a temporary directory, drop it and the
    card's cached blocks, ``resume`` it (load, trees rebuilt, transcript
    hopped to the card), launch its remaining rounds under
    ``torch.cuda.set_sync_debug_mode("error")``, finish and verify.  The
    proof must be the uninterrupted one of the same seed, byte for byte (by
    SHA-256).  The launch counts from the resume to the finished proof are
    the path ``label``.  With ``fresh_process``, the file is also resumed
    and finished by this script in a new process (``--resume-pcs``).  With
    ``keep``, the session is saved at that path (``.npz``), which outlives
    the case."""
    with tempfile.TemporaryDirectory() as tmp:
        path = keep or os.path.join(tmp, "session.npz")
        session = build()
        advance(session)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.save(path)
        save_s = time.perf_counter() - t0
        on_disk = sum(os.path.getsize(f) for f in glob.glob(path + "*"))
        del session
        gc.collect()
        clear_caches()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        session = resume(path)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        copies = stats.counts().get("d2h_copies", 0)
        torch.cuda.set_sync_debug_mode("error")
        try:
            launched = launch_rest(session)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        copies_in_rounds = stats.counts().get("d2h_copies", 0) - copies
        t0 = time.perf_counter()
        blob = to_bytes(session.finish())
        torch.cuda.synchronize()
        finish_s = time.perf_counter() - t0
        PATH_LAUNCHES[label] = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        del session
        clear_caches()
        torch.cuda.empty_cache()
        digest = hashlib.sha256(blob).hexdigest()
        verify(blob)
        row = {"path": label, "save_s": save_s, "bytes_on_disk": on_disk, "resume_s": resume_s,
               "rounds_launched_after_resume": launched, "d2h_copies_in_rounds": copies_in_rounds,
               "finish_s": finish_s, "peak_device_bytes_after_resume": peak, "proof_sha256": digest,
               "uninterrupted_sha256": want_sha256, "proof_bytes": len(blob)}
        if fresh_process:
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--resume-pcs", path],
                                 capture_output=True, text=True, timeout=600, cwd=HERE)
            lines = res.stdout.strip().splitlines()
            if res.returncode != 0 or not lines:
                raise RuntimeError(f"{label}: the resume in a fresh process failed (rc {res.returncode}): "
                                   f"{res.stderr[-2000:]}")
            row["fresh_process"] = json.loads(lines[-1])
    if copies_in_rounds or digest != want_sha256 or (
            fresh_process and row["fresh_process"]["proof_sha256"] != want_sha256):
        raise RuntimeError(f"{label}: the resumed proof is not the uninterrupted one: {row}")
    emit("checkpoint_case", **row)
    return row


def resume_pcs_only(path: str) -> int:
    """``--resume-pcs PATH``: resume a saved PCS session in this (new)
    process, finish and verify it, and print the proof's SHA-256 with the
    times of the kernels' load and of the resume."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    start = time.perf_counter()
    _build.lib()
    load_s = time.perf_counter() - start
    t0 = time.perf_counter()
    session = PCSProverSession.resume(path, ProverConfig(device="cuda:0"))
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    session.run_rounds()
    blob = pcs_proof_to_bytes(session.finish())
    pcs_proof_from_bytes(blob).verify(Transcript())
    print(json.dumps({"phase": "resumed_in_a_fresh_process", "proof_sha256": hashlib.sha256(blob).hexdigest(),
                      "kernels_load_s": load_s, "kernels_built_in_this_process": bool(_build.build_log),
                      "resume_s": resume_s, "wall_s": time.perf_counter() - start}), flush=True)
    return 0


FIRST_SNARK = ("pythagorean", 16)  # P4's constraints at 2^16 rows


def first_snark_only() -> int:
    """``--first-snark``: in this (new) process, the first SNARK prove
    (``FIRST_SNARK``) with no PCS prove and no kernel launch before it (the
    trace is made on the host; the kernels load at the prove's first
    launch), then a second prove of the same trace.  Times the card's
    context, each prove's phases and the first launch of
    ``sumcheck_round_scalars`` apart (the card synchronised before and after
    it); prints one JSON line."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    context_s = time.perf_counter() - start
    kind, log_n = FIRST_SNARK
    trace = snark_trace(kind, log_n, "cpu").to(dev)
    first = {}
    kernel = dtr.sumcheck_round_scalars

    def first_timed(*args):
        if first:
            return kernel(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kernel(*args)
        torch.cuda.synchronize()
        first["s"] = time.perf_counter() - t0

    dtr.sumcheck_round_scalars = first_timed
    config = ProverConfig(device=str(dev))
    proves = []
    for _ in range(2):
        torch.cuda.synchronize()
        with collect_phases() as phases:
            t0 = time.perf_counter()
            proof = snark_prove(kind, trace, config)
            torch.cuda.synchronize()
            prove_s = time.perf_counter() - t0
        proves.append({"prove_s": prove_s, "phases_s": dict(phases),
                       "proof_sha256": hashlib.sha256(snark_proof_to_bytes(proof)).hexdigest()})
    print(json.dumps({"phase": "first_snark_in_a_fresh_process", "kind": kind, "log_n": log_n,
                      "context_s": context_s, "kernels_built_in_this_process": bool(_build.build_log),
                      "first_sumcheck_round_scalars_launch_s": first["s"], "proves": proves,
                      "wall_s": time.perf_counter() - start}), flush=True)
    return 0


def first_snark_phase() -> None:
    """ROADMAP C-u1: ``--first-snark`` in a new process; its two proofs must
    agree."""
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--first-snark"],
                         capture_output=True, text=True, timeout=600)
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    if res.returncode != 0 or not lines:
        raise RuntimeError(f"--first-snark failed ({res.returncode}): {res.stderr[-2000:]}")
    run = json.loads(lines[-1])
    shas = {p["proof_sha256"] for p in run["proves"]}
    if len(shas) != 1:
        raise RuntimeError(f"the two SNARK proves of a fresh process differ: {shas}")
    emit("first_snark", **{k: v for k, v in run.items() if k != "phase"})


def checkpoint_phase(dev, pcs_log_n: int, batched_log_n: int, pcs_sha: str, batched_sha: str,
                     snark_shas: dict, keep_dir: str):
    """Each of the three sessions saved about half way and resumed: the PCS
    at 2^pcs_log_n (also resumed once in a fresh process), the batched PCS of
    BATCH_POLYS x 2^batched_log_n, and the SNARK paths in both phases - saved
    in the sumcheck and resumed, saved in the PCS and resumed.  Returns the
    labels of the driven paths and {"ckpt_pcs": ..., "ckpt_snark_pythagorean":
    ...}: the files of the PCS and of P4 in the sumcheck, kept in
    ``keep_dir``, whose arrays the sharded saves of the same rounds must
    reproduce."""
    kept = {kind: os.path.join(keep_dir, f"{kind}.npz") for kind in ("ckpt_pcs", "ckpt_snark_pythagorean")}
    config = ProverConfig(device=str(dev))
    rows = []

    def pcs_session():
        evals, point, output = seeded_claim(pcs_log_n, 1000 + pcs_log_n, dev)
        return PCSProverSession(point, output, evals, Transcript(), config)

    rows.append(checkpoint_case(
        f"checkpoint pcs 2^{pcs_log_n}", pcs_session, lambda s: s.run_rounds(pcs_log_n // 2),
        lambda s: s.launch_rounds(), lambda path: PCSProverSession.resume(path, config), pcs_proof_to_bytes,
        lambda b: pcs_proof_from_bytes(b).verify(Transcript()), pcs_sha, fresh_process=True,
        keep=kept["ckpt_pcs"]))

    def batched_session():
        polys, claim = seeded_batched_claim(BATCH_POLYS, batched_log_n, 2000 + batched_log_n, dev)
        return BatchedPCSProverSession(claim, polys, Transcript(), config)

    rows.append(checkpoint_case(
        f"checkpoint batched pcs {BATCH_POLYS} x 2^{batched_log_n}", batched_session,
        lambda s: s.run_rounds(batched_log_n // 2 - 1), lambda s: s.launch_rounds(),
        lambda path: BatchedPCSProverSession.resume(path, config), batched_pcs_proof_to_bytes,
        lambda b: batched_pcs_proof_from_bytes(b).verify(Transcript()), batched_sha))

    for label, kind, log_n in SNARK_PATHS:
        constraints, layout = snark_constraints(kind, 1 if kind == "width1" else 4)

        def snark_session(kind=kind, log_n=log_n):
            trace = snark_trace(kind, log_n, dev)
            return SnarkProverSession(Transcript(), *snark_constraints(kind, trace.width), trace, config=config)

        def in_pcs(s, log_n=log_n):
            s.run_sumcheck_rounds()
            s.start_pcs()
            s.run_pcs_rounds(log_n // 2)

        resume = (lambda path, c=constraints, l=layout: SnarkProverSession.resume(path, c, l, config))
        verify = (lambda b, kind=kind, width=layout.columns, log_n=log_n: snark_verify(kind, width, log_n, b))
        rows.append(checkpoint_case(
            f"checkpoint {label} in the sumcheck", snark_session, lambda s, log_n=log_n: s.run_sumcheck_rounds(
                log_n // 2), lambda s: s.launch_sumcheck_rounds(), resume, snark_proof_to_bytes, verify,
            snark_shas[label], keep=kept.get("ckpt_snark_" + kind)))
        rows.append(checkpoint_case(
            f"checkpoint {label} in the pcs", snark_session, in_pcs, lambda s: s.pcs_session.launch_rounds(),
            resume, snark_proof_to_bytes, verify, snark_shas[label]))
    emit("checkpoint", cases=[{k: r[k] for k in ("path", "save_s", "resume_s", "bytes_on_disk",
                                                  "peak_device_bytes_after_resume")} for r in rows], ok=True)
    return [r["path"] for r in rows], kept


# ---------------------------------------------------------------------------
# a SNARK above the standalone round's old degree cap
# ---------------------------------------------------------------------------

DEGREE_LOG_N = 16
DEGREE = 17  # the constraint's; its rounds have total degree 18
DEGREE_PATH = f"snark of a degree-{DEGREE} constraint, 2^{DEGREE_LOG_N} rows"


def power_constraint(e: int):
    """x^e - x: zero on a column of bits, non-zero at the extension points."""
    def constraint(v, r):
        acc = v[0]
        for _ in range(e - 1):
            acc = acc * v[0]
        return acc - v[0]

    return constraint


def degree_phase(dev, round_routes: list) -> None:
    """A SNARK whose constraint has degree DEGREE, over one column of
    2^DEGREE_LOG_N bits (numpy seed 5000): proved on the card and on the
    CPU's plain path, the bytes equal, and verified; then its sumcheck
    rounds once more on the card under the profiler (device time, the
    round kernel's part, and the same with the one-thread kernel's time a
    round from ``round_routes``, the routes phase's rows, in its place)."""
    bits = np.random.default_rng(5000).integers(0, 2, size=1 << DEGREE_LOG_N).astype(np.uint64)
    cs, layout = ConstraintSet([power_constraint(DEGREE)], DEGREE), WitnessLayout(columns=1)
    out, secs = {}, {}
    for where in (str(dev), "cpu"):
        trace = Trace.from_columns([bits], where)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        transcript = Transcript()
        proof = System.prover(transcript, cs, layout, trace, ProverConfig(device=where)).prove_snark(transcript)
        torch.cuda.synchronize()
        secs[where] = time.perf_counter() - t0
        if where != "cpu":
            PATH_LAUNCHES[DEGREE_PATH] = launch_counts()
        out[where] = snark_proof_to_bytes(proof)
    transcript = Transcript()
    System.verifier(transcript, cs, layout, Commitment(), DEGREE_LOG_N).verify_snark(
        transcript, snark_proof_from_bytes(out[str(dev)]))
    ok = out[str(dev)] == out["cpu"]
    session = SnarkProverSession(Transcript(), cs, layout, Trace.from_columns([bits], str(dev)),
                                 config=ProverConfig(device=str(dev)))
    rounds, wall, ev = traced_sumcheck_rounds(session)
    del session
    busy = sum(e.device_time_total for e in ev) / 1e6
    kernel = [e for e in ev if "sumcheck_round_scalars" in e.key]
    kernel_s = sum(e.device_time_total for e in kernel) / 1e6
    one_thread_ms = [float(np.median(r["old_ms"])) for r in round_routes if r.get("degree") == DEGREE + 1]
    rounds_device = {"rounds": rounds, "traced_rounds_s": wall, "device_busy_s": busy,
                     "round_kernel_device_s": kernel_s, "round_kernel_launches": sum(e.count for e in kernel),
                     "with_the_one_thread_kernel_s": (busy - kernel_s + rounds * one_thread_ms[0] / 1e3
                                                      if one_thread_ms else None)}
    emit("degree", path=DEGREE_PATH, round_total_degree=DEGREE + 1, card_prove_s=secs[str(dev)],
         cpu_prove_s=secs["cpu"], proof_bytes=len(out["cpu"]), card_equals_cpu=ok,
         sha256=hashlib.sha256(out[str(dev)]).hexdigest(), verified=True, sumcheck_rounds_device=rounds_device)
    if not ok:
        raise RuntimeError("the degree-17 SNARK's bytes differ between the card and the CPU")


# ---------------------------------------------------------------------------
# the smaller entry points: intt, evaluate_coeffs, mul_small, dot_mod, pow_const
# ---------------------------------------------------------------------------

API_LOG_N = 24
API_PATH = f"intt(ntt(x)) at 2^{API_LOG_N}, and intt, evaluate_coeffs, mul_small, dot_mod, pow_const at 2^16"


def api_phase(dev) -> None:
    """``intt(ntt(x)) == x`` at 2^API_LOG_N on the card; ``intt``,
    ``mle.evaluate_coeffs``, ``ops.mul_small``, ``ops.dot_mod`` and
    ``ops.pow_const`` on the card equal to the same calls on the CPU's plain
    path (numpy seed 6000).  Then ``intt``'s time at 2^API_LOG_N."""
    rng = np.random.default_rng(6000)
    x = random_field(rng, (1 << API_LOG_N,), dev)
    small = random_field(rng, (1 << 16,), "cpu")
    point = [Fp(int.from_bytes(rng.bytes(16), "little")) for _ in range(16)]
    torch.cuda.synchronize()
    reset_counts()
    roundtrip = torch.equal(ntt.intt(ntt.ntt(x)), x)
    card = {
        "intt": lambda d: ntt.intt(small.to(d)),
        "evaluate_coeffs": lambda d: mle.evaluate_coeffs(small.to(d), point),
        "mul_small": lambda d: torch.stack([ops.mul_small(small.to(d), k) for k in (0, 1, 45, (1 << 16) - 1)]),
        "dot_mod": lambda d: ops.dot_mod(small.to(d).view(4, -1, 4), small.flip(0).to(d).view(4, -1, 4), dim=1),
        "pow_const": lambda d: torch.stack([ops.pow_const(small[:1024].to(d), e) for e in (0, 1, 2**64 + 3)]),
    }
    got = {name: fn(dev) for name, fn in card.items()}
    torch.cuda.synchronize()
    PATH_LAUNCHES[API_PATH] = launch_counts()
    equal = {name: torch.equal(got[name].cpu(), fn("cpu")) for name, fn in card.items()}
    intt_ms = time_ms(lambda: ntt.intt(x), 3)
    del x
    clear_caches()
    torch.cuda.empty_cache()
    emit("api", path=API_PATH, intt_ntt_roundtrip=roundtrip, card_equals_cpu=equal, intt_ms=intt_ms)
    if not roundtrip or not all(equal.values()):
        raise RuntimeError("an entry point disagrees on the card")


# ---------------------------------------------------------------------------
# sharded proves: W ranks over torch.distributed
# ---------------------------------------------------------------------------

# Each group of rank processes: (world size, its cases' kinds; `sharded_phase`
# gives each its log2 size).  Every rank of a group is a process of this
# script (`--sharded-rank`); the ranks share card 0 over gloo unless the host
# has a card for each rank (NCCL then, `parallel.multihost.choose`).  The
# SNARK kinds are "snark_" + a constraint set of SNARK_PATHS; "ckpt_" kinds
# save a sharded session half way and resume it over the ranks.
SHARDED_GROUPS = ((4, ("pcs", "fri", "snark_width1", "ckpt_pcs")),
                  (2, ("pcs", "batched_pcs", "snark_pythagorean", "ckpt_snark_pythagorean")))
SHARDED_FRI_LOG_M = 20
SHARDED_TIMEOUT_S = 300


def snark_path(kind: str):
    """(label, constraint set, log2 rows) of the SNARK path of a sharded kind
    "snark_<set>" or "ckpt_snark_<set>"."""
    return next(p for p in SNARK_PATHS if kind.endswith("snark_" + p[1]))


def sharded_label(kind: str, log_n: int, world: int) -> str:
    if kind == "ckpt_pcs":
        return f"sharded checkpoint pcs 2^{log_n}, {world} ranks: saved at round {log_n // 2}, resumed over the ranks"
    if kind.startswith("ckpt_snark"):
        return (f"sharded checkpoint {snark_path(kind)[0]}, {world} ranks: saved in the sumcheck at round "
                f"{log_n // 2}, resumed over the ranks")
    what = {"pcs": f"pcs 2^{log_n}", "batched_pcs": f"batched pcs {BATCH_POLYS} x 2^{log_n}",
            "fri": f"fri 2^{log_n}"}.get(kind) or snark_path(kind)[0]
    return f"sharded {what}, {world} ranks"


def fri_codeword(log_m: int, dev) -> torch.Tensor:
    """The seeded codeword of the FRI case: the Reed-Solomon code of 2^(log_m
    - 1) random coefficients (seed 4000 + log_m)."""
    return ntt.reed_solomon(random_field(np.random.default_rng(4000 + log_m), (1 << (log_m - 1),), dev))


def snark_block(kind: str, dev, layout):
    """(constraints, witness layout, this rank's block of the seeded trace)
    of a sharded SNARK kind; the whole trace is made and dropped."""
    _, constraint_set, log_n = snark_path(kind)
    trace = snark_trace(constraint_set, log_n, dev)
    block = Trace.from_columns(layout.shard_rows(trace.columns_device()))
    return (*snark_constraints(constraint_set, block.width), block)


def sharded_inputs(kind: str, log_n: int, dev, layout):
    """(prove, to_bytes) of one case on this rank's block of the seeded input
    (the pcs / batched / snark phases' seeds); the whole input is made and
    dropped before the prove."""
    config = ProverConfig(device=str(dev))
    if kind == "pcs":
        evals, point, output = seeded_claim(log_n, 1000 + log_n, dev)
        block = layout.shard_rows(evals)
        return (lambda: PCSProof.prove(point, output, block, Transcript(), config, layout)), pcs_proof_to_bytes
    if kind == "batched_pcs":
        polys, claim = seeded_batched_claim(BATCH_POLYS, log_n, 2000 + log_n, dev)
        block = layout.shard_batch(polys)
        return (lambda: BatchedPCSProof.prove(claim, block, Transcript(), config, layout)), batched_pcs_proof_to_bytes
    if kind.startswith("snark_"):
        constraints, witness, block = snark_block(kind, dev, layout)

        def prove():
            transcript = Transcript()
            return System.prover(transcript, constraints, witness, block, config, shard=layout).prove_snark(transcript)

        return prove, snark_proof_to_bytes
    block = layout.shard_rows(fri_codeword(log_n, dev))
    return (lambda: fri.FriProof.prove(block, Transcript(), layout)), fri_proof_to_bytes


def resume_and_finish(kind: str, path: str, dev, layout=None):
    """Resume the file of checkpoint case ``kind`` (over ``layout``'s ranks,
    or on this card), run its remaining rounds and finish it: (the proof's
    SHA-256, the resume's seconds)."""
    config = ProverConfig(device=str(dev))
    t0 = time.perf_counter()
    if kind == "ckpt_pcs":
        session = PCSProverSession.resume(path, config, layout)
    else:
        _, constraint_set, _ = snark_path(kind)
        width = 1 if constraint_set == "width1" else 4
        session = SnarkProverSession.resume(path, *snark_constraints(constraint_set, width), config, layout)
    torch.cuda.synchronize(dev)
    resume_s = time.perf_counter() - t0
    if kind == "ckpt_pcs":
        session.run_rounds()
        blob = pcs_proof_to_bytes(session.finish())
    else:
        session.run_sumcheck_rounds()
        blob = snark_proof_to_bytes(session.finish())
    return hashlib.sha256(blob).hexdigest(), resume_s


def sharded_checkpoint(kind: str, log_n: int, dev, layout, path: str) -> dict:
    """A sharded session saved half way at ``path`` by every rank and
    resumed over the same ranks: the 2^log_n PCS at round log_n / 2 (as the
    checkpoint phase saves the single rank's), or P4 in its sumcheck at round
    log_n / 2.  Returns the resumed proof's SHA-256, the save and resume
    times, and on rank 0 the bytes on disk."""
    config = ProverConfig(device=str(dev))
    if kind == "ckpt_pcs":
        evals, point, output = seeded_claim(log_n, 1000 + log_n, dev)
        session = PCSProverSession(point, output, layout.shard_rows(evals), Transcript(), config, layout)
        del evals
        session.run_rounds(log_n // 2)
    else:
        constraints, witness, block = snark_block(kind, dev, layout)
        session = SnarkProverSession(Transcript(), constraints, witness, block, config=config, shard=layout)
        del block
        session.run_sumcheck_rounds(log_n // 2)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    session.save(path)
    save_s = time.perf_counter() - t0
    del session
    gc.collect()
    torch.cuda.empty_cache()
    digest, resume_s = resume_and_finish(kind, path, dev, layout)
    row = {"proof_sha256": digest, "save_s": save_s, "resume_s": resume_s}
    if layout.rank == 0:
        row["bytes_on_disk"] = sum(os.path.getsize(f) for f in glob.glob(path + "*"))
    return row


def sharded_rank_main(rank: int, world: int, port: int, cases: str, out_dir: str) -> int:
    """``--sharded-rank``: one rank of a group; runs each case
    (``kind:log_n``, comma-separated) on its block and prints one JSON line
    per case: the proof's SHA-256, prove_s, this process's peak device bytes,
    the collectives and their bytes, each round's bytes, the host-staged
    copies and the kernels' launches (a checkpoint case: from its build to
    its resumed proof, its file in ``out_dir``)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    from multilinear_tpu_torch.parallel import multihost

    layout = multihost.init(rank, world, f"tcp://127.0.0.1:{port}", device="cuda")
    dev = layout.device
    _build.lib()
    try:
        for case in cases.split(","):
            kind, log_n = case.split(":")
            log_n = int(log_n)
            if kind.startswith("ckpt_"):
                prove, to_bytes = None, None
            else:
                prove, to_bytes = sharded_inputs(kind, log_n, dev, layout)
            gc.collect()
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            t0 = time.perf_counter()
            if prove is None:
                extra = sharded_checkpoint(kind, log_n, dev, layout, os.path.join(out_dir, f"{kind}.npz"))
                digest = extra.pop("proof_sha256")
            else:
                proof = prove()
                torch.cuda.synchronize(dev)
                extra, digest = {}, hashlib.sha256(to_bytes(proof)).hexdigest()
                del proof, prove
            prove_s = time.perf_counter() - t0
            counts, series = stats.counts(), stats.series()
            print(json.dumps({
                "sharded_case": case, "rank": rank, "world": world, "backend": layout.backend, "device": str(dev),
                "proof_sha256": digest, "prove_s": prove_s,
                "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
                "collectives": counts.get("collectives", 0), "collective_bytes": counts.get("collective_bytes", 0),
                "round_bytes": series.get("round_collective_bytes", []),
                "sc_sum_bytes": series.get("sc_rounds_sharded_sum_bytes", []),
                "staged_copies": counts.get("collective_staged_copies", 0),
                "rounds_sharded": counts.get("rounds_sharded", 0),
                "sc_rounds_sharded": counts.get("sc_rounds_sharded", 0),
                "fri_rounds_sharded": counts.get("fri_rounds_sharded", 0),
                "d2h_copies": counts.get("d2h_copies", 0), "launches": launch_counts(), **extra}), flush=True)
    finally:
        multihost.shutdown()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(world: int, cases, out_dir: str) -> list:
    """Start the `world` rank processes of one group and wait for all;
    returns every rank's case lines.  A rank that fails or outlives
    SHARDED_TIMEOUT_S fails the run, and no rank outlives this call."""
    arg = ",".join(f"{k}:{n}" for k, n in cases)
    port = free_port()
    outs = []
    with tempfile.TemporaryDirectory() as tmp:
        logs = [(open(os.path.join(tmp, f"{r}.out"), "w+"), open(os.path.join(tmp, f"{r}.err"), "w+"))
                for r in range(world)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sharded-rank", str(r),
                                   "--sharded-world", str(world), "--sharded-port", str(port),
                                   "--sharded-cases", arg, "--sharded-dir", out_dir],
                                  stdout=out, stderr=err, text=True, cwd=HERE)
                 for r, (out, err) in enumerate(logs)]
        try:
            deadline = time.monotonic() + SHARDED_TIMEOUT_S
            for r, p in enumerate(procs):
                p.wait(timeout=max(deadline - time.monotonic(), 1))
            for r, (p, (out, err)) in enumerate(zip(procs, logs)):
                out.seek(0)
                err.seek(0)
                print(err.read()[-3000:], file=sys.stderr, flush=True)
                if p.returncode != 0:
                    raise RuntimeError(f"rank {r} of {world} exited with {p.returncode}")
                outs.append([json.loads(line) for line in out if line.startswith('{"sharded_case"')])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for out, err in logs:
                out.close()
                err.close()
    return outs


def resume_on_one_rank(kind: str, path: str, dev) -> dict:
    """A file that ranks saved, resumed and finished in this process on one
    card: the proof's SHA-256, the resume's seconds and the launches."""
    torch.cuda.synchronize()
    reset_counts()
    digest, resume_s = resume_and_finish(kind, path, dev)
    torch.cuda.synchronize()
    launches = launch_counts()
    clear_caches()
    torch.cuda.empty_cache()
    return {"proof_sha256": digest, "resume_s": resume_s, "launches": launches}


def sharded_phase(dev, pcs_log_n: int, batched_log_n: int, pcs_sha: str, batched_sha: str, pcs_peak: int,
                  snark_shas: dict, snark_peaks: dict, single_files: dict) -> list:
    """The PCS at 2^pcs_log_n over 4 and 2 ranks, the batched PCS of
    BATCH_POLYS x 2^batched_log_n over 2 ranks (a rank's polynomials whole),
    a standalone FRI of 2^SHARDED_FRI_LOG_M values over 4 ranks, the SNARK
    paths W1 over 4 ranks and P4 over 2 (the trace's rows a rank): each
    rank's proof must be the single-rank proof of this run, its device->host
    copies within MAX_D2H, and at 4 ranks each rank's peak device bytes at
    most half the single-rank PCS prove's.  The checkpoint cases - the PCS
    saved at round pcs_log_n / 2 over 4 ranks, P4 saved in its sumcheck over
    2 - must write the arrays of the single-rank file of the checkpoint
    phase (``single_files``), and resume, over the ranks and here on one
    rank, to the uninterrupted proof.  One JSON line per case; returns the
    labels of the driven paths."""
    code = fri_codeword(SHARDED_FRI_LOG_M, dev)
    fri_sha = hashlib.sha256(fri_proof_to_bytes(fri.FriProof.prove(code, Transcript()))).hexdigest()
    del code
    clear_caches()
    torch.cuda.empty_cache()
    single = {"pcs": (pcs_log_n, pcs_sha), "batched_pcs": (batched_log_n, batched_sha),
              "fri": (SHARDED_FRI_LOG_M, fri_sha), "ckpt_pcs": (pcs_log_n, pcs_sha)}
    for label, constraint_set, log_n in SNARK_PATHS:
        single["snark_" + constraint_set] = single["ckpt_snark_" + constraint_set] = (log_n, snark_shas[label])
    labels = []
    with tempfile.TemporaryDirectory() as files:
        for world, kinds in SHARDED_GROUPS:
            cases = [(k, single[k][0]) for k in kinds]
            t0 = time.perf_counter()
            outs = run_group(world, cases, files)
            group_s = time.perf_counter() - t0
            for i, (kind, log_n) in enumerate(cases):
                rows = [o[i] for o in outs]
                label = sharded_label(kind, log_n, world)
                want = single[kind][1]
                shas = {row["proof_sha256"] for row in rows}
                if shas != {want}:
                    raise RuntimeError(f"{label}: proofs {sorted(shas)} against the single rank's {want}")
                peaks = [row["peak_device_bytes"] for row in rows]
                # the memory gate holds at the driven size, where the data and
                # not the fixed tables and buffers set the peak
                if kind == "pcs" and world == 4 and pcs_log_n == PCS_LOG_SIZES[-1] and max(peaks) > pcs_peak / 2:
                    raise RuntimeError(f"a rank of the 4-rank PCS peaked at {max(peaks)} device bytes, over half "
                                       f"of the single rank's {pcs_peak}")
                copies = max(row["d2h_copies"] for row in rows)
                if kind.startswith("snark_"):
                    limit = MAX_D2H["pcs" if kind == "snark_width1" else "batched_pcs"] + MAX_D2H["snark"]
                else:
                    limit = MAX_D2H.get(kind)
                if limit is not None and copies > limit:
                    raise RuntimeError(f"a rank of {label} made {copies} device->host copies, at most {limit}")
                if min(row["rounds_sharded"] + row["fri_rounds_sharded"] for row in rows) == 0 or (
                        "snark" in kind and min(row["sc_rounds_sharded"] for row in rows) == 0):
                    raise RuntimeError(f"{label} ran no sharded round of a kind it has")
                # the replicated trees of the FRI tail open in one launch on rank 0
                gathers = [row["launches"]["open_gather"] for row in rows]
                if gathers[0] > 1 or any(gathers[1:]):
                    raise RuntimeError(f"{label}: open_gather launches per rank {gathers}, at most one on rank 0")
                labels.append(label)
                PATH_LAUNCHES[label] = {k: sum(row["launches"][k] for row in rows) for k in rows[0]["launches"]}
                line = dict(case=label, world=world, backend=rows[0]["backend"], proof_sha256=want,
                            equals_single_rank=True, prove_s_per_rank=[row["prove_s"] for row in rows],
                            peak_device_bytes_per_rank=peaks,
                            collectives_per_prove=[row["collectives"] for row in rows],
                            collective_bytes_per_rank=[row["collective_bytes"] for row in rows],
                            bytes_per_round_rank0=rows[0]["round_bytes"],
                            staged_copies_per_rank=[row["staged_copies"] for row in rows],
                            rounds_sharded=rows[0]["rounds_sharded"], sc_rounds_sharded=rows[0]["sc_rounds_sharded"],
                            fri_rounds_sharded=rows[0]["fri_rounds_sharded"],
                            d2h_copies_per_rank=[row["d2h_copies"] for row in rows],
                            open_gather_launches_per_rank=gathers,
                            launches_per_rank=[sum(row["launches"].values()) for row in rows], group_wall_s=group_s)
                if kind == "pcs":
                    line["single_rank_peak_device_bytes"] = pcs_peak
                if kind.startswith("snark_"):
                    line["single_rank_peak_device_bytes"] = snark_peaks[snark_path(kind)[0]]
                    line["sum_bytes_per_sumcheck_round_rank0"] = sorted(set(rows[0]["sc_sum_bytes"]))
                    line["max_d2h"] = limit
                if not kind.startswith("ckpt_"):
                    emit("sharded", **line)
                    continue
                # a checkpoint case: the file against the single rank's, then
                # resumed here on one rank
                differ = differing_arrays(os.path.join(files, f"{kind}.npz"), single_files[kind])
                if differ:
                    raise RuntimeError(f"{label}: the saved file's {differ} differ from the single rank's")
                one = resume_on_one_rank(kind, os.path.join(files, f"{kind}.npz"), dev)
                if one["proof_sha256"] != want:
                    raise RuntimeError(f"{label}: resumed on one rank, proof {one['proof_sha256']} against {want}")
                one_label = label.replace("resumed over the ranks", "resumed on one rank")
                labels.append(one_label)
                PATH_LAUNCHES[one_label] = one["launches"]
                emit("sharded_checkpoint", **line, arrays_equal_single_rank_file=True,
                     bytes_on_disk=rows[0]["bytes_on_disk"],
                     save_s_per_rank=[row["save_s"] for row in rows],
                     resume_s_per_rank=[row["resume_s"] for row in rows],
                     resumed_on_one_rank={"proof_sha256": one["proof_sha256"], "resume_s": one["resume_s"]})
    return labels


def _golden(name: str) -> dict:
    with open(os.path.join(HERE, "multilinear_tpu_torch", "testdata", name)) as f:
        return json.load(f)


def parity_phase(dev):
    """Proof bytes on the card == on the CPU's plain path == the golden
    digest, for the PCS at log_n = 10 and the batched PCS at 10 x 2^8; and
    card == CPU for PCS proofs of 1, 2 and 3 variables, where the transforms
    have two rows (the single-stage kernel's only callers) and the whole
    fold chain is a few elements long.  Returns both golden proofs' bytes."""
    places = (str(dev), "cpu")
    golden = _golden("pcs_golden.json")
    vals, point_v = pcs_golden_inputs(golden["log_n"], golden["seed"])
    point = [Fp(v) for v in point_v]
    out = {}
    for where in places:
        evals = limbs.pack_ints(vals, device=where)
        output = evaluate_evals_host(evals, point)
        if str(output.v) != golden["output"]:
            raise RuntimeError(f"claimed output differs from the fixture on {where}")
        proof = PCSProof.prove(point, output, evals, Transcript(), ProverConfig(device=where))
        out[where] = pcs_proof_to_bytes(proof)
    pcs_card, pcs_cpu = out[places[0]], out["cpu"]
    pcs_digest = hashlib.sha256(pcs_card).hexdigest()

    bgolden = _golden("batched_pcs_golden.json")
    polys_v, point_v = batched_pcs_golden_inputs(bgolden["n_polys"], bgolden["log_n"], bgolden["seed"])
    point = [Fp(v) for v in point_v]
    for where in places:
        polys = limbs.pack_ints([v for row in polys_v for v in row],
                                shape=(bgolden["n_polys"], 1 << bgolden["log_n"]), device=where)
        outputs = [evaluate_evals_host(polys[j], point) for j in range(polys.shape[0])]
        if [str(o.v) for o in outputs] != bgolden["outputs"]:
            raise RuntimeError(f"claimed outputs differ from the batched fixture on {where}")
        proof = BatchedPCSProof.prove(BatchedPCSClaim(point, outputs), polys, Transcript(),
                                      ProverConfig(device=where))
        out[where] = batched_pcs_proof_to_bytes(proof)
    b_card, b_cpu = out[places[0]], out["cpu"]
    b_digest = hashlib.sha256(b_card).hexdigest()

    reset_counts()
    tiny = {}
    for n_vars in (1, 2, 3):
        rng = np.random.default_rng(3000 + n_vars)
        vals = [int.from_bytes(rng.bytes(16), "little") % P for _ in range(1 << n_vars)]
        point = [Fp(int.from_bytes(rng.bytes(16), "little")) for _ in range(n_vars)]
        for where in places:
            evals = limbs.pack_ints(vals, device=where)
            proof = PCSProof.prove(point, evaluate_evals_host(evals, point), evals, Transcript(),
                                   ProverConfig(device=where))
            out[where] = pcs_proof_to_bytes(proof)
        pcs_proof_from_bytes(out[places[0]]).verify(Transcript())
        tiny[n_vars] = out[places[0]] == out["cpu"]
    PATH_LAUNCHES["pcs 2^1, 2^2, 2^3"] = launch_counts()

    sgolden = _golden("snark_golden.json")
    snark = {}
    for kind in SNARK_CONSTRAINTS:
        g = sgolden[kind]
        cols = snark_golden_columns(kind, g["log_n"], g["seed"])
        for where in places:
            trace = Trace.from_columns(limbs.pack_ints([v for c in cols for v in c],
                                                       shape=(len(cols), 1 << g["log_n"]), device=where))
            out[where] = snark_proof_to_bytes(snark_prove(kind, trace, ProverConfig(device=where)))
        digest = hashlib.sha256(out[places[0]]).hexdigest()
        snark[kind] = {"width": len(cols), "log_n": g["log_n"], "card_equals_cpu": out[places[0]] == out["cpu"],
                       "sha256": digest, "golden": g["sha256"], "bytes": out[places[0]]}

    ok = (pcs_card == pcs_cpu and pcs_digest == golden["sha256"]
          and b_card == b_cpu and b_digest == bgolden["sha256"] and all(tiny.values())
          and all(v["card_equals_cpu"] and v["sha256"] == v["golden"] for v in snark.values()))
    emit("parity",
         pcs={"log_n": golden["log_n"], "card_equals_cpu": pcs_card == pcs_cpu, "sha256": pcs_digest,
              "golden": golden["sha256"]},
         batched_pcs={"n_polys": bgolden["n_polys"], "log_n": bgolden["log_n"],
                      "card_equals_cpu": b_card == b_cpu, "sha256": b_digest, "golden": bgolden["sha256"]},
         tiny_pcs_card_equals_cpu=tiny,
         snark={k: {f: v for f, v in r.items() if f != "bytes"} for k, r in snark.items()}, ok=ok)
    if not ok:
        raise RuntimeError("proof bytes differ between the card, the CPU path and the fixture")
    return pcs_card, b_card, {k: (r["width"], r["log_n"], r["bytes"]) for k, r in snark.items()}


def messages_phase(dev) -> None:
    """Drive ``sha256.sha256_words``, the package's entry for hashing whole
    messages (no prove calls it: the trees hash their payload in place), and
    hold a sample of its digests against hashlib."""
    rng = np.random.default_rng(4000)
    msg = rng.integers(0, 2**32, size=MESSAGES_SHAPE, dtype=np.uint32)
    reset_counts()
    digests = sha256.digests_to_bytes(sha256.sha256_words(torch.from_numpy(msg.view(np.int32)).to(dev)))
    PATH_LAUNCHES[MESSAGES_PATH] = launch_counts()
    be = msg.astype(">u4")
    sample = list(range(0, MESSAGES_SHAPE[0], 65521))
    ok = all(digests[i].tobytes() == hashlib.sha256(be[i].tobytes()).digest() for i in sample)
    emit("messages", path=MESSAGES_PATH, checked_against_hashlib=len(sample), ok=ok)
    if not ok:
        raise RuntimeError("sha256_words disagrees with hashlib")


def reject_phase(kind: str, proof_bytes: bytes, verify) -> None:
    """``verify(proof_bytes)`` passes; with one bit flipped in the middle it
    must raise."""
    verify(proof_bytes)
    bad = bytearray(proof_bytes)
    bad[len(bad) // 2] ^= 0x01
    try:
        verify(bytes(bad))
    except (FriError, ValueError) as e:
        emit("reject", proof=kind, raised=type(e).__name__, message=str(e))
        return
    raise RuntimeError(f"a corrupted {kind} proof was accepted")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-sizes", default=",".join(map(str, PCS_LOG_SIZES)),
                    help="comma-separated log2 sizes of the PCS phase (default: %(default)s)")
    ap.add_argument("--batched-log-sizes", default=",".join(map(str, BATCHED_LOG_SIZES)),
                    help="comma-separated log2 sizes of the batched PCS phase (default: %(default)s)")
    ap.add_argument("--resume-pcs", metavar="PATH",
                    help="only resume the PCS session saved at PATH, finish it and print its SHA-256 "
                         "(the checkpoint phase runs this in a fresh process)")
    ap.add_argument("--first-snark", action="store_true",
                    help="only time the first SNARK prove of this process (the first_snark phase runs this "
                         "in a fresh process)")
    ap.add_argument("--sharded-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--sharded-world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--sharded-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--sharded-cases", help=argparse.SUPPRESS)
    ap.add_argument("--sharded-dir", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.sharded_rank is not None:
        return sharded_rank_main(args.sharded_rank, args.sharded_world, args.sharded_port, args.sharded_cases,
                                 args.sharded_dir)
    if args.resume_pcs:
        return resume_pcs_only(args.resume_pcs)
    if args.first_snark:
        return first_snark_only()
    log_sizes = sorted(int(x) for x in args.log_sizes.split(","))
    batched_sizes = sorted(int(x) for x in args.batched_log_sizes.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    try:
        import triton  # noqa: F401
        has_triton = True
    except ImportError:
        has_triton = False
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    emit("env", python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=run_text([nvcc, "--version"]).splitlines()[-2:], triton=has_triton,
         gpu=smi_line(), device=torch.cuda.get_device_name(0))

    _build.lib()
    print(_build.build_log, file=sys.stderr, flush=True)
    regs = re.findall(r"Compiling entry function '(\w+)'.*?Used (\d+) registers",
                      _build.build_log, flags=re.S)
    spills = re.findall(r"(\d+) bytes spill stores", _build.build_log)
    emit("build", seconds=_build.build_seconds, registers=dict(regs),
         max_spill_store_bytes=max([int(s) for s in spills], default=0))

    # the two factors of every operation bound, from this card and this build
    PEAK.update(integer_rate(dev))
    counted = count_primitive_ops()
    OPS.update(counted["ops"])
    spent = {}
    for stem in ("sha256_words", "sha256_leaves", "merkle_levels", "prev_sha256_words", "fold_commit",
                 "fold", "mul", "kron", "prev_kron", "twiddle_mul3", "zm", "round_scalars", "prev_round_scalars"):
        for fn, c in sass_int_ops(_build.library_paths[stem]).items():
            spent[f"{stem}:{fn}"] = {k: c[k] for k in ("alu", "fma", "either", "int", "all")}
    emit("bounds", peak_bytes_per_s=PEAK_BYTES_PER_S, **PEAK,
         primitive_int_ops={k: dict(zip(("alu_only", "multiply_only", "either", "bound_share_of_sum"),
                                        [*v.tolist(), ops_time_ms(v) / ops_time_ms([v.sum(), 0, 0])]))
                            for k, v in OPS.items()},
         command="cuobjdump -sass multilinear_tpu_torch/build/libopcount-*.so",
         probes=counted["probes"], kernels_as_built=spent, clocks=clock_under_load(dev))

    first_snark_phase()
    timed = kernels_phase(dev)
    round_routes = routes_phase(dev, log_sizes[-1], batched_sizes[-1])
    pcs_sha, pcs_peak = pcs_phase(dev, log_sizes)
    batched_sha = batched_pcs_phase(dev, batched_sizes)
    snark_shas, snark_peaks = snark_phase(dev)
    with tempfile.TemporaryDirectory() as kept:
        checkpoint_paths, single_files = checkpoint_phase(dev, log_sizes[-1], batched_sizes[-1], pcs_sha,
                                                          batched_sha, snark_shas, kept)
        degree_phase(dev, round_routes)
        api_phase(dev)
        sharded_paths = sharded_phase(dev, log_sizes[-1], batched_sizes[-1], pcs_sha, batched_sha, pcs_peak,
                                      snark_shas, snark_peaks, single_files)
    pcs_bytes, batched_bytes, snark_bytes = parity_phase(dev)
    reject_phase("pcs", pcs_bytes, lambda b: pcs_proof_from_bytes(b).verify(Transcript()))
    reject_phase("batched_pcs", batched_bytes, lambda b: batched_pcs_proof_from_bytes(b).verify(Transcript()))
    for kind, (width, log_n, blob) in snark_bytes.items():
        reject_phase(f"snark {kind}", blob, lambda b: snark_verify(kind, width, log_n, b))
    messages_phase(dev)

    # the driven paths: the largest PCS prove, the largest batched prove, the
    # tiny proves that reach the single-stage butterfly, the message-hashing
    # entry, which no prove calls, the two SNARK proves, the resumed proves,
    # the SNARK above the old degree cap, the smaller entry points, and the
    # sharded proves (launches summed over their ranks)
    main_paths = ([f"pcs 2^{log_sizes[-1]}", f"batched pcs {BATCH_POLYS} x 2^{batched_sizes[-1]}",
                   "pcs 2^1, 2^2, 2^3", MESSAGES_PATH] + [label for label, _, _ in SNARK_PATHS]
                  + checkpoint_paths + [DEGREE_PATH, API_PATH] + sharded_paths)
    kernels = []
    for name, meta in KERNELS.items():
        row = timed[name]
        by_path = {path: PATH_LAUNCHES[path][name] for path in main_paths}
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"], "replaces": meta["replaces"],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "shapes": row["shapes"], "bound_share": row["bound_share"],
            **({"one_thread_bound_ms": row["one_thread_bound_ms"]} if "one_thread_bound_ms" in row else {}),
        })
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        raise RuntimeError(f"kernels never launched on a driven path: {idle}")
    other = {key: {k: row[k] for k in ("case", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "shapes")}
             for key, row in timed.items() if "/" in key}
    print(json.dumps({"kernels": kernels, "main_paths": main_paths, "other_timed_shapes": other}),
          flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
