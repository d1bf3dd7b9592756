#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port: ``python3 chip_smoke.py``.

Needs one NVIDIA card, nvcc and PyTorch built for CUDA; fails without them.
It builds the CUDA kernels from ``multilinear_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card (all values are integers: the
tolerance is 0 mismatches), then drives the port's main path - a PCS prove
and verify through ``PCSProof.prove`` / ``PCSProof.verify`` - at 2^16, 2^20
and 2^24 evaluations, checks byte parity with the CPU path and the golden
digest, and checks that a corrupted proof is rejected.

Each phase prints one JSON line.  Near the end come one line
``{"kernels": [...]}`` with every kernel's launches on the main path, error,
time, plain-version time and bound, then the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from multilinear_tpu_torch import _build, sha256_cuda, stats
from multilinear_tpu_torch.config import ProverConfig
from multilinear_tpu_torch.field import cuda_ops, limbs
from multilinear_tpu_torch.field.scalar import Fp, P
from multilinear_tpu_torch.fri import FriError
from multilinear_tpu_torch import mle, ntt
from multilinear_tpu_torch.field import ops
from multilinear_tpu_torch.field.scalar import pow2_generator
from multilinear_tpu_torch.mle import evaluate_evals_host
from multilinear_tpu_torch.ntt import clear_caches, inv_gen_pows
from multilinear_tpu_torch.pcs import PCSProof
from multilinear_tpu_torch.serialize import pcs_proof_from_bytes, pcs_proof_to_bytes
from multilinear_tpu_torch.testdata import pcs_golden_inputs
from multilinear_tpu_torch.transcript import Transcript
from multilinear_tpu_torch.utils import collect_phases

HERE = os.path.dirname(os.path.abspath(__file__))
PCS_LOG_SIZES = (16, 20, 24)

# Published peaks of one H100 SXM (NVIDIA's data sheet).  The data sheet has
# no row for 32-bit integer arithmetic outside the tensor cores; the float32
# rate is used for it.  Hopper has half as many int32 lanes as float32 lanes,
# so the true integer peak is lower and the bound stays a lower bound.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# 32-bit integer operations per primitive, counted from csrc/field.cuh and
# csrc/sha256.cuh: a 128x128 product is 16 32x32 multiply-adds of two
# operations each plus their carries, the two folds by K and the final
# conditional subtraction bring it to ~110; an add, sub or half is a 4-limb
# carry chain plus the conditional correction; a SHA-256 compression is
# 64 rounds of ~26 operations and 48 schedule words of ~13.
OPS_MUL = 110
OPS_ADD = 12
OPS_SHA_BLOCK = 64 * 26 + 48 * 13 + 8

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
    "sha256_words": {
        "source": "multilinear_tpu_torch/csrc/sha256_words.cu",
        "replaces": "multilinear_tpu/sha256_pallas.py:106",
    },
    "butterfly": {
        "source": "multilinear_tpu_torch/csrc/butterfly.cu",
        "replaces": "multilinear_tpu/field/pallas_ops.py:346",
    },
    "fold_commit_leaves": {
        "source": "multilinear_tpu_torch/csrc/fold_commit.cu",
        "replaces": "multilinear_tpu/field/pallas_ops.py:794",
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


def launch_counts() -> dict:
    return {**cuda_ops.launch_counts(), **sha256_cuda.launch_counts()}


def reset_counts() -> None:
    cuda_ops.reset_launch_counts()
    sha256_cuda.reset_launch_counts()
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
    every call finds them cold."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S * 1e3
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
    torch.cuda.empty_cache()
    if res["mismatches"]:
        raise RuntimeError(f"kernel {name} disagrees with its plain version: {row}")
    return row


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
            n_bytes=48 * n, n_ops=OPS_MUL * n, shapes=[[n, 4], [n, 4]], timed=timed)
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
    # (2, 2^24) table; sub: one Moebius pass over 2^24 evaluations
    n = 1 << 24
    data = random_field(rng, (2, n), dev)
    hi, lo = data[:, n // 2:], data[:, : n // 2]
    run("add", "main halves of (2, 2^24)", lambda: cuda_ops.add(hi, lo), lambda: ops.add_plain(hi, lo),
        n_bytes=48 * n, n_ops=OPS_ADD * n, shapes=[list(hi.shape)] * 2, timed=True)
    w = data[0].view(1 << 11, 2, 1 << 12, 4)
    run("sub", "main Moebius pass, bit 12 of 2^24", lambda: cuda_ops.sub(w[:, 1], w[:, 0]),
        lambda: ops.sub_plain(w[:, 1], w[:, 0]),
        n_bytes=48 * (n // 2), n_ops=OPS_ADD * (n // 2), shapes=[list(w[:, 1].shape)] * 2, timed=True)

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

    run("sub", "Moebius pass written in place", in_place, in_place_plain, shapes=[list(w[:, 1].shape)] * 2)
    small = random_field(rng, (37, 2, 19), dev)
    run("add", "ragged strided", lambda: cuda_ops.add(small[:, 1], small[:, 0]),
        lambda: ops.add_plain(small[:, 1], small[:, 0]), shapes=[[37, 19, 4]] * 2)
    del a, b, data, hi, lo, w, small

    # butterfly: one column stage of the 2^25 four-step transform
    for label, H, C, timed in (("main H=4096 C=4096", 4096, 4096, True), ("ragged", 37, 19, False)):
        u, v = random_field(rng, (H, C), dev), random_field(rng, (H, C), dev)
        tw = random_field(rng, (H,), dev)
        run("butterfly", label, lambda: cuda_ops.butterfly(u, v, tw),
            lambda: cuda_ops.butterfly_plain(u, v, tw),
            n_bytes=64 * H * C + 16 * H, n_ops=(OPS_MUL + 2 * OPS_ADD) * H * C,
            shapes=[[H, C, 4], [H, C, 4], [H, 4]], timed=timed)
    del u, v, tw

    # sha256_words: the first inner level (2^23 nodes of 16 words) and the
    # leaf level (2^24 pair leaves of 8 words) of the layer-0 tree
    sha_cases = (("main inner 2^23 x 16", 1 << 23, 16, True), ("leaves 2^24 x 8", 1 << 24, 8, True),
                 ("ragged 1001 x 13", 1001, 13, False), ("ragged 33 x 30", 33, 30, False))
    for label, n, nw, timed in sha_cases:
        msg = torch.from_numpy(
            rng.integers(0, 2**32, size=(n, nw), dtype=np.uint32).view(np.int32)).to(dev)
        blocks = sha256_cuda.n_blocks(nw)
        run("sha256_words", label, lambda: sha256_cuda.sha256_words(msg),
            lambda: sha256_cuda.sha256_words_plain(msg),
            n_bytes=(4 * nw + 32) * n, n_ops=OPS_SHA_BLOCK * blocks * n,
            shapes=[[n, nw]], timed=timed)
    del msg

    # fold_commit_leaves: round 0 of the 2^24 prove, on the 2^25 codeword
    rh = int.from_bytes(rng.bytes(16), "little") % P
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
            n_ops=q * (2 * (2 * OPS_MUL + 4 * OPS_ADD) + OPS_SHA_BLOCK),
            shapes=[[m, 4], list(tw.shape)], timed=timed)
    del code, tw
    clear_caches()
    torch.cuda.empty_cache()
    emit("kernels", tolerance="0 mismatches (integers)", cases=rows)
    return main


# ---------------------------------------------------------------------------
# the unfused routes that stand in for the six kernels still to be ported
# ---------------------------------------------------------------------------


def unfused_phase(dev, log_n: int = 24) -> None:
    """Time, at the shapes of the 2^log_n prove (the main path's largest), each route built from plain
    tensor code and the ported kernels where the JAX package has a fused TPU
    kernel that is not ported yet.  ``fused_bound_ms`` is the bytes a fused
    kernel would have to move over the card's memory rate; ``lost_ms`` is the
    route's time above it, which ranks the kernels for later slices."""
    rng = np.random.default_rng(7)
    log_m = log_n + 1
    n, m = 1 << log_n, 1 << log_m
    elem = 16
    rows = []

    def row(kernel, route, fn, fused_bytes):
        ms = time_ms(fn, 2)
        b = fused_bytes / PEAK_BYTES_PER_S * 1e3
        rows.append({"kernel": kernel, "route": route, "ms": ms, "fused_bound_ms": b,
                     "lost_ms": ms - b})
        torch.cuda.empty_cache()

    x = random_field(rng, (n,), dev)
    # 8 index bits per pass, each pass reading and writing the table
    row("zm_butterfly_axis2", "mle.to_coeffs: one ops.sub pass per index bit",
        lambda: mle.to_coeffs(x), -(-log_n // 8) * 2 * n * elem)
    subs = mle.delta_subtables([Fp(int.from_bytes(rng.bytes(16), "little")) for _ in range(log_n)], dev)
    row("kron_mul", "mle.combine_subtables: broadcast + mul",
        lambda: mle.combine_subtables(subs), n * elem)
    del x, subs

    a = (log_m + 1) // 2
    A, B = 1 << a, 1 << (log_m - a)
    gen_v = pow2_generator(log_m).v
    pows = ntt._pow_table(gen_v, log_m - 1, dev)
    powsA, powsB = pows[::B][: A // 2], pows[::A][: B // 2]
    code = random_field(rng, (m,), dev)

    def stages():
        ntt._pease_axis0(code.view(A, B, 4), powsA, a)
        ntt._pease_axis0(code.view(B, A, 4), powsB, log_m - a)

    # two stages per pass: half as many passes over the codeword
    row("butterfly2 (+ butterfly_notw)", "ntt._pease_axis0: one butterfly launch per stage",
        stages, ((log_m + 1) // 2) * 2 * m * elem)
    Tc, Tf = ntt._twiddle_factors(gen_v, log_m, dev)
    S = Tf.shape[0]
    Fr = code.view(A // S, S, B, 4)
    row("twiddle_mul3", "ntt.fourstep_transform: two mul passes over Tc and Tf",
        lambda: ops.mul(ops.mul(Fr, Tc.reshape(A // S, 1, B, 4)), Tf.reshape(1, S, B, 4)),
        2 * m * elem + (Tc.numel() + Tf.numel()) * 4)
    del code, Fr, Tc, Tf, pows
    rows.append({"kernel": "fold_codeword", "route": "not on the PCS path: every fold goes through "
                 "fold_commit_leaves", "ms": 0.0, "fused_bound_ms": 0.0, "lost_ms": 0.0})
    clear_caches()
    torch.cuda.empty_cache()
    rows.sort(key=lambda r: -r["lost_ms"])
    emit("unfused_routes", log_n=log_n, routes=rows)


def profile_phase(dev, log_n: int) -> None:
    """One traced prove: device-busy share and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    config = ProverConfig(device=str(dev))
    evals, point, output = seeded_claim(log_n, 1000 + log_n, dev)
    PCSProof.prove(point, output, evals, Transcript(), config)  # warm caches and allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        PCSProof.prove(point, output, evals, Transcript(), config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.key_averages() if e.device_time_total > 0 and
          e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in ev) / 1e6
    top = sorted(ev, key=lambda e: -e.device_time_total)[:12]
    emit("profile", log_n=log_n, traced_prove_s=wall, device_busy_s=busy,
         device_idle_share=max(0.0, 1 - busy / wall), device_kernels=sum(e.count for e in ev),
         top=[{"name": e.key[:60], "calls": e.count, "device_ms": e.device_time_total / 1e3}
              for e in top])
    clear_caches()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the main path
# ---------------------------------------------------------------------------


def seeded_claim(log_n: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    evals = random_field(rng, (1 << log_n,), dev)
    point = [Fp(int.from_bytes(rng.bytes(16), "little")) for _ in range(log_n)]
    return evals, point, evaluate_evals_host(evals, point)


def pcs_phase(dev, log_sizes) -> dict:
    """Prove and verify at each size; returns the launch counts of the
    largest (the main path's run)."""
    config = ProverConfig(device=str(dev))
    results, main_counts = [], None
    for log_n in log_sizes:
        evals, point, output = seeded_claim(log_n, 1000 + log_n, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()  # just before the main path
        with collect_phases() as phases:
            t0 = time.perf_counter()
            proof = PCSProof.prove(point, output, evals, Transcript(), config)
            torch.cuda.synchronize()
            prove_s = time.perf_counter() - t0
        d2h = stats.counts().get("d2h_copies", 0)
        proof_bytes = pcs_proof_to_bytes(proof)
        gc.collect()  # keep a collection of the prover's garbage out of the verifier's time
        t0 = time.perf_counter()
        pcs_proof_from_bytes(proof_bytes).verify(Transcript())
        verify_s = time.perf_counter() - t0
        counts = launch_counts()  # just after
        idle = [k for k, v in counts.items() if v == 0]
        if idle:
            raise RuntimeError(f"log_n={log_n}: kernels never launched on the main path: {idle}")
        if len(proof.fri_proof.commitments) != log_n or proof.output != output:
            raise RuntimeError("proof has the wrong shape")
        results.append({
            "log_n": log_n, "prove_s": prove_s, "verify_s": verify_s,
            "proof_bytes": len(proof_bytes), "phases_s": dict(phases),
            "d2h_copies": d2h, "launches": counts,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
        })
        main_counts = counts
        del proof, evals
        clear_caches()
        torch.cuda.empty_cache()
    emit("pcs", sizes=results)
    return main_counts


def parity_phase(dev) -> bytes:
    """Proof bytes at log_n = 10: card == CPU plain path == golden digest."""
    with open(os.path.join(HERE, "multilinear_tpu_torch", "testdata", "pcs_golden.json")) as f:
        golden = json.load(f)
    vals, point_v = pcs_golden_inputs(golden["log_n"], golden["seed"])
    point = [Fp(v) for v in point_v]
    out = {}
    for where in (str(dev), "cpu"):
        evals = limbs.pack_ints(vals, device=where)
        output = evaluate_evals_host(evals, point)
        if str(output.v) != golden["output"]:
            raise RuntimeError(f"claimed output differs from the fixture on {where}")
        proof = PCSProof.prove(point, output, evals, Transcript(), ProverConfig(device=where))
        out[where] = pcs_proof_to_bytes(proof)
    card, cpu = out[str(dev)], out["cpu"]
    digest = hashlib.sha256(card).hexdigest()
    ok = card == cpu and digest == golden["sha256"]
    emit("parity", log_n=golden["log_n"], card_equals_cpu=card == cpu, sha256=digest,
         golden=golden["sha256"], ok=ok)
    if not ok:
        raise RuntimeError("proof bytes differ between the card, the CPU path and the fixture")
    return card


def reject_phase(proof_bytes: bytes) -> None:
    pcs_proof_from_bytes(proof_bytes).verify(Transcript())
    bad = bytearray(proof_bytes)
    bad[len(bad) // 2] ^= 0x01
    try:
        pcs_proof_from_bytes(bytes(bad)).verify(Transcript())
    except (FriError, ValueError) as e:
        emit("reject", raised=type(e).__name__, message=str(e))
        return
    raise RuntimeError("a corrupted proof was accepted")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-sizes", default=",".join(map(str, PCS_LOG_SIZES)),
                    help="comma-separated log2 sizes of the PCS phase (default: %(default)s)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one prove at the largest size with torch.profiler")
    args = ap.parse_args()
    log_sizes = sorted(int(x) for x in args.log_sizes.split(","))
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

    timed = kernels_phase(dev)
    unfused_phase(dev, log_sizes[-1])
    counts = pcs_phase(dev, log_sizes)
    if args.profile:
        profile_phase(dev, log_sizes[-1])
    proof_bytes = parity_phase(dev)
    reject_phase(proof_bytes)

    kernels = []
    for name, meta in KERNELS.items():
        row = timed[name]
        kernels.append({
            "name": name, "route": "cuda", "source": meta["source"], "replaces": meta["replaces"],
            "launches": counts[name], "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "shapes": row["shapes"],
        })
    print(json.dumps({"kernels": kernels, "main_path": f"PCS prove+verify, log_n={log_sizes[-1]}"}),
          flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
