"""Adapter of the ``pcs-rows4`` configuration: one request is one proof of
p(point) = output for a pool slot's 2^log_n evaluations, split by rows over
``ranks`` processes, one card a rank, through the program's
``PCSProof.prove(..., layout=...)`` and ``pcs_proof_to_bytes``; the plain
reference proves the same request again in blocks (``reference/pcs_blocks.py``)
on every card.

Ranks: rank 0 is this process.  ``Cell`` starts ranks 1 .. W-1 as fresh
processes of this file (``--rank``), which meet rank 0's process group
(``parallel.multihost.init``: NCCL with a card a rank; gloo on the CPU, in
the tests) on a free local port.  A request goes to them as one JSON line
on their standard input; each answers with the SHA-256 of its proof's bytes,
which must be rank 0's.  A rank that dies, or a request that outlasts
``REQUEST_LIMIT_S``, ends every rank; on a card this process then exits
non-zero, since a collective that a rank never joins does not return.  A
worker dies with this process (``PR_SET_PDEATHSIG``), also on SIGKILL.

Inputs: the evaluations are blocks of 2^min(24, log_n - 2) uniform residues
mod p, block b of slot s made by the generator keyed (seed, "evals", s, b),
so the polynomial does not depend on the rank count; rank r makes the run
of blocks its rows hold.  The point is uniform from (seed, "point", s).  The
claimed evaluation is each rank's sum over its blocks (plain code,
``pcs_blocks.mle_partial``), added exactly on rank 0 in set-up.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench.core import inputs  # noqa: E402
from portbench.reference import field as F  # noqa: E402
from portbench.reference import pcs as plain  # noqa: E402
from portbench.reference import pcs_blocks as ref  # noqa: E402
from portbench.reference.transcript import Transcript as RefTranscript  # noqa: E402

INPUT_LOG_BLOCK = 24  # the input blocks' size, 2^24 evaluations (256 MiB)
LOG_MAX_RANKS = 2  # smaller inputs are cut into 4 blocks, whatever the rank count
REQUEST_LIMIT_S = 300.0  # a request (or the set-up's rendezvous) that runs longer ends the ranks
QUIT_WAIT_S = 30.0


def log_block(log_n: int) -> int:
    return min(INPUT_LOG_BLOCK, log_n - LOG_MAX_RANKS)


def make_block(seed: int, slot: int, b: int, log_b: int, device) -> torch.Tensor:
    """Input block b of a slot: (2^log_b, 4) int32 limbs."""
    return inputs.uniform(inputs.generator(seed, "evals", slot, b, device=device), (1 << log_b,), device)


class Rank:
    """One rank's share of the pool and its prove: the rows of its blocks,
    the point, and its part of the claimed evaluation."""

    def __init__(self, workload: dict, config: dict, seed: int, layout):
        from multilinear_tpu_torch.config import ProverConfig
        from multilinear_tpu_torch.field.scalar import Fp

        if config["num_queries"] != 128 or config["log_blowup"] != 1:
            raise ValueError("the program's PCS has 128 queries at rate 1/2")
        n = workload["log_n"]
        lb = log_block(n)
        per_rank = (1 << (n - lb)) // layout.world
        first = layout.rank * per_rank
        self.layout, self.program = layout, ProverConfig(device=str(layout.device))
        self.pool = []
        for slot in range(workload["pool"]):
            evals = torch.empty((per_rank << lb, 4), dtype=torch.int32, device=layout.device)
            for i in range(per_rank):
                evals[i << lb : (i + 1) << lb] = make_block(seed, slot, first + i, lb, layout.device)
            pt = inputs.point(seed, "point", slot, n=n)
            part = ref.mle_partial([(first + i, evals[i << lb : (i + 1) << lb]) for i in range(per_rank)], pt, lb)
            self.pool.append((evals, [Fp(x) for x in pt], part))

    def prove(self, slot: int, nonce: bytes, output: int) -> bytes:
        from multilinear_tpu_torch.field.scalar import Fp
        from multilinear_tpu_torch.pcs import PCSProof
        from multilinear_tpu_torch.serialize import pcs_proof_to_bytes
        from multilinear_tpu_torch.transcript import Transcript

        evals, pt, _ = self.pool[slot]
        t = Transcript()
        t.absorb(nonce)
        return pcs_proof_to_bytes(PCSProof.prove(pt, Fp(output), evals, t, self.program, layout=self.layout))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Cell:
    def __init__(self, workload: dict, config: dict, seed: int, device):
        from multilinear_tpu_torch.parallel import multihost

        self.workload, self.config, self.seed = workload, config, seed
        self.cuda = torch.device(device).type == "cuda"
        self.world = config["ranks"]
        self.workers, self.broken, self._closed, self._busy_since = [], False, False, time.monotonic()
        self._ref = None  # (slot, nonce, the reference's prover state) of the last reference run
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()  # what an earlier cell's reference left on the cards
            from multilinear_tpu_torch import _build

            _build.lib()  # built once here, loaded by the workers
        port = _free_port()
        env = dict(os.environ)
        if not self.cuda:
            env["OMP_NUM_THREADS"] = "1"
        spec = json.dumps({"workload": workload, "config": config})
        for r in range(1, self.world):
            self.workers.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--rank", str(r), "--world", str(self.world),
                 "--port", str(port), "--seed", str(seed), "--device", "cuda" if self.cuda else "cpu", "--spec", spec],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=str(ROOT), env=env))
        threading.Thread(target=self._watch, daemon=True).start()
        try:
            self.layout = multihost.init(0, self.world, f"tcp://127.0.0.1:{port}", device="cuda" if self.cuda else "cpu")
            self.rank = Rank(workload, config, seed, self.layout)
            parts = [[p for _, _, p in self.rank.pool]] + [self._answer(r)["partials"] for r in range(1, self.world)]
            self.outputs = [sum(int(p[s]) for p in parts) % F.P for s in range(workload["pool"])]
        except BaseException:
            self._fail("set-up")
            multihost.shutdown()
            raise
        self._busy_since = None

    # -- the ranks ---------------------------------------------------------------
    def _answer(self, r: int) -> dict:
        line = self.workers[r - 1].stdout.readline()
        if not line:
            raise RuntimeError(f"rank {r} of {self.world} ended (exit code {self.workers[r - 1].wait()})")
        return json.loads(line)

    def _kill(self) -> None:
        for w in self.workers:
            if w.poll() is None:
                w.kill()
        for w in self.workers:
            w.wait()

    def _fail(self, what: str) -> None:
        """A rank failed or ran out of time: end every rank.  On a card this
        process cannot leave a collective that a rank never joins, so it exits."""
        self.broken = True
        self._kill()
        if self.cuda and not self._closed:
            print(f"pcs_rows4: {what}: the ranks are ended and the run with them", file=sys.stderr, flush=True)
            os._exit(1)

    def _watch(self) -> None:
        while not self._closed:
            dead = [r for r, w in enumerate(self.workers, 1) if w.poll() is not None]
            busy = self._busy_since
            if dead and not self._closed:
                self._fail(f"rank {dead[0]} exited with {self.workers[dead[0] - 1].returncode}")
                return
            if busy is not None and time.monotonic() - busy > REQUEST_LIMIT_S:
                self._fail(f"a request ran over {REQUEST_LIMIT_S:.0f} s")
                return
            time.sleep(0.5)

    # -- the cell ----------------------------------------------------------------
    def prove(self, slot: int, nonce: bytes) -> bytes:
        if self.broken:
            raise RuntimeError("a rank failed: the ranks are gone")
        self._busy_since = time.monotonic()
        try:
            out = self.outputs[slot]
            msg = json.dumps({"slot": slot, "nonce": nonce.hex(), "output": str(out)}) + "\n"
            for w in self.workers:
                w.stdin.write(msg)
                w.stdin.flush()
            blob = self.rank.prove(slot, nonce, out)
            digest = hashlib.sha256(blob).hexdigest()
            for r in range(1, self.world):
                got = self._answer(r)["sha256"]
                if got != digest:
                    raise RuntimeError(f"rank {r}'s proof differs from rank 0's")
        except BaseException:
            self._fail("a request failed")
            raise
        self._busy_since = None
        return blob

    def phases(self):
        """Rank 0's phase timers, live inside the context."""
        from multilinear_tpu_torch.utils import collect_phases

        return collect_phases()

    def free(self) -> None:
        """Stop the workers and leave the process group: the cards are the
        reference's."""
        from multilinear_tpu_torch.parallel import multihost

        self._closed = True
        for w in self.workers:
            if w.poll() is not None:
                continue
            try:
                w.stdin.write(json.dumps({"quit": True}) + "\n")
                w.stdin.flush()
            except OSError:
                pass
        if self.broken:
            self._kill()
        multihost.shutdown()
        deadline = time.monotonic() + QUIT_WAIT_S
        for w in self.workers:
            try:
                w.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                pass
        self._kill()
        self.rank = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def _state(self, slot: int, nonce: bytes) -> ref.BlockedPCS:
        """The reference's run of a request up to its queries, made again
        from the seed on every card; kept for the next call of the same
        request (the control's run, then the check's)."""
        if self._ref is not None and self._ref[:2] == (slot, nonce):
            return self._ref[2]
        self._ref = None
        gc.collect()
        n = self.workload["log_n"]
        lb = log_block(n)
        per_rank = (1 << (n - lb)) // self.world
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())] if self.cuda else ["cpu"]
        cards = ref.Cards(devices)
        blocks = [make_block(self.seed, slot, b, lb, devices[min(b // per_rank, len(devices) - 1)]).to(cards.of(b))
                  for b in range(1 << (n - lb))]
        t = RefTranscript()
        t.absorb(nonce)
        state = ref.BlockedPCS(blocks, inputs.point(self.seed, "point", slot, n=n), t, devices)
        self._ref = (slot, nonce, state)
        return state

    def reference(self, slot: int, nonce: bytes, num_queries: int = plain.NUM_QUERIES):
        """The reference's proof of the same request: a ``proof.Writer``."""
        return self._state(slot, nonce).proof(num_queries)

    def control(self, slot: int, nonce: bytes) -> bytes:
        """The reference in the program's place with a guarantee broken: the
        configuration's ``control`` query count.  The program's ranks stop
        first, as before the check: the cards are the reference's."""
        if not self._closed:
            self.free()
        return bytes(self.reference(slot, nonce, self.config["control"]["num_queries"]).buf)


# -- a worker: ranks 1 .. W-1 ------------------------------------------------------


def _die_with_parent() -> None:
    """SIGKILL this process when the process that started it ends."""
    import ctypes
    import signal

    parent = os.getppid()
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def worker_main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one rank of the pcs-rows4 cell besides rank 0")
    for flag in ("--rank", "--world", "--port", "--seed"):
        p.add_argument(flag, type=int, required=True)
    p.add_argument("--device", required=True)
    p.add_argument("--spec", required=True, help="JSON: the cell's workload and config")
    args = p.parse_args(argv)
    _die_with_parent()
    reply = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)  # whatever else writes to standard output goes to standard error
    from multilinear_tpu_torch.parallel import multihost

    spec = json.loads(args.spec)
    if args.device == "cuda":
        from multilinear_tpu_torch import _build

        _build.lib()
    layout = multihost.init(args.rank, args.world, f"tcp://127.0.0.1:{args.port}", device=args.device)
    rank = Rank(spec["workload"], spec["config"], args.seed, layout)
    reply.write(json.dumps({"partials": [str(part) for _, _, part in rank.pool]}) + "\n")
    reply.flush()
    for line in sys.stdin:
        cmd = json.loads(line)
        if cmd.get("quit"):
            break
        blob = rank.prove(cmd["slot"], bytes.fromhex(cmd["nonce"]), int(cmd["output"]))
        reply.write(json.dumps({"sha256": hashlib.sha256(blob).hexdigest()}) + "\n")
        reply.flush()
    multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(worker_main())
