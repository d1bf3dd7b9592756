"""The ``pcs-rows4`` configuration on the CPU: its adapter over four gloo
ranks, its blocked reference against the plain one, and that no rank
process outlives the cell."""

import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from portbench.core import inputs, spec
from portbench.reference import field as F
from portbench.reference import pcs as plain
from portbench.reference import pcs_blocks
from portbench.reference.transcript import Transcript

SEED = 3_000_000_017  # more than 31 bits, as a benchmark run's seed may be
LOG_N = 12


def _cell_config():
    workload = dict(spec.workload("pcs-rows4.seg2p29"), log_n=LOG_N)
    return workload, spec.config(workload["config"])


def _adapter():
    return spec.adapter(spec.config("pcs-rows4"))


def _plain_bytes(adapter, slot: int, nonce: bytes, log_n: int = LOG_N, queries: int = plain.NUM_QUERIES) -> bytes:
    lb = adapter.log_block(log_n)
    evals = torch.cat([adapter.make_block(SEED, slot, b, lb, "cpu") for b in range(1 << (log_n - lb))])
    pt = inputs.point(SEED, "point", slot, n=log_n)
    wide = F.from_u32_limbs(evals)
    t = Transcript()
    t.absorb(nonce)
    return bytes(plain.prove(wide, pt, plain.mle_eval(wide, pt), t, queries).buf)


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"  # a zombie has ended
    except FileNotFoundError:
        return True


def _wait_gone(pids, seconds: float = 20.0) -> bool:
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if all(_gone(p) for p in pids):
            return True
        time.sleep(0.2)
    return False


def test_four_gloo_ranks_prove_the_plain_references_bytes():
    workload, config = _cell_config()
    adapter = _adapter()
    cell = adapter.Cell(workload, config, SEED, "cpu")
    try:
        assert len(cell.workers) == config["ranks"] - 1 == 3
        nonces = [inputs.nonce(SEED, i) for i in range(3)]
        got = [cell.prove(i % workload["pool"], nonces[i]) for i in range(3)]
    finally:
        cell.free()
    assert _wait_gone([w.pid for w in cell.workers], 1.0)
    for i, blob in enumerate(got):
        want = _plain_bytes(adapter, i % workload["pool"], nonces[i])
        assert blob == want
        assert bytes(cell.reference(i % workload["pool"], nonces[i]).buf) == want
    control = cell.control(0, nonces[0])
    assert control == _plain_bytes(adapter, 0, nonces[0], queries=config["control"]["num_queries"])
    assert control != got[0]


@pytest.mark.parametrize("log_n", [10, 12, 15])
@pytest.mark.parametrize("blocks", [1, 2, 4])
def test_blocked_reference_equals_the_plain_one(log_n, blocks):
    evals = inputs.uniform(inputs.generator(SEED, "evals", log_n), (1 << log_n,), "cpu")
    pt = inputs.point(SEED, "point", log_n, n=log_n)
    wide = F.from_u32_limbs(evals)
    t = Transcript()
    t.absorb(b"nonce")
    want = plain.prove(wide, pt, plain.mle_eval(wide, pt), t)
    t = Transcript()
    t.absorb(b"nonce")
    got = pcs_blocks.BlockedPCS(list(evals.split((1 << log_n) // blocks)), pt, t, ["cpu", "cpu"]).proof()
    assert bytes(got.buf) == bytes(want.buf)
    assert got.sections() == want.sections()


@pytest.mark.parametrize("blocks", [1, 2, 8])
def test_blocked_mle_eval_equals_the_plain_one(blocks):
    evals = inputs.uniform(inputs.generator(SEED, "mle"), (1 << 11,), "cpu")
    pt = inputs.point(SEED, "point", n=11)
    assert pcs_blocks.mle_eval(list(evals.split((1 << 11) // blocks)), pt) == plain.mle_eval(
        F.from_u32_limbs(evals), pt)


def test_the_control_stops_the_ranks_before_it_runs():
    """``control.py`` runs the control where the program proves, before it
    frees the cell: the control frees it first, and the later ``free`` is
    harmless."""
    workload, config = _cell_config()
    adapter = _adapter()
    cell = adapter.Cell(workload, config, SEED, "cpu")
    nonce = inputs.nonce(SEED, 0)
    try:
        control = cell.control(0, nonce)
        assert _wait_gone([w.pid for w in cell.workers], 1.0)
    finally:
        cell.free()
    assert control == _plain_bytes(adapter, 0, nonce, queries=config["control"]["num_queries"])


def test_no_rank_outlives_a_failed_rank():
    workload, config = _cell_config()
    cell = _adapter().Cell(workload, config, SEED, "cpu")
    pids = [w.pid for w in cell.workers]
    try:
        bad = cell.workers[1]
        bad.stdin.write('{"slot": 99, "nonce": "00", "output": "0"}\n')  # no such slot: rank 2 raises
        bad.stdin.flush()
        bad.wait(timeout=60)
        assert bad.returncode != 0
        with pytest.raises(Exception):
            for i in range(2):  # the watch may end the ranks before the first request or during it
                cell.prove(0, inputs.nonce(SEED, i))
        assert cell.broken
    finally:
        cell.free()
    assert _wait_gone(pids)


def test_no_rank_outlives_a_terminated_run(tmp_path):
    """SIGTERM to the process that holds rank 0: the workers end with it."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    script = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {root!r})
        from portbench.core import spec
        workload = dict(spec.workload("pcs-rows4.seg2p29"), log_n={LOG_N})
        config = spec.config("pcs-rows4")
        cell = spec.adapter(config).Cell(workload, config, {SEED}, "cpu")
        print(" ".join(str(w.pid) for w in cell.workers), flush=True)
        time.sleep(600)
    """)
    proc = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE, text=True, cwd=root)
    try:
        pids = [int(p) for p in proc.stdout.readline().split()]
        assert len(pids) == 3 and not any(_gone(p) for p in pids)
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
        assert _wait_gone(pids)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
