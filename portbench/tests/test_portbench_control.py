"""What decides ``correct`` fails where it has to: the control (the
reference itself with half the queries, in the program's place) and each
fault that a one-card prover cell can have, planted in the program under a
whole run of the harness on the CPU at 2^4 (the look for a card skipped).
One-card cells exchange nothing between chips, so that fault has no test."""

import time

import pytest

from portbench import control
from portbench.core import harness, spec

CELLS = ["pcs.seg2p24", "snark-euclid4.shard2p22"]
SEED = 2**31 + 12345


def _small(cell):
    wl = spec.workload(cell)
    wl.update(log_n=4, pool=2)
    return wl, spec.config(wl["config"])


def _run(cell):
    wl, cfg = _small(cell)
    return harness.run_cell(wl, cfg, SEED, 0.01, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["checks"]["diff_bytes"]["value"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    wl, cfg = _small(cell)
    assert control.correct(control.readings(wl, cfg, SEED, "cpu", control=False))
    checks = control.readings(wl, cfg, SEED, "cpu", control=True)
    assert not control.correct(checks)
    assert checks["diff_bytes"]["value"] > 0


def _stale_fold(monkeypatch):
    """A step that returns its state unchanged: the sumcheck tables' fold
    keeps the low half as it was."""
    from multilinear_tpu_torch.sumcheck import SumcheckTables

    def fold(self, r):
        self.data = self.data[:, : self.data.shape[1] // 2].contiguous()
        self.height >>= 1

    monkeypatch.setattr(SumcheckTables, "fold", fold)


def _half_the_queries(monkeypatch):
    """Half of the batch left out: the first half of the query openings
    stand for all of them."""
    from multilinear_tpu_torch.batched_fri import BatchedFriProverData
    from multilinear_tpu_torch.fri import FriProverData

    for cls in (FriProverData, BatchedFriProverData):
        opened = cls.open_queries

        def open_queries(self, indices, opened=opened):
            half = opened(self, list(indices)[: len(indices) // 2])
            return half + half[: len(indices) - len(half)]

        monkeypatch.setattr(cls, "open_queries", open_queries)


def _altered_byte(monkeypatch):
    """An answer altered where it is produced: one byte of the proof flipped
    as the program writes it."""
    from multilinear_tpu_torch import serialize

    for name in ("pcs_proof_to_bytes", "snark_proof_to_bytes"):
        write = getattr(serialize, name)

        def altered(proof, write=write):
            blob = bytearray(write(proof))
            blob[len(blob) // 3] ^= 0x10
            return bytes(blob)

        monkeypatch.setattr(serialize, name, altered)


@pytest.mark.parametrize("fault", [_stale_fold, _half_the_queries, _altered_byte], ids=lambda f: f.__name__[1:])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_in_the_program_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(cell)
    assert not result["correct"]
    assert result["checks"]["diff_bytes"]["value"] > 0 or result["failed"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_a_sound_run_is_correct_and_the_control_is_not(cell, card):
    wl, cfg = _small(cell)
    wl["log_n"] = 10
    result = harness.run_cell(wl, cfg, SEED, 1.0, False, card, time.perf_counter())
    assert result["correct"], result["checks"]
    assert not control.correct(control.readings(wl, cfg, SEED, card, control=True))
