"""Adapter of the ``snark-euclid4`` configuration: one request is one SNARK
proof of a pool slot's trace of four columns under v0^2 + v1^2 - v2^2 = 0
and v0 + v1 - v3 = 0, through the program's ``System.prover(...).prove_snark``
(a batched PCS opens the columns) and ``snark_proof_to_bytes``; the plain
reference (``reference/snark.py``, ``reference/euclid4.py``) proves the same
request again from the seed.

Inputs: rows (m^2 - n^2, 2mn, m^2 + n^2, a + b) of uniform m and n from the
seed and the slot, made on the device by the benchmark's plain field code:
every row satisfies both constraints over the whole field.
"""

from __future__ import annotations

from portbench.core import inputs
from portbench.reference import euclid4
from portbench.reference import field as F
from portbench.reference import snark as ref
from portbench.reference.transcript import Transcript as RefTranscript


def make_input(workload: dict, seed: int, slot: int, device):
    """The trace as the program takes it: (4, 2^log_n, 4) int32 limbs."""
    h = 1 << workload["log_n"]
    gen = inputs.generator(seed, "rows", slot, device=device)
    m = F.from_u32_limbs(inputs.uniform(gen, (h,), device))
    n = F.from_u32_limbs(inputs.uniform(gen, (h,), device))
    return F.to_u32_limbs(euclid4.rows(m, n))


class Cell:
    def __init__(self, workload: dict, config: dict, seed: int, device):
        from multilinear_tpu_torch.config import ProverConfig
        from multilinear_tpu_torch.system import ConstraintSet, Trace, WitnessLayout

        if config["num_queries"] != 128 or config["columns"] != 4 or config["degree"] != euclid4.DEGREE:
            raise ValueError("the program proves this configuration with 128 queries, 4 columns, degree 2")
        self.workload, self.config, self.seed, self.device = workload, config, seed, device
        self.program = ProverConfig(device=str(device))
        self.constraints = ConstraintSet([lambda v, r: v[0] * v[0] + v[1] * v[1] - v[2] * v[2],
                                          lambda v, r: v[0] + v[1] - v[3]], euclid4.DEGREE)
        self.layout = WitnessLayout(columns=config["columns"])
        self.pool = [Trace.from_columns(make_input(workload, seed, slot, device))
                     for slot in range(workload["pool"])]

    def prove(self, slot: int, nonce: bytes) -> bytes:
        from multilinear_tpu_torch.serialize import snark_proof_to_bytes
        from multilinear_tpu_torch.system import System
        from multilinear_tpu_torch.transcript import Transcript

        t = Transcript()
        t.absorb(nonce)
        prover = System.prover(t, self.constraints, self.layout, self.pool[slot], self.program)
        return snark_proof_to_bytes(prover.prove_snark(t))

    def phases(self):
        from multilinear_tpu_torch.utils import collect_phases

        return collect_phases()

    def free(self) -> None:
        self.pool = None

    def reference(self, slot: int, nonce: bytes, num_queries: int = ref.NUM_QUERIES):
        cols = F.from_u32_limbs(make_input(self.workload, self.seed, slot, self.device))
        t = RefTranscript()
        t.absorb(nonce)
        return ref.prove(cols, euclid4.CONSTRAINTS, euclid4.DEGREE, t, num_queries=num_queries)

    def control(self, slot: int, nonce: bytes) -> bytes:
        return bytes(self.reference(slot, nonce, self.config["control"]["num_queries"]).buf)
