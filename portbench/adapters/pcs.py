"""Adapter of the ``pcs`` configuration: one request is one proof of
p(point) = output for a pool slot's evaluations, through the program's
``PCSProof.prove`` and ``pcs_proof_to_bytes``; the plain reference
(``reference/pcs.py``) proves the same request again from the seed.

Inputs: 2^log_n uniform residues mod p and a uniform point, both from the
seed and the slot; the claimed evaluation is worked out by the benchmark's
plain code in set-up and handed to the program.
"""

from __future__ import annotations

from portbench.core import inputs
from portbench.reference import field as F
from portbench.reference import pcs as ref
from portbench.reference.transcript import Transcript as RefTranscript


def make_input(workload: dict, seed: int, slot: int, device):
    n = workload["log_n"]
    evals = inputs.uniform(inputs.generator(seed, "evals", slot, device=device), (1 << n,), device)
    return evals, inputs.point(seed, "point", slot, n=n)


class Cell:
    def __init__(self, workload: dict, config: dict, seed: int, device):
        from multilinear_tpu_torch.config import ProverConfig
        from multilinear_tpu_torch.field.scalar import Fp

        if config["num_queries"] != 128 or config["log_blowup"] != 1:
            raise ValueError("the program's PCS has 128 queries at rate 1/2")
        self.workload, self.config, self.seed, self.device = workload, config, seed, device
        self.program = ProverConfig(device=str(device))
        self.pool = []
        for slot in range(workload["pool"]):
            evals, pt = make_input(workload, seed, slot, device)
            out = ref.mle_eval(F.from_u32_limbs(evals), pt)
            self.pool.append((evals, [Fp(x) for x in pt], Fp(out)))

    def prove(self, slot: int, nonce: bytes) -> bytes:
        from multilinear_tpu_torch.pcs import PCSProof
        from multilinear_tpu_torch.serialize import pcs_proof_to_bytes
        from multilinear_tpu_torch.transcript import Transcript

        evals, pt, out = self.pool[slot]
        t = Transcript()
        t.absorb(nonce)
        return pcs_proof_to_bytes(PCSProof.prove(pt, out, evals, t, self.program))

    def phases(self):
        """The program's phase timers, live inside the context."""
        from multilinear_tpu_torch.utils import collect_phases

        return collect_phases()

    def free(self) -> None:
        self.pool = None

    def reference(self, slot: int, nonce: bytes, num_queries: int = ref.NUM_QUERIES):
        """The reference's proof of the same request, its inputs made again
        from the seed: a ``proof.Writer`` with the proof's sections."""
        evals, pt = make_input(self.workload, self.seed, slot, self.device)
        evals = F.from_u32_limbs(evals)
        t = RefTranscript()
        t.absorb(nonce)
        return ref.prove(evals, pt, ref.mle_eval(evals, pt), t, num_queries)

    def control(self, slot: int, nonce: bytes) -> bytes:
        """The reference in the program's place with a guarantee broken: the
        configuration's ``control`` query count."""
        return bytes(self.reference(slot, nonce, self.config["control"]["num_queries"]).buf)
