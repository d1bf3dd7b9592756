"""multilinear_tpu_torch: the PyTorch / CUDA port of the multilinear prover.

Counterpart of the JAX package ``multilinear_tpu``, module by module, for an
NVIDIA Hopper card.  Plain tensor code is PyTorch; the hot primitives (field
multiply, add and subtract, SHA-256, the NTT stages and twiddle step, the
zeta/Moebius transform, the tensor product, the FRI fold alone and fused
with the leaf hash, the rounds' Fiat-Shamir scalars) are CUDA C++ kernels
under ``csrc/``, built with nvcc at first use (``_build``) and loaded
through ctypes.  Importing the package builds nothing and imports neither
jax nor the JAX package.  Every entry point runs on the card unless the
caller asks for the CPU (``config.ProverConfig(device="cpu")``), where each
kernel's wrapper runs its plain PyTorch version.

What it covers, on one device:

* the FRI-based multilinear PCS, plain and batched: ``pcs.PCSProof.prove`` /
  ``verify``, ``batched_pcs.BatchedPCSProof.prove`` / ``verify``, standalone
  and batched FRI (``fri``, ``batched_fri``), Merkle commitments
  (``merkle``, ``sha256``, ``sha256_cuda``);
* the constraint-system SNARK (``system``: ``System.prove_snark`` /
  ``verify_snark``) over the standalone sumcheck (``sumcheck``), whose
  rounds run the composition traced once to a program (``composition``);
* the rounds' Fiat-Shamir on the card (``device_transcript``) beside the
  host transcript (``transcript``);
* checkpoint / resume of the three prover sessions (``checkpoint``;
  ``PCSProverSession``, ``BatchedPCSProverSession`` and
  ``SnarkProverSession`` ``.save`` / ``.resume``);
* the building blocks: the field (``field``), the NTT and its inverse
  (``ntt``), multilinear polynomials (``mle``), univariate polynomials
  (``poly``), proof bytes (``serialize``), counters and phase timers
  (``stats``, ``utils``), the runtime config (``config``), and the inputs of
  the golden proofs (``testdata``).

Across W ranks, one process each over ``torch.distributed`` (``parallel``:
the JAX package's ``parallel`` and ``dist``): the PCS and the standalone FRI
row-sharded, the batched PCS batch-sharded, each rank ending with the
single-device proof's bytes.
"""

__version__ = "0.1.0"

__all__ = [
    "batched_fri",
    "batched_pcs",
    "checkpoint",
    "composition",
    "config",
    "device_transcript",
    "field",
    "fri",
    "merkle",
    "mle",
    "ntt",
    "parallel",
    "pcs",
    "poly",
    "serialize",
    "sha256",
    "sha256_cuda",
    "stats",
    "sumcheck",
    "system",
    "testdata",
    "transcript",
    "utils",
]
