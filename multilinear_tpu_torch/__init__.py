"""multilinear_tpu_torch: the PyTorch / CUDA port of the multilinear prover.

Counterpart of the JAX package ``multilinear_tpu``, module by module, for an
NVIDIA Hopper card.  Plain tensor code is PyTorch; the hot primitives (field
multiply, add and subtract, SHA-256, the NTT stages and twiddle step, the
zeta/Moebius transform, the tensor product, the FRI fold alone and fused
with the leaf hash) are CUDA C++ kernels under ``csrc/``, built with nvcc at first use and loaded through
ctypes.  Importing the package builds nothing and imports neither jax nor the
JAX package.

It covers the FRI-based multilinear PCS, plain and batched:
``pcs.PCSProof.prove`` / ``verify``, ``batched_pcs.BatchedPCSProof.prove`` /
``verify``, standalone and batched FRI, and everything beneath them.
"""

__version__ = "0.1.0"

__all__ = [
    "batched_fri",
    "batched_pcs",
    "config",
    "field",
    "fri",
    "merkle",
    "mle",
    "ntt",
    "pcs",
    "poly",
    "serialize",
    "sha256",
    "sha256_cuda",
    "stats",
    "sumcheck",
    "transcript",
]
