"""multilinear_tpu_torch: the PyTorch / CUDA port of the multilinear prover.

Counterpart of the JAX package ``multilinear_tpu``, module by module, for an
NVIDIA Hopper card.  Plain tensor code is PyTorch; the hot primitives (field
multiply, SHA-256, NTT butterfly, fused FRI fold + leaf hash) are CUDA C++
kernels under ``csrc/``, built with nvcc at first use and loaded through
ctypes.  Importing the package builds nothing and imports neither jax nor the
JAX package.

This slice covers the FRI-based multilinear PCS: ``pcs.PCSProof.prove`` /
``verify`` and everything beneath them.
"""

__version__ = "0.1.0"

__all__ = [
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
