// Field add and subtract, elementwise: out[i] = a[i] +- b[i] mod p.
//
// The JAX package has no TPU kernel for these: they are jnp code there
// (field/ops.py `add`, `sub`).  In PyTorch the same limb arithmetic is some
// forty small tensor operations per call, which made the zeta/Moebius passes
// and the sumcheck rounds launch-bound, so the port gives them one kernel
// each from the same field.cuh as the multiply.
//
// Bound on an H100: 48 bytes per element against ~12 integer operations:
// memory-bound.  `out` may alias `a` (each thread reads its element before it
// writes it), which the Moebius pass uses to update a strided half in place.
#include "strided.cuh"

extern "C" int mlt_add(const void* a, const void* b, void* out, long long n, long long d1,
                       long long d2, const long long* strides, int device,
                       cudaStream_t stream) {
  return launch_elementwise<EW_ADD>(a, b, out, n, d1, d2, strides, device, stream);
}

extern "C" int mlt_sub(const void* a, const void* b, void* out, long long n, long long d1,
                       long long d2, const long long* strides, int device,
                       cudaStream_t stream) {
  return launch_elementwise<EW_SUB>(a, b, out, n, d1, d2, strides, device, stream);
}
