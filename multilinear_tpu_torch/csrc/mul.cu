// Field multiply, elementwise: out[i] = a[i] * b[i] mod p.
//
// Replaces the TPU kernel `_mul_flat` / `mul` of the JAX package's
// field/pallas_ops.py (Karatsuba over 8x16-bit limbs); same canonical value,
// computed here as one 128x128 product with 64-bit multiplies (field.cuh).
//
// Bound on an H100: 48 bytes per element (two 16-byte reads, one write)
// against ~110 32-bit integer operations; the bytes take several times
// longer than the operations, so the kernel is memory-bound.  The design is
// one element per thread with one 16-byte load per operand on neighbouring
// addresses.  Operands are read through their own strides (strided.cuh), so
// a broadcast factor (a scalar challenge, a twiddle row, one side of a
// tensor product) costs its own bytes and not a materialised copy.
#include "strided.cuh"

extern "C" int mlt_mul(const void* a, const void* b, void* out, long long n, long long d1,
                       long long d2, const long long* strides, int device,
                       cudaStream_t stream) {
  return launch_elementwise<EW_MUL>(a, b, out, n, d1, d2, strides, device, stream);
}
