// The twiddle step of the four-step NTT in one pass:
//   G[a, b] = F[a, b] * Tc[a / S, b] * Tf[a % S, b]
// F, G: (batch, A, B) elements; Tc: (A/S, B); Tf: (S, B); S a power of two.
// The dense (A, B) twiddle matrix w^(a*b) factors through the row index
// a = k*S + d into these two small matrices, so it is never materialised.
//
// Replaces the TPU kernel `_twiddle_mul3_flat` / `twiddle_mul3` of the JAX
// package's field/pallas_ops.py, and in the port the two strided `mul`
// passes that stood in for it (one read and one write of the codeword
// saved).
//
// Bound on an H100: 16 bytes read and 16 written per element, plus the two
// factor matrices once (they are ~sqrt(A) times smaller than F and stay in
// the L2 cache), against two field multiplies: memory-bound.  One thread per
// (batch, a, b); a warp walks neighbouring b, so all three loads and the
// store are contiguous.
#include "field.cuh"

__global__ void twiddle_mul3_kernel(const void* __restrict__ F, const void* __restrict__ Tc,
                                    const void* __restrict__ Tf, void* __restrict__ G,
                                    long long batch, long long A, long long B, int log_s) {
  // the element index fits 32 bits (the wrapper checks): split it with
  // 32-bit divisions, which cost a fraction of 64-bit ones
  unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= batch * A * B) return;
  unsigned row = idx / (unsigned)B;
  long long b = idx - row * (unsigned)B;
  long long a = row % (unsigned)A;
  fp f = fp_load(F, idx);
  fp c = fp_load(Tc, (a >> log_s) * B + b);
  fp d = fp_load(Tf, (a & ((1ll << log_s) - 1)) * B + b);
  fp_store(G, idx, fp_mul(fp_mul(f, c), d));
}

extern "C" int mlt_twiddle_mul3(const void* F, const void* Tc, const void* Tf, void* G,
                                long long batch, long long A, long long B, int log_s,
                                int device, cudaStream_t stream) {
  device_guard guard(device);
  const int threads = 256;
  long long n = batch * A * B;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  twiddle_mul3_kernel<<<blocks, threads, 0, stream>>>(F, Tc, Tf, G, batch, A, B, log_s);
  return (int)cudaGetLastError();
}
