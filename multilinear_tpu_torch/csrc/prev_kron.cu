// The first port of `kron_mul` (out[i * n + j] = a[i] * b[j]), replaced by
// kron.cu and kept compiled under its first symbol for one use:
// chip_smoke.py's `routes` phase times it beside the kernel that replaced it
// (previous_routes.kron_mul).  No prover path launches it.
//
// Bound on an H100: 16 bytes written per output element (the factors are
// m + n elements, read once) against one field multiply: memory-bound on the
// store.  One thread per output element: b[j] is a contiguous load across a
// warp, a[i] a broadcast load (one address per warp when n >= 32), the store
// contiguous.
#include "field.cuh"

__global__ void kron_kernel(const void* __restrict__ a, const void* __restrict__ b,
                            void* __restrict__ out, long long m, long long n) {
  // the output index fits 32 bits (the wrapper checks): a 32-bit division
  // costs a fraction of a 64-bit one
  unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= m * n) return;
  unsigned i = idx / (unsigned)n;
  unsigned j = idx - i * (unsigned)n;
  fp_store(out, idx, fp_mul(fp_load(a, i), fp_load(b, j)));
}

extern "C" int mlt_kron(const void* a, const void* b, void* out, long long m, long long n,
                        int device, cudaStream_t stream) {
  device_guard guard(device);
  const int threads = 256;
  unsigned blocks = (unsigned)((m * n + threads - 1) / threads);
  kron_kernel<<<blocks, threads, 0, stream>>>(a, b, out, m, n);
  return (int)cudaGetLastError();
}
