// Elementwise kernels over up to three collapsed value dimensions, each
// operand with its own strides (in elements; 0 for a broadcast dimension).
// The wrapper merges neighbouring dimensions that every operand walks
// contiguously, so a contiguous call arrives as one dimension and a
// broadcast or sliced operand is read in place instead of being copied.
#pragma once
#include "field.cuh"

struct strides3 {
  long long s0, s1, s2;
};

// Offsets of flat index idx over dims (d0, d1, d2), d2 fastest.
__device__ __forceinline__ void unravel3(unsigned idx, unsigned d1, unsigned d2, unsigned& i0,
                                         unsigned& i1, unsigned& i2) {
  i2 = idx % d2;
  unsigned t = idx / d2;
  i1 = t % d1;
  i0 = t / d1;
}

__device__ __forceinline__ long long offset3(strides3 s, unsigned i0, unsigned i1, unsigned i2) {
  return (long long)i0 * s.s0 + (long long)i1 * s.s1 + (long long)i2 * s.s2;
}

enum { EW_MUL = 0, EW_ADD = 1, EW_SUB = 2 };

// No __restrict__: out may alias an operand (an in-place update).
template <int OP>
__global__ void elementwise_kernel(const void* a, const void* b, void* out, unsigned n, unsigned d1, unsigned d2, strides3 sa,
                                   strides3 sb, strides3 so) {
  unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  unsigned i0, i1, i2;
  unravel3(idx, d1, d2, i0, i1, i2);
  fp x = fp_load(a, offset3(sa, i0, i1, i2));
  fp y = fp_load(b, offset3(sb, i0, i1, i2));
  fp r = OP == EW_MUL ? fp_mul(x, y) : OP == EW_ADD ? fp_add(x, y) : fp_sub(x, y);
  fp_store(out, offset3(so, i0, i1, i2), r);
}

template <int OP>
static int launch_elementwise(const void* a, const void* b, void* out, long long n, long long d1,
                              long long d2, const long long* st, int device,
                              cudaStream_t stream) {
  device_guard guard(device);
  strides3 sa = {st[0], st[1], st[2]}, sb = {st[3], st[4], st[5]}, so = {st[6], st[7], st[8]};
  const int threads = 256;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  elementwise_kernel<OP><<<blocks, threads, 0, stream>>>(a, b, out, (unsigned)n, (unsigned)d1,
                                                         (unsigned)d2, sa, sb, so);
  return (int)cudaGetLastError();
}
