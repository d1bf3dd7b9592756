// One constant-geometry (Pease) radix-2 NTT stage over rows:
//   out[2i]   = u[i] + v[i]
//   out[2i+1] = (u[i] - v[i]) * tw[i]
// u, v: (batch, H, C) elements, each batch entry contiguous and
// `in_stride` elements after the one before (so u and v may be the two row
// halves of one (batch, 2H, C) tensor); tw: (H) elements, one twiddle per
// row, shared by the batch; out: (batch, 2H, C) elements, rows interleaved.
//
// Two kernels.  `butterfly_kernel` replaces the TPU kernel `_butterfly_flat`
// / `butterfly` of the JAX package's field/pallas_ops.py; the transforms use
// it where a sub-transform has fewer than four rows (two stages fuse into
// butterfly2.cu otherwise).  `butterfly_notw_kernel` replaces
// `_butterfly_notw_flat` / `butterfly_notw`: the last stage of a transform,
// whose twiddles are all 1, as (u + v, u - v) with no twiddle load and no
// multiply.
//
// Bound on an H100: 32 bytes read and 32 written per butterfly (plus 16 per
// row for the twiddle, amortised over C columns) against one field multiply
// and two add/sub chains (two chains alone without twiddles) - memory-bound
// by the same count as the multiply kernel.  One thread per (batch, row,
// column); a warp's threads read neighbouring columns of one row, so loads
// and stores are contiguous 512-byte runs and the row's twiddle is one
// broadcast load.
#include "field.cuh"

template <bool TW>
__global__ void butterfly_kernel(const void* __restrict__ u, const void* __restrict__ v,
                                 const void* __restrict__ tw, void* __restrict__ out,
                                 long long batch, long long H, long long C,
                                 long long in_stride) {
  // the thread index fits 32 bits (the wrapper checks): split it with 32-bit
  // divisions, which cost a fraction of 64-bit ones, and widen for offsets
  unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= batch * H * C) return;
  unsigned t = idx / (unsigned)C;
  long long c = idx - t * (unsigned)C;
  long long b = t / (unsigned)H;
  long long i = t - (unsigned)b * (unsigned)H;
  long long in = b * in_stride + i * C + c;
  fp x = fp_load(u, in);
  fp y = fp_load(v, in);
  long long o = (b * 2 * H + 2 * i) * C + c;
  fp_store(out, o, fp_add(x, y));
  fp d = fp_sub(x, y);
  fp_store(out, o + C, TW ? fp_mul(d, fp_load(tw, i)) : d);
}

template <bool TW>
static int launch_butterfly(const void* u, const void* v, const void* tw, void* out,
                            long long batch, long long H, long long C, long long in_stride,
                            int device, cudaStream_t stream) {
  device_guard guard(device);
  const int threads = 256;
  long long blocks = (batch * H * C + threads - 1) / threads;
  butterfly_kernel<TW><<<(unsigned)blocks, threads, 0, stream>>>(u, v, tw, out, batch, H, C,
                                                                 in_stride);
  return (int)cudaGetLastError();
}

extern "C" int mlt_butterfly(const void* u, const void* v, const void* tw, void* out,
                             long long batch, long long H, long long C, long long in_stride,
                             int device, cudaStream_t stream) {
  return launch_butterfly<true>(u, v, tw, out, batch, H, C, in_stride, device, stream);
}

extern "C" int mlt_butterfly_notw(const void* u, const void* v, void* out, long long batch,
                                  long long H, long long C, long long in_stride, int device,
                                  cudaStream_t stream) {
  return launch_butterfly<false>(u, v, nullptr, out, batch, H, C, in_stride, device, stream);
}
