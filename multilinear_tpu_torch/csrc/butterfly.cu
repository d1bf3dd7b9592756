// One constant-geometry (Pease) radix-2 NTT stage over rows:
//   out[2i]   = u[i] + v[i]
//   out[2i+1] = (u[i] - v[i]) * tw[i]
// u, v: (H, C) elements, tw: (H) elements (one twiddle per row), out:
// (2H, C) elements, rows interleaved.
//
// Replaces the TPU kernel `_butterfly_flat` / `butterfly` of the JAX
// package's field/pallas_ops.py.  The last stage of a transform, whose
// twiddles are all 1, goes through this kernel too (same values as the TPU
// package's twiddle-free kernel).
//
// Bound on an H100: 32 bytes read and 32 written per butterfly (plus 16 per
// row for the twiddle, amortised over C columns) against one field multiply
// and two add/sub chains - memory-bound by the same count as the multiply
// kernel.  One thread per (row, column); a warp's threads read neighbouring
// columns of one row, so loads and stores are contiguous 512-byte runs and
// the row's twiddle is one broadcast load.
#include "field.cuh"

__global__ void butterfly_kernel(const void* __restrict__ u, const void* __restrict__ v,
                                 const void* __restrict__ tw, void* __restrict__ out,
                                 long long H, long long C) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= H * C) return;
  long long i = idx / C;
  long long c = idx - i * C;
  fp x = fp_load(u, idx);
  fp y = fp_load(v, idx);
  fp w = fp_load(tw, i);
  fp_store(out, (2 * i) * C + c, fp_add(x, y));
  fp_store(out, (2 * i + 1) * C + c, fp_mul(fp_sub(x, y), w));
}

extern "C" int mlt_butterfly(const void* u, const void* v, const void* tw, void* out,
                             long long H, long long C, int device, cudaStream_t stream) {
  int cur = -1;
  cudaGetDevice(&cur);
  if (cur != device) cudaSetDevice(device);
  const int threads = 256;
  long long blocks = (H * C + threads - 1) / threads;
  butterfly_kernel<<<(unsigned)blocks, threads, 0, stream>>>(u, v, tw, out, H, C);
  int rc = (int)cudaGetLastError();
  if (cur != device && cur >= 0) cudaSetDevice(cur);
  return rc;
}
