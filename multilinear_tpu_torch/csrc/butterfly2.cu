// Two consecutive constant-geometry (Pease) radix-2 NTT stages in one pass.
//   x: (batch, M, C) elements, M a multiple of 4;  Q = M/4, stages s0 = 2*ps
//   and s1 = 2*ps + 1 of a log_m-stage transform.  For group i < Q, with
//   x0..x3 = x[i], x[i+Q], x[i+2Q], x[i+3Q]:
//     A = x0 + x2,  Bta = (x0 - x2) * ta,  C = x1 + x3,  Dtb = (x1 - x3) * tb
//     out[4i]   = A + C          out[4i+1] = (A - C) * tc
//     out[4i+2] = Bta + Dtb      out[4i+3] = (Bta - Dtb) * td
//   which is exactly stage s0 followed by stage s1 of butterfly.cu.
//
// Replaces the TPU kernel `_butterfly2_flat` / `butterfly2` of the JAX
// package's field/pallas_ops.py.  That kernel is handed a packed (M/4, 4)
// twiddle tensor gathered for each pair of stages; here the four twiddle
// exponents are computed in the kernel from (i, ps, log_m),
//   e(s, r) = ((r >> s) & ((M/2 - 1) >> s)) << s,
//   ta = e(s0, i), tb = e(s0, i + Q), tc = e(s1, 2i), td = e(s1, 2i + 1),
// and read straight from the power table pows[e * pow_stride], so no gather
// runs between stages.
//
// Bound on an H100: 64 bytes read and 64 written per group and column (the
// twiddles are four broadcast loads per row, amortised over C columns)
// against four field multiplies and eight add/sub chains - memory-bound,
// with half the traffic of two single-stage passes.  One thread per
// (batch, group, column): a warp's threads walk neighbouring columns, so each
// of the four loads and four stores is a contiguous 512-byte run.
#include "field.cuh"

__device__ __forceinline__ long long stage_exp(int s, long long r, long long half) {
  return ((r >> s) & ((half - 1) >> s)) << s;
}

__global__ void butterfly2_kernel(const void* __restrict__ x, const void* __restrict__ pows,
                                  void* __restrict__ out, long long batch, long long M,
                                  long long C, int ps, long long pow_stride) {
  // the thread index fits 32 bits (the wrapper checks): split it with 32-bit
  // divisions, which cost a fraction of 64-bit ones, and widen for offsets
  unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  long long Q = M / 4, half = M / 2;
  if (idx >= batch * Q * C) return;
  unsigned t = idx / (unsigned)C;
  long long c = idx - t * (unsigned)C;
  unsigned b = t / (unsigned)Q;
  long long i = t - b * (unsigned)Q;
  long long base = (long long)b * M * C;
  int s0 = 2 * ps, s1 = 2 * ps + 1;
  fp x0 = fp_load(x, base + i * C + c);
  fp x1 = fp_load(x, base + (i + Q) * C + c);
  fp x2 = fp_load(x, base + (i + 2 * Q) * C + c);
  fp x3 = fp_load(x, base + (i + 3 * Q) * C + c);
  fp ta = fp_load(pows, stage_exp(s0, i, half) * pow_stride);
  fp tb = fp_load(pows, stage_exp(s0, i + Q, half) * pow_stride);
  fp tc = fp_load(pows, stage_exp(s1, 2 * i, half) * pow_stride);
  fp td = fp_load(pows, stage_exp(s1, 2 * i + 1, half) * pow_stride);
  fp A = fp_add(x0, x2);
  fp Bta = fp_mul(fp_sub(x0, x2), ta);
  fp Cc = fp_add(x1, x3);
  fp Dtb = fp_mul(fp_sub(x1, x3), tb);
  long long o = base + 4 * i * C + c;
  fp_store(out, o, fp_add(A, Cc));
  fp_store(out, o + C, fp_mul(fp_sub(A, Cc), tc));
  fp_store(out, o + 2 * C, fp_add(Bta, Dtb));
  fp_store(out, o + 3 * C, fp_mul(fp_sub(Bta, Dtb), td));
}

extern "C" int mlt_butterfly2(const void* x, const void* pows, void* out, long long batch,
                              long long M, long long C, int ps, long long pow_stride,
                              int device, cudaStream_t stream) {
  device_guard guard(device);
  const int threads = 256;
  long long n = batch * (M / 4) * C;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  butterfly2_kernel<<<blocks, threads, 0, stream>>>(x, pows, out, batch, M, C, ps, pow_stride);
  return (int)cudaGetLastError();
}
