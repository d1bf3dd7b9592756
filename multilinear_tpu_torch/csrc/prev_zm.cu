// The 2^11-element, stage-by-stage zeta / Moebius kernel that zm.cu replaced.
// Nothing on the prover's path calls it: it stays compiled, under its first
// symbol, only for the smoke script's `routes` phase, which times the
// replaced route (three passes, a gather, a padded copy) beside the new one.
//
// Zeta / Moebius butterflies for a GROUP of index bits in one pass:
//   for every bit d <= bit < d + c of the element index:
//     x[i | 1 << bit] = x[i | 1 << bit] +- x[i]          (i with that bit 0)
// in place, over N elements (N a multiple of 2^(d+c)); `add` picks the zeta
// transform (+, coefficients -> evaluations) or the Moebius transform (-).
// The per-bit passes commute, so a full transform over L bits is a few calls
// that partition the bits; a batch of transforms is one call over all of its
// elements (the index bits above L are simply never butterflied).
//
// Replaces the TPU kernel `_zm_group_flat` / `zm_butterfly_axis2` of the JAX
// package's field/pallas_ops.py (8 bits per pass in VMEM), and in the port
// one `sub` launch per bit, each a full read and write of the table.
//
// Bound on an H100: 16 bytes read and 16 written per element and pass
// against c add/sub chains: memory-bound.  Design: a block owns a tile of
// R = 2^c "rows" by W adjacent elements, R * W <= ZM_TILE = 2048 elements =
// 32 KiB of static shared memory (below the 48 KiB that needs no opt-in; up
// to seven blocks fit on an SM).  It loads the tile, runs the c stages in
// shared memory with __syncthreads() between stages, and stores the tile
// back; no other block touches those elements, so in place is safe.
//   * low bits (d = 0): the tile is 2^c consecutive elements, c <= 11, W = 1;
//   * higher bits: the rows are 2^d elements apart, and the block takes
//     W = 2048 / R >= 4 adjacent elements of each row, so every global
//     access is a run of at least 64 bytes.
// The wrapper takes 11 bits in the first pass and up to 9 in each later one:
// 2^24 elements are 3 passes (11 + 9 + 4), 2^22 are 3 (11 + 9 + 2), where
// the per-bit route needed 24 and 22.
#include "field.cuh"

#define ZM_TILE 2048
#ifndef ZM_THREADS
#define ZM_THREADS 256
#endif

// inner = 2^d: distance between rows; log_r = c; log_w = log2(W).
template <bool ADD>
__global__ void zm_kernel(void* x, long long inner, int log_r, int log_w) {
  __shared__ uint4 tile[ZM_TILE];
  const long long W = 1ll << log_w;
  const int elems = 1 << (log_r + log_w);
  const long long col_blocks = inner >> log_w;
  const long long outer = blockIdx.x / col_blocks;
  const long long cb = blockIdx.x - outer * col_blocks;
  const long long base = (outer << log_r) * inner + cb * W;
  uint4* g = reinterpret_cast<uint4*>(x);
  for (int e = threadIdx.x; e < elems; e += ZM_THREADS) {
    long long r = e >> log_w, w = e & (W - 1);
    tile[e] = g[base + r * inner + w];
  }
  __syncthreads();
  for (int s = 0; s < log_r; ++s) {
    for (int t = threadIdx.x; t < elems / 2; t += ZM_THREADS) {
      int w = t & ((1 << log_w) - 1);
      int p = t >> log_w;
      int r_lo = ((p >> s) << (s + 1)) | (p & ((1 << s) - 1));
      int lo_i = (r_lo << log_w) | w;
      int hi_i = lo_i + (1 << (s + log_w));
      fp lo = fp_load(tile, lo_i);
      fp hi = fp_load(tile, hi_i);
      fp_store(tile, hi_i, ADD ? fp_add(hi, lo) : fp_sub(hi, lo));
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < elems; e += ZM_THREADS) {
    long long r = e >> log_w, w = e & (W - 1);
    g[base + r * inner + w] = tile[e];
  }
}

extern "C" int mlt_zm(void* x, long long n_elements, long long inner, int log_r, int log_w,
                      int add, int device, cudaStream_t stream) {
  device_guard guard(device);
  if (log_r + log_w > 11 || (inner >> log_w) < 1) return (int)cudaErrorInvalidValue;
  unsigned blocks = (unsigned)(n_elements >> (log_r + log_w));
  if (add)
    zm_kernel<true><<<blocks, ZM_THREADS, 0, stream>>>(x, inner, log_r, log_w);
  else
    zm_kernel<false><<<blocks, ZM_THREADS, 0, stream>>>(x, inner, log_r, log_w);
  return (int)cudaGetLastError();
}
