// Zeta / Moebius butterflies for a GROUP of index bits in one pass:
//   for every bit d <= bit < d + c of the element index:
//     x[i | 1 << bit] = x[i | 1 << bit] +- x[i]          (i with that bit 0)
// read from `in`, written to `out` (which may be `in`); `add` picks the zeta
// transform (+, coefficients -> evaluations) or the Moebius transform (-).
// The per-bit passes commute, so a full transform over L bits is a few calls
// that partition the bits; a batch of transforms is one call over all of its
// elements (the index bits above L are simply never butterflied).
//
// Replaces the TPU kernel `_zm_group_flat` / `zm_butterfly_axis2` of the JAX
// package's field/pallas_ops.py (8 bits per pass in VMEM).
//
// Bound on an H100: 16 bytes read and 16 written per element against c
// add/sub chains: memory-bound, so the design spends as few passes over
// device memory as the shared memory of a multiprocessor allows, and as
// little shared-memory traffic per pass as the registers allow.
//   * A block owns a tile of 2^T elements, T = 13 (144 KiB with its padding,
//     one block of 1024 threads a multiprocessor) or T = 12 (72 KiB, 512
//     threads, two blocks): dynamic shared memory above the 48 KiB that
//     needs no opt-in.  The first pass takes the low T bits as tiles of
//     consecutive elements; each later pass takes up to T - 2 bits as tiles
//     of 2^c rows, 2^d elements apart, by 2^(T-c) >= 4 adjacent elements, so
//     every access to device memory is a run of at least 64 bytes.  With
//     T = 13, 2^24 and 2^22 elements are two passes (13 + 11, 13 + 9).
//   * Between stages the values stay in registers: a thread holds 8 elements
//     that differ in three tile-index bits, runs those three stages on them
//     and puts them back, so the tile makes one round trip through shared
//     memory per three bits (5 for 13 bits) where a stage-by-stage kernel
//     makes one per bit.  The triples sit at fixed bits (0-2, 3-5, 6-8, 9-11,
//     and 10-12 for the thirteenth), so every shared-memory address is the
//     thread's base slot plus a compile-time constant; a pass butterflies
//     the bits of each triple that are its own.  Slot e of the tile lies at e + e/8 + e/2^(T-3):
//     the first term spreads a thread's 8 neighbours (strides of 8 elements
//     would all fall on one 16-byte bank group), the second spreads the
//     eight top-bit blocks that the bit-reversed store below reads together.
//   * The first pass reads its input and writes another tensor, so the
//     wrapper clones nothing; later passes run in place on that output.
//   * The last pass can store the transform's element i at bitrev(i) of an
//     output whose groups are `out_group` elements apart (the encode wants
//     the bit-reversed coefficients zero-padded to the codeword's length; the
//     caller zeroes the upper part).  In the last pass the tile's rows are
//     the index's high bits, which the reversal makes the low bits: the store
//     walks the rows fastest, so a tile's 2^c rows become runs of 2^c * 16
//     contiguous bytes.
#include "field.cuh"

extern __shared__ uint4 zm_tile[];

// Slot of tile element e.  For index parts that share no bits,
// zm_slot(x | y) = zm_slot(x) + zm_slot(y): the kernel computes a thread's
// base slot once and reaches its other elements through constant offsets.
template <int T>
__device__ __forceinline__ constexpr int zm_slot(int e) {
  return e + (e >> 3) + (e >> (T - 3));
}

__device__ __forceinline__ unsigned zm_brev(unsigned x, int bits) {
  return bits ? __brev(x) >> (32 - bits) : 0u;
}

// One trip of the tile through the registers: the thread's 8 elements differ
// in tile-index bits [S3, S3 + 3); those of them that are set in `active` and
// are not below NEW_LO (bits a previous, overlapping step has done) are
// butterflied.  S3 is a compile-time constant, so the 8 slots are the
// thread's base slot plus constants.  Every thread of the block sees the
// same `active`, so the barrier inside the branch is reached by all or none.
template <int T, bool ADD, int S3, int NEW_LO>
__device__ __forceinline__ void zm_step(int tid, unsigned active) {
  const unsigned mine = (active >> S3) & 7u & ~((1u << (NEW_LO - S3)) - 1u);
  if (!mine) return;
  const int e0 = ((tid >> S3) << (S3 + 3)) | (tid & ((1 << S3) - 1));
  uint4* mine_tile = zm_tile + zm_slot<T>(e0);
  fp x[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = fp_load(mine_tile, zm_slot<T>(j << S3));
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    if (mine & (1u << b)) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!(j & (1 << b))) {
          const int hi = j | (1 << b);
          x[hi] = ADD ? fp_add(x[hi], x[j]) : fp_sub(x[hi], x[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) fp_store(mine_tile, zm_slot<T>(j << S3), x[j]);
  __syncthreads();
}

// Tile geometry: local index e = (hi << (w + c)) | (r << w) | col, with
//   col  w bits: adjacent elements of a row
//   r    c bits: the butterflied bits, rows 2^d elements apart
//   hi   T - w - c bits: whole transforms side by side (first pass of a
//        transform shorter than the tile; d = w = 0 there)
// w <= T - 3, so the 2^(T-3) threads of a block cover whole rows at a time:
// walking the tile in steps of the thread count keeps a thread's column and
// advances its row by a constant.
// rev_bits != 0: store in bit-reversed order; then d + c == rev_bits, the
// bit count of one transform.
template <int T, bool ADD>
__global__ void __launch_bounds__(1 << (T - 3), T == 13 ? 1 : 2)
zm_kernel(const uint4* in, uint4* out, long long total, int d, int c, int w, int rev_bits,
          long long out_group) {
  constexpr int THREADS = 1 << (T - 3);
  const int tid = threadIdx.x;
  const long long outer = blockIdx.x >> (d - w);
  const long long cb = blockIdx.x & ((1ll << (d - w)) - 1);
  const long long base = (outer << (T - w + d)) + (cb << w);
  const int wmask = (1 << w) - 1;
  const long long first = base + ((long long)(tid >> w) << d) + (tid & wmask);
  const long long stride = (long long)(THREADS >> w) << d;
  uint4* my_slots = zm_tile + zm_slot<T>(tid);

#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const long long addr = first + k * stride;
    my_slots[zm_slot<T>(k * THREADS)] = addr < total ? in[addr] : make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const unsigned active = ((1u << c) - 1u) << w;
  zm_step<T, ADD, 0, 0>(tid, active);
  zm_step<T, ADD, 3, 3>(tid, active);
  zm_step<T, ADD, 6, 6>(tid, active);
  zm_step<T, ADD, 9, 9>(tid, active);
  if (T == 13) zm_step<T, ADD, T - 3, 12>(tid, active);

  if (!rev_bits) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const long long addr = first + k * stride;
      if (addr < total) out[addr] = my_slots[zm_slot<T>(k * THREADS)];
    }
    return;
  }
  // bit-reversed store: thread index u walks the reversed row index fastest
  const int cmask = (1 << c) - 1;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int u = tid + k * THREADS;
    const int rr = u & cmask;           // reversed row = low bits of the target
    const int rest = u >> c;
    const int col = rest & wmask;
    const int hi = rest >> w;
    const int e = (hi << (w + c)) | ((int)zm_brev((unsigned)rr, c) << w) | col;
    const long long addr = base + ((long long)(e >> w) << d) + col;
    if (addr < total) {
      const long long group = (outer << (T - w - c)) + hi;
      const unsigned gcol = (unsigned)((cb << w) + col);  // index bits below d
      out[group * out_group + ((long long)zm_brev(gcol, d) << c) + rr] = zm_tile[zm_slot<T>(e)];
    }
  }
}

template <int T>
static int zm_launch(const void* in, void* out, long long total, int d, int c, int w, int add,
                     int rev_bits, long long out_group, cudaStream_t stream) {
  constexpr int THREADS = 1 << (T - 3);
  constexpr int SMEM = ((1 << T) + (1 << (T - 3)) + 8) * (int)sizeof(uint4);
  auto kernel = add ? zm_kernel<T, true> : zm_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  unsigned blocks = (unsigned)((total + (1ll << T) - 1) >> T);
  kernel<<<blocks, THREADS, SMEM, stream>>>(static_cast<const uint4*>(in),
                                            static_cast<uint4*>(out), total, d, c, w, rev_bits,
                                            out_group);
  return (int)cudaGetLastError();
}

// tile_bits: 12 or 13.  c >= 1, w + c <= tile_bits, w <= d, w <= tile_bits - 3;
// a pass with d > 0 has w + c == tile_bits and total a multiple of 2^(d + c).
extern "C" int mlt_zm_tiles(const void* in, void* out, long long total, int d, int c, int w,
                            int add, int rev_bits, long long out_group, int tile_bits, int device,
                            cudaStream_t stream) {
  device_guard guard(device);
  if ((tile_bits != 12 && tile_bits != 13) || c < 1 || w < 0 || w + c > tile_bits || w > d ||
      w > tile_bits - 3 || d > 31 || (d > 0 && w + c != tile_bits) || total < 1)
    return (int)cudaErrorInvalidValue;
  if (tile_bits == 13)
    return zm_launch<13>(in, out, total, d, c, w, add, rev_bits, out_group, stream);
  return zm_launch<12>(in, out, total, d, c, w, add, rev_bits, out_group, stream);
}
