// Several levels of a SHA-256 Merkle tree in one launch.
//   in:  n_in digests (8 words each), n_in a power of two >= 2
//   out: the next `levels` levels, one after the other: n_in/2 digests, then
//        n_in/4, ...; parent i of a level = SHA-256(child 2i || child 2i+1)
// Every level is kept: the openings read them.
//
// Replaces, for the inner levels of the Merkle trees, the TPU kernel
// `_sha_flat` / `sha256_words` of the JAX package's sha256_pallas.py, which
// is launched once a level there, as the kernel this one replaced was here:
// 24 launches for a tree of 2^24 leaves and some 300 a prove, most of them
// on levels too small to fill one multiprocessor.
//
// Bound on an H100: integer operations (a parent reads 64 bytes and writes
// 32 against two compressions, the second over the constant padding block,
// which runs from a table without a schedule).  A block of 256 threads
// takes SPAN = 512 * IPT child digests, hashes their parents IPT to a
// thread, keeps them in shared memory and halves down to one digest:
// log2(SPAN) levels a launch, 9 for IPT = 1 and 11 for IPT = 4.  A level
// that fits one block finishes the tree in that launch.
//
// What the idle upper threads cost.  A warp's hash takes the same scheduler
// slots whether 32 of its threads work or one.  With IPT = 1 a block spends
// 8 + 4 + 2 + 1 full warps on levels 1-4 and one mostly empty warp on each
// of levels 5-9: 20 warp-hashes for 511 hashes, 16 warps' worth of work, a
// quarter more scheduler slots than a launch per level spends.  With IPT = 4
// the same five thin levels sit on 32 + 16 + 8 + 4 + 2 + 1 full warps: 68
// warp-hashes for 64 warps' worth, 6 % more.  Against that stand the
// launches saved: each costs the host a tensor allocation, a foreign call
// and the card a few microseconds of a dependent 128-round chain on one
// multiprocessor, on a prove whose card waits for the host most of the time.
// The wide block needs four times the digests to put as many blocks on the
// card, so it loses on small levels and wins on large ones; the launch
// function takes IPT from its caller, which picks by the level's size.
#include "launch.cuh"
#include "sha256.cuh"

#define ML_THREADS 256

// The 16 words of children 2 * pair and 2 * pair + 1 of the level at src.
__device__ __forceinline__ void ml_load_pair(const uint4* src, int pair, u32 w[16]) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    uint4 q = src[4 * pair + g];
    w[4 * g] = q.x;
    w[4 * g + 1] = q.y;
    w[4 * g + 2] = q.z;
    w[4 * g + 3] = q.w;
  }
}

template <int IPT>
__global__ void __launch_bounds__(ML_THREADS)
merkle_levels_kernel(const uint4* __restrict__ in, u32* __restrict__ out, long long n_in,
                     int levels) {
  // level 1 of the block goes to buf_a, the next ones alternately to buf_b
  // and buf_a; one loop body serves the level read from device memory and
  // those read from shared memory, so the unrolled hash is in the code once
  __shared__ uint4 buf_a[2 * ML_THREADS * IPT];
  __shared__ uint4 buf_b[ML_THREADS * IPT];
  const long long span = 2ll * ML_THREADS * IPT;
  const long long first = (long long)blockIdx.x * span;  // first child digest of the block
  int cnt = (int)((n_in < span ? n_in : span) / 2);      // parents this block hashes
  long long level_off = 0;                               // digests of `out` before this level
  long long level_len = n_in / 2;
  const uint4* src = in + 2 * first;
  uint4* dst = buf_a;
  uint4* other = buf_b;
  for (int lvl = 1; lvl <= levels; ++lvl) {
    const long long block_first = first >> lvl;  // the block's first digest of this level
    for (int idx = threadIdx.x; idx < cnt; idx += ML_THREADS) {
      u32 w[16], st[8];
      ml_load_pair(src, idx, w);
      sha256_node(st, w);
      sha_store_digest(out, level_off + block_first + idx, st);
      dst[2 * idx] = make_uint4(st[0], st[1], st[2], st[3]);
      dst[2 * idx + 1] = make_uint4(st[4], st[5], st[6], st[7]);
    }
    __syncthreads();
    level_off += level_len;
    level_len >>= 1;
    cnt >>= 1;
    src = dst;
    dst = other;
    other = const_cast<uint4*>(src);
  }
}

// levels <= log2(min(n_in, 512 * ipt)); ipt is 1 or 4.
extern "C" int mlt_merkle_levels(const void* in, void* out, long long n_in, int levels, int ipt,
                                 int device, cudaStream_t stream) {
  device_guard guard(device);
  const long long span = 2ll * ML_THREADS * ipt;
  if ((ipt != 1 && ipt != 4) || n_in < 2 || (n_in & (n_in - 1)) || levels < 1 ||
      (1ll << levels) > (n_in < span ? n_in : span))
    return (int)cudaErrorInvalidValue;
  unsigned blocks = (unsigned)(n_in <= span ? 1 : n_in / span);
  const uint4* i = static_cast<const uint4*>(in);
  u32* o = static_cast<u32*>(out);
  if (ipt == 1)
    merkle_levels_kernel<1><<<blocks, ML_THREADS, 0, stream>>>(i, o, n_in, levels);
  else
    merkle_levels_kernel<4><<<blocks, ML_THREADS, 0, stream>>>(i, o, n_in, levels);
  return (int)cudaGetLastError();
}
