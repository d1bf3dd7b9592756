// The Fiat-Shamir scalars of one sumcheck + FRI round, on the card: one
// launch a round, so that the rounds of a prove never wait for the host.
//
// Replaces the jnp scalar tail `pcs._round_scalars` of the JAX package
// (multilinear_tpu/pcs.py:84-115) and the root absorb of `_pcs_round_body`
// (:148).  Neither is a Pallas kernel; the TPU runs them inside the round's
// XLA program.
//
// The transcript state is 26 int32 words in device memory
// (device_transcript.py): 8 SHA-256 chaining words, the 64-byte partial
// block as 16 big-endian words (bytes at or past the fill are zero), the fill
// in bytes and the total length in bytes.  Any byte fill is taken, so any
// midstate the host exports can hop here.
//
// A round launch (sums given), one warp:
//   1. lanes 0 and 1 reduce the two unreduced int64 limb sums s(1), s(2)
//      mod p at once;
//   2. s0 = prev - s1, c2 = (s2 - 2 s1 + s0) / 2, c1 = s1 - s0 - c2;
//   3. absorbs the previous tree's root, if one is pending (8 digest words,
//      whose big-endian bytes are the root bytes), then c1 and c2 as 16
//      little-endian bytes each (Q9), and draws r = the first 16 digest
//      bytes, little-endian, mod p;
//   4. writes c1, c2 into `coeffs` (2 elements: the round's slot);
//   5. writes prev' = s0 + r (c1 + r c2), r and rh = r / 2 into scal[0..2];
//   6. writes the digest and the new state.
// A last-element launch (elem given, no sums) absorbs elem[0] - the element
// every entry of the last fold's codeword must equal - and writes the digest.
//
// A standalone sumcheck round (sumcheck_round_scalars_kernel, a second
// entry of this file), one block, has no roots and any total degree d >= 1
// whose evaluations and coefficients fit in a block's shared memory:
//   1. thread i reduces the unreduced int64 limb sums of s(i + 1) mod p;
//      s0 = prev - s1;
//   2. the d + 1 coefficients c = V^-1 (s0, s1, ..., sd), V^-1 read from a
//      (d+1, d+1) table of field elements in device memory; its row 0 is
//      e0 (c0 = p(0) = s0), so only rows 1..d are multiplied: a warp a row,
//      its lanes across the columns (coalesced 16-byte loads), a tree of
//      shuffles and additions over the lanes;
//   3. one warp absorbs c1..cd as 16 little-endian bytes each, in order (Q7,
//      Q9), and draws r;
//   4. writes c1..cd into `coeffs` (the round's slot), prev' = p(r) over
//      `prev` and r into `r_out` (the round's slot of the randoms, where the
//      table fold reads it);
//   5. writes the digest and the new state.
// It replaces the jnp scalar tail of `_sc_round_body` in the JAX package
// (multilinear_tpu/sumcheck.py:352-372), which the TPU runs inside the
// round's XLA program, not as a Pallas kernel.
//
// Bound on an H100: Fiat-Shamir makes the SHA-256 compressions one chain,
// which one warp issues at about one instruction a clock; the rest of a
// round (the reductions, the d (d + 1) multiplies of V^-1, p(r)) is spread
// over the lanes of the warp or the block.  Every lane of the absorbing warp
// holds the state and runs every compression on the same words, so no lane
// waits for a broadcast of the chaining words; the 16 words of a block are
// made a word a lane and gathered by shuffles.  The absorb moves whole
// 32-bit words, shifted into place with funnel shifts when the fill is not a
// multiple of 4.
#include "field.cuh"
#include "sha256.cuh"

#define FULL_MASK 0xFFFFFFFFu

// The transcript state as one warp holds it: every lane keeps the chaining
// words, the fill and the length; lane t holds word t & 15 of the partial
// block (big-endian; zero at and past the fill).
struct warp_tr {
  u32 st[8];
  u32 word;
  u32 fill;   // bytes in the partial block, 0..63
  u32 total;  // bytes absorbed in all
};

__device__ __forceinline__ void warp_tr_load(warp_tr& s, const int* __restrict__ state) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s.st[j] = (u32)state[j];
  s.word = (u32)state[8 + (threadIdx.x & 15)];
  s.fill = (u32)state[24];
  s.total = (u32)state[25];
}

// Lanes 0-7 write the digest words, lanes 0-15 the state (a full warp).
__device__ __forceinline__ void warp_tr_store(const warp_tr& s, const u32 d[8], int* __restrict__ state,
                                              int* __restrict__ digest) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (lane == j) {
      digest[j] = (int)d[j];
      state[j] = (int)s.st[j];
    }
  }
  if (lane < 16) state[8 + lane] = (int)s.word;
  if (lane == 16) state[24] = (int)s.fill;
  if (lane == 17) state[25] = (int)s.total;
}

// Every lane compresses the block whose word t lane t holds (t < 16).
__device__ __forceinline__ void warp_compress(u32 st[8], u32 word) {
  u32 w[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) w[j] = __shfl_sync(FULL_MASK, word, j);
  sha256_compress(st, w);
}

// Absorb n >= 1 big-endian message words, msg(k) for k in [0, n).  Every
// lane calls msg (with k clamped into range) on every pass, so msg may
// shuffle.  Word t of block b of the buffer holds the last fill % 4 bytes of
// message word k - 1 and the first 4 - fill % 4 of word k, k = 16 b + t -
// fill / 4 (before the message: the bytes already in the buffer).
template <class Msg>
__device__ __forceinline__ void warp_absorb(warp_tr& s, int n, Msg msg) {
  const int t = threadIdx.x & 15;
  const u32 sh = 8 * (s.fill & 3);
  const int q0 = (int)(s.fill >> 2);
  // the bytes already in word q0, as the tail of a word before the message
  // (0 when the fill is a multiple of 4: the word is empty)
  const u32 head = __funnelshift_l(__shfl_sync(FULL_MASK, s.word, q0), 0u, sh);
  const u32 end = s.fill + 4u * (u32)n;
  const int full = (int)(end >> 6);
#pragma unroll 1
  for (int b = 0;; ++b) {
    const int k = 16 * b + t - q0;
    const u32 cur = msg(min(max(k, 0), n - 1));
    const u32 before = msg(min(max(k - 1, 0), n - 1));
    const u32 lo = (k >= 0 && k < n) ? cur : 0u;
    const u32 hi = k >= 1 ? (k <= n ? before : 0u) : head;
    const u32 w = k < 0 ? s.word : __funnelshift_r(lo, hi, sh);
    if (b == full) {
      s.word = w;
      break;
    }
    warp_compress(s.st, w);
  }
  s.fill = end & 63u;
  s.total += 4u * (u32)n;
}

// Digest of a finalized clone (the state does not advance, quirk Q1): the
// 0x80 byte after the fill, zeros, the 64-bit bit length; two blocks when
// the fill leaves no room for the length.
__device__ __forceinline__ void warp_digest(const warp_tr& s, u32 d[8]) {
  const int t = threadIdx.x & 15;
#pragma unroll
  for (int j = 0; j < 8; ++j) d[j] = s.st[j];
  const u32 fill = s.fill;
  const unsigned long long bits = 8ull * s.total;
  const int nblocks = fill <= 55 ? 1 : 2;
#pragma unroll 1
  for (int blk = 0; blk < nblocks; ++blk) {
    u32 v = 0;
    if (blk == 0) {
      v = s.word;
      if (t == (int)(fill >> 2)) v |= 0x80000000u >> (8 * (fill & 3));
    }
    if (blk == nblocks - 1) {
      if (t == 14) v = (u32)(bits >> 32);
      if (t == 15) v = (u32)bits;
    }
    warp_compress(d, v);
  }
}

// r: the first 16 digest bytes as a little-endian u128, < 2^128 < 2p.
__device__ __forceinline__ fp digest_challenge(const u32 d[8]) {
  fp r;
  r.lo = ((u64)sha_bswap(d[1]) << 32) | sha_bswap(d[0]);
  r.hi = ((u64)sha_bswap(d[3]) << 32) | sha_bswap(d[2]);
  return fp_canon(r, 0ull);
}

// Limb i (0..3) of v, as the big-endian message word of its 4 bytes.
__device__ __forceinline__ u32 fp_msg_word(fp v, int i) {
  const u64 half = i < 2 ? v.lo : v.hi;
  return sha_bswap((u32)(half >> (32 * (i & 1))));
}

__device__ __forceinline__ fp fp_shfl(fp v, int src) {
  fp r;
  r.lo = __shfl_sync(FULL_MASK, v.lo, src);
  r.hi = __shfl_sync(FULL_MASK, v.hi, src);
  return r;
}

__device__ __forceinline__ fp fp_shfl_xor(fp v, int mask) {
  fp r;
  r.lo = __shfl_xor_sync(FULL_MASK, v.lo, mask);
  r.hi = __shfl_xor_sync(FULL_MASK, v.hi, mask);
  return r;
}

__device__ __forceinline__ fp fp_shfl_down(fp v, int delta) {
  fp r;
  r.lo = __shfl_down_sync(FULL_MASK, v.lo, delta);
  r.hi = __shfl_down_sync(FULL_MASK, v.hi, delta);
  return r;
}

__global__ void __launch_bounds__(32)
    round_scalars_kernel(int* __restrict__ state, const int* __restrict__ root, const void* __restrict__ elem,
                         const unsigned long long* __restrict__ sums, void* __restrict__ scal,
                         void* __restrict__ coeffs, int* __restrict__ digest) {
  const int lane = threadIdx.x;
  warp_tr s;
  warp_tr_load(s, state);

  // the message, a big-endian word a lane: the root's 8 words (if one is
  // pending), then the 4 limbs of c1 and of c2; or the 4 limbs of elem[0]
  u32 word = 0;
  int n;
  fp s0, c1, c2;
  if (sums) {
    const fp v = reduce_lane_sums(sums + 4 * (lane & 1));
    const fp s1 = fp_shfl(v, 0), s2 = fp_shfl(v, 1);
    s0 = fp_sub(fp_load(scal, 0), s1);
    c2 = fp_half(fp_sub(fp_add(s2, s0), fp_add(s1, s1)));
    c1 = fp_sub(fp_sub(s1, s0), c2);
    const int rw = root ? 8 : 0;
    const int k = lane - rw;
    if (lane < rw) word = (u32)root[lane];
    else if (k >= 0 && k < 8) word = fp_msg_word(k < 4 ? c1 : c2, k & 3);
    n = rw + 8;
  } else {
    if (lane < 4) word = sha_bswap(reinterpret_cast<const u32*>(elem)[lane]);
    n = 4;
  }
  warp_absorb(s, n, [&](int k) { return __shfl_sync(FULL_MASK, word, k); });
  u32 d[8];
  warp_digest(s, d);

  if (sums && lane == 0) {
    const fp r = digest_challenge(d);
    fp_store(scal, 0, fp_add(s0, fp_mul(r, fp_add(c1, fp_mul(r, c2)))));
    fp_store(scal, 1, r);
    fp_store(scal, 2, fp_half(r));
    fp_store(coeffs, 0, c1);
    fp_store(coeffs, 1, c2);
  }
  warp_tr_store(s, d, state, digest);
}

// A standalone round keeps its d + 1 evaluations and d + 1 coefficients in
// dynamic shared memory, sized at launch: SC_BYTES_PER_POINT (d + 1) bytes,
// and no static shared memory.  The only cap on d is what a block's shared
// memory holds (mlt_sumcheck_max_degree); every loop over the points strides
// by the block or by the warps, so the threads of a block cap nothing.
#define SC_BYTES_PER_POINT 32
#define SC_THREADS 256

// p(r) = sum_j c[j] r^j for j < n, on one warp: lane l evaluates its run of
// k = ceil(n / 32) coefficients by Horner, then 5 levels (fewer for n < 32)
// of a tree join neighbouring runs, a + b r^(k 2^level); lane 0 holds p(r).
__device__ __forceinline__ fp warp_eval(const uint4* c, int n, fp r) {
  const int lane = threadIdx.x & 31;
  const int k = (n + 31) >> 5;
  const int runs = (n + k - 1) / k;
  fp acc = {0ull, 0ull};
  const int first = lane * k, last = min(first + k, n);
  if (first < n) {
    acc = fp_load(c, last - 1);
#pragma unroll 1
    for (int j = last - 2; j >= first; --j) acc = fp_add(fp_mul(acc, r), fp_load(c, j));
  }
  fp rk = r;  // r^k by squaring, from the top bit of k down
#pragma unroll 1
  for (int bit = 30 - __clz(k); bit >= 0; --bit) {
    rk = fp_mul(rk, rk);
    if ((k >> bit) & 1) rk = fp_mul(rk, r);
  }
#pragma unroll 1
  for (int o = 1; o < runs; o <<= 1) {
    acc = fp_add(acc, fp_mul(fp_shfl_down(acc, o), rk));
    rk = fp_mul(rk, rk);
  }
  return acc;
}

__global__ void __launch_bounds__(SC_THREADS)
    sumcheck_round_scalars_kernel(int* __restrict__ state, const unsigned long long* __restrict__ sums,
                                  const void* __restrict__ vinv, int degree, void* __restrict__ prev,
                                  void* __restrict__ coeffs, void* __restrict__ r_out, int* __restrict__ digest) {
  extern __shared__ uint4 sc_points[];  // ev[0..d], then c[0..d]
  const int n = degree + 1;
  uint4* ev = sc_points;
  uint4* c = sc_points + n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  warp_tr s;
  if (warp == 0) warp_tr_load(s, state);  // in flight while the sums reduce

#pragma unroll 1
  for (int i = tid; i < degree; i += blockDim.x) {
    const fp v = reduce_lane_sums(sums + 4ll * i);
    fp_store(ev, i + 1, v);
    if (i == 0) {
      const fp s0 = fp_sub(fp_load(prev, 0), v);
      fp_store(ev, 0, s0);
      fp_store(c, 0, s0);
    }
  }
  __syncthreads();

#pragma unroll 1
  for (int j = 1 + warp; j < n; j += warps) {
    const uint4* row = reinterpret_cast<const uint4*>(vinv) + (long long)j * n;
    fp acc = {0ull, 0ull};
#pragma unroll 4
    for (int i = lane; i < n; i += 32) acc = fp_add(acc, fp_mul(fp_load(row, i), fp_load(ev, i)));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc = fp_add(acc, fp_shfl_xor(acc, o));
    if (lane == 0) fp_store(c, j, acc);
  }
  __syncthreads();

#pragma unroll 1
  for (int j = tid; j < degree; j += blockDim.x) reinterpret_cast<uint4*>(coeffs)[j] = c[j + 1];
  if (warp != 0) return;
  const u32* cw = reinterpret_cast<const u32*>(c + 1);  // c1..cd as little-endian limbs
  warp_absorb(s, 4 * degree, [&](int k) { return sha_bswap(cw[k]); });
  u32 d[8];
  warp_digest(s, d);
  const fp r = digest_challenge(d);
  const fp pr = warp_eval(c, n, r);
  if (lane == 0) {
    fp_store(prev, 0, pr);
    fp_store(r_out, 0, r);
  }
  warp_tr_store(s, d, state, digest);
}

extern "C" int mlt_round_scalars(void* state, const void* root, const void* elem, const void* sums,
                                 void* scal, void* coeffs, void* digest, int device,
                                 cudaStream_t stream) {
  device_guard guard(device);
  round_scalars_kernel<<<1, 32, 0, stream>>>(
      static_cast<int*>(state), static_cast<const int*>(root), elem,
      static_cast<const unsigned long long*>(sums), scal, coeffs, static_cast<int*>(digest));
  return (int)cudaGetLastError();
}

// The largest total degree whose round fits in one block's shared memory on
// `device` (the opt-in maximum, less the kernel's static shared memory), or
// -1 if the card cannot be asked.
extern "C" int mlt_sumcheck_max_degree(int device) {
  device_guard guard(device);
  int optin = 0;
  cudaFuncAttributes attr;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, sumcheck_round_scalars_kernel) != cudaSuccess)
    return -1;
  return (int)((optin - (long long)attr.sharedSizeBytes) / SC_BYTES_PER_POINT) - 1;
}

extern "C" int mlt_sumcheck_round_scalars(void* state, const void* sums, const void* vinv, int degree,
                                          void* prev, void* coeffs, void* r_out, void* digest, int device,
                                          cudaStream_t stream) {
  if (degree < 1) return (int)cudaErrorInvalidValue;
  device_guard guard(device);
  const size_t bytes = (size_t)SC_BYTES_PER_POINT * (degree + 1);
  // past the default 48 KiB of a block, the kernel must be allowed more; the
  // card refuses what it lacks
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(sumcheck_round_scalars_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  sumcheck_round_scalars_kernel<<<1, SC_THREADS, bytes, stream>>>(
      static_cast<int*>(state), static_cast<const unsigned long long*>(sums), vinv, degree, prev, coeffs, r_out,
      static_cast<int*>(digest));
  return (int)cudaGetLastError();
}
