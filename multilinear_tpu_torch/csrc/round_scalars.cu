// The Fiat-Shamir scalars of one sumcheck + FRI round, on the card: one
// launch of one thread per round, so that the rounds of a prove never wait
// for the host.
//
// Replaces the jnp scalar tail `pcs._round_scalars` of the JAX package
// (multilinear_tpu/pcs.py:84-115) and the root absorb of `_pcs_round_body`
// (:148).  Neither is a Pallas kernel; the TPU runs them inside the round's
// XLA program.
//
// The transcript state is 26 int32 words in device memory
// (device_transcript.py): 8 SHA-256 chaining words, the 64-byte partial
// block as 16 big-endian words (bytes at or past the fill are zero), the fill
// in bytes and the total length in bytes.  Absorbs are byte-granular, so any
// midstate the host exports can hop here.
//
// A round launch (sums given):
//   1. absorbs the previous tree's root, if one is pending (root: 8 digest
//      words; their big-endian bytes are the root bytes);
//   2. reduces the two unreduced int64 limb sums s(1), s(2) mod p;
//   3. s0 = prev - s1, c2 = (s2 - 2 s1 + s0) / 2, c1 = s1 - s0 - c2;
//   4. absorbs c1 and c2 as 16 little-endian bytes each (Q9) and draws
//      r = the first 16 digest bytes, little-endian, mod p;
//   5. writes c1, c2 into `coeffs` (2 elements: the round's slot);
//   6. writes prev' = s0 + r (c1 + r c2), r and rh = r / 2 into scal[0..2];
//   7. writes the digest and the new state.
// A last-element launch (elem given, no sums) absorbs elem[0] - the element
// every entry of the last fold's codeword must equal - and writes the digest.
//
// A standalone sumcheck round (sumcheck_round_scalars_kernel, a second
// entry of this file) has no roots and any total degree d >= 1 whose
// evaluations and coefficients fit in a block's shared memory:
//   1. reduces the d unreduced int64 limb sums s(1)..s(d) mod p;
//   2. s0 = prev - s1;
//   3. the d + 1 coefficients c = V^-1 (s0, s1, ..., sd), V^-1 read from a
//      (d+1, d+1) table of field elements in device memory; its row 0 is
//      e0 (c0 = p(0) = s0), so only rows 1..d are multiplied;
//   4. absorbs c1..cd as 16 little-endian bytes each (Q7, Q9), each as it
//      is made, draws r;
//   5. writes c1..cd into `coeffs` (the round's slot), prev' = p(r) (Horner)
//      over `prev`, and r into `r_out` (the round's slot of the randoms,
//      where the table fold reads it);
//   6. writes the digest and the new state.
// It replaces the jnp scalar tail of `_sc_round_body` in the JAX package
// (multilinear_tpu/sumcheck.py:352-372), which the TPU runs inside the
// round's XLA program, not as a Pallas kernel.
//
// Bound on an H100: one thread, a chain of dependent integer instructions
// (SHA-256 compressions, field multiplies): the issue rate of one warp, about
// one instruction a clock.  The absorb loop runs byte by byte through shared
// memory; every compression of a launch is inlined at one of two sites
// (absorb, digest), so the machine code stays small.
#include "field.cuh"
#include "sha256.cuh"

struct tr_state {
  u32 st[8];
  u32 buf[16];  // big-endian words of the partial block; zero at and past `fill`
  u32 fill;     // bytes in the partial block, 0..63
  u32 total;    // bytes absorbed in all
};

// Absorb `len` bytes: byte p of a block is byte p ^ 3 of the little-endian
// words that hold it big-endian.
__device__ __forceinline__ void tr_absorb(tr_state& s, const unsigned char* msg, int len) {
  unsigned char* bytes = reinterpret_cast<unsigned char*>(s.buf);
#pragma unroll 1
  for (int i = 0; i < len; ++i) {
    bytes[s.fill ^ 3] = msg[i];
    s.total += 1;
    if (++s.fill == 64) {
      u32 w[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        w[j] = s.buf[j];
        s.buf[j] = 0;
      }
      sha256_compress(s.st, w);
      s.fill = 0;
    }
  }
}

// Digest of a finalized clone (the state does not advance, quirk Q1): the
// 0x80 byte after the fill, zeros, the 64-bit bit length; two blocks when
// the fill leaves no room for the length.
__device__ __forceinline__ void tr_digest(const tr_state& s, u32 d[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) d[j] = s.st[j];
  const u32 fill = s.fill;
  const unsigned long long bits = 8ull * s.total;
  const int nblocks = fill <= 55 ? 1 : 2;
#pragma unroll 1
  for (int blk = 0; blk < nblocks; ++blk) {
    u32 w[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      u32 v = 0;
      if (blk == 0) {
        v = s.buf[j];
        if (j == (int)(fill >> 2)) v |= 0x80000000u >> (8 * (fill & 3));
      }
      if (blk == nblocks - 1) {
        if (j == 14) v = (u32)(bits >> 32);
        if (j == 15) v = (u32)bits;
      }
      w[j] = v;
    }
    sha256_compress(d, w);
  }
}

// sum_i lanes[i] * 2^(32 i) mod p, for four unsigned 64-bit lanes (the
// int64 limb sums of ops.sum_limbs: each below 2^63).
__device__ __forceinline__ fp reduce_lane_sums(const unsigned long long* lanes) {
  const u64 m32 = 0xFFFFFFFFull;
  u64 acc[5];
  acc[0] = lanes[0] & m32;
  acc[1] = (lanes[0] >> 32) + (lanes[1] & m32);
  acc[2] = (lanes[1] >> 32) + (lanes[2] & m32);
  acc[3] = (lanes[2] >> 32) + (lanes[3] & m32);
  acc[4] = lanes[3] >> 32;
  u32 w[5];
  u64 c = 0;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    u64 v = acc[i] + c;
    w[i] = (u32)v;
    c = v >> 32;
  }
  // value = lo + 2^128 * hi with hi < 2^34; 2^128 = K (mod p), K * hi < 2^80
  fp t;
  const u64 hi = (u64)w[4] | (c << 32);
  const u64 klo = FP_K * hi, khi = __umul64hi(FP_K, hi);
  const u64 lo_hi = ((u64)w[3] << 32) | w[2];
  t.lo = (((u64)w[1] << 32) | w[0]) + klo;
  t.hi = lo_hi + khi + (u64)(t.lo < klo);
  if (t.hi < lo_hi) {  // a carry out of 128 bits: t < 2^80, and 2^128 = K
    fp u;
    fp_add_k(t, u);
    t = u;
  }
  return fp_canon(t, 0ull);
}

__device__ __forceinline__ void put_fp(unsigned char* msg, int& len, fp v) {
#pragma unroll
  for (int i = 0; i < 8; ++i) msg[len + i] = (unsigned char)(v.lo >> (8 * i));
#pragma unroll
  for (int i = 0; i < 8; ++i) msg[len + 8 + i] = (unsigned char)(v.hi >> (8 * i));
  len += 16;
}

__global__ void round_scalars_kernel(int* __restrict__ state, const int* __restrict__ root,
                                     const void* __restrict__ elem,
                                     const unsigned long long* __restrict__ sums,
                                     void* __restrict__ scal, void* __restrict__ coeffs,
                                     int* __restrict__ digest) {
  __shared__ tr_state s;
  __shared__ unsigned char msg[64];
#pragma unroll
  for (int j = 0; j < 8; ++j) s.st[j] = (u32)state[j];
#pragma unroll
  for (int j = 0; j < 16; ++j) s.buf[j] = (u32)state[8 + j];
  s.fill = (u32)state[24];
  s.total = (u32)state[25];

  int len = 0;
  fp s0, c1, c2;
  if (sums) {
    if (root) {
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const u32 word = (u32)root[w];
#pragma unroll
        for (int q = 0; q < 4; ++q) msg[len + 4 * w + q] = (unsigned char)(word >> (24 - 8 * q));
      }
      len = 32;
    }
    const fp s1 = reduce_lane_sums(sums), s2 = reduce_lane_sums(sums + 4);
    s0 = fp_sub(fp_load(scal, 0), s1);
    c2 = fp_half(fp_sub(fp_add(s2, s0), fp_add(s1, s1)));
    c1 = fp_sub(fp_sub(s1, s0), c2);
    put_fp(msg, len, c1);
    put_fp(msg, len, c2);
  } else {
    put_fp(msg, len, fp_load(elem, 0));
  }
  tr_absorb(s, msg, len);
  u32 d[8];
  tr_digest(s, d);

  if (sums) {
    fp r;  // the first 16 digest bytes as a little-endian u128: < 2^128 < 2p
    r.lo = ((u64)sha_bswap(d[1]) << 32) | sha_bswap(d[0]);
    r.hi = ((u64)sha_bswap(d[3]) << 32) | sha_bswap(d[2]);
    r = fp_canon(r, 0ull);
    fp_store(scal, 0, fp_add(s0, fp_mul(r, fp_add(c1, fp_mul(r, c2)))));
    fp_store(scal, 1, r);
    fp_store(scal, 2, fp_half(r));
    fp_store(coeffs, 0, c1);
    fp_store(coeffs, 1, c2);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    digest[j] = (int)d[j];
    state[j] = (int)s.st[j];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) state[8 + j] = (int)s.buf[j];
  state[24] = (int)s.fill;
  state[25] = (int)s.total;
}

extern "C" int mlt_round_scalars(void* state, const void* root, const void* elem, const void* sums,
                                 void* scal, void* coeffs, void* digest, int device,
                                 cudaStream_t stream) {
  device_guard guard(device);
  round_scalars_kernel<<<1, 1, 0, stream>>>(
      static_cast<int*>(state), static_cast<const int*>(root), elem,
      static_cast<const unsigned long long*>(sums), scal, coeffs, static_cast<int*>(digest));
  return (int)cudaGetLastError();
}

// A standalone round keeps its d + 1 evaluations and d + 1 coefficients in
// dynamic shared memory, sized at launch: SC_BYTES_PER_POINT (d + 1) bytes.
// Each coefficient is absorbed as it is made, through a 16-byte buffer.  The
// only cap on d is what a block's shared memory holds (mlt_sumcheck_max_degree).
#define SC_BYTES_PER_POINT 32

__global__ void sumcheck_round_scalars_kernel(int* __restrict__ state,
                                              const unsigned long long* __restrict__ sums,
                                              const void* __restrict__ vinv, int degree,
                                              void* __restrict__ prev, void* __restrict__ coeffs,
                                              void* __restrict__ r_out, int* __restrict__ digest) {
  __shared__ tr_state s;
  __shared__ unsigned char msg[16];
  extern __shared__ uint4 sc_points[];  // ev[0..d], then c[0..d]
#pragma unroll
  for (int j = 0; j < 8; ++j) s.st[j] = (u32)state[j];
#pragma unroll
  for (int j = 0; j < 16; ++j) s.buf[j] = (u32)state[8 + j];
  s.fill = (u32)state[24];
  s.total = (u32)state[25];

  const int n = degree + 1;
  uint4* ev = sc_points;
  uint4* c = sc_points + n;
#pragma unroll 1
  for (int i = 1; i < n; ++i) fp_store(ev, i, reduce_lane_sums(sums + 4 * (i - 1)));
  const fp s0 = fp_sub(fp_load(prev, 0), fp_load(ev, 1));
  fp_store(ev, 0, s0);
  fp_store(c, 0, s0);
#pragma unroll 1
  for (int j = 1; j < n; ++j) {
    fp acc = fp_mul(fp_load(vinv, (long long)j * n), s0);
#pragma unroll 1
    for (int i = 1; i < n; ++i) acc = fp_add(acc, fp_mul(fp_load(vinv, (long long)j * n + i), fp_load(ev, i)));
    fp_store(c, j, acc);
    int len = 0;
    put_fp(msg, len, acc);
    tr_absorb(s, msg, len);
  }
  u32 d[8];
  tr_digest(s, d);

  fp r;  // the first 16 digest bytes as a little-endian u128: < 2^128 < 2p
  r.lo = ((u64)sha_bswap(d[1]) << 32) | sha_bswap(d[0]);
  r.hi = ((u64)sha_bswap(d[3]) << 32) | sha_bswap(d[2]);
  r = fp_canon(r, 0ull);
  fp acc = fp_load(c, n - 1);
#pragma unroll 1
  for (int j = n - 2; j >= 0; --j) acc = fp_add(fp_mul(acc, r), fp_load(c, j));
  fp_store(prev, 0, acc);
  fp_store(r_out, 0, r);
#pragma unroll 1
  for (int j = 1; j < n; ++j) fp_store(coeffs, j - 1, fp_load(c, j));
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    digest[j] = (int)d[j];
    state[j] = (int)s.st[j];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) state[8 + j] = (int)s.buf[j];
  state[24] = (int)s.fill;
  state[25] = (int)s.total;
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
  // past the default 48 KiB of a block (with room for the static shared
  // memory), the kernel must be allowed more; the card refuses what it lacks
  if (bytes > 47 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(sumcheck_round_scalars_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  sumcheck_round_scalars_kernel<<<1, 1, bytes, stream>>>(
      static_cast<int*>(state), static_cast<const unsigned long long*>(sums), vinv, degree, prev,
      coeffs, r_out, static_cast<int*>(digest));
  return (int)cudaGetLastError();
}
