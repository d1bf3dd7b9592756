// The first port of the rounds' Fiat-Shamir scalars, one thread a launch,
// replaced by round_scalars.cu (a warp for a PCS round, a block for a
// standalone sumcheck round) and kept compiled under symbols of its own for
// one use: chip_smoke.py's `routes` phase times it beside the kernels that
// replaced it (previous_routes.round_scalars_one_thread,
// previous_routes.sumcheck_round_scalars_one_thread).  No prover path
// launches it.
//
// Both entries compute what round_scalars.cu's entries compute, on one
// thread: the lane sums reduced one after another, the rows of V^-1 as
// d (d + 1) dependent multiplies whose operands are scalar loads from device
// memory, each coefficient absorbed byte by byte through shared memory,
// p(r) by Horner.  The chain of dependent instructions bounds it: the issue
// rate of one thread, about one instruction a clock, and less where a load
// from device memory sits on the chain.
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

__device__ __forceinline__ void put_fp(unsigned char* msg, int& len, fp v) {
#pragma unroll
  for (int i = 0; i < 8; ++i) msg[len + i] = (unsigned char)(v.lo >> (8 * i));
#pragma unroll
  for (int i = 0; i < 8; ++i) msg[len + 8 + i] = (unsigned char)(v.hi >> (8 * i));
  len += 16;
}

__global__ void round_scalars_one_thread_kernel(int* __restrict__ state, const int* __restrict__ root,
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

extern "C" int mlt_round_scalars_one_thread(void* state, const void* root, const void* elem, const void* sums,
                                 void* scal, void* coeffs, void* digest, int device,
                                 cudaStream_t stream) {
  device_guard guard(device);
  round_scalars_one_thread_kernel<<<1, 1, 0, stream>>>(
      static_cast<int*>(state), static_cast<const int*>(root), elem,
      static_cast<const unsigned long long*>(sums), scal, coeffs, static_cast<int*>(digest));
  return (int)cudaGetLastError();
}

// A standalone round keeps its d + 1 evaluations and d + 1 coefficients in
// dynamic shared memory, sized at launch: SC_BYTES_PER_POINT (d + 1) bytes.
// Each coefficient is absorbed as it is made, through a 16-byte buffer.
#define SC_BYTES_PER_POINT 32

__global__ void sumcheck_round_scalars_one_thread_kernel(int* __restrict__ state,
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

extern "C" int mlt_sumcheck_round_scalars_one_thread(void* state, const void* sums, const void* vinv, int degree,
                                          void* prev, void* coeffs, void* r_out, void* digest, int device,
                                          cudaStream_t stream) {
  if (degree < 1) return (int)cudaErrorInvalidValue;
  device_guard guard(device);
  const size_t bytes = (size_t)SC_BYTES_PER_POINT * (degree + 1);
  // past the default 48 KiB of a block (with room for the static shared
  // memory), the kernel must be allowed more; the card refuses what it lacks
  if (bytes > 47 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(sumcheck_round_scalars_one_thread_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  sumcheck_round_scalars_one_thread_kernel<<<1, 1, bytes, stream>>>(
      static_cast<int*>(state), static_cast<const unsigned long long*>(sums), vinv, degree, prev,
      coeffs, r_out, static_cast<int*>(digest));
  return (int)cudaGetLastError();
}
