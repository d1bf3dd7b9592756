// GF(p) arithmetic for one element per thread, p = 2^128 - 45*2^40 + 1.
//
// An element is 16 bytes in memory: four little-endian 32-bit limbs, which a
// thread loads as one uint4 and holds as two 64-bit halves.  The modulus is
// sparse: 2^128 = K (mod p) with K = 45*2^40 - 1, so a value
// lo + 2^128 * hi reduces to lo + K * hi.  fp_mul takes the full 128x128
// product with 64-bit multiplies (mul.lo / mul.hi) and folds the high half
// twice.  All functions take and return canonical values in [0, p).
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

typedef unsigned long long u64;
typedef unsigned int u32;

struct fp {
  u64 lo, hi;
};

#define FP_K ((45ull << 40) - 1ull)        // 2^128 mod p
#define FP_HALF_LO (1ull - (45ull << 39))  // (p+1)/2, low 64 bits
#define FP_HALF_HI 0x7FFFFFFFFFFFFFFFull   // (p+1)/2, high 64 bits

__device__ __forceinline__ fp fp_load(const void* base, long long i) {
  uint4 w = reinterpret_cast<const uint4*>(base)[i];
  fp r;
  r.lo = ((u64)w.y << 32) | w.x;
  r.hi = ((u64)w.w << 32) | w.z;
  return r;
}

__device__ __forceinline__ void fp_store(void* base, long long i, fp v) {
  uint4 w;
  w.x = (u32)v.lo;
  w.y = (u32)(v.lo >> 32);
  w.z = (u32)v.hi;
  w.w = (u32)(v.hi >> 32);
  reinterpret_cast<uint4*>(base)[i] = w;
}

// Additions and subtractions run as carry chains (add.cc / addc, sub.cc /
// subc): four 32-bit instructions for 128 bits and one more for the carry
// out, where compares and selects of 64-bit halves take about twice as many.
// A host compiler (the sources also build without nvcc for checks of the
// index arithmetic) takes the plain C forms.

// v + K over 128 bits; returns the carry out of bit 127.
__device__ __forceinline__ u64 fp_add_k(fp v, fp& out) {
  u64 c;
#ifdef __CUDA_ARCH__
  asm("add.cc.u64 %0, %3, %5;\n\t"
      "addc.cc.u64 %1, %4, 0;\n\t"
      "addc.u64 %2, 0, 0;"
      : "=l"(out.lo), "=l"(out.hi), "=l"(c)
      : "l"(v.lo), "l"(v.hi), "l"(FP_K));
#else
  out.lo = v.lo + FP_K;
  u64 c0 = out.lo < v.lo;
  out.hi = v.hi + c0;
  c = out.hi < c0;
#endif
  return c;
}

// carry * 2^128 + v, known to be < 2p, into [0, p): the value is >= p
// exactly when adding K carries out of 128 bits, and then value - p is
// the low 128 bits of value + K.
__device__ __forceinline__ fp fp_canon(fp v, u64 carry) {
  fp t;
  u64 c = fp_add_k(v, t);
  return (carry | c) ? t : v;
}

__device__ __forceinline__ fp fp_add(fp a, fp b) {
  fp s;
  u64 c;
#ifdef __CUDA_ARCH__
  asm("add.cc.u64 %0, %3, %5;\n\t"
      "addc.cc.u64 %1, %4, %6;\n\t"
      "addc.u64 %2, 0, 0;"
      : "=l"(s.lo), "=l"(s.hi), "=l"(c)
      : "l"(a.lo), "l"(a.hi), "l"(b.lo), "l"(b.hi));
#else
  s.lo = a.lo + b.lo;
  u64 c0 = s.lo < a.lo;
  u64 h = a.hi + b.hi;
  c = h < a.hi;
  s.hi = h + c0;
  c |= s.hi < c0;
#endif
  return fp_canon(s, c);
}

__device__ __forceinline__ fp fp_sub(fp a, fp b) {
  // a < b: the true value is d - 2^128, and adding p gives d - K
#ifdef __CUDA_ARCH__
  fp d, e;
  u64 m;  // all ones when the subtraction borrowed
  asm("sub.cc.u64 %0, %3, %5;\n\t"
      "subc.cc.u64 %1, %4, %6;\n\t"
      "subc.u64 %2, 0, 0;"
      : "=l"(d.lo), "=l"(d.hi), "=l"(m)
      : "l"(a.lo), "l"(a.hi), "l"(b.lo), "l"(b.hi));
  asm("sub.cc.u64 %0, %2, %4;\n\t"
      "subc.u64 %1, %3, 0;"
      : "=l"(e.lo), "=l"(e.hi)
      : "l"(d.lo), "l"(d.hi), "l"(FP_K & m));
  return e;
#else
  fp d;
  d.lo = a.lo - b.lo;
  u64 b0 = a.lo < b.lo;
  u64 h = a.hi - b.hi;
  u64 b1 = a.hi < b.hi;
  d.hi = h - b0;
  b1 |= h < b0;
  fp e;
  e.lo = d.lo - FP_K;
  e.hi = d.hi - (u64)(d.lo < FP_K);
  return b1 ? e : d;
#endif
}

// a / 2: a >> 1 for even a, (a >> 1) + (p+1)/2 for odd a (exact, < p).
__device__ __forceinline__ fp fp_half(fp a) {
  u64 odd = a.lo & 1ull;
  fp s;
  s.lo = (a.lo >> 1) | (a.hi << 63);
  s.hi = a.hi >> 1;
  u64 add_lo = odd ? FP_HALF_LO : 0ull;
  u64 add_hi = odd ? FP_HALF_HI : 0ull;
  fp r;
  r.lo = s.lo + add_lo;
  r.hi = s.hi + add_hi + (u64)(r.lo < s.lo);
  return r;
}

__device__ __forceinline__ fp fp_mul(fp a, fp b) {
  // 256-bit product t0 + t1*2^64 + t2*2^128 + t3*2^192
  u64 l00 = a.lo * b.lo, h00 = __umul64hi(a.lo, b.lo);
  u64 l01 = a.lo * b.hi, h01 = __umul64hi(a.lo, b.hi);
  u64 l10 = a.hi * b.lo, h10 = __umul64hi(a.hi, b.lo);
  u64 l11 = a.hi * b.hi, h11 = __umul64hi(a.hi, b.hi);
  u64 t0 = l00;
  u64 t1 = h00 + l01;
  u64 c1 = t1 < l01;
  t1 += l10;
  c1 += t1 < l10;
  u64 t2 = h01 + h10;
  u64 c2 = t2 < h10;
  t2 += l11;
  c2 += t2 < l11;
  t2 += c1;
  c2 += t2 < c1;
  u64 t3 = h11 + c2;  // cannot overflow: the product is < 2^256

  // first fold: (t0, t1) + K * (t2, t3) = r0 + r1*2^64 + r2*2^128, r2 < 2^47
  u64 m0 = FP_K * t2;
  u64 m1 = __umul64hi(FP_K, t2);
  u64 k3 = FP_K * t3;
  u64 m2 = __umul64hi(FP_K, t3);
  m1 += k3;
  m2 += m1 < k3;
  u64 r0 = t0 + m0;
  u64 c = r0 < t0;
  u64 r1 = t1 + m1;
  u64 d = r1 < t1;
  r1 += c;
  d += r1 < c;
  u64 r2 = m2 + d;

  // second fold: (r0, r1) + K * r2, K * r2 < 2^93; the carry is 0 or 1
  u64 n0 = FP_K * r2;
  u64 n1 = __umul64hi(FP_K, r2);
  fp s;
  s.lo = r0 + n0;
  c = s.lo < r0;
  s.hi = r1 + n1;
  d = s.hi < r1;
  s.hi += c;
  d += s.hi < c;
  // a carry means the low part is < 2^93, so adding K once more cannot carry
  u64 kadd = d ? FP_K : 0ull;
  u64 lo2 = s.lo + kadd;
  s.hi += (u64)(lo2 < s.lo);
  s.lo = lo2;
  return fp_canon(s, 0ull);
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
