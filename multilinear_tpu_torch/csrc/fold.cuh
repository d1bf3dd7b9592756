// The FRI fold of one output element, shared by the standalone fold kernel
// (fold.cu) and the fused fold + leaf-hash kernel (fold_commit.cu):
//   nxt[j] = half(a + b) + (a - b) * tw[j * stride] * rh,
//            a = code[j], b = code[j + h]
// rh = r/2 mod p is the fold challenge times 2^-1.  It lies in device
// memory, where the round's Fiat-Shamir kernel (round_scalars.cu) wrote it:
// every thread of a fold reads the same 16 bytes (fold_rh), so a round needs
// no copy to the host and back between drawing the challenge and folding.
#pragma once
#include "field.cuh"

__device__ __forceinline__ fp fold_rh(const void* rh) { return fp_load(rh, 0); }

__device__ __forceinline__ fp fold_one(const void* code, const void* tw, long long j,
                                       long long h, long long stride, fp rh) {
  fp a = fp_load(code, j);
  fp b = fp_load(code, j + h);
  fp t = fp_load(tw, j * stride);
  fp even = fp_half(fp_add(a, b));
  fp odd = fp_mul(fp_mul(fp_sub(a, b), t), rh);
  return fp_add(even, odd);
}
