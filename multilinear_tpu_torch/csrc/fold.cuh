// The FRI fold of one output element, shared by the standalone fold kernel
// (fold.cu) and the fused fold + leaf-hash kernel (fold_commit.cu):
//   nxt[j] = half(a + b) + (a - b) * tw[j * stride] * rh,
//            a = code[j], b = code[j + h]
// rh = r/2 mod p is the fold challenge times 2^-1, computed once on the
// host and passed to the kernel by value.
#pragma once
#include "field.cuh"

__device__ __forceinline__ fp fold_one(const void* code, const void* tw, long long j,
                                       long long h, long long stride, fp rh) {
  fp a = fp_load(code, j);
  fp b = fp_load(code, j + h);
  fp t = fp_load(tw, j * stride);
  fp even = fp_half(fp_add(a, b));
  fp odd = fp_mul(fp_mul(fp_sub(a, b), t), rh);
  return fp_add(even, odd);
}
