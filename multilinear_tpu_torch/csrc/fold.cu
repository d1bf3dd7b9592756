// One FRI fold, without the Merkle leaf level:
//   code: (m) elements, m even;  h = m/2
//   nxt[j] = half(a + b) + (a - b) * tw[j * stride] * rh,
//            a = code[j], b = code[j + h]            for j < h
//
// Replaces the TPU kernel `_fold_flat` / `fold_codeword` of the JAX package's
// field/pallas_ops.py.  Callers: the first fold of the batched protocol
// (whose result is committed as an ordinary pair tree afterwards) and the
// last fold of every chain, which commits nothing.
//
// rh = r/2 mod p: a (4,) field element in device memory (fold.cuh).
//
// Bound on an H100, per output element: 32 bytes of codeword and 16 of
// twiddle read, 16 written, against two field multiplies (~250 32-bit
// integer operations): memory-bound.  One thread per output element; the two
// codeword loads and the store are contiguous across a warp, the twiddle
// read is strided by 2^k like the fused kernel's.  The fold body is the one
// of fold_commit.cu (fold.cuh).
#include "fold.cuh"

__global__ void fold_kernel(const void* __restrict__ code, const void* __restrict__ tw,
                            void* __restrict__ nxt, long long h, long long stride,
                            const void* __restrict__ rh_ptr) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= h) return;
  fp_store(nxt, j, fold_one(code, tw, j, h, stride, fold_rh(rh_ptr)));
}

extern "C" int mlt_fold(const void* code, const void* tw, void* nxt, long long m,
                        long long stride, const void* rh, int device, cudaStream_t stream) {
  device_guard guard(device);
  const int threads = 256;
  long long h = m / 2;
  unsigned blocks = (unsigned)((h + threads - 1) / threads);
  fold_kernel<<<blocks, threads, 0, stream>>>(code, tw, nxt, h, stride, rh);
  return (int)cudaGetLastError();
}
