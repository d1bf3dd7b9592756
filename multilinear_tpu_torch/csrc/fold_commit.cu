// One FRI fold and the Merkle leaf level of the folded codeword, fused.
//   code: (m) elements, m a multiple of 4;  h = m/2, q = m/4
//   nxt[j]  = half(a + b) + (a - b) * tw[j * stride] * rh,
//             a = code[j], b = code[j + h]            for j < h
//   digs[i] = SHA-256(le_bytes(nxt[i]) || le_bytes(nxt[i + q]))   for i < q
// rh = r/2 mod p is the fold challenge times 2^-1, read from device memory
// (fold.cuh).
//
// Replaces the TPU kernel `_fold_commit_flat` / `fold_commit_leaves` of the
// JAX package's field/pallas_ops.py.
//
// Bound on an H100, per leaf: 64 bytes of codeword and 32 of twiddles read,
// 32 bytes of folded pair and 32 of digest written, against four field
// multiplies and one SHA-256 compression (~2,000 32-bit integer operations).
// The compression makes the kernel operation-bound.  One thread per leaf:
// it folds both elements of its pair, writes them, and hashes the 32-byte
// message while both are still in registers, so the folded codeword is not
// read back from device memory for the leaf level.
#include "fold.cuh"
#include "sha256.cuh"

__global__ void fold_commit_kernel(const void* __restrict__ code, const void* __restrict__ tw,
                                   void* __restrict__ nxt, u32* __restrict__ digs,
                                   long long m, long long stride, const void* __restrict__ rh_ptr) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long q = m / 4, h = m / 2;
  if (i >= q) return;
  fp rh = fold_rh(rh_ptr);
  fp x = fold_one(code, tw, i, h, stride, rh);
  fp y = fold_one(code, tw, i + q, h, stride, rh);
  fp_store(nxt, i, x);
  fp_store(nxt, i + q, y);
  u32 w[16];
  w[0] = sha_bswap((u32)x.lo);
  w[1] = sha_bswap((u32)(x.lo >> 32));
  w[2] = sha_bswap((u32)x.hi);
  w[3] = sha_bswap((u32)(x.hi >> 32));
  w[4] = sha_bswap((u32)y.lo);
  w[5] = sha_bswap((u32)(y.lo >> 32));
  w[6] = sha_bswap((u32)y.hi);
  w[7] = sha_bswap((u32)(y.hi >> 32));
  w[8] = 0x80000000u;
#pragma unroll
  for (int j = 9; j < 15; ++j) w[j] = 0;
  w[15] = 256;  // message length in bits
  u32 st[8];
  sha256_init(st);
  sha256_compress(st, w);
  uint4* o = reinterpret_cast<uint4*>(digs + i * 8);
  o[0] = make_uint4(st[0], st[1], st[2], st[3]);
  o[1] = make_uint4(st[4], st[5], st[6], st[7]);
}

extern "C" int mlt_fold_commit(const void* code, const void* tw, void* nxt, void* digs,
                               long long m, long long stride, const void* rh, int device,
                               cudaStream_t stream) {
  device_guard guard(device);
  const int threads = 128;
  long long q = m / 4;
  unsigned blocks = (unsigned)((q + threads - 1) / threads);
  fold_commit_kernel<<<blocks, threads, 0, stream>>>(code, tw, nxt, static_cast<u32*>(digs), m,
                                                     stride, rh);
  return (int)cudaGetLastError();
}
