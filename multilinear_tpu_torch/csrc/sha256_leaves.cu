// Merkle leaf digests of field-element payloads read where they lie.
//   cols: B columns of n field elements (16 bytes: four little-endian
//         limbs); element i of column b is the uint4 at
//         b * col_stride + i * elem_stride
//   out:  (n, 8) digest words; leaf i = SHA-256 of the B elements' 16
//         little-endian bytes in column order
// Replaces, for the Merkle leaf levels, the TPU kernel `_sha_flat` /
// `sha256_words` of the JAX package's sha256_pallas.py together with the
// tensor code that fed it: a byte swap of every limb (a flip and a copy) and
// a concatenation of the B columns into contiguous messages, each a full
// read and write of the payload before the hash read it a third time.
//
// Bound on an H100: integer operations (one compression per four elements;
// the payload is read once, 16 bytes a thread and element, neighbouring
// threads on neighbouring addresses, where the message layout put them
// 32-320 bytes apart).  A message block is exactly four elements, so a
// thread loads up to four uint4, swaps their bytes in registers and
// compresses.  B = 2 (the pair leaves of a codeword: one block whose last
// eight words are constants) and B = 20 (the batch tree of ten codewords:
// five blocks, then a block of nothing but padding, run from a table) are
// compile-time cases; any other B takes the same code with a run-time count.
#include "launch.cuh"
#include "sha256.cuh"

template <int B>
__global__ void sha256_leaves_kernel(const uint4* __restrict__ cols, long long col_stride,
                                     long long elem_stride, u32* __restrict__ out,
                                     long long n, int n_cols_rt) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int nb = B ? B : n_cols_rt;
  const int nw = 4 * nb;
  const int total = ((nw + 3 + 15) / 16) * 16;   // words after padding
  const bool table_tail = nb == 4 || nb == 20;   // last block: padding only
  const int n_blocks = (table_tail ? nw : total) / 16;
  const uint4* mine = cols + i * elem_stride;
  u32 st[8];
  sha256_init(st);
  // one block (B = 2) unrolls, so that its padding words are constants; more
  // blocks stay a loop, which keeps the code inside the instruction cache
#pragma unroll(B == 2 ? 2 : 1)
  for (int blk = 0; blk < n_blocks; ++blk) {
    u32 w[16];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int e = 4 * blk + g;
      if (e < nb) {
        uint4 q = mine[e * col_stride];
        w[4 * g] = sha_bswap(q.x);
        w[4 * g + 1] = sha_bswap(q.y);
        w[4 * g + 2] = sha_bswap(q.z);
        w[4 * g + 3] = sha_bswap(q.w);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) w[4 * g + j] = sha_pad_word(4 * e + j, nw, total);
      }
    }
    sha256_compress(st, w);
  }
  if (nb == 4) sha256_compress_kw(st, SHA_KW_PAD64);
  else if (nb == 20) sha256_compress_kw(st, SHA_KW_PAD320);
  sha_store_digest(out, i, st);
}

extern "C" int mlt_sha256_leaves(const void* cols, long long col_stride, long long elem_stride,
                                 void* out, long long n, int n_cols, int device,
                                 cudaStream_t stream) {
  device_guard guard(device);
  const int threads = 128;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  const uint4* c = static_cast<const uint4*>(cols);
  u32* o = static_cast<u32*>(out);
  if (n_cols == 2)
    sha256_leaves_kernel<2><<<blocks, threads, 0, stream>>>(c, col_stride, elem_stride, o, n, 2);
  else if (n_cols == 20)
    sha256_leaves_kernel<20><<<blocks, threads, 0, stream>>>(c, col_stride, elem_stride, o, n, 20);
  else
    sha256_leaves_kernel<0><<<blocks, threads, 0, stream>>>(c, col_stride, elem_stride, o, n,
                                                            n_cols);
  return (int)cudaGetLastError();
}
