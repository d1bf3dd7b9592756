// The message-layout SHA-256 kernel that sha256_words.cu, sha256_leaves.cu
// and merkle_levels.cu replaced.  Nothing on the prover's path calls it: it
// stays compiled, under its first symbol, only for the smoke script's
// `routes` phase, which times the replaced route beside the new kernels.
//
// SHA-256 of N equal-length messages, one message per thread.
//   msg: (N, n_words) big-endian 32-bit words, each message contiguous
//   out: (N, 8) digest words
// The padding (0x80 byte, zeros, 64-bit bit length) is built in the kernel,
// over as many 64-byte blocks as the length needs.
//
// Replaces the TPU kernel `_sha_flat` / `sha256_words` of the JAX package's
// sha256_pallas.py.
//
// Bound on an H100: a Merkle inner node (n_words = 16) reads 64 bytes and
// writes 32, and runs two compressions of 64 rounds, ~3,500 32-bit integer
// operations; a 32-byte pair leaf (n_words = 8) runs one.  At the card's
// int32 rate the operations take several times longer than the bytes, so
// the kernel is operation-bound: the rounds are fully unrolled with the
// message schedule in registers, and the widths the Merkle trees of single
// codewords use (8 and 16 words) are compile-time constants so that the
// padding folds away.  Any other width - the batch tree's 80-word leaves,
// 2 * 10 field elements - takes the run-time branch: scalar loads a whole
// message apart across threads, six compressions.
#include "launch.cuh"
#include "sha256.cuh"

template <int NW>
__global__ void sha256_words_kernel(const u32* __restrict__ msg, u32* __restrict__ out,
                                    long long n, int n_words_rt) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int nw = NW ? NW : n_words_rt;
  const int total = ((nw + 3 + 15) / 16) * 16;  // words after padding
  const unsigned long long bits = 32ull * (unsigned long long)nw;
  const u32* m = msg + i * (long long)nw;
  u32 st[8];
  sha256_init(st);
  for (int base = 0; base < total; base += 16) {
    u32 w[16];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int k0 = base + 4 * g;
      if (NW && (NW % 4 == 0) && k0 + 4 <= NW) {
        // whole 16-byte group inside the message: one vector load
        uint4 q = reinterpret_cast<const uint4*>(m)[k0 / 4];
        w[4 * g] = q.x;
        w[4 * g + 1] = q.y;
        w[4 * g + 2] = q.z;
        w[4 * g + 3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + j;
          u32 x = 0;
          if (k < nw) x = m[k];
          else if (k == nw) x = 0x80000000u;
          else if (k == total - 2) x = (u32)(bits >> 32);
          else if (k == total - 1) x = (u32)bits;
          w[4 * g + j] = x;
        }
      }
    }
    sha256_compress(st, w);
  }
  uint4* o = reinterpret_cast<uint4*>(out + i * 8);
  o[0] = make_uint4(st[0], st[1], st[2], st[3]);
  o[1] = make_uint4(st[4], st[5], st[6], st[7]);
}

extern "C" int mlt_sha256_words(const void* msg, void* out, long long n, int n_words,
                                int device, cudaStream_t stream) {
  device_guard guard(device);
  const int threads = 128;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  const u32* m = static_cast<const u32*>(msg);
  u32* o = static_cast<u32*>(out);
  if (n_words == 8)
    sha256_words_kernel<8><<<blocks, threads, 0, stream>>>(m, o, n, n_words);
  else if (n_words == 16)
    sha256_words_kernel<16><<<blocks, threads, 0, stream>>>(m, o, n, n_words);
  else
    sha256_words_kernel<0><<<blocks, threads, 0, stream>>>(m, o, n, n_words);
  return (int)cudaGetLastError();
}
