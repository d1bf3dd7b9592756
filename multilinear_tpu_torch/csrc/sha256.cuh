// SHA-256 one-block compression for one message per thread: the 64 rounds
// unrolled, the 16-word message schedule kept as a rolling window in
// registers, rotations as funnel shifts.  A block that holds nothing but
// padding (the last block of a message whose length is a multiple of 64
// bytes) has a constant schedule: sha256_compress_kw runs its rounds from a
// table of K[t] + W[t] and expands nothing.
#pragma once
#include <cuda_runtime.h>

typedef unsigned int u32;

__constant__ u32 SHA_K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

// K[t] + W[t] of the block 0x80, zeros, bit length 512: the second block of
// every 64-byte message (a Merkle inner node).
__constant__ u32 SHA_KW_PAD64[64] = {
    0xc28a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf374, 0x649b69c1, 0xf0fe4786,
    0x0fe1edc6, 0x240cf254, 0x4fe9346f, 0x6cc984be, 0x61b9411e, 0x16f988fa,
    0xf2c65152, 0xa88e5a6d, 0xb019fc65, 0xb9d99ec7, 0x9a1231c3, 0xe70eeaa0,
    0xfdb1232b, 0xc7353eb0, 0x3069bad5, 0xcb976d5f, 0x5a0f118f, 0xdc1eeefd,
    0x0a35b689, 0xde0b7a04, 0x58f4ca9d, 0xe15d5b16, 0x007f3e86, 0x37088980,
    0xa507ea32, 0x6fab9537, 0x17406110, 0x0d8cd6f1, 0xcdaa3b6d, 0xc0bbbe37,
    0x83613bda, 0xdb48a363, 0x0b02e931, 0x6fd15ca7, 0x521afaca, 0x31338431,
    0x6ed41a95, 0x6d437890, 0xc39c91f2, 0x9eccabbd, 0xb5c9a0e6, 0x532fb63c,
    0xd2c741c6, 0x07237ea3, 0xa4954b68, 0x4c191d76};

// The same for bit length 2560: the sixth block of a 320-byte message (a
// batch-tree leaf of 20 field elements).
__constant__ u32 SHA_KW_PAD320[64] = {
    0xc28a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bfb74, 0x649b69c1, 0xf3fe4788,
    0x0fe1edc6, 0x240cf474, 0x4fe9346f, 0x6d7584be, 0x61b9491e, 0x96f9de7a,
    0xf8c65156, 0xc8be2a82, 0xb01e18c5, 0x9fd99f15, 0x104232b9, 0xe726bce0,
    0x80f46f59, 0xf66d48c5, 0x145f287d, 0xd2f6994c, 0x7fef2a00, 0x75c08039,
    0x0e3b0145, 0xef101174, 0x11a4378a, 0x67816305, 0x7a3f6b79, 0xbf4ae647,
    0x9bf45a3a, 0x8d305710, 0x0d10d2e5, 0x96d6d687, 0x31d470fc, 0x076e42c1,
    0xdc2f58a3, 0xe35796b7, 0x8db4ca8e, 0x77f287ce, 0x42a722e9, 0xd5b91323,
    0xa30d502b, 0x8515c437, 0x48ab12b8, 0xf424e915, 0x1a44c23a, 0x7439932f,
    0xab2f4c45, 0x2dac1b86, 0x9eebb4e5, 0xda84c5f6};

__device__ __forceinline__ u32 sha_rotr(u32 x, int r) {
  return __funnelshift_r(x, x, r);
}

__device__ __forceinline__ void sha256_init(u32 st[8]) {
  st[0] = 0x6a09e667;
  st[1] = 0xbb67ae85;
  st[2] = 0x3c6ef372;
  st[3] = 0xa54ff53a;
  st[4] = 0x510e527f;
  st[5] = 0x9b05688c;
  st[6] = 0x1f83d9ab;
  st[7] = 0x5be0cd19;
}

// st <- compress(st, w); w (16 big-endian message words) is clobbered.
__device__ __forceinline__ void sha256_compress(u32 st[8], u32 w[16]) {
  u32 a = st[0], b = st[1], c = st[2], d = st[3];
  u32 e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) {
      u32 w1 = w[(t + 1) & 15], w14 = w[(t + 14) & 15];
      u32 s0 = sha_rotr(w1, 7) ^ sha_rotr(w1, 18) ^ (w1 >> 3);
      u32 s1 = sha_rotr(w14, 17) ^ sha_rotr(w14, 19) ^ (w14 >> 10);
      w[t & 15] = w[t & 15] + s0 + w[(t + 9) & 15] + s1;
    }
    u32 S1 = sha_rotr(e, 6) ^ sha_rotr(e, 11) ^ sha_rotr(e, 25);
    u32 ch = (e & f) ^ (~e & g);
    u32 t1 = h + S1 + ch + SHA_K[t] + w[t & 15];
    u32 S0 = sha_rotr(a, 2) ^ sha_rotr(a, 13) ^ sha_rotr(a, 22);
    u32 maj = (a & b) ^ (a & c) ^ (b & c);
    u32 t2 = S0 + maj;
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

// st <- compress(st, block) for a constant block given as kw[t] = K[t] + W[t].
__device__ __forceinline__ void sha256_compress_kw(u32 st[8], const u32* kw) {
  u32 a = st[0], b = st[1], c = st[2], d = st[3];
  u32 e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    u32 S1 = sha_rotr(e, 6) ^ sha_rotr(e, 11) ^ sha_rotr(e, 25);
    u32 ch = (e & f) ^ (~e & g);
    u32 t1 = h + S1 + ch + kw[t];
    u32 S0 = sha_rotr(a, 2) ^ sha_rotr(a, 13) ^ sha_rotr(a, 22);
    u32 maj = (a & b) ^ (a & c) ^ (b & c);
    u32 t2 = S0 + maj;
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  st[0] += a;
  st[1] += b;
  st[2] += c;
  st[3] += d;
  st[4] += e;
  st[5] += f;
  st[6] += g;
  st[7] += h;
}

// The big-endian message word holding a little-endian 32-bit limb's bytes.
__device__ __forceinline__ u32 sha_bswap(u32 x) {
  return __byte_perm(x, 0, 0x0123);
}

// Word k >= nw of a message of nw words padded to `total` words: the 0x80
// byte, zeros, and the 64-bit bit length in the last two words.
__device__ __forceinline__ u32 sha_pad_word(int k, int nw, int total) {
  const unsigned long long bits = 32ull * (unsigned long long)nw;
  if (k == nw) return 0x80000000u;
  if (k == total - 2) return (u32)(bits >> 32);
  if (k == total - 1) return (u32)bits;
  return 0u;
}

__device__ __forceinline__ void sha_store_digest(u32* out, long long i, const u32 st[8]) {
  uint4* o = reinterpret_cast<uint4*>(out + i * 8);
  o[0] = make_uint4(st[0], st[1], st[2], st[3]);
  o[1] = make_uint4(st[4], st[5], st[6], st[7]);
}

// Parent digest of two child digests held as 16 words: one full
// compression, then the constant padding block.
__device__ __forceinline__ void sha256_node(u32 st[8], u32 w[16]) {
  sha256_init(st);
  sha256_compress(st, w);
  sha256_compress_kw(st, SHA_KW_PAD64);
}
