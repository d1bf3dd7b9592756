// Probe kernels that are never launched: one primitive each between a load
// and a store, so that the integer instructions of the primitive alone can
// be counted in the machine code (`cuobjdump -sass` on the built library;
// the smoke script does it and subtracts the count of `opcount_base`).  The
// counts are the operations the roofline bounds of the kernels are made of.
#include "field.cuh"
#include "sha256.cuh"

extern "C" {

// load two elements, store them: the frame around every field probe
__global__ void opcount_base(const void* a, const void* b, void* out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  fp_store(out, 2 * i, fp_load(a, i));
  fp_store(out, 2 * i + 1, fp_load(b, i));
}

__global__ void opcount_mul(const void* a, const void* b, void* out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  fp_store(out, i, fp_mul(fp_load(a, i), fp_load(b, i)));
}

__global__ void opcount_add(const void* a, const void* b, void* out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  fp_store(out, i, fp_add(fp_load(a, i), fp_load(b, i)));
}

__global__ void opcount_sub(const void* a, const void* b, void* out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  fp_store(out, i, fp_sub(fp_load(a, i), fp_load(b, i)));
}

__global__ void opcount_half(const void* a, const void* b, void* out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  fp_store(out, 2 * i, fp_half(fp_load(a, i)));
  fp_store(out, 2 * i + 1, fp_load(b, i));
}

// the four unreduced int64 limb sums of one element (two 16-byte loads)
// reduced mod p (ops.sum_limbs' lanes, as the round kernels take them)
__global__ void opcount_lane_sums(const void* a, const void* b, void* out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  fp_store(out, i, reduce_lane_sums(reinterpret_cast<const unsigned long long*>(a) + 4 * i));
}

// load a state and 16 message words, store them: the frame around the
// SHA-256 probes
__global__ void opcount_sha_base(const u32* msg, u32* out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    u32 st[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) st[j] = msg[24 * i + 8 * k + j];
    sha_store_digest(out, 3ll * i + k, st);
  }
}

// one compression of 16 message words
__global__ void opcount_sha_block(const u32* msg, u32* out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  u32 st[8], w[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) st[j] = msg[24 * i + j];
#pragma unroll
  for (int j = 0; j < 16; ++j) w[j] = msg[24 * i + 8 + j];
  sha256_compress(st, w);
  sha_store_digest(out, i, st);
}

// one compression of a 32-byte message: 8 message words, 8 constant words
__global__ void opcount_sha_half_block(const u32* msg, u32* out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  u32 st[8], w[16];
#pragma unroll
  for (int j = 0; j < 8; ++j) st[j] = msg[24 * i + j];
#pragma unroll
  for (int j = 0; j < 8; ++j) w[j] = msg[24 * i + 8 + j];
#pragma unroll
  for (int j = 8; j < 16; ++j) w[j] = sha_pad_word(j, 8, 16);
  sha256_compress(st, w);
  sha_store_digest(out, i, st);
}

// one compression of a constant block, from its K + W table
__global__ void opcount_sha_table_block(const u32* msg, u32* out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  u32 st[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) st[j] = msg[24 * i + j];
  sha256_compress_kw(st, SHA_KW_PAD64);
  sha_store_digest(out, i, st);
}

}  // extern "C"
