// Tensor product of two field vectors: out[i * ld + j] = a[i] * b[j] for
// i < m, j < w.  The wrapper passes ld = n (all of b) and w = n, or slabs of
// at most KRON_SLAB columns of a wider b.
//
// Replaces the TPU kernel `_kron_flat` / `kron_mul` of the JAX package's
// field/pallas_ops.py:570-612; it builds the eq/delta weight table of the
// packed sumcheck table (the 2^24 prove's last product is 2^16 x 2^8, 256 MiB
// written) and the power tables by doubling.
//
// Bound on an H100: 16 bytes written per output element against one field
// multiply (146 integer instructions, 73 on the busier pipe): by those counts
// the store and the multiplies take about as long (0.080 and 0.073 ms at 2^24
// elements).  On an H100 SXM at 700 W the multiplies alone (this kernel with
// its stores taken out, MODE 2) take about 0.14 ms at 2^24 and the stores
// alone (MODE 1) about 0.09 ms: the multiply issues at about half the rate its
// instruction count assumes, so the kernel is bound by its multiplies, and no
// order of the same work reaches the bytes bound.  The design:
// * a block owns row steps of R = max(1, 256 / w) rows x all w columns, and a
//   thread owns the same column(s) in every step: it loads its b[j] once and
//   keeps it in registers (C = ceil(w / 256) of them) - no division and no
//   load of b per element;
// * the block stages its rows of a in shared memory, 256 at a time; a thread
//   reads one element a step, the same address as its row-mates (broadcast);
// * a persistent grid (as many blocks as fit on the card at once) splits the
//   row steps into equal contiguous runs, so the stores of one step overlap
//   the multiplies of the next in the other resident blocks;
// * 16-byte streaming stores (st.global.cs): the output is five times the
//   L2 and should not evict what the next kernel reads.
#include "field.cuh"

// MODE 0 is the product, the only mode a prover launches.  MODE 1 (the stores
// alone: b[j] stored, no multiply) and MODE 2 (the multiplies alone: a store
// only if a product equals a value it never equals) are the same kernel less
// one part, launched by chip_smoke.py's `routes` phase to show what binds it.
#define KRON_THREADS 256
#define KRON_TILE 256  // elements of a staged in shared memory at a time

__device__ __forceinline__ void fp_store_cs(uint4* p, fp v) {
  __stcs(p, make_uint4((u32)v.lo, (u32)(v.lo >> 32), (u32)v.hi, (u32)(v.hi >> 32)));
}

template <int C, int MODE>
__global__ void __launch_bounds__(KRON_THREADS, 4)
    kron_tiles_kernel(const void* __restrict__ a, const void* __restrict__ b, void* __restrict__ out,
                      long long m, int w, long long ld) {
  __shared__ uint4 a_s[KRON_TILE];
  const int t = threadIdx.x;
  const int R = w >= KRON_THREADS ? 1 : KRON_THREADS / w;  // rows a step
  const int lane = t / w;                                  // this thread's row in a step
  const int j0 = t - lane * w;
  const bool active = lane < R;
  fp bj[C];
  bool ok[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c * KRON_THREADS;
    ok[c] = active && j < w;
    bj[c] = ok[c] ? fp_load(b, j) : fp{0ull, 0ull};
  }
  const long long steps = (m + R - 1) / R;
  const long long s_end = steps * (blockIdx.x + 1) / gridDim.x;
  const int K = KRON_TILE / R;  // steps a staged tile
  const long long o_step = (long long)R * ld;
  for (long long s = steps * blockIdx.x / gridDim.x; s < s_end; s += K) {
    const long long row0 = s * R;
    const int n_steps = (int)min((long long)K, s_end - s);
    const long long n_rows = min((long long)n_steps * R, m - row0);
    __syncthreads();  // the previous tile's reads are done
    if (t < n_rows) a_s[t] = reinterpret_cast<const uint4*>(a)[row0 + t];
    __syncthreads();
    // the steps whose row of this thread exists: all of them but in the
    // last tile of a ragged m, none for a thread past the last row lane
    const long long first = row0 + lane;
    const int my_steps = active && first < m ? (int)min((long long)n_steps, (m - first + R - 1) / R) : 0;
    uint4* o = reinterpret_cast<uint4*>(out) + first * ld + j0;
#pragma unroll 2
    for (int k = 0; k < my_steps; ++k, o += o_step) {
      const uint4 av = a_s[k * R + lane];
      fp x;
      x.lo = ((u64)av.y << 32) | av.x;
      x.hi = ((u64)av.w << 32) | av.z;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!ok[c]) continue;
        if (MODE == 1) {
          fp_store_cs(o + c * KRON_THREADS, bj[c]);
        } else {
          const fp y = fp_mul(x, bj[c]);
          if (MODE == 0 || (y.lo == 0x0123456789ABCDEFull && y.hi == 1ull)) fp_store_cs(o + c * KRON_THREADS, y);
        }
      }
    }
  }
}

template <int C, int MODE = 0>
static int kron_launch(const void* a, const void* b, void* out, long long m, int w, long long ld,
                       int device, cudaStream_t stream) {
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kron_tiles_kernel<C, MODE>, KRON_THREADS, 0);
  const long long R = w >= KRON_THREADS ? 1 : KRON_THREADS / w;
  const long long steps = (m + R - 1) / R;
  long long blocks = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (blocks > steps) blocks = steps;
  kron_tiles_kernel<C, MODE><<<(unsigned)blocks, KRON_THREADS, 0, stream>>>(a, b, out, m, w, ld);
  return (int)cudaGetLastError();
}

extern "C" int mlt_kron_tiles(const void* a, const void* b, void* out, long long m, long long w,
                              long long ld, int device, cudaStream_t stream) {
  device_guard guard(device);
  if (m <= 0 || w <= 0) return 0;
  if (w <= KRON_THREADS) return kron_launch<1>(a, b, out, m, (int)w, ld, device, stream);
  if (w <= 2 * KRON_THREADS) return kron_launch<2>(a, b, out, m, (int)w, ld, device, stream);
  if (w <= 4 * KRON_THREADS) return kron_launch<4>(a, b, out, m, (int)w, ld, device, stream);
  return (int)cudaErrorInvalidValue;  // the wrapper cuts b into slabs of at most 1024
}

// The kernel less one part (MODE 1: stores alone, 2: multiplies alone), for
// one column a thread (w <= 256); chip_smoke.py times it beside the product.
extern "C" int mlt_kron_parts(int mode, const void* a, const void* b, void* out, long long m,
                              long long w, int device, cudaStream_t stream) {
  device_guard guard(device);
  if (m <= 0 || w <= 0 || w > KRON_THREADS) return (int)cudaErrorInvalidValue;
  if (mode == 1) return kron_launch<1, 1>(a, b, out, m, (int)w, w, device, stream);
  if (mode == 2) return kron_launch<1, 2>(a, b, out, m, (int)w, w, device, stream);
  return (int)cudaErrorInvalidValue;
}
