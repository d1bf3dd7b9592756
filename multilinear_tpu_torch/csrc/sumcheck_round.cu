// A constraint-sumcheck round in two launches: the round's sums, which run
// the composition as a traced program (composition.py), and the table fold.
//
// Replaces the round body of the JAX package's standalone sumcheck
// (`_sc_round_body`, multilinear_tpu/sumcheck.py): the partial sums over a
// user composition and the fold, which the TPU runs inside the round's XLA
// program and no Pallas kernel.  Run operation by operation, the same round
// takes about 45 launches, each writing a full-size temporary (the
// composition's add, sub and mul at each point, the delta multiply, the limb
// sums, the extensions); here the table is read once for the sums and once
// for the fold, and nothing else touches device memory.  A program wider
// than a block runs operation by operation (composition.round_sums).
//
// sumcheck_sums_kernel: the packed (w+1, h, 4) table, delta row last, pairs
// row i with i + h/2.  A thread takes row pairs in a grid-stride loop, keeps
// its slots - the value at the current point of each column the program
// reads, the temporaries, and above degree 1 each column's step hi - lo - in
// dynamic shared memory ([slot][thread], sized at launch), and runs the
// program over them at each point, the instructions being the same for
// every thread.  Points go in passes of SR_POINTS, whose int64 lane sums stay
// in registers: the first point of a pass is hi + (X - 1)(hi - lo), the next
// ones add the step.  A degree of 3 is one pass and reads the table once; a
// degree of thousands rereads it once a pass.  A pass ends with a warp
// shuffle tree, a sum over the block's warps in shared memory and one 64-bit
// atomic add a block per lane and point: integer sums are exact and the
// order of the atomics cannot change them.  The sums must be zero before a
// round (the caller keeps one zeroed row of sums a round).
//
// An operand of the program is a slot (>= 0) or a scalar (< 0: -1 - o into
// the aux scalars, then the program's constants), read by every thread of a
// warp at one address.  The program's layout is composition.py's.
//
// sumcheck_fold_kernel: out[c, i] = lo + r (hi - lo) for every row c of the
// table, lo = data[c, i], hi = data[c, i + h/2]; r is read where the round's
// Fiat-Shamir kernel wrote it.
//
// Bound on an H100: the sums read the table's (w+1) h 16 bytes once at d <=
// SR_POINTS; the program's multiplies (about 50 integer instructions each,
// 3 x 6 a row pair for the euclid4 composition) put the kernel near the
// integer rate rather than the memory rate.  The fold reads (w+1) h and
// writes (w+1) h / 2 elements of 16 bytes with one multiply an output:
// memory-bound.
#include <mutex>

#include "field.cuh"

#define SR_THREADS 256
#define SR_POINTS 4
#define SR_HEADER 8

enum { SR_ADD = 0, SR_SUB = 1, SR_MUL = 2, SR_NEG = 3 };

__device__ __forceinline__ fp sr_operand(int o, const uint4* sl, const void* aux, int n_aux, const void* consts) {
  if (o >= 0) return fp_load(sl, (long long)o * blockDim.x + threadIdx.x);
  const int k = -1 - o;
  return k < n_aux ? fp_load(aux, k) : fp_load(consts, k - n_aux);
}

__device__ __forceinline__ fp sr_small(int v) {
  fp r;
  r.lo = (u64)v;
  r.hi = 0ull;
  return r;
}

__global__ void __launch_bounds__(SR_THREADS)
    sumcheck_sums_kernel(const void* __restrict__ data, long long h, int w, int degree,
                         const int* __restrict__ prog, const void* __restrict__ aux, int n_aux,
                         unsigned long long* __restrict__ sums) {
  extern __shared__ uint4 sr_slots[];
  __shared__ unsigned long long red[SR_THREADS / 32][SR_POINTS * 4];
  const int n_cols = prog[0], n_temps = prog[1], n_instr = prog[2], result = prog[3], n_consts = prog[4];
  const void* consts = prog + SR_HEADER;
  const int4* instr = reinterpret_cast<const int4*>(prog + SR_HEADER + 4 * n_consts);
  const int* cols = prog + SR_HEADER + 4 * n_consts + 4 * n_instr;
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long half = h >> 1;
  const long long delta = (long long)w * h;  // the delta row's first element
  const int steps = n_cols + n_temps;        // the slot of column u's step is steps + u
  uint4* sl = sr_slots;

#pragma unroll 1
  for (int x0 = 1; x0 <= degree; x0 += SR_POINTS) {
    const int np = min(SR_POINTS, degree - x0 + 1);
    unsigned long long acc[SR_POINTS][4];
#pragma unroll
    for (int p = 0; p < SR_POINTS; ++p)
#pragma unroll
      for (int l = 0; l < 4; ++l) acc[p][l] = 0ull;

#pragma unroll 1
    for (long long i = (long long)blockIdx.x * T + tid; i < half; i += (long long)gridDim.x * T) {
      const fp dlo = fp_load(data, delta + i), dhi = fp_load(data, delta + half + i);
      const fp dstep = fp_sub(dhi, dlo);
      fp dcur = x0 == 1 ? dhi : fp_add(dhi, fp_mul(dstep, sr_small(x0 - 1)));
#pragma unroll 1
      for (int u = 0; u < n_cols; ++u) {
        const long long base = (long long)cols[u] * h + i;
        const fp lo = fp_load(data, base), hi = fp_load(data, base + half);
        const fp step = fp_sub(hi, lo);
        fp_store(sl, (long long)u * T + tid, x0 == 1 ? hi : fp_add(hi, fp_mul(step, sr_small(x0 - 1))));
        if (degree > 1) fp_store(sl, (long long)(steps + u) * T + tid, step);
      }
#pragma unroll
      for (int p = 0; p < SR_POINTS; ++p) {
        if (p < np) {
          if (p > 0) {
            dcur = fp_add(dcur, dstep);
#pragma unroll 1
            for (int u = 0; u < n_cols; ++u)
              fp_store(sl, (long long)u * T + tid,
                       fp_add(fp_load(sl, (long long)u * T + tid), fp_load(sl, (long long)(steps + u) * T + tid)));
          }
#pragma unroll 1
          for (int k = 0; k < n_instr; ++k) {
            const int4 ins = instr[k];
            const fp a = sr_operand(ins.z, sl, aux, n_aux, consts);
            fp r;
            if (ins.x == SR_NEG) {
              r = fp_sub(sr_small(0), a);
            } else {
              const fp b = sr_operand(ins.w, sl, aux, n_aux, consts);
              if (ins.x == SR_ADD) r = fp_add(a, b);
              else if (ins.x == SR_SUB) r = fp_sub(a, b);
              else r = fp_mul(a, b);
            }
            fp_store(sl, (long long)ins.y * T + tid, r);
          }
          const fp v = fp_mul(sr_operand(result, sl, aux, n_aux, consts), dcur);
          acc[p][0] += v.lo & 0xFFFFFFFFull;
          acc[p][1] += v.lo >> 32;
          acc[p][2] += v.hi & 0xFFFFFFFFull;
          acc[p][3] += v.hi >> 32;
        }
      }
    }

    // the block's sums: a shuffle tree in each warp, then over the warps
#pragma unroll
    for (int p = 0; p < SR_POINTS; ++p) {
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        unsigned long long s = acc[p][l];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xFFFFFFFFu, s, o);
        if (lane == 0) red[warp][p * 4 + l] = s;
      }
    }
    __syncthreads();
    if (tid < np * 4) {
      unsigned long long s = 0ull;
      for (int j = 0; j < (T >> 5); ++j) s += red[j][tid];
      atomicAdd(sums + 4ll * (x0 - 1) + tid, s);
    }
    __syncthreads();  // red is written again by the next pass
  }
}

__global__ void __launch_bounds__(256)
    sumcheck_fold_kernel(const void* __restrict__ data, void* __restrict__ out, long long n, long long h,
                         const void* __restrict__ r_ptr) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const long long half = h >> 1;
  const long long c = idx / half, i = idx - c * half;
  const fp lo = fp_load(data, c * h + i), hi = fp_load(data, c * h + half + i);
  fp_store(out, idx, fp_add(lo, fp_mul(fp_sub(hi, lo), fp_load(r_ptr, 0))));
}

// What a launch of sumcheck_sums asks of the card, asked once: per device
// the dynamic shared memory a block may opt into (the opt-in limit less the
// kernel's static shared memory, which the 48 KiB default shares) - the
// kernel's attribute is raised to it at the first query, so a launch of any
// size within it needs no attribute call - and the SM count; per (device,
// slots) the block width and the blocks an SM holds at once.
struct sr_device_info {
  int ready;
  size_t avail;
  int sms;
};
struct sr_shape {
  int device, slots, threads, per_sm;
};
#define SR_DEVICES 64
#define SR_SHAPES 64
static sr_device_info sr_devices[SR_DEVICES];
static sr_shape sr_shapes[SR_SHAPES];
static int sr_n_shapes = 0;
static std::mutex sr_mutex;

static int sr_device(int device, sr_device_info* out) {
  if (device < 0 || device >= SR_DEVICES) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(sr_mutex);
  sr_device_info& d = sr_devices[device];
  if (!d.ready) {
    int optin = 0, sms = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, sumcheck_sums_kernel);
    if (err != cudaSuccess) return (int)err;
    const size_t avail = (size_t)optin - attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(sumcheck_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)avail);
    if (err != cudaSuccess) return (int)err;
    d.avail = avail;
    d.sms = sms;
    d.ready = 1;
  }
  *out = d;
  return 0;
}

// The widest block (256 threads down to 32) whose slots fit in shared
// memory, and the blocks of it an SM holds at once.
static int sr_shape_of(int device, int slots, size_t avail, sr_shape* out) {
  {
    std::lock_guard<std::mutex> lock(sr_mutex);
    for (int k = 0; k < sr_n_shapes; ++k)
      if (sr_shapes[k].device == device && sr_shapes[k].slots == slots) {
        *out = sr_shapes[k];
        return 0;
      }
  }
  int threads = SR_THREADS;
  while (threads > 32 && (size_t)slots * threads * sizeof(uint4) > avail) threads >>= 1;
  const size_t bytes = (size_t)slots * threads * sizeof(uint4);
  if (bytes > avail) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sumcheck_sums_kernel, threads, bytes);
  if (err != cudaSuccess) return (int)err;
  *out = sr_shape{device, slots, threads, per_sm > 0 ? per_sm : 1};
  std::lock_guard<std::mutex> lock(sr_mutex);
  if (sr_n_shapes < SR_SHAPES) sr_shapes[sr_n_shapes++] = *out;
  return 0;
}

// The most slots a thread can hold: one block of 32 threads in the opt-in
// shared memory of a block, less the kernel's static shared memory; -1 if
// the card cannot be asked.
extern "C" int mlt_sumcheck_max_slots(int device) {
  device_guard guard(device);
  sr_device_info d;
  if (sr_device(device, &d) != 0) return -1;
  return (int)(d.avail / (32 * sizeof(uint4)));
}

// As many blocks as the card holds at once (fewer for a small table).
extern "C" int mlt_sumcheck_sums(const void* data, long long h, int w, int degree, const void* prog, int slots,
                                 const void* aux, int n_aux, void* sums, int device, cudaStream_t stream) {
  if (h < 2 || degree < 1 || slots < 0) return (int)cudaErrorInvalidValue;
  device_guard guard(device);
  sr_device_info d;
  sr_shape shape;
  int err = sr_device(device, &d);
  if (err == 0) err = sr_shape_of(device, slots, d.avail, &shape);
  if (err != 0) return err;
  const int threads = shape.threads;
  const size_t bytes = (size_t)slots * threads * sizeof(uint4);
  const long long half = h >> 1;
  long long blocks = (half + threads - 1) / threads;
  const long long resident = (long long)shape.per_sm * d.sms;
  if (blocks > resident) blocks = resident;
  sumcheck_sums_kernel<<<(unsigned)blocks, threads, bytes, stream>>>(
      data, h, w, degree, static_cast<const int*>(prog), aux, n_aux, static_cast<unsigned long long*>(sums));
  return (int)cudaGetLastError();
}

extern "C" int mlt_sumcheck_fold(const void* data, void* out, long long rows, long long h, const void* r,
                                 int device, cudaStream_t stream) {
  if (h < 2) return (int)cudaErrorInvalidValue;
  device_guard guard(device);
  const long long n = rows * (h >> 1);
  if (n == 0) return 0;
  const int threads = 256;
  sumcheck_fold_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0, stream>>>(data, out, n, h, r);
  return (int)cudaGetLastError();
}
