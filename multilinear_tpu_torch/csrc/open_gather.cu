// The query openings of every Merkle tree of a proof in one launch: the
// leaf payloads and the sibling digests of all queries of all trees.
//   idx:  the n_idx query indices (int64), which every tree opens
//   segs: one Segment a payload column or a digest level of a tree
//   out:  the openings, a Segment's rows at out_off, a query's row width
//         uint4 long
// A Segment reads, for each query q, the unit
//   j = ((idx[q] & mask) >> shift) ^ flip
// of its source: a tree's query index is the index modulo its leaf count
// (mask), a level's node is that index shifted by the level (shift), and
// its sibling flips the lowest bit (flip = 1; a payload column reads the
// leaf itself, flip = 0).  Unit j starts at src + j * stride uint4 and is
// `width` uint4 long (1: a field element; 2: a 32-byte digest).
//
// Replaces no TPU kernel: the JAX package gathers the openings with XLA
// indexing.  It stands for the eager gathers of its plain version
// (sha256_cuda.open_gather_plain: per tree one index copy and one payload
// gather, three launches a level, ~300 levels at 2^24): one copy of the
// indices and the table, and one launch.  Bound on an H100: launch latency -
// a 2^24 proof's openings are ~1.3 MB, under a microsecond of memory
// traffic.  One
// block a segment, a thread a query; the loads are scattered (a query's
// node in each level), the stores contiguous.
#include "launch.cuh"

struct Segment {
  long long src;      // address of unit 0
  long long stride;   // uint4 from one unit to the next
  long long width;    // uint4 a unit
  long long mask;     // leaf count - 1
  long long shift;    // level
  long long flip;     // 1: the sibling; 0: the node itself
  long long out_off;  // uint4 into out
};

__global__ void open_gather_kernel(const long long* __restrict__ idx, long long n_idx,
                                   const Segment* __restrict__ segs, uint4* __restrict__ out) {
  const Segment s = segs[blockIdx.x];
  const uint4* src = reinterpret_cast<const uint4*>(s.src);
  for (long long q = threadIdx.x; q < n_idx; q += blockDim.x) {
    const long long j = ((idx[q] & s.mask) >> s.shift) ^ s.flip;
    const uint4* unit = src + j * s.stride;
    uint4* o = out + s.out_off + q * s.width;
    for (long long w = 0; w < s.width; ++w) o[w] = unit[w];
  }
}

// table: the int64 query indices, then n_segments Segments (7 int64 each).
extern "C" int mlt_open_gather(const void* table, long long n_idx, long long n_segments, void* out,
                               int device, cudaStream_t stream) {
  device_guard guard(device);
  const long long* idx = static_cast<const long long*>(table);
  const Segment* segs = reinterpret_cast<const Segment*>(idx + n_idx);
  open_gather_kernel<<<(unsigned)n_segments, 128, 0, stream>>>(idx, n_idx, segs, static_cast<uint4*>(out));
  return (int)cudaGetLastError();
}
