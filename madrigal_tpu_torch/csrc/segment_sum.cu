// Sorted segment sum for Hopper (sm_90a):
//
//   out[s, :] = sum of data[t, :] for t in [starts[s], min(starts[s+1], end))
//   end = min(starts[N], E)
//
// The rows of `data` [E, W] are grouped by ascending segment id, so each
// segment's rows are one contiguous span; rows at or past starts[N]
// (trailing padding) belong to no segment. The sum is taken in f32, in
// ascending row order, so every run gives the same bits.
//
// Replaces the Pallas TPU kernel `_kernel` launched by
// `_sorted_segment_sum_mxu` (madrigal_tpu/ops/segment_pallas.py:62-151),
// which folds each span into its output block as one-hot matmuls on the
// MXU. On the card the same sums need no matmul: one owner per segment
// walks its span. It is the backward of the HGT's source gather of the
// fused k|v table (W = 256): the cotangent rows, permuted into source
// order outside the kernel, reduce into one gradient row per source node.
//
// What bounds the wide shapes: bytes. Each input row is read once and
// each output row written once: E*W*sizeof(in) + N*W*4 + (N+1)*4 bytes,
// at 3.35 TB/s on an H100 SXM. For the protein-ppi-protein edge type of the PrimeKG-scale
// graph (E = 1,200,128, N = 27,000, W = 256, f32) that is about 1.26 GB,
// 0.375 ms; all 17 edge types of one HGT layer move about 8.8 GB, 2.6 ms.
//
// Design. A work item is one piece of a segment; the lanes of a warp are
// cut into groups of G, and each group sums one item. A lane owns VEC
// contiguous columns, so a group reads each row's columns as one
// contiguous stretch. VEC = 8 where W is a multiple of 256 (two float4
// loads of f32, or one 16-byte load of bf16 / f16, per row and lane),
// VEC = 4 where W is a multiple of 4, VEC = 1 for any other width; a
// vector load is used only where the rows are aligned for it. G is the
// lanes a row needs, ceil(W / VEC), rounded up to a power of two and at
// most 32 (`mapping`; C entries madrigal_segment_lane_group and
// madrigal_segment_vector).
//
// - Wide rows, W > 16 * VEC (G = 32): one warp owns one item and one
//   group of 32 * VEC columns (`segment_sum_kernel`): the lane loops
//   over the piece with an f32 register accumulator, four rows unrolled,
//   and writes its columns once.
// - Narrow rows (G < 32): a warp takes 32 / G items, one a group of G
//   lanes (`segment_groups_kernel`), all columns at once. At W = 4 (the
//   4-wide softmax denominators) each of the 32 lanes sums a piece of
//   its own; one warp a piece would leave 31 lanes idle. What bounds
//   these shapes is the latency of a lane's chain of loads, not bytes
//   (a segment of ppi's destinations is 44 rows of 16 bytes on average,
//   a piece of a hub 512): so each lane issues the loads of kAhead rows
//   together, then adds them in row order, and a piece of P rows takes
//   P / kAhead round trips to memory. A lane whose piece ends neither
//   loads nor adds the rows past it. The lanes of a warp walk pieces of
//   other lengths; nothing is shared between them, so no shuffle or
//   ballot runs in these loops. A block is one warp, so that a hub's
//   pieces (32 a warp) spread over as many SMs as warps.
//
// No atomics, no shared memory in the sums and no padding; an empty
// segment writes zeros.
//
// The order of every sum, fixed by P = kSplitRows alone (the plain
// PyTorch form is `sorted_segment_sum_ordered` in ops/segment_sorted.py):
// a segment of L <= P rows is summed in f32 from 0, one row after another
// in ascending order. A longer one is cut into pieces of P rows, piece k
// holding rows [b + kP, min(b + (k + 1)P, e)); each piece is summed as a
// short segment into a partial p_k, and out = (..((p_0 + p_1) + p_2) ..),
// in ascending k. So no lane walks more than P rows, however skewed the
// degrees (a hub node, chemCPA's covariate segments of one row a drug).
// G and VEC change which lane adds a value, never the order of the adds.
//
// Two launches (one where E <= P, as no segment can be longer). The first
// has ceil(E / P) chunk items, then N segment items. Segment item s sums
// piece 0 of segment s (its first min(L, P) rows) into out[s]. Chunk item
// c takes rows [cP, (c + 1)P): it finds the segment A holding row cP by a
// search in `starts` and, if a piece k >= 1 of A starts inside the chunk,
// sums that piece into scratch[c]. A chunk holds at most one such piece
// start: pieces start P rows apart, and a segment that begins inside the
// chunk has its piece 1 past the chunk's end. The chunk items come first
// so that the long pieces start early. At G = 32 the warp searches
// together (32 probes a round, 3 rounds at 27,000 segments); at G < 32
// each lane runs a search of its own, kProbes probes a round (8 trips to
// memory at 27,000 segments), since a collective search would run once
// for each of the warp's 32 / G chunks in turn (96 rounds at G = 1).
// In the second launch a block reads 1,024 segments' spans (256 at
// G < 32), one a thread, and lists those longer than P; its warps take
// them in turn (a group of G lanes each at G < 32, G from W and the f32
// scratch's alignment): for each, the group adds scratch[(b + kP) / P]
// for k = 1, 2, ... to out[s], in order. The scratch is ceil(E / P) * W
// f32, allocated by the wrapper.
//
// C entries: madrigal_sorted_segment_sum(...) returns cudaGetLastError();
// madrigal_segment_split_rows() returns P; madrigal_segment_lane_group and
// madrigal_segment_vector return the G and VEC of a launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps per block of the first launch, G = 32
constexpr int kThreads = kWarps * 32;
constexpr int kGroupWarps = 1;  // warps per block of the first launch, G < 32
constexpr int kAhead = 16;  // rows a lane loads before it adds them, G < 32
constexpr int kProbes = 4;  // probes a round of a lane's search, G < 32
constexpr int kCombineThreads = 1024;  // threads per block of the second
// threads per block of the second launch at G < 32 (fewer than
// kCombineThreads, so that a lane's kAhead partials fit its registers)
constexpr int kCombineGroupThreads = 256;

constexpr int kSplitRows = 512;  // P, the rows of a piece (see above)

using bf16 = __nv_bfloat16;

// two 16-bit values packed in 32 bits, widened to f32
__device__ __forceinline__ float2 widen2(uint32_t w, bf16) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}
__device__ __forceinline__ float2 widen2(uint32_t w, __half) {
  return __half22float2(*reinterpret_cast<const __half2*>(&w));
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

// VEC contiguous values of one row, widened to f32 and added to acc
template <typename T, int VEC> struct Row {
  static __device__ __forceinline__ void add(const T* p, float* acc) {
    if constexpr (VEC == 1) {
      acc[0] += widen(__ldg(p));
    } else if constexpr (sizeof(T) == 4) {  // f32: VEC / 4 float4 loads
#pragma unroll
      for (int i = 0; i < VEC / 4; ++i) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
        acc[4 * i + 0] += v.x;
        acc[4 * i + 1] += v.y;
        acc[4 * i + 2] += v.z;
        acc[4 * i + 3] += v.w;
      }
    } else {  // 16-bit: one 16-byte load for VEC = 8, 8 bytes for VEC = 4
      uint32_t w[VEC / 2];
      if constexpr (VEC == 8) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
      } else {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
        w[0] = v.x; w[1] = v.y;
      }
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i) {
        const float2 f = widen2(w[i], T());
        acc[2 * i + 0] += f.x;
        acc[2 * i + 1] += f.y;
      }
    }
  }
};

// VEC contiguous values of one row as loaded (VEC = 1 or 4), then widened
// to f32 and added to acc: the loads of several rows can be issued
// before their adds
template <typename T, int VEC> struct Loaded {
  using V = T;  // VEC = 1
  static __device__ __forceinline__ V load(const T* p) { return __ldg(p); }
  static __device__ __forceinline__ void add(V v, float* acc) {
    acc[0] += widen(v);
  }
};
template <> struct Loaded<float, 4> {
  using V = float4;
  static __device__ __forceinline__ V load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void add(V v, float* acc) {
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  }
};
template <typename T> struct Loaded16x4 {  // four bf16 or f16 values
  using V = uint2;
  static __device__ __forceinline__ V load(const T* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ void add(V v, float* acc) {
    const float2 lo = widen2(v.x, T()), hi = widen2(v.y, T());
    acc[0] += lo.x;
    acc[1] += lo.y;
    acc[2] += hi.x;
    acc[3] += hi.y;
  }
};
template <> struct Loaded<bf16, 4> : Loaded16x4<bf16> {};
template <> struct Loaded<__half, 4> : Loaded16x4<__half> {};

// acc += rows p, p + stride, ..., n of them, in that order: the loads of
// kAhead rows are issued together, then added one row after another; the
// rows past the n-th are neither loaded nor added
template <typename T, int VEC>
__device__ __forceinline__ void add_rows_ahead(const T* p, int64_t n,
                                               int64_t stride, float* acc) {
  using L = Loaded<T, VEC>;
  typename L::V v[kAhead];
  for (; n >= kAhead; n -= kAhead, p += kAhead * stride) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) v[i] = L::load(p + i * stride);
#pragma unroll
    for (int i = 0; i < kAhead; ++i) L::add(v[i], acc);
  }
#pragma unroll
  for (int i = 0; i < kAhead; ++i)
    if (i < n) v[i] = L::load(p + i * stride);
#pragma unroll
  for (int i = 0; i < kAhead; ++i)
    if (i < n) L::add(v[i], acc);
}

// VEC f32 values of acc to dst (float4 stores for VEC = 4 or 8)
template <int VEC>
__device__ __forceinline__ void store(const float* acc, float* dst) {
  if constexpr (VEC == 1) {
    dst[0] = acc[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      reinterpret_cast<float4*>(dst)[i] = make_float4(
          acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  }
}

// rows [b, e) of the lane's VEC columns, summed in f32 from 0 in ascending
// row order, written to dst
template <typename T, int VEC>
__device__ __forceinline__ void sum_rows(const T* __restrict__ data,
                                         int64_t b, int64_t e, int W,
                                         int64_t col, float* __restrict__ dst) {
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;

  const T* p = data + b * W + col;
#pragma unroll 4
  for (int64_t t = b; t < e; ++t, p += W) Row<T, VEC>::add(p, acc);

  store<VEC>(acc, dst + col);
}

// the same sum as sum_rows, kAhead rows in flight (G < 32)
template <typename T, int VEC>
__device__ __forceinline__ void sum_rows_ahead(const T* __restrict__ data,
                                               int64_t b, int64_t e, int W,
                                               int64_t col,
                                               float* __restrict__ dst) {
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  add_rows_ahead<T, VEC>(data + b * W + col, e - b, W, acc);
  store<VEC>(acc, dst + col);
}

// segment s's span, clipped to the real rows [0, min(starts[N], E))
__device__ __forceinline__ void span(const int* __restrict__ starts,
                                     int64_t end, int64_t s, int64_t& b,
                                     int64_t& e) {
  e = __ldg(starts + s + 1);
  e = e < end ? e : end;
  b = __ldg(starts + s);
  b = b > 0 ? b : 0;
}

// the last s in [0, N) with starts[s] <= r, given starts[0] <= r: a search
// by the whole warp, 32 probes a round
__device__ __forceinline__ int64_t find_segment(const int* __restrict__ starts,
                                                int N, int64_t r, int lane) {
  int64_t lo = 0, hi = N - 1;  // the answer lies in [lo, hi]
  while (hi - lo >= 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t probe = lo + (lane + 1) * step;
    // starts is sorted, so the probes at or below r are a prefix
    const int below = __popc(__ballot_sync(
        0xffffffffu, probe <= hi && __ldg(starts + probe) <= r));
    if (below < 32) hi = min(hi, lo + (below + 1) * step - 1);
    lo += below * step;
  }
  const int64_t c = lo + lane;
  return lo - 1 + __popc(__ballot_sync(
      0xffffffffu, c <= hi && __ldg(starts + c) <= r));
}

// the same segment as find_segment, found by one lane alone: kProbes
// independent probes a round, so that a round costs one trip to memory
// (8 trips at 27,000 segments, where a binary search takes 15)
__device__ __forceinline__ int64_t search_segment(
    const int* __restrict__ starts, int N, int64_t r) {
  int64_t lo = 0, hi = N - 1;  // starts[lo] <= r; the answer lies in [lo, hi]
  while (hi - lo >= kProbes) {
    const int64_t step = (hi - lo + kProbes - 1) / kProbes;
    // starts is sorted, so the probes at or below r are a prefix
    int below = 0;
#pragma unroll
    for (int i = 1; i <= kProbes; ++i) {
      const int64_t probe = lo + i * step;
      below += probe <= hi && __ldg(starts + probe) <= r;
    }
    if (below < kProbes) hi = min(hi, lo + (below + 1) * step - 1);
    lo += below * step;
  }
  int below = 0;
#pragma unroll
  for (int i = 1; i < kProbes; ++i)
    below += lo + i <= hi && __ldg(starts + lo + i) <= r;
  return lo + below;
}

// first launch at G = 32: warps [0, chunks) are chunk warps, warps
// [chunks, chunks + N) segment warps
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ data, const int* __restrict__ starts,
                   float* __restrict__ out, float* __restrict__ scratch,
                   int64_t E, int N, int W, int64_t chunks) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t g = (int64_t)blockIdx.x * kWarps + warp;
  if (g >= chunks + N) return;  // the whole warp
  const int64_t col = (int64_t)blockIdx.y * (32 * VEC) + lane * VEC;
  // W % VEC == 0, so a lane's VEC columns lie all inside the row or all
  // past it; a lane past it still takes part in the chunk warp's search
  const bool active = col < W;
  int64_t end = __ldg(starts + N);
  end = end < E ? end : E;
  int64_t b, e;

  if (g >= chunks) {  // segment warp: piece 0, the first min(L, P) rows
    const int64_t s = g - chunks;
    span(starts, end, s, b, e);
    const int64_t e0 = e - b > kSplitRows ? b + kSplitRows : e;
    if (active) sum_rows<T, VEC>(data, b, e0, W, col, out + s * W);
    return;
  }

  // chunk warp: the piece k >= 1 that starts in rows [r, r + P), if any
  const int64_t r = g * kSplitRows;
  if (r >= end || r < __ldg(starts)) return;  // the whole warp
  span(starts, end, find_segment(starts, N, r, lane), b, e);
  if (e - b <= kSplitRows) return;
  const int64_t k = (r - b + kSplitRows - 1) / kSplitRows;
  const int64_t ps = b + k * kSplitRows;  // in [r, r + P)
  if (k == 0 || ps >= e) return;
  const int64_t pe = e - ps > kSplitRows ? ps + kSplitRows : e;
  if (active) sum_rows<T, VEC>(data, ps, pe, W, col, scratch + g * W);
}

// first launch at G = 1 << log_group < 32: item i (chunk items [0,
// chunks), then segment items) goes to group i % (32 / G) of warp
// i / (32 / G); a lane owns columns [l * VEC, (l + 1) * VEC) of its
// group's item, l its place in the group
template <typename T, int VEC>
__global__ void __launch_bounds__(kGroupWarps * 32)
segment_groups_kernel(const T* __restrict__ data,
                      const int* __restrict__ starts, float* __restrict__ out,
                      float* __restrict__ scratch, int64_t E, int N, int W,
                      int64_t chunks, int log_group) {
  const int lane = threadIdx.x % 32;
  const int64_t warp = (int64_t)blockIdx.x * kGroupWarps + threadIdx.x / 32;
  const int64_t g = (warp << (5 - log_group)) + (lane >> log_group);
  const int64_t col = (int64_t)(lane & ((1 << log_group) - 1)) * VEC;
  if (g >= chunks + N || col >= W) return;  // this lane alone
  int64_t end = __ldg(starts + N);
  end = end < E ? end : E;
  int64_t b, e;

  if (g >= chunks) {  // segment item: piece 0, the first min(L, P) rows
    const int64_t s = g - chunks;
    span(starts, end, s, b, e);
    const int64_t e0 = e - b > kSplitRows ? b + kSplitRows : e;
    sum_rows_ahead<T, VEC>(data, b, e0, W, col, out + s * W);
    return;
  }

  // chunk item: the piece k >= 1 that starts in rows [r, r + P), if any
  const int64_t r = g * kSplitRows;
  if (r >= end || r < __ldg(starts)) return;
  span(starts, end, search_segment(starts, N, r), b, e);
  if (e - b <= kSplitRows) return;
  const int64_t k = (r - b + kSplitRows - 1) / kSplitRows;
  const int64_t ps = b + k * kSplitRows;  // in [r, r + P)
  if (k == 0 || ps >= e) return;
  const int64_t pe = e - ps > kSplitRows ? ps + kSplitRows : e;
  sum_rows_ahead<T, VEC>(data, ps, pe, W, col, scratch + g * W);
}

// the segments of [first block segment, + kBlock) longer than P, listed
// in shared memory in ascending order (a prefix count of the warps'
// ballots, no atomics): entry j is segment ids[j], rows [first[j],
// last[j]); returns the count. Every thread of the block (kBlock of
// them, one a segment) calls it.
template <int kBlock>
__device__ __forceinline__ int list_long_segments(
    const int* __restrict__ starts, int64_t E, int N, int64_t* first,
    int64_t* last, int64_t* ids, int* counts) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int64_t s = (int64_t)blockIdx.x * kBlock + threadIdx.x;
  int64_t end = __ldg(starts + N);
  end = end < E ? end : E;
  int64_t b = 0, e = 0;
  if (s < N) span(starts, end, s, b, e);
  const bool split = e - b > kSplitRows;
  const unsigned ballot = __ballot_sync(0xffffffffu, split);
  if (lane == 0) counts[warp] = __popc(ballot);
  __syncthreads();
  int slot = __popc(ballot & ((1u << lane) - 1)), listed = 0;
  for (int w = 0; w < kBlock / 32; ++w) {
    slot += w < warp ? counts[w] : 0;
    listed += counts[w];
  }
  if (split) {
    first[slot] = b;
    last[slot] = e;
    ids[slot] = s;
  }
  __syncthreads();
  return listed;
}

// second launch: a block reads the spans of kCombineThreads segments, one
// a thread, and lists those longer than P in shared memory (a prefix count
// of the warps' ballots, no atomics); its warps take the list's entries in
// turn, and for each the lanes add scratch[(b + kP) / P] for k = 1, 2, ...
// to out[s] over the block's columns, in order
template <int VEC>
__global__ void __launch_bounds__(kCombineThreads)
segment_combine_kernel(const float* __restrict__ scratch,
                       const int* __restrict__ starts,
                       float* __restrict__ out, int64_t E, int N, int W) {
  __shared__ int64_t first[kCombineThreads], last[kCombineThreads];
  __shared__ int64_t ids[kCombineThreads];
  __shared__ int counts[kCombineThreads / 32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int listed = list_long_segments<kCombineThreads>(
      starts, E, N, first, last, ids, counts);
  const int64_t col = (int64_t)blockIdx.y * (32 * VEC) + lane * VEC;
  if (col >= W) return;
  for (int j = warp; j < listed; j += kCombineThreads / 32) {
    // piece k >= 1 of the segment is in chunk b / P + k
    const int64_t pieces = (last[j] - first[j] + kSplitRows - 1) / kSplitRows;
    const float* q = scratch + (first[j] / kSplitRows + 1) * W + col;
    float* o = out + ids[j] * W + col;
    if constexpr (VEC == 1) {
      float acc = o[0];
#pragma unroll 8
      for (int64_t k = 1; k < pieces; ++k, q += W) acc += __ldg(q);
      o[0] = acc;
    } else {
      float4 acc = *reinterpret_cast<const float4*>(o);
#pragma unroll 8
      for (int64_t k = 1; k < pieces; ++k, q += W) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(q));
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      *reinterpret_cast<float4*>(o) = acc;
    }
  }
}

// second launch at G = 1 << log_group < 32: the listed segments go to the
// groups of G lanes in turn, 32 / G a warp; a group adds the partials of
// its segment in ascending k, kAhead partials in flight a lane
template <int VEC>
__global__ void __launch_bounds__(kCombineGroupThreads)
segment_combine_groups_kernel(const float* __restrict__ scratch,
                              const int* __restrict__ starts,
                              float* __restrict__ out, int64_t E, int N,
                              int W, int log_group) {
  __shared__ int64_t first[kCombineGroupThreads], last[kCombineGroupThreads];
  __shared__ int64_t ids[kCombineGroupThreads];
  __shared__ int counts[kCombineGroupThreads / 32];
  const int lane = threadIdx.x % 32;
  const int listed = list_long_segments<kCombineGroupThreads>(
      starts, E, N, first, last, ids, counts);
  const int64_t col = (int64_t)(lane & ((1 << log_group) - 1)) * VEC;
  if (col >= W) return;
  const int groups = kCombineGroupThreads >> log_group;  // in the block
  for (int j = threadIdx.x >> log_group; j < listed; j += groups) {
    // piece k >= 1 of the segment is in chunk b / P + k
    const int64_t pieces = (last[j] - first[j] + kSplitRows - 1) / kSplitRows;
    float* o = out + ids[j] * W + col;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = o[i];
    add_rows_ahead<float, VEC>(
        scratch + (first[j] / kSplitRows + 1) * W + col, pieces - 1, W, acc);
    store<VEC>(acc, o);
  }
}

// (VEC, G) of a launch on rows of `elem`-byte values whose address is a
// multiple of `align` bytes (a power of two, at most 32): the widest
// vector the width and the alignment allow, then the lanes a row needs
struct Mapping {
  int vec, group;
};
Mapping mapping(int W, int elem, int align) {
  const int vec = W % 256 == 0 && align % (8 * elem) == 0 ? 8
                  : W % 4 == 0 && align % (4 * elem) == 0 ? 4
                                                          : 1;
  const int lanes = (W + vec - 1) / vec;
  int group = 1;
  while (group < lanes && group < 32) group *= 2;
  return {vec, group};
}

int log2_of(int group) {  // group: a power of two
  int k = 0;
  while ((1 << k) < group) ++k;
  return k;
}

// the largest power of two, up to 32, that divides addr
int alignment(uintptr_t addr) {
  int align = 1;
  while (align < 32 && addr % (2 * align) == 0) align *= 2;
  return align;
}

template <typename T, int VEC>
void launch(const void* data, const int* starts, float* out, float* scratch,
            int64_t E, int N, int W, int64_t chunks, cudaStream_t stream) {
  const dim3 grid((unsigned)((chunks + N + kWarps - 1) / kWarps),
                  (W + 32 * VEC - 1) / (32 * VEC));
  segment_sum_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(data), starts, out, scratch, E, N, W, chunks);
}

template <typename T, int VEC>
void launch_groups(const void* data, const int* starts, float* out,
                   float* scratch, int64_t E, int N, int W, int64_t chunks,
                   int group, cudaStream_t stream) {
  const int64_t per_block = (int64_t)kGroupWarps * (32 / group);  // items
  const unsigned blocks = (unsigned)((chunks + N + per_block - 1)
                                     / per_block);
  segment_groups_kernel<T, VEC><<<blocks, kGroupWarps * 32, 0, stream>>>(
      static_cast<const T*>(data), starts, out, scratch, E, N, W, chunks,
      log2_of(group));
}

// the second launch; the output and the scratch (fresh allocations) are
// aligned for float4 wherever W % 4 == 0
void launch_combine(const float* scratch, const int* starts, float* out,
                    int64_t E, int N, int W, cudaStream_t stream) {
  const Mapping m = mapping(W, 4, 16);  // VEC 4 or 1
  if (m.group < 32) {
    const unsigned blocks = (unsigned)((N + kCombineGroupThreads - 1)
                                      / kCombineGroupThreads);
    if (m.vec == 4)
      segment_combine_groups_kernel<4><<<blocks, kCombineGroupThreads, 0,
                                         stream>>>(
          scratch, starts, out, E, N, W, log2_of(m.group));
    else
      segment_combine_groups_kernel<1><<<blocks, kCombineGroupThreads, 0,
                                         stream>>>(
          scratch, starts, out, E, N, W, log2_of(m.group));
    return;
  }
  const unsigned blocks = (unsigned)((N + kCombineThreads - 1)
                                    / kCombineThreads);
  if (m.vec == 4) {
    segment_combine_kernel<4><<<dim3(blocks, (W + 127) / 128),
                                kCombineThreads, 0, stream>>>(
        scratch, starts, out, E, N, W);
  } else {
    segment_combine_kernel<1><<<dim3(blocks, (W + 31) / 32),
                                kCombineThreads, 0, stream>>>(
        scratch, starts, out, E, N, W);
  }
}

template <typename T>
void launch_any_width(const void* data, const int* starts, float* out,
                      float* scratch, int64_t E, int N, int W,
                      cudaStream_t stream) {
  // no segment is longer than P unless E is: then one launch does it all
  const int64_t chunks = E > kSplitRows ? (E + kSplitRows - 1) / kSplitRows
                                        : 0;
  const Mapping m = mapping(W, sizeof(T),
                            alignment(reinterpret_cast<uintptr_t>(data)));
  if (m.group < 32) {
    if (m.vec == 4)
      launch_groups<T, 4>(data, starts, out, scratch, E, N, W, chunks,
                          m.group, stream);
    else
      launch_groups<T, 1>(data, starts, out, scratch, E, N, W, chunks,
                          m.group, stream);
  } else if (m.vec == 8) {
    launch<T, 8>(data, starts, out, scratch, E, N, W, chunks, stream);
  } else if (m.vec == 4) {
    launch<T, 4>(data, starts, out, scratch, E, N, W, chunks, stream);
  } else {
    launch<T, 1>(data, starts, out, scratch, E, N, W, chunks, stream);
  }
  if (chunks > 0) launch_combine(scratch, starts, out, E, N, W, stream);
}

const int kElemBytes[] = {4, 2, 2};  // by dtype code

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16
// scratch: [ceil(E / P), W] f32, or null where E <= P
extern "C" int madrigal_sorted_segment_sum(const void* data, const void* starts,
                                           void* out, void* scratch, int64_t E,
                                           int N, int W, int dtype,
                                           void* stream) {
  // the wrapper has checked: N > 0, W > 0, contiguous rows and output
  const int* st = static_cast<const int*>(starts);
  float* o = static_cast<float*>(out);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) launch_any_width<float>(data, st, o, sc, E, N, W, s);
  else if (dtype == 1) launch_any_width<bf16>(data, st, o, sc, E, N, W, s);
  else if (dtype == 2) launch_any_width<__half>(data, st, o, sc, E, N, W, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int madrigal_segment_split_rows(void) { return kSplitRows; }

// G and VEC of the first launch at width W for rows of dtype (as above)
// whose address is a multiple of `align` bytes (a power of two; any
// multiple of 32 counts as 32); -1 for another dtype
extern "C" int madrigal_segment_lane_group(int W, int dtype, int align) {
  if (dtype < 0 || dtype > 2 || W <= 0 || align <= 0) return -1;
  return mapping(W, kElemBytes[dtype], alignment(align)).group;
}

extern "C" int madrigal_segment_vector(int W, int dtype, int align) {
  if (dtype < 0 || dtype > 2 || W <= 0 || align <= 0) return -1;
  return mapping(W, kElemBytes[dtype], alignment(align)).vec;
}
