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
// What bounds it: bytes. Each input row is read once and each output row
// written once: E*W*sizeof(in) + N*W*4 + (N+1)*4 bytes, at 3.35 TB/s on
// an H100 SXM. For the protein-ppi-protein edge type of the PrimeKG-scale
// graph (E = 1,200,128, N = 27,000, W = 256, f32) that is about 1.26 GB,
// 0.375 ms; all 17 edge types of one HGT layer move about 8.8 GB, 2.6 ms.
//
// Design: one warp owns one segment and one group of 32 * VEC columns;
// each lane owns VEC contiguous columns, so a warp reads each row's group
// as one contiguous stretch. VEC = 8 where W is a multiple of 256 (two
// float4 loads of f32, or one 16-byte load of bf16 / f16, per row and
// lane), VEC = 4 where W is a multiple of 4 (the last group may leave
// lanes idle), VEC = 1 for any other width; a vector load is used only
// where the rows are aligned for it. The lane loops over the span with an
// f32 register accumulator and writes its columns once. No atomics, no
// shared memory and no padding; an empty segment writes zeros.
//
// Known weakness: a hub node with a very long span runs on one warp while
// the others finish, and a short span leaves the warp waiting on the
// latency of a few loads. The synthetic KG's degrees are uniform, real
// PrimeKG's are skewed; splitting long spans across warps and pipelining
// the loads (cp.async) are later work.
//
// C entry: madrigal_sorted_segment_sum(...) returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps (segments) per block
constexpr int kThreads = kWarps * 32;

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

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ data, const int* __restrict__ starts,
                   float* __restrict__ out, int64_t E, int N, int W) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * kWarps + warp;
  const int64_t col = (int64_t)blockIdx.y * (32 * VEC) + lane * VEC;
  // W % VEC == 0, so a lane's VEC columns lie all inside the row or all
  // past it
  if (s >= N || col >= W) return;

  // the span, clipped to the real rows [0, min(starts[N], E))
  int64_t end = __ldg(starts + N);
  end = end < E ? end : E;
  int64_t e = __ldg(starts + s + 1);
  e = e < end ? e : end;
  int64_t b = __ldg(starts + s);
  b = b > 0 ? b : 0;

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;

  const T* p = data + b * W + col;
#pragma unroll 4
  for (int64_t t = b; t < e; ++t, p += W) Row<T, VEC>::add(p, acc);

  float* o = out + (int64_t)s * W + col;
  if constexpr (VEC == 1) {
    o[0] = acc[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      reinterpret_cast<float4*>(o)[i] = make_float4(
          acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
  }
}

template <typename T, int VEC>
void launch(const void* data, const int* starts, float* out, int64_t E, int N,
            int W, cudaStream_t stream) {
  const dim3 grid((N + kWarps - 1) / kWarps, (W + 32 * VEC - 1) / (32 * VEC));
  segment_sum_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(data), starts, out, E, N, W);
}

template <typename T>
void launch_any_width(const void* data, const int* starts, float* out,
                      int64_t E, int N, int W, cudaStream_t stream) {
  // the widest vector the width and the rows' alignment allow; the output
  // (a fresh allocation) is aligned for float4 wherever W % 4 == 0
  const uintptr_t addr = reinterpret_cast<uintptr_t>(data);
  if (W % 256 == 0 && addr % (8 * sizeof(T)) == 0)
    launch<T, 8>(data, starts, out, E, N, W, stream);
  else if (W % 4 == 0 && addr % (4 * sizeof(T)) == 0)
    launch<T, 4>(data, starts, out, E, N, W, stream);
  else
    launch<T, 1>(data, starts, out, E, N, W, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16
extern "C" int madrigal_sorted_segment_sum(const void* data, const void* starts,
                                           void* out, int64_t E, int N, int W,
                                           int dtype, void* stream) {
  // the wrapper has checked: N > 0, W > 0, contiguous rows and output
  const int* st = static_cast<const int*>(starts);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) launch_any_width<float>(data, st, o, E, N, W, s);
  else if (dtype == 1) launch_any_width<bf16>(data, st, o, E, N, W, s);
  else if (dtype == 2) launch_any_width<__half>(data, st, o, E, N, W, s);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
