// Pair x outcome bilinear scores for Hopper (sm_90a):
//
//   out[l, i, j] = round_c(z_head[i] . W_l) . z_tail[j]
//
// Replaces the Pallas TPU kernel `_make_kernel._kernel` launched by
// `_pallas_scores` (madrigal_tpu/ops/bilinear_pallas.py:35-84). As there,
// the caller has already symmetrized W, the first product accumulates in
// f32 and is rounded to the compute type (round_c), and the second
// accumulates in f32 and is written once, in the output type.
//
// What bounds it: every score is written once, so with a bf16 output the
// [L, M, N] block is memory-bound on H100 (2 bytes per 256 flops); with
// f32 compute it is bound by the f32 FMA rate, since f32 does not go
// through the tensor cores (no TF32 here).
//
// Design: one block owns rows [i0, i0 + 64) of z_head and one outcome l.
// It stages the z_head tile and W_l in shared memory, forms
// ZW = z_head_tile @ W_l once, rounds it to the compute type and keeps it
// in shared memory, then walks its share of the z_tail tiles: each
// 64-row tile is staged, multiplied against ZW and written out with the
// ragged edge masked (no padding and no slice-back). bf16 runs on the
// tensor cores through WMMA 16x16x16 with f32 accumulators; f32 runs as
// exact FMAs. The loads are not pipelined yet (no cp.async / TMA).
//
// C entry: madrigal_bilinear_scores(...) returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int D = 128;      // embedding width (the model's feature_dim)
constexpr int TM = 64;      // z_head rows per block
constexpr int TN = 64;      // z_tail rows per inner tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

using bf16 = __nv_bfloat16;

// shared-memory leading dimensions: bf16 rows padded to 136 elements
// (272 B, a multiple of the 32 B that WMMA loads need); f32 rows padded
// to 129 words so the row-strided reads of the FMA path hit distinct
// banks.
template <typename T> struct Layout;
template <> struct Layout<bf16> {
  static constexpr int LD = D + 8;   // z tiles and ZW
  static constexpr int LDW = D + 8;  // W_l
  static constexpr int LDS = TN + 4; // f32 staging of one score tile
};
template <> struct Layout<float> {
  static constexpr int LD = D + 1;
  static constexpr int LDW = D;
  static constexpr int LDS = 0;
};

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

// byte offsets of the shared-memory regions
template <typename T> struct Smem {
  using Lt = Layout<T>;
  static constexpr size_t zw = 0;  // [TM, LD] compute type, lives on
  static constexpr size_t zw_bytes = align128(sizeof(T) * TM * Lt::LD);
  // phase 1 (ZW): z_head tile and W_l
  static constexpr size_t zh = zw + zw_bytes;
  static constexpr size_t zh_bytes = align128(sizeof(T) * TM * Lt::LD);
  static constexpr size_t w = zh + zh_bytes;
  static constexpr size_t w_bytes = align128(sizeof(T) * D * Lt::LDW);
  // phase 2 (scores) reuses the phase-1 region: z_tail tile + staging
  static constexpr size_t zt = zh;
  static constexpr size_t zt_bytes = align128(sizeof(T) * TN * Lt::LD);
  static constexpr size_t st = zt + zt_bytes;
  static constexpr size_t st_bytes = align128(sizeof(float) * TM * Lt::LDS);
  // per-warp 16x16 f32 scratch for rounding ZW fragments (bf16 only)
  static constexpr size_t scratch = w + w_bytes;
  static constexpr size_t scratch_bytes =
      std::is_same<T, bf16>::value ? sizeof(float) * 256 * kWarps : 0;
  static constexpr size_t phase1_end = scratch + scratch_bytes;
  static constexpr size_t phase2_end = st + st_bytes;
  static constexpr size_t total =
      phase1_end > phase2_end ? phase1_end : phase2_end;
};

template <typename O> __device__ __forceinline__ O from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Copy rows [r0, r0 + rows) of a row-major [nrows, D] matrix into shared
// memory with leading dimension LD; rows at or past nrows are zero.
// Global reads are 16-byte vectors (the wrapper checks the alignment).
template <typename T, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src,
                                          int r0, int rows, int nrows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = D / VEC;
  for (int idx = threadIdx.x; idx < rows * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * VEC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nrows) {
      v = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c));
    }
    if constexpr ((LD * sizeof(T)) % 16 == 0) {
      *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
    } else {
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int q = 0; q < VEC; ++q) dst[r * LD + c + q] = e[q];
    }
  }
}

// ---------------------------------------------------------------- bf16
// ZW[TM, D] = zh[TM, D] @ W[D, D]: warp w owns rows 16*(w%4) and the
// four 16-column fragments starting at 64*(w/4).
__device__ __forceinline__ void zw_bf16(bf16* zw_s, const bf16* zh_s,
                                        const bf16* w_s, float* scratch) {
  using namespace nvcuda;
  using Lt = Layout<bf16>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * (warp % 4), c0 = 64 * (warp / 4);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0.0f);
#pragma unroll
  for (int k = 0; k < D; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, zh_s + r0 * Lt::LD + k, Lt::LD);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, w_s + k * Lt::LDW + c0 + 16 * f, Lt::LDW);
      wmma::mma_sync(acc[f], a, b, acc[f]);
    }
  }
  float* scr = scratch + 256 * warp;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    wmma::store_matrix_sync(scr, acc[f], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      zw_s[(r0 + e / 16) * Lt::LD + c0 + 16 * f + e % 16] =
          __float2bfloat16_rn(scr[e]);
    }
    __syncwarp();
  }
}

// S[TM, TN] = ZW[TM, D] @ zt[TN, D]^T into the f32 staging tile: warp w
// owns rows 16*(w%4) and two 16-column fragments from 32*(w/4).
__device__ __forceinline__ void scores_bf16(float* st_s, const bf16* zw_s,
                                            const bf16* zt_s) {
  using namespace nvcuda;
  using Lt = Layout<bf16>;
  const int warp = threadIdx.x / 32;
  const int r0 = 16 * (warp % 4), c0 = 32 * (warp / 4);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
#pragma unroll
  for (int k = 0; k < D; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, zw_s + r0 * Lt::LD + k, Lt::LD);
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      // B[k][n] = zt[n][k]: the row-major z_tail tile read column-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, zt_s + (c0 + 16 * f) * Lt::LD + k, Lt::LD);
      wmma::mma_sync(acc[f], a, b, acc[f]);
    }
  }
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    wmma::store_matrix_sync(st_s + r0 * Lt::LDS + c0 + 16 * f, acc[f],
                            Lt::LDS, wmma::mem_row_major);
  }
}

// ----------------------------------------------------------------- f32
// Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16*i and columns
// tx + 16*c, so neighbouring threads read neighbouring words.
__device__ __forceinline__ void zw_f32(float* zw_s, const float* zh_s,
                                       const float* w_s) {
  using Lt = Layout<float>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    float a[4], b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = zh_s[(ty + 16 * i) * Lt::LD + k];
#pragma unroll
    for (int c = 0; c < 8; ++c) b[c] = w_s[k * Lt::LDW + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      zw_s[(ty + 16 * i) * Lt::LD + tx + 16 * c] = acc[i][c];
}

template <typename O>
__device__ __forceinline__ void scores_f32_store(
    O* __restrict__ out, const float* zw_s, const float* zt_s, int i0, int j0,
    int M, int N) {
  using Lt = Layout<float>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = zw_s[(ty + 16 * i) * Lt::LD + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = zt_s[(tx + 16 * j) * Lt::LD + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = i0 + ty + 16 * i;
    if (gi >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gj = j0 + tx + 16 * j;
      if (gj < N) out[(size_t)gi * N + gj] = from_f32<O>(acc[i][j]);
    }
  }
}

// grid: (ceil(M / TM), L, splits). Block (x, l, z) owns z_head rows
// [TM*x, TM*x + TM), outcome l, and z_tail tiles [z*per, (z+1)*per).
template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
bilinear_kernel(const T* __restrict__ z_head, const T* __restrict__ z_tail,
                const T* __restrict__ w, O* __restrict__ out, int M, int N,
                int tiles_per_split) {
  using Lt = Layout<T>;
  using S = Smem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* zw_s = reinterpret_cast<T*>(smem + S::zw);
  T* zh_s = reinterpret_cast<T*>(smem + S::zh);
  T* w_s = reinterpret_cast<T*>(smem + S::w);
  T* zt_s = reinterpret_cast<T*>(smem + S::zt);

  const int i0 = blockIdx.x * TM;
  const int l = blockIdx.y;
  const int n_tiles = (N + TN - 1) / TN;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  if (t_begin >= t_end) return;

  // phase 1: ZW = round_c(z_head_tile @ W_l)
  load_rows<T, Lt::LD>(zh_s, z_head, i0, TM, M);
  load_rows<T, Lt::LDW>(w_s, w + (size_t)l * D * D, 0, D, D);
  __syncthreads();
  if constexpr (std::is_same<T, bf16>::value) {
    zw_bf16(zw_s, zh_s, w_s, reinterpret_cast<float*>(smem + S::scratch));
  } else {
    zw_f32(zw_s, zh_s, w_s);
  }
  __syncthreads();  // ZW complete; the phase-1 region is free again

  O* out_l = out + (size_t)l * M * N;
  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * TN;
    load_rows<T, Lt::LD>(zt_s, z_tail, j0, TN, N);
    __syncthreads();
    if constexpr (std::is_same<T, bf16>::value) {
      float* st_s = reinterpret_cast<float*>(smem + S::st);
      scores_bf16(st_s, zw_s, zt_s);
      __syncthreads();
      for (int e = threadIdx.x; e < TM * TN; e += kThreads) {
        const int gi = i0 + e / TN, gj = j0 + e % TN;
        if (gi < M && gj < N) {
          out_l[(size_t)gi * N + gj] =
              from_f32<O>(st_s[(e / TN) * Lt::LDS + e % TN]);
        }
      }
    } else {
      scores_f32_store<O>(out_l, zw_s, zt_s, i0, j0, M, N);
    }
    __syncthreads();  // before the next tile overwrites zt_s / st_s
  }
}

template <typename T, typename O>
cudaError_t launch(const void* z_head, const void* z_tail, const void* w,
                   void* out, int L, int M, int N, int splits,
                   cudaStream_t stream) {
  const size_t smem = Smem<T>::total;
  cudaError_t err = cudaFuncSetAttribute(
      bilinear_kernel<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (N + TN - 1) / TN;
  if (splits < 1) splits = 1;
  if (splits > n_tiles) splits = n_tiles;
  const int per = (n_tiles + splits - 1) / splits;
  const dim3 grid((M + TM - 1) / TM, L, (n_tiles + per - 1) / per);
  bilinear_kernel<T, O><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(z_head), static_cast<const T*>(z_tail),
      static_cast<const T*>(w), static_cast<O*>(out), M, N, per);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// z_head [M, 128], z_tail [N, 128], w [L, 128, 128] in the compute type
// (bf16 if compute_bf16 else f32), all contiguous and 16-byte aligned;
// out [L, M, N] in bf16 if out_bf16 else f32. Launches on `stream`,
// does not synchronize, and returns cudaGetLastError().
int madrigal_bilinear_scores(const void* z_head, const void* z_tail,
                             const void* w, void* out, int L, int M, int N,
                             int compute_bf16, int out_bf16, int splits,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (compute_bf16) {
    err = out_bf16 ? launch<bf16, bf16>(z_head, z_tail, w, out, L, M, N, splits, s)
                   : launch<bf16, float>(z_head, z_tail, w, out, L, M, N, splits, s);
  } else {
    err = out_bf16 ? launch<float, bf16>(z_head, z_tail, w, out, L, M, N, splits, s)
                   : launch<float, float>(z_head, z_tail, w, out, L, M, N, splits, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
