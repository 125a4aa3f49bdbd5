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
// What bounds it: with f32 compute, the f32 FMA rate (f32 does not go
// through the tensor cores, and no TF32 is used: every product is an
// fmaf); with bf16 compute and output, the bytes of the [L, M, N] scores,
// each written once (2 bytes per 256 flops).
//
// f32 compute: two kernels, both the register-blocked FMA product
// `gemm_f32`.
//   1. ZW pass: zw[l] = z_head @ W_l into an f32 scratch [L, M, 128] that
//      the caller allocates (round_c is the identity in f32).
//   2. Score pass: out[l] = zw[l] @ z_tail^T, a batched product with
//      K = 128.
// A block of 256 threads owns a 128x128 output tile, and each thread an
// 8x8 register block (64 accumulators). K is walked in slabs of BK = 8:
// each slab of both operands is read from global memory as float4 and
// stored k-major in shared memory, so that a k step reads a thread's 8
// rows and 8 columns as four 16-byte loads for 64 FMAs (the first design
// did 8 scalar loads for 16). Slabs are double-buffered, with one
// __syncthreads a slab, and two blocks fit on an SM. The main loop is
// then bound by the rate at which the SM issues FMAs. The epilogue stages
// the tile in shared memory, and each warp writes 16 of its rows, each
// as one contiguous run of 128 scores, with streaming stores
// (st.global.cs), so that the scores do not evict z_tail and zw from L2:
// 4-element vectors where N % 4 == 0 and `out` is aligned for them,
// single values otherwise (N = 6843 on the serving path). Rows >= M and
// columns >= N are masked; there is no padding and no slice-back.
//
// bf16 compute (the design of the first port, unchanged): one block owns
// rows [i0, i0 + 64) of z_head and one outcome l. It stages the z_head
// tile and W_l in shared memory, forms ZW = round_c(z_head_tile @ W_l)
// once on the tensor cores (WMMA 16x16x16, f32 accumulators) and keeps
// it in shared memory, then walks its share of the z_tail tiles: each
// 64-row tile is staged, multiplied against ZW and written out through an
// f32 staging tile, with the ragged edge masked. Its loads are not
// pipelined (no cp.async / TMA).
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
// (272 B, a multiple of the 32 B that WMMA loads need)
template <typename T> struct Layout;
template <> struct Layout<bf16> {
  static constexpr int LD = D + 8;   // z tiles and ZW
  static constexpr int LDW = D + 8;  // W_l
  static constexpr int LDS = TN + 4; // f32 staging of one score tile
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
  zw_bf16(zw_s, zh_s, w_s, reinterpret_cast<float*>(smem + S::scratch));
  __syncthreads();  // ZW complete; the phase-1 region is free again

  O* out_l = out + (size_t)l * M * N;
  for (int t = t_begin; t < t_end; ++t) {
    const int j0 = t * TN;
    load_rows<T, Lt::LD>(zt_s, z_tail, j0, TN, N);
    __syncthreads();
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

// ----------------------------------------------------------------- f32
namespace f32 {

constexpr int BM = 128, BN = 128;  // output tile of a block
constexpr int BK = 8;              // k slab
// k-major slab row: float4-aligned, and the transposed stores of the two
// row groups a warp writes land on distinct banks
constexpr int LDT = BM + 4;
constexpr int LOADS = BM * BK / 4 / kThreads;  // float4 a thread, operand, slab
constexpr int LDO = BN + 4;  // row of the epilogue's staged output tile
// shared memory: two slabs of each operand, then (reusing them) the
// block's 128x128 output tile
constexpr size_t kSlabBytes = sizeof(float) * 2 * 2 * BK * LDT;
constexpr size_t kTileBytes = sizeof(float) * BM * LDO;
constexpr size_t kSmem = kSlabBytes > kTileBytes ? kSlabBytes : kTileBytes;
static_assert(BN == D, "a k-major B operand (W_l) is one column tile");
static_assert(LOADS * kThreads * 4 == BM * BK, "slab loads cover the slab");
static_assert(BN == 32 * 4 && BM == 16 * kWarps,
              "the epilogue: a warp writes 16 rows, a lane 4 columns a row");

// 16 bytes from global memory through the read-only path, or zeros where
// not `ok`, with no branch. A plain asm statement: as __ldg, or as a
// volatile asm with a memory clobber, ptxas issued the next slab's loads
// after the slab's FMAs instead of before them, and every slab waited out
// the load's latency.
__device__ __forceinline__ float4 load4(const float* p, bool ok) {
  float4 v;
  asm("{ .reg .pred q; setp.ne.b32 q, %5, 0;\n"
      "  mov.b32 %0, 0; mov.b32 %1, 0; mov.b32 %2, 0; mov.b32 %3, 0;\n"
      "  @q ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4]; }"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "r"((int)ok));
  return v;
}

// Rows [r0, r0 + BM), columns [k0, k0 + BK) of a row-major [nrows, D]
// matrix as float4, thread t taking row idx / (BK/4) of idx = t + 256*h;
// rows at or past nrows are zero.
__device__ __forceinline__ void fetch_rows(float4 (&v)[LOADS],
                                           const float* __restrict__ src,
                                           int r0, int nrows, int k0) {
#pragma unroll
  for (int h = 0; h < LOADS; ++h) {
    const int idx = threadIdx.x + kThreads * h;
    const int r = idx / (BK / 4), c = (idx % (BK / 4)) * 4;
    const bool ok = r0 + r < nrows;
    v[h] = load4(src + (size_t)(ok ? r0 + r : 0) * D + k0 + c, ok);
  }
}

// ... stored transposed into the k-major slab dst[BK][LDT]
__device__ __forceinline__ void stash_rows(float* dst,
                                           const float4 (&v)[LOADS]) {
#pragma unroll
  for (int h = 0; h < LOADS; ++h) {
    const int idx = threadIdx.x + kThreads * h;
    const int r = idx / (BK / 4), c = (idx % (BK / 4)) * 4;
    dst[(c + 0) * LDT + r] = v[h].x;
    dst[(c + 1) * LDT + r] = v[h].y;
    dst[(c + 2) * LDT + r] = v[h].z;
    dst[(c + 3) * LDT + r] = v[h].w;
  }
}

// Rows [k0, k0 + BK) of a k-major [D, BN] matrix (W_l) as float4, and
// their copy into the slab as they are.
__device__ __forceinline__ void fetch_kmajor(float4 (&v)[LOADS],
                                             const float* __restrict__ src,
                                             int k0) {
#pragma unroll
  for (int h = 0; h < LOADS; ++h) {
    const int idx = threadIdx.x + kThreads * h;
    const int k = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
    v[h] = load4(src + (size_t)(k0 + k) * D + c, true);
  }
}

__device__ __forceinline__ void stash_kmajor(float* dst,
                                             const float4 (&v)[LOADS]) {
#pragma unroll
  for (int h = 0; h < LOADS; ++h) {
    const int idx = threadIdx.x + kThreads * h;
    const int k = idx / (BN / 4), c = (idx % (BN / 4)) * 4;
    *reinterpret_cast<float4*>(dst + k * LDT + c) = v[h];
  }
}

// Streaming stores (st.global.cs, the instruction __stcs emits) of one
// and of four scores, done only where `ok`: the predicate is inside the
// asm, so a masked store costs no branch (__stcs under an `if` compiles
// to one branch region per store, which serializes the epilogue).
__device__ __forceinline__ void store1(float* p, float x, bool ok) {
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %2, 0;\n"
      "  @q st.global.cs.f32 [%0], %1; }" ::"l"(p), "f"(x), "r"((int)ok)
      : "memory");
}
__device__ __forceinline__ void store1(bf16* p, float x, bool ok) {
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %2, 0;\n"
      "  @q st.global.cs.b16 [%0], %1; }" ::"l"(p),
      "h"(__bfloat16_as_ushort(__float2bfloat16_rn(x))), "r"((int)ok)
      : "memory");
}
__device__ __forceinline__ void store4(float* p, float4 v, bool ok) {
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %5, 0;\n"
      "  @q st.global.cs.v4.f32 [%0], {%1, %2, %3, %4}; }" ::"l"(p),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"((int)ok)
      : "memory");
}
__device__ __forceinline__ void store4(bf16* p, float4 v, bool ok) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %3, 0;\n"
      "  @q st.global.cs.v2.b32 [%0], {%1, %2}; }" ::"l"(p),
      "r"(*reinterpret_cast<const unsigned*>(&lo)),
      "r"(*reinterpret_cast<const unsigned*>(&hi)), "r"((int)ok)
      : "memory");
}

// C[l] = A[l] @ B[l]^T on one 128x128 tile of C, in f32 FMAs.
//   A [M, D] row-major at A + l * a_lstride;
//   B [N, D] row-major at B + l * b_lstride, or with B_KMAJOR the k-major
//     [D, N = BN] (W_l, so that C[l] = A[l] @ W_l);
//   C [M, N] row-major at out + l * M * N, in O; `vec`: N % 4 == 0 and
//     `out` aligned for 4-element stores.
// grid: (ceil(N / BN), ceil(M / BM), L). Warp w owns the 64x32 warp tile
// at rows 64*(w/4), columns 32*(w%4); lane (lm, ln) = (lane/4, lane%4)
// owns rows 4*lm + 32*s + i and columns 4*ln + 16*t + j of it, s, t in
// {0, 1} and i, j in [0, 4): the 8 lanes of a row group read one
// contiguous 128-byte run of the A slab, the 4 of a column group a
// 64-byte run of the B slab, as broadcasts without bank conflicts.
template <bool B_KMAJOR, typename O>
__global__ void __launch_bounds__(kThreads, 2)
gemm_f32(const float* __restrict__ A, size_t a_lstride,
         const float* __restrict__ B, size_t b_lstride, O* __restrict__ out,
         int M, int N, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* as = reinterpret_cast<float*>(smem);  // [2][BK][LDT]
  float* bs = as + 2 * BK * LDT;               // [2][BK][LDT]
  const int l = blockIdx.z;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const float* a = A + l * a_lstride;
  const float* b = B + l * b_lstride;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4, lm = lane / 4, ln = lane % 4;
  const int ra = 64 * wm + 4 * lm;  // this thread's rows: ra + 32*s + i
  const int cb = 32 * wn + 4 * ln;  // and columns: cb + 16*t + j

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // slab kt of both operands into registers, and from there into
  // shared-memory buffer kt % 2
  float4 va[LOADS], vb[LOADS];
  auto fetch = [&](int kt) {
    fetch_rows(va, a, i0, M, kt * BK);
    if constexpr (B_KMAJOR) {
      fetch_kmajor(vb, b, kt * BK);
    } else {
      fetch_rows(vb, b, j0, N, kt * BK);
    }
  };
  auto stash = [&](int kt) {
    stash_rows(as + (kt & 1) * BK * LDT, va);
    if constexpr (B_KMAJOR) {
      stash_kmajor(bs + (kt & 1) * BK * LDT, vb);
    } else {
      stash_rows(bs + (kt & 1) * BK * LDT, vb);
    }
  };
  fetch(0);
  stash(0);
  __syncthreads();

#pragma unroll 1
  for (int kt = 0; kt < D / BK; ++kt) {
    // slab kt + 1 into registers, in flight during this slab's FMAs
    const bool more = kt + 1 < D / BK;
    if (more) fetch(kt + 1);
    const float* as_c = as + (kt & 1) * BK * LDT;
    const float* bs_c = bs + (kt & 1) * BK * LDT;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as_c + k * LDT + ra);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as_c + k * LDT + ra + 32);
      const float4 b0 = *reinterpret_cast<const float4*>(bs_c + k * LDT + cb);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs_c + k * LDT + cb + 16);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    // into the other buffer, which was last read before the last barrier
    if (more) stash(kt + 1);
    __syncthreads();  // the slab just read is free; the next is in place
  }

  // epilogue: the block's tile staged in the (now free) slab buffers,
  // then warp w writes rows [16w, 16w + 16) of it, each as one contiguous
  // run of 128 scores
  float* tile = reinterpret_cast<float*>(smem);  // [BM][LDO]
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < 2; ++t)
        *reinterpret_cast<float4*>(tile + (ra + 32 * s + i) * LDO + cb +
                                   16 * t) =
            make_float4(acc[4 * s + i][4 * t], acc[4 * s + i][4 * t + 1],
                        acc[4 * s + i][4 * t + 2], acc[4 * s + i][4 * t + 3]);
  __syncthreads();
  const int r0 = 16 * warp;
  const float* src = tile + r0 * LDO;
  O* dst = out + (size_t)l * M * N + (size_t)(i0 + r0) * N + j0;
  if (vec) {  // lane: columns [4 * lane, 4 * lane + 4)
    const bool col_ok = j0 + 4 * lane < N;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      store4(dst + (size_t)r * N + 4 * lane,
             *reinterpret_cast<const float4*>(src + r * LDO + 4 * lane),
             col_ok && i0 + r0 + r < M);
    }
  } else {  // lane: columns lane + 32*q
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = src[r * LDO + lane + 32 * q];
      const bool row_ok = i0 + r0 + r < M;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        store1(dst + (size_t)r * N + lane + 32 * q, v[q],
               row_ok && j0 + lane + 32 * q < N);
      }
    }
  }
}

// The ZW pass into `zw` [L, M, D], then the score pass into `out`.
template <typename O>
cudaError_t launch(const float* z_head, const float* z_tail, const float* w,
                   float* zw, O* out, int L, int M, int N,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_f32<true, float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gemm_f32<false, O>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem);
  if (err != cudaSuccess) return err;
  const int m_tiles = (M + BM - 1) / BM;
  gemm_f32<true, float><<<dim3(1, m_tiles, L), kThreads, kSmem, stream>>>(
      z_head, 0, w, (size_t)D * D, zw, M, D, 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int vec = N % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % (4 * sizeof(O)) == 0;
  gemm_f32<false, O><<<dim3((N + BN - 1) / BN, m_tiles, L), kThreads, kSmem,
                       stream>>>(zw, (size_t)M * D, z_tail, 0, out, M, N,
                                 vec);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

extern "C" {

// z_head [M, 128], z_tail [N, 128], w [L, 128, 128] in the compute type
// (bf16 if compute_bf16 else f32), all contiguous and 16-byte aligned;
// with f32 compute, zw is an f32 scratch [L, M, 128] (unused, and may be
// null, with bf16 compute); out [L, M, N] in bf16 if out_bf16 else f32.
// `splits` divides the bf16 kernel's z_tail sweep. Launches on `stream`,
// does not synchronize, and returns cudaGetLastError().
int madrigal_bilinear_scores(const void* z_head, const void* z_tail,
                             const void* w, void* zw, void* out, int L,
                             int M, int N, int compute_bf16, int out_bf16,
                             int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (compute_bf16) {
    err = out_bf16 ? launch<bf16, bf16>(z_head, z_tail, w, out, L, M, N, splits, s)
                   : launch<bf16, float>(z_head, z_tail, w, out, L, M, N, splits, s);
  } else {
    const float* zh = static_cast<const float*>(z_head);
    const float* zt = static_cast<const float*>(z_tail);
    const float* wf = static_cast<const float*>(w);
    float* zwf = static_cast<float*>(zw);
    err = out_bf16
              ? f32::launch(zh, zt, wf, zwf, static_cast<bf16*>(out), L, M, N, s)
              : f32::launch(zh, zt, wf, zwf, static_cast<float*>(out), L, M, N, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
