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
// fmaf); with bf16 compute, the bytes of the [L, M, N] scores, each
// written once (2 or 4 bytes per 256 flops).
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
// bf16 compute: one kernel, `bilinear_kernel`. What bounds it is the bytes
// of the scores: at the all-pairs export chunk (64 x 6843 x 6843) the
// products take about 0.8 ms at the tensor cores' rate, writing the 6 GB
// of bf16 scores about 1.8 ms. The design keeps the stores flowing:
//   1. Outcome blocking. A block owns TM = 64 z_head rows and kGroup
//      consecutive outcomes (the TPU kernel's tile_l). It forms ZW_g =
//      round_c(z_head_tile @ W_g) for each of them once, and every z_tail
//      tile that arrives feeds all of them, so z_tail is read from L2 once
//      per kGroup outcomes instead of once per outcome.
//   2. A cp.async ring. z_tail tiles (TN = 64 rows) arrive by 16-byte
//      cp.async.cg copies into two stages: tile t + 1 is in flight while
//      tile t is multiplied and written. One __syncthreads a tile, plus
//      one for the staged output.
//   3. Tensor-core products on mma.sync.m16n8k16 (bf16 in, f32
//      accumulators) fed by ldmatrix, whose fragment layouts are known:
//      ZW is rounded to bf16 once, in registers, and each warp keeps its
//      rows of every ZW_g as A fragments in registers for the whole sweep,
//      so the main loop reads only z_tail from shared memory. The score is
//      converted to the output type once, as it is staged. Rows >= M,
//      columns >= N and outcomes >= L are masked; there is no padding and
//      no slice-back.
//   4. A branch-free epilogue that writes whole 128-byte lines. With N =
//      6843 (odd) every output row starts at its own 2-byte offset, and
//      stores of each tile's 64 scores as they fall leave two partly
//      written 32-byte sectors a row: that took more time than the
//      products. So each row is staged in a ring of 128 columns, and a
//      tile writes the row's columns that end on a 128-byte line boundary,
//      holding back the rest for the next tile: 16-byte streaming stores
//      (st.global.cs) of aligned lines, with the predicate inside the asm
//      (no branch a store). Only the first and last tile of a block's
//      sweep write single values.
//   The output is bf16 (bench.py's op) or f32 (score_all_pairs'
//   throughput export).
//
// C entry: madrigal_bilinear_scores(...) returns cudaGetLastError();
// madrigal_bilinear_outcome_group() returns kGroup, from which the wrapper
// sizes the bf16 grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;      // embedding width (the model's feature_dim)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

using bf16 = __nv_bfloat16;

// Streaming stores (st.global.cs, the instruction __stcs emits) of one
// score, of four, and of 16 raw bytes, done only where `ok`: the predicate
// is inside the asm, so a masked store costs no branch (__stcs under an
// `if` compiles to one branch region per store, which serializes the
// epilogue).
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
__device__ __forceinline__ void store1(bf16* p, bf16 x, bool ok) {
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %2, 0;\n"
      "  @q st.global.cs.b16 [%0], %1; }" ::"l"(p),
      "h"(__bfloat16_as_ushort(x)), "r"((int)ok)
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
__device__ __forceinline__ void store16(void* p, uint4 v, bool ok) {
  asm volatile(
      "{ .reg .pred q; setp.ne.b32 q, %5, 0;\n"
      "  @q st.global.cs.v4.b32 [%0], {%1, %2, %3, %4}; }" ::"l"(p),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"((int)ok)
      : "memory");
}

// ---------------------------------------------------------------- bf16
constexpr int kGroup = 2;  // outcomes a block (G); 2 ran faster than 4
constexpr int TM = 64;      // z_head rows a block
constexpr int TN = 64;      // z_tail rows a tile
// shared-memory row of a bf16 tile: 136 elements (272 B), so that the 8
// rows an ldmatrix reads start on 8 distinct 16-byte bank groups
constexpr int LD = D + 8;
constexpr size_t kZTileBytes = sizeof(bf16) * TM * LD;  // 64 rows (TM == TN)
static_assert(TM == TN && TM == 16 * (kWarps / 2), "a warp: 16 rows x 32");

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

// The staged output rows, in the output type O. Each row is a ring of
// CIRC columns holding this tile's 64 scores and the ones of the last tile
// not yet written; column c sits at (c + shift) % CIRC, shift being the
// row's offset in scores inside an aligned 16 bytes of `out`, so that every
// 16 bytes the epilogue stores are one aligned 16-byte read of the stage.
template <typename O> struct Stage {
  static constexpr int VEC = 16 / sizeof(O);    // scores in a 16-byte store
  static constexpr int LINE = 128 / sizeof(O);  // scores in a 128-byte line
  static constexpr int CIRC = 128;
  static constexpr int LDS = CIRC + VEC;        // 272 B (bf16), 528 B (f32)
  static constexpr int ROW_LANES = TN / VEC;    // lanes that write one row
  static constexpr int ROWS = 32 / ROW_LANES;   // rows a warp writes at once
  static_assert(TN + LINE <= CIRC, "a tile and a row's carry fit its ring");
};

// byte offsets of the shared-memory regions for G outcomes a block
template <typename O, int G> struct Smem {
  // phase 1 (ZW): the z_head tile, W_g (128 rows) and ZW_g, which each
  // warp then loads into registers
  static constexpr size_t zh = 0;
  static constexpr size_t w = zh + kZTileBytes;
  static constexpr size_t zw = w + 2 * kZTileBytes;
  static constexpr size_t phase1_end = zw + kZTileBytes;
  // phase 2 (scores) reuses it: the two-stage z_tail ring, then the G
  // staged output tiles [G][TM][LDS] in O
  static constexpr size_t ring = 0;
  static constexpr size_t stage = ring + 2 * kZTileBytes;
  static constexpr size_t phase2_end =
      stage + align128(sizeof(O) * G * TM * Stage<O>::LDS);
  // each output row's offset in scores inside its 128-byte line [G * TM]
  static constexpr size_t offs =
      phase1_end > phase2_end ? phase1_end : phase2_end;
  static constexpr size_t total = offs + G * TM;
};

template <typename O> __device__ __forceinline__ O from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zeros where not `ok`
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `pending` of this thread's groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// Rows [r0, r0 + rows) of a row-major bf16 [nrows, D] matrix into shared
// memory with leading dimension LD, by cp.async; rows at or past nrows
// are zero. The wrapper checks the 16-byte alignment.
__device__ __forceinline__ void copy_rows(bf16* dst,
                                          const bf16* __restrict__ src,
                                          int r0, int rows, int nrows) {
  constexpr int PER_ROW = D / 8;
  for (int idx = threadIdx.x; idx < rows * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * 8;
    const bool ok = r0 + r < nrows;
    cp_async16(dst + r * LD + c, src + (size_t)(ok ? r0 + r : 0) * D + c, ok);
  }
}

// four 8x8 bf16 matrices from shared memory, lane i giving the address of
// row i % 8 of matrix i / 8; with .trans each is transposed
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// acc[16x8] += a[16x16] @ b[16x8], bf16 in, f32 accumulators. Lane (g, q)
// = (lane / 4, lane % 4) holds acc rows g and g + 8, columns 2q and 2q + 1.
__device__ __forceinline__ void mma16816(float (&acc)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows [r0, r0 + 16), columns [k0, k0 + 16) of a
// row-major [*, LD] bf16 tile.
__device__ __forceinline__ void load_a(unsigned (&a)[4], const bf16* t,
                                       int r0, int k0) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(a, t + (r0 + lane % 16) * LD + k0 + (lane / 16) * 8);
}

// ZW[TM, D] = round_bf16(zh[TM, D] @ W[D, D]): warp w owns rows 16*(w%4)
// and columns [64*(w/4), +64). W is row-major [k][n], read transposed.
__device__ __forceinline__ void zw_tile(bf16* zw, const bf16* zh,
                                        const bf16* w_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * (warp % 4), c0 = 64 * (warp / 4);
  float acc[8][4] = {};
#pragma unroll
  for (int k0 = 0; k0 < D; k0 += 16) {
    unsigned a[4];
    load_a(a, zh, r0, k0);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      unsigned b[4];  // columns c0 + 16p + [0, 8) and [8, 16)
      ldsm_x4_trans(b, w_s + (k0 + lane % 16) * LD + c0 + 16 * p +
                           (lane / 16) * 8);
      mma16816(acc[2 * p], a, b[0], b[1]);
      mma16816(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = c0 + 8 * nt + 2 * q;
    *reinterpret_cast<__nv_bfloat162*>(zw + (r0 + g) * LD + c) =
        __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<__nv_bfloat162*>(zw + (r0 + g + 8) * LD + c) =
        __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
  }
}

// grid: (ceil(M / TM), ceil(L / G), splits). Block (x, y, z) owns z_head
// rows [TM*x, TM*x + TM), outcomes [G*y, G*y + G) and z_tail tiles
// [z*per, (z+1)*per). In phase 2 warp w owns rows 16*(w%4) and columns
// [32*(w/4), +32) of each outcome's 64x64 score tile.
template <typename O, int G>
__global__ void __launch_bounds__(kThreads, G <= 2 ? 2 : 1)
bilinear_kernel(const bf16* __restrict__ z_head,
                const bf16* __restrict__ z_tail, const bf16* __restrict__ w,
                O* __restrict__ out, int L, int M, int N,
                int tiles_per_split) {
  using S = Smem<O, G>;
  using St = Stage<O>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* zh_s = reinterpret_cast<bf16*>(smem + S::zh);
  bf16* w_s = reinterpret_cast<bf16*>(smem + S::w);
  bf16* zw_s = reinterpret_cast<bf16*>(smem + S::zw);
  bf16* ring = reinterpret_cast<bf16*>(smem + S::ring);
  O* stage = reinterpret_cast<O*>(smem + S::stage);
  unsigned char* offs = smem + S::offs;

  const int i0 = blockIdx.x * TM, l0 = blockIdx.y * G;
  const int n_tiles = (N + TN - 1) / TN;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  if (t_begin >= t_end) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 4, wn = warp / 4, gq = lane / 4, q = lane % 4;

  // output row (g, r) starts at score (l0 + g, i0 + r, 0): its offset in
  // scores inside the 128-byte line there
  for (int e = threadIdx.x; e < G * TM; e += kThreads) {
    const size_t first = ((size_t)(l0 + e / TM) * M + i0 + e % TM) * N;
    offs[e] = static_cast<unsigned char>(
        (reinterpret_cast<uintptr_t>(out) / sizeof(O) + first) % St::LINE);
  }

  // phase 1: ZW_g = round_c(z_head_tile @ W_g) for each outcome of the
  // block, kept as this warp's A fragments (rows 16*wm, all of K) in
  // registers; past L, W_g keeps the last outcome's values (masked below)
  unsigned a[G][D / 16][4];
  copy_rows(zh_s, z_head, i0, TM, M);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (l0 + g < L) copy_rows(w_s, w + (size_t)(l0 + g) * D * D, 0, D, D);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    zw_tile(zw_s, zh_s, w_s);
    __syncthreads();  // ZW_g complete
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      load_a(a[g][kk], zw_s, 16 * wm, 16 * kk);
    }
    __syncthreads();  // before the next W_g and ZW_g, or the ring, land
  }

  // phase 2: the z_tail tiles through the two-stage ring
  const int sub = lane / St::ROW_LANES, k = lane % St::ROW_LANES;
  copy_rows(ring + (t_begin & 1) * TN * LD, z_tail, t_begin * TN, TN, N);
  cp_async_commit();
#pragma unroll 1
  for (int t = t_begin; t < t_end; ++t) {
    if (t + 1 < t_end) {
      copy_rows(ring + ((t + 1) & 1) * TN * LD, z_tail, (t + 1) * TN, TN, N);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile t has landed; tile t + 1 stays in flight
    __syncthreads();     // tile t in place for every thread; stage free
    const bf16* zt = ring + (t & 1) * TN * LD;

    float acc[G][4][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned b[2][4];  // columns 32wn + 16p + [0, 8) and [8, 16)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        ldsm_x4(b[p], zt + (32 * wn + 16 * p + lane % 8 + (lane / 16) * 8) *
                               LD + 16 * kk + ((lane / 8) % 2) * 8);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          mma16816(acc[g][2 * p], a[g][kk], b[p][0], b[p][1]);
          mma16816(acc[g][2 * p + 1], a[g][kk], b[p][2], b[p][3]);
        }
      }
    }

    // stage: column TN*t + c of row (g, r) into its ring
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = g * TM + 16 * wm + gq + 8 * h;
        const int base = TN * t + (offs[rr] & (St::VEC - 1));
        O* row = stage + rr * St::LDS;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = base + 32 * wn + 8 * nt + 2 * q;
          row[c & (St::CIRC - 1)] = from_f32<O>(acc[g][nt][2 * h]);
          row[(c + 1) & (St::CIRC - 1)] = from_f32<O>(acc[g][nt][2 * h + 1]);
        }
      }
    }
    __syncthreads();  // the staged tiles are complete

    // store: a row's columns [TN*t - off, TN*t + TN - off) are whole
    // 128-byte lines of `out` (off: its offset in its line), written as
    // 16-byte vectors, ROW_LANES lanes a row; its last off columns wait
    // for the next tile. The first tile of the block's sweep starts at
    // column TN*t, the last one ends at min(TN*t + TN, N): single values.
    const bool whole = t != t_begin && t != t_end - 1;  // block-uniform
#pragma unroll 2
    for (int rr = warp * St::ROWS + sub; rr < G * TM;
         rr += kWarps * St::ROWS) {
      const int g = rr / TM, r = rr % TM;
      const bool row_ok = l0 + g < L && i0 + r < M;
      O* dst = out + ((size_t)(l0 + g) * M + i0 + r) * N;
      const int off = offs[rr], shift = off & (St::VEC - 1);
      const O* src = stage + rr * St::LDS;
      if (whole) {
        const int c = TN * t - off + St::VEC * k;
        store16(dst + c,
                *reinterpret_cast<const uint4*>(
                    src + ((c + shift) & (St::CIRC - 1))),
                row_ok);
      } else {
        const int lo = t == t_begin ? TN * t : TN * t - off;
        const int hi =
            t == t_end - 1 ? min(TN * t + TN, N) : TN * t + TN - off;
        for (int c = lo + k; c < hi; c += St::ROW_LANES) {
          store1(dst + c, src[(c + shift) & (St::CIRC - 1)], row_ok);
        }
      }
    }
  }
}

template <typename O>
cudaError_t launch(const void* z_head, const void* z_tail, const void* w,
                   void* out, int L, int M, int N, int splits,
                   cudaStream_t stream) {
  constexpr int G = kGroup;
  const size_t smem = Smem<O, G>::total;
  cudaError_t err = cudaFuncSetAttribute(
      bilinear_kernel<O, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (N + TN - 1) / TN;
  if (splits < 1) splits = 1;
  if (splits > n_tiles) splits = n_tiles;
  const int per = (n_tiles + splits - 1) / splits;
  const dim3 grid((M + TM - 1) / TM, (L + G - 1) / G,
                  (n_tiles + per - 1) / per);
  bilinear_kernel<O, G><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(z_head), static_cast<const bf16*>(z_tail),
      static_cast<const bf16*>(w), static_cast<O*>(out), L, M, N, per);
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
    err = out_bf16 ? launch<bf16>(z_head, z_tail, w, out, L, M, N, splits, s)
                   : launch<float>(z_head, z_tail, w, out, L, M, N, splits, s);
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

// Outcomes a block of the bf16 kernel owns: its grid is ceil(M / 64) x
// ceil(L / this) x splits.
int madrigal_bilinear_outcome_group(void) { return kGroup; }

}  // extern "C"
