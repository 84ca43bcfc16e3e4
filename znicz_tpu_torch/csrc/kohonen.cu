// Fused Kohonen batch-SOM statistics for Hopper (sm_90a), as 3xTF32
// tensor-core GEMM launches.
//
// Replaces the pl.pallas_call of znicz_tpu/ops/pallas/kohonen.py:
//   _accumulate / _accum_kernel (:93, kernel at :36)
// For x [B, F], the map w [M, F], the row mask [B], the pairwise squared
// grid distances d2m [M, M] and 2 sigma^2 (a host float):
//   win_b  = argmax_j (x_b . w_j - |w_j|^2 / 2)        (first index on ties)
//   h_bj   = exp(-d2m[win_b, j] / (2 sigma^2)) * mask_b
//   num    = h^T x  [M, F]          den = sum_b h_b  [M]
// A row whose scores are all -inf or NaN keeps unit 0.  The weight update
// w + lr (num / den - w) runs outside, in PyTorch.
//
// What bounds it on an H100: operations.  The scores x.w^T and num = h^T x
// are 4 B M F flops (B 4096, a 32x32 map, F 784: 13.15 GFLOP, 0.080 ms at
// the TF32 tensor-core rate taken three times, 0.196 ms on f32 FMAs)
// against ~24 MB of inputs and outputs.  At the model's shape (B 100, an 8x8
// map, F 784: 20 MFLOP) a step is below a launch's fixed cost, so the
// launches must spread over many SMs rather than walk F in a few blocks.
//
// Design: one tiled GEMM on the tensor cores in 3xTF32, launched for each
// product with its own operands and epilogue, with the winners and the
// neighbourhood table between them; three launches a call:
//   scores_kernel  S = x.w^T over K = F, split along F into `nsplit` pieces
//                  of whole chunks (grid z) when the batch and map tiles
//                  alone would leave the card idle.  Each block writes its
//                  partial scores [B, M] of its piece, and the blocks of the
//                  first batch tile the partial |w_j|^2 of their units
//                  (f32, each lane's k in order, then a fixed shuffle tree).
//   winners_kernel one warp a batch row sums the partial scores and |w|^2
//                  over the pieces in order, subtracts |w|^2 / 2 and takes
//                  the row's (best, first index); the blocks past the rows
//                  write neigh = exp(-d2m / 2 sigma^2) [M, M] once.
//   accum_kernel   [num | den] = h^T [x | 1] over K = B: A = h^T is gathered
//                  in the load stage, one row of neigh a batch row (neigh's
//                  row win_b, coalesced along the units; the chunk's winners
//                  are copied into shared memory a chunk ahead), and scaled
//                  by the row mask as it is read, so h never reaches device
//                  memory; B = x with a column of ones at F (written into
//                  the landed tile by the threads that zero-filled it), so
//                  den comes out of the same tiles as num, in the same
//                  fixed order.
// The GEMM: a block of 4 warps owns a 64 x 64 output tile, a warp a 32 x 32
// quarter of it (two m16 rows x four n8 columns of m16n8k8 tiles: 16
// fragment values a lane for 24 mma a k8 step), and walks K in chunks of 64,
// copied by cp.async (16-byte copies where every row of every operand is
// 16-byte aligned, else 4-byte ones; zero-filled past M, N and K) into a
// double-buffered raw stage: one barrier a chunk.  Each warp reads its
// fragments straight from the raw stage (rows of 64 along k at a stride of
// 68 floats, rows along m or n at 72: conflict-free) and splits each value
// as it reads it into big = tf32(v) and small = v - big.  A product is
// small.big + big.small + big.big (3xTF32) on mma.sync.m16n8k8.tf32, with
// f32 accuracy: a chunk's small and big terms gather in two fresh
// accumulators, added into an f32 register sum each chunk (the tensor cores
// truncate as they accumulate, so no long sum stays in an mma accumulator).
// Every sum runs in a fixed order and nothing uses atomics: a call gives the
// same bits every run.  Limits: B and M at most 65535 tiles of 64 (a grid's
// y axis).
//
// Each C entry returns cudaGetLastError() (or the error of its set-up
// call); the Python wrapper raises on a non-zero code.

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int NT = 128;             // threads a GEMM block: 4 warps
constexpr int TILE = 64;            // output rows and columns of a GEMM block
constexpr int KC = 64;              // reduction chunk
constexpr int WARPS_N = 2;          // warps along a tile's columns (2 x 2 warps)
constexpr int MI = TILE / (4 / WARPS_N) / 16;  // m16 tiles a warp: 2
constexpr int NJ = TILE / WARPS_N / 8;         // n8 tiles a warp: 4
constexpr int LD_K = KC + 4;        // row of a raw tile whose rows run along k
constexpr int LD_MN = TILE + 8;     // row of a raw tile whose rows run along m or n
constexpr int RAW = KC * LD_MN > TILE * LD_K ? KC * LD_MN : TILE * LD_K;  // either way
// a stage: the raw tiles of A and B, then for the accumulate the chunk's
// row scale (the mask) and gathered rows (the winners)
constexpr int STAGE = 2 * RAW + 2 * KC;
constexpr int SMEM_BYTES = 2 * STAGE * 4;  // two stages
static_assert(SMEM_BYTES <= 232448, "a block's shared memory");
static_assert(RAW % 4 == 0 && STAGE % 4 == 0, "16-byte aligned tiles");
constexpr int WR = 8;               // batch rows a winners block: a warp each

// -- copies and 3xTF32 pieces; twins of csrc/rbm.cu's (smem_u32, cp_async16,
// cp_async4, cp_async_commit, cp_async_wait_all, split_tf32, mma_tf32),
// copied so that this file alone keys its build

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero-filled when !full
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy of this thread has landed; a __syncthreads() then makes all
// threads' copies visible
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x = big + small: big is x rounded to tf32 (10 stored mantissa bits), to
// nearest with ties away from zero, in two integer instructions; small =
// x - big is exact, and the tensor cores read its top 19 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c += a.b for one m16n8k8 tile, tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- the GEMM -----------------------------------------------------------------

// C[M, N] = sum_k A(m, k) B(k, n).  scores (ACC false): A(m, k) =
// a[m * lda + k] (x), B(k, n) = b[n * ldb + k] (w).  accumulate (ACC true):
// A(m, k) = a[rows[k] * lda + m] * scale[k] (neigh's row win_k times the
// mask), B(k, n) = b[k * ldb + n] (x) for n < n_load and 1 at n == n_load
// (the ones column that gives den).
struct Gemm {
  const float* a;
  const float* b;
  const int* rows;
  const float* scale;
  long long lda, ldb;
  int m, n, k, n_load;
};

// rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major matrix (row stride
// ld; rows from r_lim and columns from c_lim on are zero-filled; tile row r
// read from row rows[r] when rows is given) into dst[r * LD + c], C being
// its contiguous axis.  COPY 16 needs 16-byte-aligned rows and c_lim a
// multiple of 4, so that a piece is all in or all out.
template <int COPY, int R, int C, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long ld, int r0,
                                          int r_lim, int c0, int c_lim, const int* rows) {
  constexpr int W = COPY / 4;  // floats a copy
  constexpr int PIECES = R * C / W;
  static_assert(PIECES % NT == 0, "a tile is a whole number of copies a thread");
  // 4-byte copies: 32 a thread, unrolled 4 at a time, so that their addresses
  // do not crowd the fragments out of the registers
#pragma unroll(COPY == 16 ? PIECES / NT : 4)
  for (int it = 0; it < PIECES / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / (C / W), c = (i % (C / W)) * W;
    const bool in = r0 + r < r_lim && c0 + c < c_lim;
    const float* s = src;
    if (in) s = src + (long long)(rows != nullptr ? rows[r] : r0 + r) * ld + c0 + c;
    if constexpr (COPY == 16) {
      cp_async16(dst + r * LD + c, s, in);
    } else {
      cp_async4(dst + r * LD + c, s, in);
    }
  }
}

// the accumulate's rows of chunk c (the winners of its batch rows, 0 past
// K) into a stage
__device__ __forceinline__ void load_rows(const Gemm& g, int c, float* stage) {
  if (threadIdx.x < KC) {
    const int k = c * KC + threadIdx.x;
    cp_async4(stage + 2 * RAW + KC + threadIdx.x, k < g.k ? g.rows + k : g.rows, k < g.k);
  }
}

// chunk c's raw tiles of A (m0's rows) and B (n0's columns), and for the
// accumulate its row scale, into one stage; the accumulate gathers A's rows
// through the stage's rows, loaded one chunk ahead
template <int COPY, bool ACC>
__device__ __forceinline__ void load_chunk(const Gemm& g, int c, int m0, int n0, float* stage) {
  const int k0 = c * KC;
  float* ra = stage;
  float* rb = stage + RAW;
  if constexpr (ACC) {
    // A^T = neigh's rows win_k: [k][m]; B = x: [k][n]
    const int* rows = reinterpret_cast<const int*>(stage + 2 * RAW + KC);
    load_tile<COPY, KC, TILE, LD_MN>(ra, g.a, g.lda, k0, g.k, m0, g.m, rows);
    load_tile<COPY, KC, TILE, LD_MN>(rb, g.b, g.ldb, k0, g.k, n0, g.n_load, nullptr);
    if (threadIdx.x < KC) {
      const int k = k0 + threadIdx.x;
      cp_async4(stage + 2 * RAW + threadIdx.x, k < g.k ? g.scale + k : g.scale, k < g.k);
    }
  } else {
    // A = x: [m][k]; B^T = w: [n][k]
    load_tile<COPY, TILE, KC, LD_K>(ra, g.a, g.lda, m0, g.m, k0, g.k, nullptr);
    load_tile<COPY, TILE, KC, LD_K>(rb, g.b, g.ldb, n0, g.n, k0, g.k, nullptr);
  }
}

// the accumulate's ones column (tile column col) into the B tile of a
// stage whose copies have landed: each element by the thread that copied
// (zero-filled) it, so that no other thread's copy can land after it
template <int COPY>
__device__ __forceinline__ void ones_column(float* rb, int col) {
  constexpr int W = COPY / 4, PER_ROW = TILE / W;
#pragma unroll
  for (int it = 0; it < KC * PER_ROW / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    if (i % PER_ROW == col / W) rb[(i / PER_ROW) * LD_MN + col] = 1.f;
  }
}

// A(m, k) and B(k, n) of a raw tile, tile-local indices
template <bool ACC>
__device__ __forceinline__ float raw_a(const float* ra, int m, int k) {
  return ACC ? ra[k * LD_MN + m] : ra[m * LD_K + k];
}
template <bool ACC>
__device__ __forceinline__ float raw_b(const float* rb, int k, int n) {
  return ACC ? rb[k * LD_MN + n] : rb[n * LD_K + k];
}

// m16n8k8 fragments (lane = 4 g + t): A holds (row g, k t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); B (k t, column g), (t + 4, g); the
// accumulator (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
//
// The block's 64 x 64 tile of C at (m0, n0) over chunks [c0, c1) into acc:
// warp w owns rows 16 MI (w / WARPS_N) + 16 i + g (+ 8) and columns
// 8 NJ (w % WARPS_N) + 8 j + 2t (+ 1) of acc[i][j].  With `want_sq` (scores
// only), the lanes also sum the squares of the B values they read into
// sq[j]: over the 4 lanes of one g, the squares of column 8 NJ (w %
// WARPS_N) + 8 j + g over [c0, c1).
template <int COPY, bool ACC>
__device__ __forceinline__ void gemm_tile(const Gemm& g, int m0, int n0, int c0, int c1,
                                          float* smem, float (&acc)[MI][NJ][4], bool want_sq,
                                          float (&sq)[NJ]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int am = 16 * MI * (warp / WARPS_N) + gq, bn = 8 * NJ * (warp % WARPS_N) + gq;
  const int ones = ACC ? g.n_load - n0 : -1;  // the ones column, if in this tile
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) sq[j] = 0.f;
  if constexpr (ACC) {  // chunk c0's rows now, chunk c0 + 1's ahead
    load_rows(g, c0, smem);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    if (c0 + 1 < c1) load_rows(g, c0 + 1, smem + STAGE);
  }
  load_chunk<COPY, ACC>(g, c0, m0, n0, smem);
  cp_async_commit();
  for (int c = c0; c < c1; ++c) {
    float* stage = smem + STAGE * ((c - c0) & 1);
    cp_async_wait_all();
    if (ACC && ones >= 0 && ones < TILE) ones_column<COPY>(stage + RAW, ones);
    __syncthreads();  // chunk c landed; every warp is done with chunk c - 1's stage
    if (c + 1 < c1) {
      float* next = smem + STAGE * ((c + 1 - c0) & 1);
      load_chunk<COPY, ACC>(g, c + 1, m0, n0, next);
      if (ACC && c + 2 < c1) load_rows(g, c + 2, stage);  // chunk c's rows are spent
      cp_async_commit();
    }
    const float* ra = stage;
    const float* rb = stage + RAW;
    float cb[MI][NJ][4] = {}, cs[MI][NJ][4] = {};  // this chunk's big and small terms
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      const int k = 8 * ks + t;
      float s0 = 1.f, s1 = 1.f;
      if constexpr (ACC) {
        s0 = stage[2 * RAW + k];
        s1 = stage[2 * RAW + k + 4];
      }
      uint32_t ab[MI][4], as[MI][4], bb[NJ][2], bs[NJ][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int m = am + 16 * i;
        split_tf32(raw_a<ACC>(ra, m, k) * s0, ab[i][0], as[i][0]);
        split_tf32(raw_a<ACC>(ra, m + 8, k) * s0, ab[i][1], as[i][1]);
        split_tf32(raw_a<ACC>(ra, m, k + 4) * s1, ab[i][2], as[i][2]);
        split_tf32(raw_a<ACC>(ra, m + 8, k + 4) * s1, ab[i][3], as[i][3]);
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float v0 = raw_b<ACC>(rb, k, bn + 8 * j), v1 = raw_b<ACC>(rb, k + 4, bn + 8 * j);
        if (!ACC && want_sq) sq[j] = fmaf(v1, v1, fmaf(v0, v0, sq[j]));
        split_tf32(v0, bb[j][0], bs[j][0]);
        split_tf32(v1, bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          mma_tf32(cs[i][j], as[i], bb[j][0], bb[j][1]);
          mma_tf32(cs[i][j], ab[i], bs[j][0], bs[j][1]);
          mma_tf32(cb[i][j], ab[i], bb[j][0], bb[j][1]);
        }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += cb[i][j][e] + cs[i][j][e];
  }
}

// the row and column of element e of acc[i][j] in the block's tile
__device__ __forceinline__ int tile_row(int i, int e) {
  return 16 * MI * ((threadIdx.x >> 5) / WARPS_N) + 16 * i + ((threadIdx.x & 31) >> 2) +
         8 * (e >> 1);
}
__device__ __forceinline__ int tile_col(int j, int e) {
  return 8 * NJ * ((threadIdx.x >> 5) % WARPS_N) + 8 * j + 2 * (threadIdx.x & 3) + (e & 1);
}

__host__ __device__ constexpr int tiles(int n) { return (n + TILE - 1) / TILE; }
__host__ __device__ constexpr int chunks(int n) { return (n + KC - 1) / KC; }

// partial scores of piece z = blockIdx.z (chunks [z cps, (z + 1) cps) of F):
// part[z][b][j] = x_b . w_j over the piece; the blocks of the first batch
// tile also write sq_part[z][j] = |w_j|^2 over the piece
template <int COPY>
__global__ void __launch_bounds__(NT, 2)
    scores_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ part, float* __restrict__ sq_part, int b, int m, int f,
                  int cps) {
  extern __shared__ __align__(16) float smem[];
  const Gemm g{x, w, nullptr, nullptr, f, f, b, m, f, m};
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE, z = blockIdx.z;
  const int c0 = z * cps, c1 = min(c0 + cps, chunks(f));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the warps of the tile's first rows see every column
  const bool want_sq = blockIdx.y == 0 && warp < WARPS_N;
  float acc[MI][NJ][4], sq[NJ];
  gemm_tile<COPY, false>(g, m0, n0, c0, c1, smem, acc, want_sq, sq);
  float* out = part + (size_t)z * b * m;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + tile_row(i, e), n = n0 + tile_col(j, e);
        if (r < b && n < m) out[(size_t)r * m + n] = acc[i][j][e];
      }
  if (want_sq) {
    // the 4 lanes of one g hold column g's k = t, t + 4 (mod 8): xor 1, then 2
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float s = sq[j];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const int n = n0 + 8 * NJ * (warp % WARPS_N) + 8 * j + (lane >> 2);
      if ((lane & 3) == 0 && n < m) sq_part[(size_t)z * m + n] = s;
    }
  }
}

// blocks [0, row_blocks): one warp a batch row, its winner; the blocks after
// them: neigh = exp(-d2m / 2 sigma^2), grid-stride
__global__ void __launch_bounds__(32 * WR)
    winners_kernel(const float* __restrict__ part, const float* __restrict__ sq_part,
                   const float* __restrict__ d2m, float* __restrict__ neigh,
                   int* __restrict__ win, int b, int m, int nsplit, int row_blocks,
                   float two_sigma_sq) {
  if ((int)blockIdx.x >= row_blocks) {
    const long long n = (long long)m * m;
    for (long long i = (blockIdx.x - row_blocks) * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)(gridDim.x - row_blocks) * blockDim.x) {
      neigh[i] = expf(-d2m[i] / two_sigma_sq);
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WR + (threadIdx.x >> 5);
  if (r >= b) return;
  float best = -INFINITY;
  int best_i = INT_MAX;
  // units in increasing order: a strict > keeps the first of equal scores
  for (int j = lane; j < m; j += 32) {
    float s = part[(size_t)r * m + j], sq = sq_part[j];
    for (int z = 1; z < nsplit; ++z) {
      s += part[((size_t)z * b + r) * m + j];
      sq += sq_part[(size_t)z * m + j];
    }
    s -= 0.5f * sq;
    if (s > best) {
      best = s;
      best_i = j;
    }
  }
  // argmax across the warp, lower index on ties
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (ov > best || (ov == best && oi < best_i)) {
      best = ov;
      best_i = oi;
    }
  }
  // a row whose scores are all -inf or NaN keeps unit 0, a valid index
  if (lane == 0) win[r] = best_i == INT_MAX ? 0 : best_i;
}

// [num | den] = h^T [x | 1] over K = B, h = neigh[win] * mask
template <int COPY>
__global__ void __launch_bounds__(NT, 2)
    accum_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                 const int* __restrict__ win, const float* __restrict__ neigh,
                 float* __restrict__ num, float* __restrict__ den, int b, int m, int f) {
  extern __shared__ __align__(16) float smem[];
  const Gemm g{neigh, x, win, mask, m, f, m, f + 1, b, f};
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  float acc[MI][NJ][4], unused[NJ];
  gemm_tile<COPY, true>(g, m0, n0, 0, chunks(b), smem, acc, false, unused);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = m0 + tile_row(i, e), n = n0 + tile_col(j, e);
        if (u >= m) continue;
        if (n < f) {
          num[(size_t)u * f + n] = acc[i][j][e];
        } else if (n == f) {
          den[u] = acc[i][j][e];
        }
      }
}

// the GEMM kernels' dynamic shared memory, allowed once on each device
template <int COPY>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load() & bit) return cudaSuccess;
  for (const void* k : {reinterpret_cast<const void*>(scores_kernel<COPY>),
                        reinterpret_cast<const void*>(accum_kernel<COPY>)}) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
  }
  done.fetch_or(bit);
  return cudaSuccess;
}

template <int COPY>
cudaError_t run(const float* x, const float* w, const float* mask, const float* d2m,
                float* part, float* sq_part, float* neigh, int* win, float* num, float* den,
                int b, int m, int f, int nsplit, float two_sigma_sq, cudaStream_t s) {
  cudaError_t err = allow_smem<COPY>();
  if (err != cudaSuccess) return err;
  const int cps = (chunks(f) + nsplit - 1) / nsplit;
  scores_kernel<COPY><<<dim3(tiles(m), tiles(b), nsplit), NT, SMEM_BYTES, s>>>(
      x, w, part, sq_part, b, m, f, cps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int row_blocks = (b + WR - 1) / WR;
  const long long mm = (long long)m * m;
  const int neigh_blocks = (int)(mm / (32 * WR) < 1024 ? (mm + 32 * WR - 1) / (32 * WR) : 1024);
  winners_kernel<<<row_blocks + neigh_blocks, 32 * WR, 0, s>>>(
      part, sq_part, d2m, neigh, win, b, m, nsplit, row_blocks, two_sigma_sq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  accum_kernel<COPY><<<dim3(tiles(f + 1), tiles(m)), NT, SMEM_BYTES, s>>>(
      x, mask, win, neigh, num, den, b, m, f);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// part [nsplit, B, M], sq_part [nsplit, M], neigh [M, M] and win [B] (int32)
// are the wrapper's scratch (ops/kernels/kohonen.py buffer_shapes), each
// written whole before it is read; win holds the winners after the call;
// num [M, F] and den [M] are written whole.  B, M, F >= 1; nsplit pieces of
// ceil(chunks / nsplit) chunks of 64 features, none empty; B and M at most
// 65535 tiles of 64.
int znicz_kohonen_accumulate(const float* x, const float* w, const float* mask,
                             const float* d2m, float* part, float* sq_part, float* neigh,
                             int* win, float* num, float* den, int b, int m, int f, int nsplit,
                             float two_sigma_sq, void* stream) {
  if (b < 1 || m < 1 || f < 1 || nsplit < 1 || nsplit > chunks(f)) {
    return (int)cudaErrorInvalidValue;
  }
  const int cps = (chunks(f) + nsplit - 1) / nsplit;
  if ((chunks(f) + cps - 1) / cps != nsplit) return (int)cudaErrorInvalidValue;
  if (tiles(b) > 65535 || tiles(m) > 65535 || nsplit > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte copies when every row of every copied operand starts on 16 bytes
  const bool wide = f % 4 == 0 && m % 4 == 0 && aligned16(x) && aligned16(w) && aligned16(neigh);
  return (int)(wide ? run<16>(x, w, mask, d2m, part, sq_part, neigh, win, num, den, b, m, f,
                              nsplit, two_sigma_sq, s)
                    : run<4>(x, w, mask, d2m, part, sq_part, neigh, win, num, den, b, m, f,
                             nsplit, two_sigma_sq, s));
}

const char* znicz_kohonen_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
