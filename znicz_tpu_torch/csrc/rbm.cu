// RBM CD-k statistics for Hopper (sm_90a), as ordinary tensor-core GEMMs.
//
// Replaces the pl.pallas_call of znicz_tpu/ops/pallas/rbm.py:
//   _statistics / _cd_kernel (:161, kernel at :59)
// For v0 [B, V], the row mask [B], W [V, H], vbias [V], hbias [H]:
//   h0p = sigmoid(v0 W + hb),   h = (u < h0p)
//   k times:  vp = sigmoid(h W^T + vb),  v = (u < vp),
//             hp = sigmoid(v W + hb),    h = (u < hp)  (not drawn on the last step)
//   dW  = (v0 m)^T h0p - (vp m)^T hp            [V, H]
//   dvb = sum_b (v0 - vp) m,  dhb = sum_b (h0p - hp) m
//   stats = (sum_b mean_v (v0 - vp)^2 m,  sum_b m)
// The lr / n_valid update runs outside, in PyTorch.
//
// Random numbers.  The TPU kernel samples with the TPU's hardware PRNG,
// which nothing else reproduces.  Here every uniform is a counter-based
// draw: Philox4x32-10 with key (seed, stream) at counter (n, 0, 0, 0),
// where n is the element's flat index in uh [1 + k, B, H] (stream 0, the
// hidden draws: slot 0 the first, slot s + 1 step s's) or uv [k, B, V]
// (stream 1, the visible draws), and the uniform is the first output
// word's 24 low bits times 2^-24, as the TPU kernel's _uniform makes it.
// ops/kernels/rbm.py has a bit-identical PyTorch twin, so the card and the
// CPU draw the same numbers.  Given uh and uv (non-null), the kernel reads
// them instead: the JAX kernel's interpret-mode contract, which the tests
// use.
//
// What bounds it on an H100: operations.  CD-k does (2k + 3) products of
// 2 B V H flops (k = 1, B 1024, 784 x 1024: 8.2 GFLOP, 0.050 ms at the
// TF32 tensor-core rate taken three times, 0.12 ms at the f32 FMA rate)
// against ~10 MB of inputs and outputs.  At the model's shape (B 100,
// 784 x 128, k 1: 0.1 GFLOP) a step is below a launch's fixed cost.  The
// TPU kernel holds the whole chain in VMEM (its 10 MiB fits_vmem budget);
// here W alone is 3.2 MB at 784 x 1024, beyond any block's 227 KB, and a
// chain held in one block's shared memory bounds V + H.  So the design is
// one ordinary tiled GEMM, reused by every product through strides and an
// epilogue, launched 2k + 2 times a step; the chain's states live in
// buffers the wrapper allocates, read by the next launch:
//   hidden_kernel  (1 + k launches): A = v0 or step s's visible draws,
//                  B = W; h0p and the first draw, step s's draw, or on the
//                  last step hp and each (64-row tile, column)'s partial
//                  of dhb;
//   visible_kernel (k launches): A = step s's hidden draws, B = W^T; the
//                  visible draws, and on the last step vp, each (row,
//                  64-column tile)'s partial of (v0 - vp)^2 and each
//                  (64-row tile, column)'s partial of dvb;
//   stats_kernel   (1 launch): dW over K = 2B, A = v0 m then -vp m, B =
//                  h0p then hp; its edge blocks sum the dvb and dhb
//                  partials, block (0, 0) the two statistics.
// The GEMM: a block of 4 warps owns a 64 x 64 output tile (a warp 16 rows
// and all 64 columns, eight m16n8k8 tiles) and walks K in chunks of 32,
// copied by cp.async (16-byte copies where every row of every operand is
// 16-byte aligned, else 4-byte ones; zero-filled past M, N and K) into a
// double-buffered raw stage, then split once in shared memory into big =
// tf32(x) and small = x - big, stored in the order of the mma fragments
// (one 16-byte load a fragment).  Each product is small.big + big.small +
// big.big (3xTF32) on mma.sync.m16n8k8.tf32, with f32 accuracy: a chunk's
// small and big terms gather in two fresh accumulators, added into an f32
// register sum each chunk (the tensor cores truncate as they accumulate,
// so no long sum stays in an mma accumulator).  Every sum runs in a fixed
// order and nothing uses atomics: a step gives the same bits every run.
// Masked rows run the chain and contribute nothing.  Limits: any shape
// whose buffers fit the card, with B and V at most 65535 tiles of 64 (the
// grid's y axis).
//
// Each C entry returns cudaGetLastError() (or the error of its set-up
// call); the Python wrapper raises on a non-zero code.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr int NT = 128;       // threads a block: 4 warps
constexpr int TILE = 64;      // output rows and columns of a block
constexpr int KC = 32;        // reduction chunk
constexpr int LD_NARROW = KC + 4;    // row of a raw tile whose rows are 32 wide
constexpr int LD_WIDE = TILE + 8;    // row of a raw tile whose rows are 64 wide
constexpr int RAW = TILE * LD_NARROW;  // floats of a raw tile, either way (= KC * LD_WIDE)
static_assert(RAW == KC * LD_WIDE, "both raw layouts take the same room");
constexpr int FRAG_A = 4 * (KC / 8) * 32;  // (warp, k8 step, lane) slots of A's fragments
constexpr int FRAG_B = (KC / 8) * (TILE / 8) * 32;  // (k8 step, n8 tile, lane) of B's
// two raw stages of A and B, then A's big and small fragments (a uint4 each
// a slot) and B's (one uint4 a slot: b0, b1 big, then b0, b1 small)
constexpr int SMEM_BYTES = (4 * RAW + 8 * FRAG_A + 4 * FRAG_B) * 4;
static_assert(SMEM_BYTES <= 232448, "a block's shared memory");

constexpr uint32_t PHILOX_M0 = 0xD2511F53u;
constexpr uint32_t PHILOX_M1 = 0xCD9E8D57u;
constexpr uint32_t PHILOX_W0 = 0x9E3779B9u;
constexpr uint32_t PHILOX_W1 = 0xBB67AE85u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(PHILOX_M0, c.x), lo0 = PHILOX_M0 * c.x;
    const uint32_t hi1 = __umulhi(PHILOX_M1, c.z), lo1 = PHILOX_M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += PHILOX_W0;
    k1 += PHILOX_W1;
  }
  return c;
}

// element n of the (seed, stream) sequence of uniforms in [0, 1)
__device__ __forceinline__ float uniform_at(unsigned long long n, uint32_t seed, uint32_t stream) {
  const uint4 r = philox4x32_10(
      make_uint4(static_cast<uint32_t>(n), static_cast<uint32_t>(n >> 32), 0u, 0u), seed, stream);
  return static_cast<float>(r.x & 0xFFFFFFu) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// -- copies and 3xTF32 pieces; twins of csrc/flash_attention.cu's (smem_u32,
// cp_async16, cp_async4, cp_async_commit, cp_async_wait_all, split_tf32,
// mma_tf32), copied so that this file alone keys its build

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

// C[M, N] = sum over segments s < nseg of sum_k A_s(m, k) B_s(k, n) scale_s(k),
// K rows a segment.  A_s(m, k) is a[s][m * lda + k] when AK (k contiguous),
// else a[s][k * lda + m]; B_s(k, n) is b[s][k * ldb + n] when BN (n
// contiguous), else b[s][n * ldb + k].  scale_s(k) is 1 without `scale`, else
// scale[k] negated in segment 1 (the statistics' row mask, and the minus of
// the negative phase).
struct Gemm {
  const float* a[2];
  const float* b[2];
  long long lda, ldb;
  int m, n, k, nseg;
  const float* scale;
};

// rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major matrix (row stride
// ld; rows from r_lim and columns from c_lim on are zero-filled) into
// dst[r * LD + c], C being its contiguous axis.  COPY 16 needs 16-byte-aligned
// rows and c_lim a multiple of 4, so that a piece is all in or all out.
template <int COPY, int R, int C>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long ld, int r0,
                                          int r_lim, int c0, int c_lim) {
  constexpr int W = COPY / 4;  // floats a copy
  constexpr int LD = C == KC ? LD_NARROW : LD_WIDE;
  constexpr int PIECES = R * C / W;
  static_assert(PIECES % NT == 0, "a tile is a whole number of copies a thread");
#pragma unroll
  for (int it = 0; it < PIECES / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / (C / W), c = (i % (C / W)) * W;
    const bool in = r0 + r < r_lim && c0 + c < c_lim;
    const float* s = in ? src + (long long)(r0 + r) * ld + c0 + c : src;
    if constexpr (COPY == 16) {
      cp_async16(dst + r * LD + c, s, in);
    } else {
      cp_async4(dst + r * LD + c, s, in);
    }
  }
}

// chunk c's raw tiles of A (m0's rows) and B (n0's columns) into ra, rb
template <int COPY, bool AK, bool BN>
__device__ __forceinline__ void load_chunk(const Gemm& g, int c, int nch, int m0, int n0,
                                           float* ra, float* rb) {
  // the segment by a select, not an index: g stays in registers
  const bool seg1 = c >= nch;
  const int k0 = (seg1 ? c - nch : c) * KC;
  const float* a = seg1 ? g.a[1] : g.a[0];
  const float* b = seg1 ? g.b[1] : g.b[0];
  if constexpr (AK) {
    load_tile<COPY, TILE, KC>(ra, a, g.lda, m0, g.m, k0, g.k);
  } else {
    load_tile<COPY, KC, TILE>(ra, a, g.lda, k0, g.k, m0, g.m);
  }
  if constexpr (BN) {
    load_tile<COPY, KC, TILE>(rb, b, g.ldb, k0, g.k, n0, g.n);
  } else {
    load_tile<COPY, TILE, KC>(rb, b, g.ldb, n0, g.n, k0, g.k);
  }
  cp_async_commit();
}

// A(m, k) and B(k, n) of a raw tile, tile-local indices
template <bool AK>
__device__ __forceinline__ float raw_a(const float* ra, int m, int k) {
  return AK ? ra[m * LD_NARROW + k] : ra[k * LD_WIDE + m];
}
template <bool BN>
__device__ __forceinline__ float raw_b(const float* rb, int k, int n) {
  return BN ? rb[k * LD_WIDE + n] : rb[n * LD_NARROW + k];
}

// m16n8k8 fragments (lane = 4 g + t): A holds (row g, k t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); B (k t, column g), (t + 4, g); the
// accumulator (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
//
// The raw chunk split into big and small fragments by the whole block:
// A's slot (warp w, k8 step ks, lane) at (w * 4 + ks) * 32 + lane, B's slot
// (ks, n8 tile j, lane) at (ks * 8 + j) * 32 + lane.  A's rows scaled by
// s0 (k t) and s1 (k t + 4) of this thread's k8 step first.
template <bool AK, bool BN>
__device__ __forceinline__ void split_chunk(const float* ra, const float* rb, uint4* fa_big,
                                            uint4* fa_small, uint4* fb, float s0, float s1) {
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int ks = tid >> 5;  // A: slot tid + 128 w has k8 step tid / 32
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const int m = 16 * w + g, k = 8 * ks + t;
    uint4 big, small;
    split_tf32(raw_a<AK>(ra, m, k) * s0, big.x, small.x);
    split_tf32(raw_a<AK>(ra, m + 8, k) * s0, big.y, small.y);
    split_tf32(raw_a<AK>(ra, m, k + 4) * s1, big.z, small.z);
    split_tf32(raw_a<AK>(ra, m + 8, k + 4) * s1, big.w, small.w);
    fa_big[tid + NT * w] = big;
    fa_small[tid + NT * w] = small;
  }
#pragma unroll
  for (int it = 0; it < FRAG_B / NT; ++it) {
    const int e = tid + NT * it, j = (e >> 5) & 7, k = 8 * (e >> 8) + t, n = 8 * j + g;
    uint4 f;
    split_tf32(raw_b<BN>(rb, k, n), f.x, f.z);
    split_tf32(raw_b<BN>(rb, k + 4, n), f.y, f.w);
    fb[e] = f;
  }
}

// The block's 64 x 64 tile of C at (m0, n0) into acc: a warp's 16 rows
// (16 w + g, + 8) at the columns 8 j + 2t (+ 1) of acc[j].
template <int COPY, bool AK, bool BN>
__device__ __forceinline__ void gemm_tile(const Gemm& g, int m0, int n0, float* smem,
                                          float (&acc)[8][4]) {
  float* raw = smem;  // [stage][A, B]
  uint4* fa_big = reinterpret_cast<uint4*>(smem + 4 * RAW);
  uint4* fa_small = fa_big + FRAG_A;
  uint4* fb = fa_small + FRAG_A;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nch = (g.k + KC - 1) / KC, total = g.nseg * nch;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  load_chunk<COPY, AK, BN>(g, 0, nch, m0, n0, raw, raw + RAW);
  for (int c = 0; c < total; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c landed; every warp is done with chunk c - 1's fragments
    float s0 = 1.f, s1 = 1.f;
    if (g.scale != nullptr) {
      const int kk = (c % nch) * KC + 8 * (tid >> 5) + (lane & 3);
      const float sign = c < nch ? 1.f : -1.f;
      s0 = kk < g.k ? sign * g.scale[kk] : 0.f;
      s1 = kk + 4 < g.k ? sign * g.scale[kk + 4] : 0.f;
    }
    const float* stage = raw + 2 * RAW * (c & 1);
    split_chunk<AK, BN>(stage, stage + RAW, fa_big, fa_small, fb, s0, s1);
    if (c + 1 < total) {  // into the other stage, last read by chunk c - 1's split
      float* next = raw + 2 * RAW * ((c + 1) & 1);
      load_chunk<COPY, AK, BN>(g, c + 1, nch, m0, n0, next, next + RAW);
    }
    __syncthreads();  // the fragments are split
    float cb[8][4] = {}, cs[8][4] = {};  // this chunk's big and small terms
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks) {
      const uint4 ab4 = fa_big[(warp * 4 + ks) * 32 + lane];
      const uint4 as4 = fa_small[(warp * 4 + ks) * 32 + lane];
      const uint32_t ab[4] = {ab4.x, ab4.y, ab4.z, ab4.w};
      const uint32_t as[4] = {as4.x, as4.y, as4.z, as4.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint4 f = fb[(ks * 8 + j) * 32 + lane];
        mma_tf32(cs[j], as, f.x, f.y);
        mma_tf32(cs[j], ab, f.z, f.w);
        mma_tf32(cb[j], ab, f.x, f.y);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += cb[j][e] + cs[j][e];
  }
  __syncthreads();  // the epilogue may reuse the shared memory
}

// -- the chain's launches -----------------------------------------------------

struct Chain {
  const float* v0;
  const float* mask;
  const float* w;
  const float* vb;
  const float* hb;
  const float* uh;  // [1 + k, B, H] or null: draw in the kernel
  const float* uv;  // [k, B, V] or null
  float* h0p;       // [B, H]
  float* vp;        // [B, V], the last step's
  float* hp;        // [B, H], the last step's
  float* hs;        // [k, B, H]: the hidden draws of slots 0 .. k - 1
  float* vs;        // [k, B, V]: each step's visible draws
  float* err_part;  // [B, tiles(V)]: sum of (v0 - vp)^2 over a 64-column tile
  float* dvb_part;  // [tiles(B), V]: sum of (v0 - vp) m over a 64-row tile
  float* dhb_part;  // [tiles(B), H]: sum of (h0p - hp) m over a 64-row tile
  float* dw;        // [V, H]
  float* dvb;       // [V]
  float* dhb;       // [H]
  float* stats;     // [2]
  int b, v, h, cd_k;
  const uint32_t* seed;  // one uint32 on the card, read by each thread
};

__host__ __device__ constexpr int tiles(int n) { return (n + TILE - 1) / TILE; }

// the column sums over the block's 64 rows of col[j][q] (a thread's two rows
// at its columns 8 j + 2t + q), in a fixed order: a thread's rows, the 8
// lanes of one t (xor 4, 8, 16), then the 4 warps; into out[n0 + c] for
// n0 + c < n
__device__ __forceinline__ void column_partials(float (&col)[8][2], float* red, float* out,
                                                int n0, int n) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float s = col[j][q];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 4) red[warp * TILE + 8 * j + 2 * t + q] = s;
    }
  __syncthreads();
  if (tid < TILE && n0 + tid < n)
    out[n0 + tid] = ((red[tid] + red[TILE + tid]) + red[2 * TILE + tid]) + red[3 * TILE + tid];
}

// hidden units of slot `slot` from A = a [B, V] (v0 for slot 0, step
// slot - 1's visible draws after): p = sigmoid(a W + hb); slot 0 writes h0p,
// slot k (the last step) hp and the dhb partials, every other slot draws
template <int COPY>
__global__ void __launch_bounds__(NT) hidden_kernel(Chain c, const float* a, int slot) {
  extern __shared__ __align__(16) float smem[];
  const Gemm g{{a, nullptr}, {c.w, nullptr}, c.v, c.h, c.b, c.h, c.v, 1, nullptr};
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  float acc[8][4];
  gemm_tile<COPY, true, true>(g, m0, n0, smem, acc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool last = slot == c.cd_k;
  const uint32_t seed = *c.seed;
  float col[8][2] = {};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + 16 * warp + (lane >> 2) + 8 * (e >> 1);
      const int n = n0 + 8 * j + 2 * (lane & 3) + (e & 1);
      if (r >= c.b || n >= c.h) continue;
      const float p = sigmoid(acc[j][e] + c.hb[n]);
      const size_t idx = (size_t)r * c.h + n;
      if (last) {
        c.hp[idx] = p;
        col[j][e & 1] += (c.h0p[idx] - p) * c.mask[r];
      } else {
        if (slot == 0) c.h0p[idx] = p;
        const size_t at = (size_t)slot * c.b * c.h + idx;
        const float u = c.uh ? c.uh[at] : uniform_at(at, seed, 0u);
        c.hs[at] = u < p ? 1.f : 0.f;
      }
    }
  if (last) column_partials(col, smem, c.dhb_part + (size_t)blockIdx.y * c.h, n0, c.h);
}

// visible units of step `step` from A = its hidden draws [B, H]: p =
// sigmoid(h W^T + vb), drawn; the last step also writes vp, the error and
// the dvb partials
template <int COPY>
__global__ void __launch_bounds__(NT) visible_kernel(Chain c, int step) {
  extern __shared__ __align__(16) float smem[];
  const Gemm g{{c.hs + (size_t)step * c.b * c.h, nullptr}, {c.w, nullptr}, c.h, c.h, c.b, c.v,
               c.h, 1, nullptr};
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  float acc[8][4];
  gemm_tile<COPY, true, false>(g, m0, n0, smem, acc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool last = step == c.cd_k - 1;
  const uint32_t seed = *c.seed;
  float col[8][2] = {}, row[2] = {};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + 16 * warp + (lane >> 2) + 8 * (e >> 1);
      const int n = n0 + 8 * j + 2 * (lane & 3) + (e & 1);
      if (r >= c.b || n >= c.v) continue;
      const float p = sigmoid(acc[j][e] + c.vb[n]);
      const size_t idx = (size_t)r * c.v + n, at = (size_t)step * c.b * c.v + idx;
      const float u = c.uv ? c.uv[at] : uniform_at(at, seed, 1u);
      c.vs[at] = u < p ? 1.f : 0.f;
      if (last) {
        c.vp[idx] = p;
        const float d = c.v0[idx] - p;
        row[e >> 1] = fmaf(d, d, row[e >> 1]);
        col[j][e & 1] += d * c.mask[r];
      }
    }
  if (!last) return;
  // each row's error over the tile's 64 columns: a thread's 16, then the 4
  // lanes of its row (xor 1, 2)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float s = row[half];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const int r = m0 + 16 * warp + (lane >> 2) + 8 * half;
    if ((lane & 3) == 0 && r < c.b) c.err_part[(size_t)r * tiles(c.v) + blockIdx.x] = s;
  }
  column_partials(col, smem, c.dvb_part + (size_t)blockIdx.y * c.v, n0, c.v);
}

// dW over K = 2B in two segments, (v0 m)^T h0p then -(vp m)^T hp; the
// blocks of the first column of tiles sum the dvb partials, those of the
// first row the dhb partials, and block (0, 0) the two statistics
template <int COPY>
__global__ void __launch_bounds__(NT) stats_kernel(Chain c) {
  extern __shared__ __align__(16) float smem[];
  const Gemm g{{c.v0, c.vp}, {c.h0p, c.hp}, c.v, c.h, c.v, c.h, c.b, 2, c.mask};
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE, tid = threadIdx.x;
  float acc[8][4];
  gemm_tile<COPY, false, true>(g, m0, n0, smem, acc);
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = m0 + 16 * warp + (lane >> 2) + 8 * (e >> 1);
      const int n = n0 + 8 * j + 2 * (lane & 3) + (e & 1);
      if (i < c.v && n < c.h) c.dw[(size_t)i * c.h + n] = acc[j][e];
    }
  const int tb = tiles(c.b);
  if (blockIdx.x == 0 && tid < TILE && m0 + tid < c.v) {
    float s = 0.f;
    for (int q = 0; q < tb; ++q) s += c.dvb_part[(size_t)q * c.v + m0 + tid];
    c.dvb[m0 + tid] = s;
  }
  if (blockIdx.y == 0 && tid >= TILE && n0 + tid - TILE < c.h) {
    float s = 0.f;
    for (int q = 0; q < tb; ++q) s += c.dhb_part[(size_t)q * c.h + n0 + tid - TILE];
    c.dhb[n0 + tid - TILE] = s;
  }
  if (blockIdx.x == 0 && blockIdx.y == 0) {  // (sum_b err_b m_b, sum_b m_b)
    float* re = smem;
    float* rm = smem + NT;
    const int tv = tiles(c.v);
    float e = 0.f, mm = 0.f;
    for (int r = tid; r < c.b; r += NT) {
      float s = 0.f;
      for (int q = 0; q < tv; ++q) s += c.err_part[(size_t)r * tv + q];
      e += s / static_cast<float>(c.v) * c.mask[r];
      mm += c.mask[r];
    }
    re[tid] = e;
    rm[tid] = mm;
    __syncthreads();
    for (int s = NT / 2; s > 0; s >>= 1) {
      if (tid < s) {
        re[tid] += re[tid + s];
        rm[tid] += rm[tid + s];
      }
      __syncthreads();
    }
    if (tid == 0) {
      c.stats[0] = re[0];
      c.stats[1] = rm[0];
    }
  }
}

__global__ void uniforms_kernel(float* out, long long n, uint32_t seed, uint32_t stream) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = uniform_at(static_cast<unsigned long long>(i), seed, stream);
  }
}

// the kernels' dynamic shared memory, allowed once on each device (not on
// every call: a call may be captured into a CUDA graph)
template <int COPY>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};  // a bit a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load() & bit) return cudaSuccess;
  for (const void* k : {reinterpret_cast<const void*>(hidden_kernel<COPY>),
                        reinterpret_cast<const void*>(visible_kernel<COPY>),
                        reinterpret_cast<const void*>(stats_kernel<COPY>)}) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return err;
  }
  done.fetch_or(bit);
  return cudaSuccess;
}

template <int COPY>
cudaError_t run_chain(const Chain& c, cudaStream_t s) {
  {
    const cudaError_t err = allow_smem<COPY>();
    if (err != cudaSuccess) return err;
  }
  const dim3 hid(tiles(c.h), tiles(c.b)), vis(tiles(c.v), tiles(c.b)), st(tiles(c.h), tiles(c.v));
  hidden_kernel<COPY><<<hid, NT, SMEM_BYTES, s>>>(c, c.v0, 0);
  cudaError_t err = cudaGetLastError();
  for (int step = 0; step < c.cd_k && err == cudaSuccess; ++step) {
    visible_kernel<COPY><<<vis, NT, SMEM_BYTES, s>>>(c, step);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    hidden_kernel<COPY><<<hid, NT, SMEM_BYTES, s>>>(c, c.vs + (size_t)step * c.b * c.v, step + 1);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  stats_kernel<COPY><<<st, NT, SMEM_BYTES, s>>>(c);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// Every buffer after uv is the wrapper's (ops/kernels/rbm.py buffer_shapes,
// in this order) and is written whole before it is read; dw [V, H], dvb [V],
// dhb [H] and stats [2] are the results.  uh, uv: null to draw in the kernel
// from `seed` (one uint32 on the card, read through the pointer).  B, V, H,
// cd_k >= 1; B and V at most 65535 tiles of 64.
int znicz_rbm_cd(const float* v0, const float* mask, const float* w, const float* vb,
                 const float* hb, const float* uh, const float* uv, float* h0p, float* vp,
                 float* hp, float* hs, float* vs, float* err_part, float* dvb_part,
                 float* dhb_part, float* dw, float* dvb, float* dhb, float* stats, int b, int v,
                 int h, int cd_k, const unsigned int* seed, void* stream) {
  if (b < 1 || v < 1 || h < 1 || cd_k < 1) return (int)cudaErrorInvalidValue;
  if (tiles(b) > 65535 || tiles(v) > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Chain c{v0, mask, w, vb, hb, uh, uv, h0p, vp, hp, hs, vs, err_part, dvb_part,
                dhb_part, dw, dvb, dhb, stats, b, v, h, cd_k, seed};
  // 16-byte copies when every row of every operand starts on 16 bytes
  const bool wide = v % 4 == 0 && h % 4 == 0 && aligned16(v0) && aligned16(w) &&
                    aligned16(h0p) && aligned16(vp) && aligned16(hp) && aligned16(hs) &&
                    aligned16(vs);
  return (int)(wide ? run_chain<16>(c, s) : run_chain<4>(c, s));
}

// out[i] = the in-kernel uniform of flat index i of (seed, stream), for i < n
int znicz_rbm_uniforms(float* out, long long n, unsigned int seed, unsigned int stream,
                       void* stream_handle) {
  if (n < 1) return 0;
  const long long blocks = (n + NT - 1) / NT;
  uniforms_kernel<<<static_cast<unsigned int>(blocks < 4096 ? blocks : 4096), NT, 0,
                    static_cast<cudaStream_t>(stream_handle)>>>(out, n, seed, stream);
  return (int)cudaGetLastError();
}

const char* znicz_rbm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
