// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the three pl.pallas_call's of znicz_tpu/ops/pallas/attention.py:
//   _flash_fwd_impl / _fwd_kernel (:212)  ->  fwd_tf32_kernel (f32), fwd_mma_kernel (bf16)
//   _flash_bwd / _dq_kernel        (:265)  ->  dq_tf32_kernel (f32), dq_mma_kernel (bf16)
//   _flash_bwd / _dkv_kernel       (:277)  ->  dkv_tf32_kernel (f32), dkv_mma_kernel (bf16)
//
// Layout: q, k, v, out, dout and the gradients are [B, T, H, D] contiguous,
// read in place through their strides (no [B*H, T, D] transposes); lse and
// delta are [B, T, H] float32.  D is 16, 32, 64, 128 or 256 (a template
// argument); T is any length: the ragged last tile is masked by index.
//
// What bounds these on an H100: operations.  At the LM slice (B*H = 128,
// T = 2048, D = 64, causal) the forward does 2 products over the T(T+1)/2
// live (q, k) pairs a head, ~69 GFLOP, dQ 3 and dK/dV 4, against ~0.13 GB
// of q, k, v, out: far above the card's ops-per-byte line in either type.
// In every kernel one block owns a 64-row tile and loops over the other
// side's 64-row tiles (the TPU grid's sequential axis becomes this loop);
// the f32 kernels' tiles take 32 rows at D 256 (below).
//
// The bf16 kernels (fwd_mma_kernel, dq_mma_kernel, dkv_mma_kernel) run on
// the tensor cores, the contract of the TPU kernels (each input's dtype on
// the matrix unit, f32 accumulation) being exactly mma.sync m16n8k16 bf16 x
// bf16 -> f32:
// - 4 warps (128 threads) a 64-row tile, each warp owning 16 rows.  The
//   forward and dQ hold their Q (and dO) A-fragments in registers for the
//   whole k loop at D <= 128: S = Q.K^T (and dP = dO.V^T); dK/dV works
//   key-major, S^T = K.Q^T and dP^T = V.dO^T, with the K and V A-fragments
//   in registers at D <= 64 and re-read from shared memory at D 128 (two
//   16 x 128 f32 accumulators already take 128 registers a thread there).
// - D 256: a warp's 16 x 256 f32 output accumulator alone takes 128
//   registers a thread (of 255).  The forward and dQ re-read Q's (and dO's)
//   A fragments from shared memory at each k16 step instead of holding them
//   (64 and 128 registers more), and dK/dV, whose dK and dV accumulators
//   would take 256, splits D's output columns between two blocks (gridDim.z
//   2): each recomputes the full-D score products S^T and dP^T from shared
//   memory and accumulates 128 columns of dK and dV, about 1.5 times the
//   kernel's products.  Every D-256 kernel compiles without spills.
// - p and ds never touch shared memory: two neighbouring m16n8 f32
//   accumulators packed to bf16x2 (cvt.rn, round to nearest even, the
//   TPU kernels' casts) are the A fragment of the next m16n8k16 product,
//   p.V (forward), ds.K (dQ), P^T.dO and dS^T.Q (dK/dV).  Nothing else is
//   rounded; the forward's row sums l take the unrounded f32 p.
// - The forward's online softmax runs on the score accumulators: a row's
//   64 scores of a k tile lie in the 4 lanes that share lane/4, so its max
//   is the thread's 16 values and two xor-shuffles; acc and l are rescaled
//   once a tile, and l is summed across the 4 lanes only at the end.  The
//   backward needs no row reduction, so it takes the other side's tile 16
//   rows at a time: two n8 score tiles, then one k16 step of the output
//   product, which keeps the live registers small.
// - The elementwise work between the products is kept short, as it
//   competes with them for the warp schedulers: p is exp2 of one FMA
//   (scale, and the forward's running max or the backward's lse, in log2
//   units), and the index mask is applied only to the 16 x 16 pieces that
//   cross the causal diagonal or the end of the sequence.
// - One bf16 copy of each tile in shared memory, rows padded to D + 8
//   elements so the 8 rows an ldmatrix reads fall in 8 distinct 16-byte
//   bank groups: ldmatrix.x4 gives the B fragments of the A.B^T products,
//   ldmatrix.x4.trans those of the A.B products from the same copy.
// - cp.async 16-byte copies, double buffered: the next K/V tile (forward,
//   dQ) or Q/dO/lse/delta tile (dK/dV) is in flight while this one is
//   computed; rows at or past T are zero-filled by the copy's source size,
//   so the tensors' data must start on a 16-byte boundary (the wrapper
//   checks).
// - ~46 KB (forward) to ~55 KB of shared memory a block at D 64 (~87 to
//   ~105 KB at D 128), so several blocks share an SM; at D 256 a 64-row
//   tile is 33,792 bytes, and the forward's 5 (168,960 bytes) and dQ's and
//   dK/dV's 6 (202,752 and 203,776) leave one block an SM.
// The f32 kernels (fwd_tf32_kernel, dq_tf32_kernel, dkv_tf32_kernel) take
// the same skeleton on the tensor cores in 3xTF32: mma.sync m16n8k8 tf32 x
// tf32 -> f32, each f32 operand split into a big and a small TF32 part and
// each product taken three times, which keeps f32's accuracy (the section
// below says how, and what the numerics are).  The f32 forward keeps the
// bf16 forward's online softmax on the score accumulators, with the running
// max in natural units and p in f32, exp2f of one FMA times log2 e as the
// backward computes it (not the bf16 forward's ex2.approx.ftz, which
// flushes a subnormal p to 0).  At D 256 an f32 tile of 64 rows (padded to
// D + 4) is 66,560 bytes, and the 5 or 6 that a kernel streams would take
// 332,800 to 400,384 of a block's 232,448: there the f32 tiles take 32 rows
// on both sides and a block two warps (166,400 to 200,192 bytes), with the
// bf16 kernels' re-read A fragments and dK/dV's column split.  wgmma, TMA
// and warp specialisation are left for later work.
//
// Causal: the k loop of a q tile stops at the diagonal tile, and the q loop
// of a k tile (dK/dV) starts there (the TPU kernels' _live skip); the
// kernels also skip, warp by warp, the 16-row pieces of the diagonal tile
// that are wholly masked (no score and no output product).
// Masked probabilities are exactly 0 (selected by index, never computed
// from the NEG_INF sentinel).  dK/dV has one owner per k tile, the forward
// and dQ one per q tile: no atomics, a launch is bitwise repeatable.  out,
// dq, dk and dv are scaled and rounded once, at the store.
//
// Each C entry returns cudaGetLastError() (or the error of its set-up
// call); the Python wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE = 64;          // rows of a q tile and of a k tile
constexpr float NEG_INF = -1e30f;  // the TPU kernels' sentinel
constexpr float L_FLOOR = 1e-30f;

struct Geom {
  int t;           // sequence length
  int h;           // heads
  long long sb;    // element stride of the batch axis (T * H * D)
  long long st;    // element stride of the time axis (H * D)
};

__device__ __forceinline__ bool valid(int qi, int ki, int t, int causal) {
  return ki < t && qi < t && (!causal || ki <= qi);
}

// ---------------------------------------------------------------------------
// bf16 forward, dQ and dK/dV on the tensor cores
//
// m16n8k16 fragments (lane = threadIdx.x % 32): an A tile (16 x 16) holds
// rows lane/4 and lane/4 + 8 at columns 2(lane%4) + {0, 1} and the same + 8;
// a B tile (16 x 8) columns lane/4 at rows 2(lane%4) + {0, 1} and + 8; an f32
// accumulator (16 x 8) c[0..1] at row lane/4 and c[2..3] at row lane/4 + 8,
// columns 2(lane%4) + {0, 1}.

using bf16 = __nv_bfloat16;
constexpr int MMA_NT = 128;  // 4 warps, 16 rows of the 64-row tile each
constexpr float LOG2E = 1.4426950408889634f;  // exp(x) = exp2(x * LOG2E)

// row stride, in elements, of a bf16 tile in shared memory
template <int D>
__host__ __device__ constexpr int ldb() { return D + 8; }

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

// four 8 x 8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a.b for one m16n8k16 tile, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to nearest even bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// fn(ks) for ks in [0, N): G steps unrolled at a time, the groups rolled
// (all N unrolled when G >= N)
template <int N, int G, typename Fn>
__device__ __forceinline__ void steps(Fn&& fn) {
  if constexpr (G >= N) {
#pragma unroll
    for (int ks = 0; ks < N; ++ks) fn(ks);
  } else {
#pragma unroll 1
    for (int k0 = 0; k0 < N; k0 += G)
#pragma unroll
      for (int kk = 0; kk < G; ++kk) fn(k0 + kk);
  }
}

// the copies of a tile that a thread unrolls together: all of them up to D
// 128; at D 256 four, the groups rolled.  Unrolled whole there, the compiler
// keeps the offsets of each of the thread's 16 or 32 rows live through the
// kernel (64-bit each), and every D-256 kernel spilled.
template <int D>
__host__ __device__ constexpr int copy_group() { return D <= 128 ? D : 4; }

// rows [r0, r0 + 64) of one head into dst[r * ldb + c], one 16-byte copy
// each; rows at or past the end of the sequence are zero-filled
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int r0,
                                                const Geom& g) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  static_assert(TILE * CH % MMA_NT == 0, "a tile is a whole number of copies a thread");
  steps<TILE * CH / MMA_NT, copy_group<D>()>([&](int it) {
    const int i = threadIdx.x + it * MMA_NT;
    const int r = i / CH, c = i % CH;
    const bool in = r0 + r < g.t;
    cp_async16(dst + r * ldb<D>() + c * 8, in ? src + (long long)(r0 + r) * g.st + c * 8 : src,
               in);
  });
}

// the x4 loads' per-lane row and column offsets: A fragments and the
// transposed B fragments of an A.B product (row lane % 16, column block
// lane / 16), and the B fragments of an A.B^T product (two n8 tiles of one
// k16 step: row lane % 8 + 8 (lane / 16), column block (lane / 8) % 2)
struct Lanes {
  int a_row, a_col, b_row, b_col;
  __device__ __forceinline__ explicit Lanes(int lane)
      : a_row(lane & 15),
        a_col((lane >> 4) * 8),
        b_row((lane & 7) + ((lane >> 4) << 3)),
        b_col(((lane >> 3) & 1) * 8) {}
};

// the k steps of a score product unrolled together where both operands are
// read from shared memory: all of them up to D 128; at D 256 eight, the
// groups rolled (a third less code to compile, and about as fast)
template <int D>
__host__ __device__ constexpr int score_group() { return D <= 128 ? D : 8; }

// s[j] += X[16 rows] . Y[y0 + 8j .. + 8)^T over D, for j 0, 1: X's A
// fragments from registers (xf, when HELD) or read at each k16 step from
// X's rows [x0, x0 + 16) in shared memory, Y's rows (the other side's tile,
// [64][ldb]) from shared memory
template <int D, bool HELD>
__device__ __forceinline__ void scores16(float s[2][4], uint32_t (*xf)[4], const bf16* X, int x0,
                                         const bf16* Y, int y0, const Lanes& ln) {
  steps<D / 16, HELD ? D : score_group<D>()>([&](int ks) {
    uint32_t xr[4], yf[4];
    const uint32_t* x = xr;
    if constexpr (HELD)
      x = xf[ks];
    else
      ldsm_x4(xr, X + (x0 + ln.a_row) * ldb<D>() + ks * 16 + ln.a_col);
    ldsm_x4(yf, Y + (y0 + ln.b_row) * ldb<D>() + ks * 16 + ln.b_col);
    mma_bf16(s[0], x, yf[0], yf[1]);
    mma_bf16(s[1], x, yf[2], yf[3]);
  });
}

// the forward's and dQ's Q (and dO) A fragments held in registers for the
// whole k loop, or re-read from shared memory (D 256, see above)
template <int D>
__host__ __device__ constexpr bool hold_afrags() { return D <= 128; }

// dK/dV's output columns split between this many blocks (gridDim.z), in
// both dtypes: above D 128 the dK and dV accumulators of all D would take
// 256 registers a thread
template <int D>
__host__ __device__ constexpr int dkv_splits() { return D > 128 ? 2 : 1; }

// the A fragments of rows [x0, x0 + 16) of a [64][ldb] tile, over D
template <int D>
__device__ __forceinline__ void load_afrags(uint32_t (*xf)[4], const bf16* X, int x0,
                                            const Lanes& ln) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldsm_x4(xf[ks], X + (x0 + ln.a_row) * ldb<D>() + ks * 16 + ln.a_col);
}

// acc[n] += a . Z[z0 .. z0 + 16)[8n .. 8n + 8) for every n8 tile of the NC
// columns from Z (rows of D): a is the packed A fragment of one k16 step,
// Z's rows its k axis
template <int D, int NC = D>
__device__ __forceinline__ void accumulate16(float (*acc)[4], const uint32_t a[4], const bf16* Z,
                                             int z0, const Lanes& ln) {
#pragma unroll
  for (int n2 = 0; n2 < NC / 16; ++n2) {
    uint32_t zf[4];
    ldsm_x4_t(zf, Z + (z0 + ln.a_row) * ldb<D>() + n2 * 16 + ln.a_col);
    mma_bf16(acc[2 * n2], a, zf[0], zf[1]);
    mma_bf16(acc[2 * n2 + 1], a, zf[2], zf[3]);
  }
}

// the A fragment of a 16 x 16 tile held as two n8 accumulators
__device__ __forceinline__ void pack_afrag(uint32_t a[4], float x[2][4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

// 16 rows x D of f32 accumulators, row lane/4 times mul0 and row lane/4 + 8
// times mul1, rounded once to bf16 and stored at rows r0 + lane/4 {, + 8} of
// one head; rows at or past T skipped
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, float (*acc)[4], float mul0, float mul1,
                                           int r0, const Geom& g, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + lane / 4 + 8 * half;
    if (r >= g.t) continue;
    const float mul = half ? mul1 : mul0;
    bf16* row = dst + (long long)r * g.st + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + 8 * n) =
          pack_bf16(mul * acc[n][2 * half], mul * acc[n][2 * half + 1]);
  }
}

// dQ: one block per (q tile, batch-head), looping over the live k tiles:
//   p = exp(s - lse), ds = p (dp - delta), dq = scale * sum_k ds.K
template <int D>
__global__ void __launch_bounds__(MMA_NT)
    dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dq, Geom g, float scale, int causal) {
  constexpr int LT = TILE * ldb<D>();  // elements of one tile
  constexpr bool HOLD = hold_afrags<D>();
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // [64][ldb]
  bf16* dOs = Qs + LT;                        // [64][ldb]
  bf16* Ks = dOs + LT;                        // [2 stages][64][ldb]
  bf16* Vs = Ks + 2 * LT;                     // [2 stages][64][ldb]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Lanes ln(lane);
  const int nt = (g.t + TILE - 1) / TILE;
  const int qb = nt - 1 - blockIdx.x;  // the longest causal rows start first
  const int b = blockIdx.y / g.h, h = blockIdx.y % g.h;
  const long long base = b * g.sb + (long long)h * D;
  const int q0 = qb * TILE;
  const int k_end = causal ? qb + 1 : nt;

  load_tile_async<D>(Qs, q + base, q0, g);
  load_tile_async<D>(dOs, dout + base, q0, g);
  load_tile_async<D>(Ks, k + base, 0, g);
  load_tile_async<D>(Vs, v + base, 0, g);
  cp_async_commit();

  const int w0 = q0 + warp * 16;  // this warp's first row
  const float scale2 = scale * LOG2E;
  float lse2[2], delta_r[2];  // rows w0 + lane/4 and + 8; lse2 = lse * LOG2E
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = w0 + lane / 4 + 8 * half;
    const long long si = ((long long)b * g.t + qi) * g.h + h;
    lse2[half] = qi < g.t ? lse[si] * LOG2E : 0.f;
    delta_r[half] = qi < g.t ? delta[si] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[HOLD ? D / 16 : 1][4], dof[HOLD ? D / 16 : 1][4];
  if constexpr (HOLD) {
    load_afrags<D>(qf, Qs, warp * 16, ln);
    load_afrags<D>(dof, dOs, warp * 16, ln);
  }

  for (int kb = 0; kb < k_end; ++kb) {
    if (kb + 1 < k_end) {  // the next tile's copies, in flight during this one
      const int st = (kb + 1) & 1;
      load_tile_async<D>(Ks + st * LT, k + base, (kb + 1) * TILE, g);
      load_tile_async<D>(Vs + st * LT, v + base, (kb + 1) * TILE, g);
      cp_async_commit();
    }
    const bf16* Kc = Ks + (kb & 1) * LT;
    const bf16* Vc = Vs + (kb & 1) * LT;
    const int k0 = kb * TILE;
#pragma unroll
    for (int c = 0; c < TILE / 16; ++c) {
      const int kc = k0 + 16 * c;  // this piece's first key
      // wholly masked for this warp: past the diagonal, past T
      if ((causal && kc > w0 + 15) || kc >= g.t || w0 >= g.t) continue;
      float s[2][4] = {}, dp[2][4] = {};
      scores16<D, HOLD>(s, qf, Qs, warp * 16, Kc, 16 * c, ln);
      scores16<D, HOLD>(dp, dof, dOs, warp * 16, Vc, 16 * c, ln);
      // s -> ds = p (dp - delta); the index mask only where the piece
      // crosses the diagonal or the end of the sequence
      auto to_ds = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2f(fmaf(s[j][e], scale2, -lse2[e >> 1]));
            if constexpr (decltype(masked)::value) {
              const int qi = w0 + lane / 4 + 8 * (e >> 1);
              const int ki = kc + 8 * j + 2 * (lane % 4) + (e & 1);
              p = valid(qi, ki, g.t, causal) ? p : 0.f;
            }
            s[j][e] = p * (dp[j][e] - delta_r[e >> 1]);
          }
      };
      if ((causal && kc + 15 > w0) || kc + 16 > g.t || w0 + 16 > g.t)
        to_ds(std::true_type{});
      else
        to_ds(std::false_type{});
      uint32_t a[4];
      pack_afrag(a, s);  // ds cast to k's type before ds.K
      accumulate16<D>(acc, a, Kc, 16 * c, ln);
    }
    cp_async_wait_all();
    __syncthreads();  // the next tile has landed; this one is consumed
  }
  store_rows<D>(dq + base, acc, scale, scale, w0, g, lane);
}

// dK/dV: one block per (k tile, batch-head, column part), looping over the
// live q tiles, key-major: s^T = K.Q^T, dp^T = V.dO^T; dv = sum_q p^T.dout,
// dk = scale sum_q ds^T.q, on the block's NC columns of dk and dv (all D but
// above 128: dkv_splits)
template <int D>
__global__ void __launch_bounds__(MMA_NT)
    dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, Geom g, float scale,
                   int causal) {
  constexpr int LT = TILE * ldb<D>();
  constexpr bool HOLD = D <= 64;  // K, V A-fragments in registers, else re-read
  constexpr int NC = D / dkv_splits<D>();  // this block's output columns
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);  // [64][ldb] (this block's keys)
  bf16* Vs = Ks + LT;                         // [64][ldb]
  bf16* Qs = Vs + LT;                         // [2 stages][64][ldb]
  bf16* dOs = Qs + 2 * LT;                    // [2 stages][64][ldb]
  float* stat = reinterpret_cast<float*>(dOs + 2 * LT);  // [2 stages][lse 64, delta 64]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Lanes ln(lane);
  const int nt = (g.t + TILE - 1) / TILE;
  const int kb = blockIdx.x;  // the longest causal columns start first
  const int b = blockIdx.y / g.h, h = blockIdx.y % g.h;
  const long long base = b * g.sb + (long long)h * D;
  const int k0 = kb * TILE;
  const int q_begin = causal ? kb : 0;
  const int c0 = blockIdx.z * NC;  // the first of them

  // one q tile's Q, dO, lse and delta into stage st
  auto load_q_tile = [&](int qb, int st) {
    const int q0 = qb * TILE;
    load_tile_async<D>(Qs + st * LT, q + base, q0, g);
    load_tile_async<D>(dOs + st * LT, dout + base, q0, g);
    const int r = threadIdx.x % TILE, qi = q0 + r;
    const float* src = threadIdx.x < TILE ? lse : delta;
    const long long si = ((long long)b * g.t + qi) * g.h + h;
    cp_async4(stat + st * 2 * TILE + threadIdx.x, qi < g.t ? src + si : src, qi < g.t);
  };

  load_tile_async<D>(Ks, k + base, k0, g);
  load_tile_async<D>(Vs, v + base, k0, g);
  load_q_tile(q_begin, 0);
  cp_async_commit();

  const int w0 = k0 + warp * 16;  // this warp's first key
  const float scale2 = scale * LOG2E;
  float dk_acc[NC / 8][4], dv_acc[NC / 8][4];
#pragma unroll
  for (int n = 0; n < NC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  cp_async_wait_all();
  __syncthreads();
  uint32_t kf[HOLD ? D / 16 : 1][4], vf[HOLD ? D / 16 : 1][4];
  if constexpr (HOLD) {
    load_afrags<D>(kf, Ks, warp * 16, ln);
    load_afrags<D>(vf, Vs, warp * 16, ln);
  }

  for (int qb = q_begin; qb < nt; ++qb) {
    const int it = qb - q_begin;
    if (qb + 1 < nt) {  // the next q tile's copies, in flight during this one
      load_q_tile(qb + 1, (it + 1) & 1);
      cp_async_commit();
    }
    const bf16* Qc = Qs + (it & 1) * LT;
    const bf16* dOc = dOs + (it & 1) * LT;
    const float* lse_c = stat + (it & 1) * 2 * TILE;
    const float* delta_c = lse_c + TILE;
    const int q0 = qb * TILE;
#pragma unroll
    for (int c = 0; c < TILE / 16; ++c) {
      const int qc = q0 + 16 * c;  // this piece's first query
      // wholly masked for this warp: before the diagonal, past T
      if ((causal && qc + 15 < w0) || qc >= g.t || w0 >= g.t) continue;
      float st[2][4] = {}, dpt[2][4] = {};  // [key][query]
      if constexpr (HOLD) {
        scores16<D, true>(st, kf, Ks, warp * 16, Qc, 16 * c, ln);
        scores16<D, true>(dpt, vf, Vs, warp * 16, dOc, 16 * c, ln);
      } else {
        steps<D / 16, score_group<D>()>([&](int ks) {
          uint32_t xf[4], yf[4];
          ldsm_x4(xf, Ks + (warp * 16 + ln.a_row) * ldb<D>() + ks * 16 + ln.a_col);
          ldsm_x4(yf, Qc + (16 * c + ln.b_row) * ldb<D>() + ks * 16 + ln.b_col);
          mma_bf16(st[0], xf, yf[0], yf[1]);
          mma_bf16(st[1], xf, yf[2], yf[3]);
          ldsm_x4(xf, Vs + (warp * 16 + ln.a_row) * ldb<D>() + ks * 16 + ln.a_col);
          ldsm_x4(yf, dOc + (16 * c + ln.b_row) * ldb<D>() + ks * 16 + ln.b_col);
          mma_bf16(dpt[0], xf, yf[0], yf[1]);
          mma_bf16(dpt[1], xf, yf[2], yf[3]);
        });
      }
      // s^T -> p^T, dp^T -> ds^T; the index mask only where the piece
      // crosses the diagonal or the end of the sequence
      auto to_p_ds = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 16 * c + 8 * j + 2 * (lane % 4);  // this thread's queries: col, col + 1
          const float2 l2 = *reinterpret_cast<const float2*>(lse_c + col);
          const float2 d2 = *reinterpret_cast<const float2*>(delta_c + col);
          const float lse2[2] = {l2.x * LOG2E, l2.y * LOG2E}, dlt[2] = {d2.x, d2.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = exp2f(fmaf(st[j][e], scale2, -lse2[e & 1]));
            if constexpr (decltype(masked)::value) {
              const int ki = w0 + lane / 4 + 8 * (e >> 1);
              const int qi = q0 + col + (e & 1);
              p = valid(qi, ki, g.t, causal) ? p : 0.f;
            }
            dpt[j][e] = p * (dpt[j][e] - dlt[e & 1]);
            st[j][e] = p;
          }
        }
      };
      if ((causal && qc < w0 + 15) || qc + 16 > g.t || w0 + 16 > g.t)
        to_p_ds(std::true_type{});
      else
        to_p_ds(std::false_type{});
      uint32_t pa[4], da[4];
      pack_afrag(pa, st);   // p^T cast to dout's type before p^T.dout
      pack_afrag(da, dpt);  // ds^T cast to q's type before ds^T.q
      accumulate16<D, NC>(dv_acc, pa, dOc + c0, 16 * c, ln);
      accumulate16<D, NC>(dk_acc, da, Qc + c0, 16 * c, ln);
    }
    cp_async_wait_all();
    __syncthreads();  // the next tile has landed; this one is consumed
  }
  store_rows<NC>(dk + base + c0, dk_acc, scale, scale, w0, g, lane);
  store_rows<NC>(dv + base + c0, dv_acc, 1.f, 1.f, w0, g, lane);
}

// exp2(x) in one special-function instruction, subnormal results flushed to 0
// (exp2f adds a rescaling around it for subnormals)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The 16-key pieces of an R-row k tile (keys from k0) for one warp's 16
// query rows (from w0), in the forwards, which score all of a tile before its
// row max.  A piece wholly masked (past the causal diagonal, past T) is dead
// and skipped: no score product, no P.V product.  The index mask is applied
// only to the pieces that cross the diagonal or the end of the sequence
// (`masked` a compile-time true there, false elsewhere).
template <int R>
struct KeyPieces {
  int k0, w0, t, causal, lane;
  __device__ __forceinline__ bool dead(int c) const {
    const int kc = k0 + 16 * c;
    return (causal && kc > w0 + 15) || kc >= t || w0 >= t;
  }
  // fn(c, masked) for each live piece c
  template <typename Fn>
  __device__ __forceinline__ void each_live(Fn&& fn) const {
#pragma unroll
    for (int c = 0; c < R / 16; ++c) {
      if (dead(c)) continue;
      const int kc = k0 + 16 * c;
      if ((causal && kc + 15 > w0) || kc + 16 > t || w0 + 16 > t)
        fn(c, std::true_type{});
      else
        fn(c, std::false_type{});
    }
  }
  // whether element e of piece c's n8 score tile j (an f32 accumulator, in
  // the m16n8k16 and m16n8k8 layouts alike) is a live (q, k) pair
  template <typename Masked>
  __device__ __forceinline__ bool ok(Masked, int c, int j, int e) const {
    if constexpr (Masked::value)
      return valid(w0 + lane / 4 + 8 * (e >> 1), k0 + 16 * c + 8 * j + 2 * (lane % 4) + (e & 1),
                   t, causal);
    else
      return true;
  }
};

// bf16 forward: one block per (q tile, batch-head), each warp 16 query rows, an
// online softmax over the live k tiles kept on the score accumulators:
//   s = Q.K^T, m = running row max of s.scale, p = exp(s.scale - m),
//   l = running row sum of p, acc = alpha acc + p.V with alpha = exp(m_old - m),
//   out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))
// m is kept in log2 units (m2 = m log2 e), so that p is exp2 of one FMA.
template <int D>
__global__ void __launch_bounds__(MMA_NT)
    fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                   Geom g, float scale, int causal) {
  constexpr int LT = TILE * ldb<D>();
  constexpr float LN2 = 0.6931471805599453f;
  constexpr bool HOLD = hold_afrags<D>();
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // [64][ldb]
  bf16* Ks = Qs + LT;                         // [2 stages][64][ldb]
  bf16* Vs = Ks + 2 * LT;                     // [2 stages][64][ldb]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Lanes ln(lane);
  const int nt = (g.t + TILE - 1) / TILE;
  const int qb = nt - 1 - blockIdx.x;  // the longest causal rows start first
  const int b = blockIdx.y / g.h, h = blockIdx.y % g.h;
  const long long base = b * g.sb + (long long)h * D;
  const int q0 = qb * TILE;
  const int k_end = causal ? qb + 1 : nt;

  load_tile_async<D>(Qs, q + base, q0, g);
  load_tile_async<D>(Ks, k + base, 0, g);
  load_tile_async<D>(Vs, v + base, 0, g);
  cp_async_commit();

  const int w0 = q0 + warp * 16;  // this warp's first row
  // s.scale = (-s).(-scale): a negative scale flips q's signs (below), so
  // the row max of s.scale is |scale| times the row max of the products
  const float scale2 = fabsf(scale) * LOG2E;
  float m2[2] = {NEG_INF, NEG_INF};  // rows w0 + lane/4 and + 8, log2 units
  float l[2] = {0.f, 0.f};  // this thread's columns' share of the row sums
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[HOLD ? D / 16 : 1][4];
  if constexpr (HOLD) {
    load_afrags<D>(qf, Qs, warp * 16, ln);
    if (scale < 0.f) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) qf[ks][r] ^= 0x80008000u;  // both bf16 sign bits
    }
  } else if (scale < 0.f) {  // the warp's own 16 rows of Q, flipped where they lie
    for (int i = lane; i < 16 * D / 2; i += 32)
      reinterpret_cast<uint32_t*>(Qs + (warp * 16 + i / (D / 2)) * ldb<D>())[i % (D / 2)] ^=
          0x80008000u;
    __syncwarp();
  }

  for (int kb = 0; kb < k_end; ++kb) {
    if (kb + 1 < k_end) {  // the next tile's copies, in flight during this one
      const int st = (kb + 1) & 1;
      load_tile_async<D>(Ks + st * LT, k + base, (kb + 1) * TILE, g);
      load_tile_async<D>(Vs + st * LT, v + base, (kb + 1) * TILE, g);
      cp_async_commit();
    }
    const bf16* Kc = Ks + (kb & 1) * LT;
    const bf16* Vc = Vs + (kb & 1) * LT;
    const KeyPieces<TILE> pc{kb * TILE, w0, g.t, causal, lane};

    float s[TILE / 8][4] = {};  // 16 rows x 64 keys: n8 tile 2c + j is keys 16c + 8j ..
#pragma unroll
    for (int c = 0; c < TILE / 16; ++c)
      if (!pc.dead(c)) scores16<D, HOLD>(&s[2 * c], qf, Qs, warp * 16, Kc, 16 * c, ln);

    // the rows' maxima over this tile: the thread's 16 values a row, then
    // the 4 lanes that share the row (lane/4)
    float mx[2] = {NEG_INF, NEG_INF};
    pc.each_live([&](int c, auto masked) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (pc.ok(masked, c, j, e)) mx[e >> 1] = fmaxf(mx[e >> 1], s[2 * c + j][e]);
    });
    float neg_m2[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float x = mx[half];
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m2[half], x * scale2);
      const float alpha = exp2_ftz(m2[half] - m_new);
      m2[half] = m_new;
      neg_m2[half] = -m_new;
      l[half] *= alpha;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * half] *= alpha;
        acc[n][2 * half + 1] *= alpha;
      }
    }

    // p, summed unrounded into l; masked entries exactly 0 (selected by
    // index); then p rounded to bf16 (v's type) as the A fragment of P.V
    pc.each_live([&](int c, auto masked) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2_ftz(fmaf(s[2 * c + j][e], scale2, neg_m2[e >> 1]));
          p = pc.ok(masked, c, j, e) ? p : 0.f;
          s[2 * c + j][e] = p;
          l[e >> 1] += p;
        }
      uint32_t a[4];
      pack_afrag(a, &s[2 * c]);
      accumulate16<D>(acc, a, Vc, 16 * c, ln);
    });
    cp_async_wait_all();
    __syncthreads();  // the next tile has landed; this one is consumed
  }

  float inv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float lt = l[half];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt = fmaxf(lt, L_FLOOR);  // padded rows have zero mass
    inv[half] = 1.f / lt;
    const int qi = w0 + lane / 4 + 8 * half;
    if (qi < g.t && lane % 4 == 0)
      lse[((long long)b * g.t + qi) * g.h + h] = m2[half] * LN2 + logf(lt);
  }
  store_rows<D>(o + base, acc, inv[0], inv[1], w0, g, lane);
}

// ---------------------------------------------------------------------------
// f32 forward, dQ and dK/dV on the tensor cores, in 3xTF32
//
// Each f32 operand x is split into a big part b = tf32(x) (rounded to
// nearest, ties away) and a small part s = x - b, exact in f32, of which the
// tensor cores read the top 19 bits (a tf32 operand's low 13 bits are
// ignored), so x = b + s to within 2^-21 |x|.  A product a.c is taken as
// a_s.c_b + a_b.c_s + a_b.c_b on mma.sync m16n8k8 tf32 x tf32 -> f32; the
// dropped a_s.c_s is at most 2^-22 of |a.c|, so each product keeps about
// f32's accuracy (a few f32 roundings) where one TF32 product would keep
// 2^-11.  p, ds and every sum are f32: nothing is rounded to a narrower type,
// and the split is the only approximation (the TPU kernels' f32 case takes
// f32 products).  The tensor cores truncate as they accumulate, so no long
// sum is left in an mma accumulator: a score's small terms and big terms
// gather in two accumulators over D, added once, and the output products
// of each 16-row piece go into a fresh accumulator that one f32 add (round
// to nearest) puts into the running sum.  Measured against float64 on the
// card, the out, lse, dq, dk and dv errors stay within a few times the f32
// plain version's (full f32 products).
//
// m16n8k8 tf32 fragments (g = lane / 4, t = lane % 4): an A tile (16 x 8)
// holds a[0] (row g, k t), a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8,
// t + 4); a B tile (8 x 8) b[0] (k t, column g) and b[1] (t + 4, g); the f32
// accumulator (16 x 8) c[0..1] at row g and c[2..3] at row g + 8, columns
// 2t + {0, 1}.  So an accumulator is not an A fragment in place: the p and
// ds accumulators enter the next product with k permuted (a sum does not
// care about the order of its terms): columns 2t and 2t + 1 become k
// positions t and t + 4, and the B operand's rows are read in the same order,
// b[0] from row 2t and b[1] from row 2t + 1.  Those B columns (K in dQ, dO
// and Q in dK/dV) are scalar shared-memory loads; ldmatrix (16-bit elements,
// no 32-bit transpose) gives the A fragments and the B fragments of the
// A.B^T products, a 16-byte row piece being 4 floats.
//
// The kernels are bound by their instruction count more than by the tensor cores:
// a split is three instructions, and each warp would split every element of
// the streamed tile (K and V in the forward and dQ, Q and dO in dK/dV) twice
// over.  At D <= 64 the block splits each streamed tile once into big and
// small copies in shared memory, and the tile's raw copy is single-buffered
// (the next one in flight while this one's split copies are computed on);
// the forward holds Q's split A fragments in registers, dQ Q's and dO's,
// dK/dV K's and V's raw ones (its dk and dv accumulators take D registers
// already).  At D 128 there is no room for that: the streamed tiles are
// double-buffered raw, and every operand is split as it is read.

// row stride, in floats, of an f32 tile in shared memory: D + 4 puts the 8
// rows an ldmatrix reads in 8 distinct 16-byte bank groups, and the column
// reads of rows 2t and 2t + 1 at columns g in 32 distinct banks
template <int D>
__host__ __device__ constexpr int ldf() { return D + 4; }

// the streamed tiles split once in shared memory (see above)
template <int D>
__host__ __device__ constexpr bool presplit() { return D <= 64; }

// rows of an f32 tile, on the q and the k side alike, and the threads of a
// block (a warp a 16 rows): 64, and 32 above D 128, where a 64-row tile
// (66,560 bytes at D 256) would leave room for three of a kernel's 5 or 6
template <int D>
struct F32Tile {
  static constexpr int R = D <= 128 ? TILE : TILE / 2;
  static constexpr int NT = 2 * R;
};

// x = big + small: big is x rounded to tf32 (10 stored mantissa bits), to
// nearest with ties away from zero, as cvt.rna.tf32.f32 rounds a finite x
// but in two integer instructions where the cvt compiles to five (its checks
// for special values); small = x - big is exact, and the tensor cores read
// its top 19 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// four 8 x 4 f32 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4_f32(uint32_t r[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// c += a.b for one m16n8k8 tile, tf32 in, f32 accumulate
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in 3xTF32: small.big, big.small, then big.big
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t ab[4], const uint32_t as[4],
                                           uint32_t bb0, uint32_t bb1, uint32_t bs0,
                                           uint32_t bs1) {
  mma_tf32(c, as, bb0, bb1);
  mma_tf32(c, ab, bs0, bs1);
  mma_tf32(c, ab, bb0, bb1);
}

// rows [r0, r0 + R) of one head into dst[r * ldf + c], one 16-byte copy
// each; rows at or past the end of the sequence are zero-filled
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int r0,
                                              const Geom& g) {
  constexpr int CH = D / 4;  // 16-byte chunks a row
  constexpr int R = F32Tile<D>::R, NT = F32Tile<D>::NT;
  static_assert(R * CH % NT == 0, "a tile is a whole number of copies a thread");
  steps<R * CH / NT, copy_group<D>()>([&](int it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / CH, c = i % CH;
    const bool in = r0 + r < g.t;
    cp_async16(dst + r * ldf<D>() + c * 4, in ? src + (long long)(r0 + r) * g.st + c * 4 : src,
               in);
  });
}

// a raw f32 tile split into its big and small copies, by the whole block
template <int D>
__device__ __forceinline__ void split_tile(float* big, float* small, const float* raw) {
  constexpr int CH = D / 4;
  constexpr int R = F32Tile<D>::R, NT = F32Tile<D>::NT;
#pragma unroll
  for (int it = 0; it < R * CH / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int o = (i / CH) * ldf<D>() + (i % CH) * 4;
    const float4 x = *reinterpret_cast<const float4*>(raw + o);
    uint4 b, s;
    split_tf32(x.x, b.x, s.x);
    split_tf32(x.y, b.y, s.y);
    split_tf32(x.z, b.z, s.z);
    split_tf32(x.w, b.w, s.w);
    *reinterpret_cast<uint4*>(big + o) = b;
    *reinterpret_cast<uint4*>(small + o) = s;
  }
}

// the x4 loads' per-lane row and column (in floats) offsets: A fragments
// (row lane % 16, column 4 (lane / 16)) and the B fragments of an A.B^T
// product (two n8 tiles of one k8 step: row lane % 8 + 8 (lane / 16), column
// 4 ((lane / 8) % 2)); g and t of the fragment layouts
struct LanesF32 {
  int a_row, a_col, b_row, b_col, g, t;
  __device__ __forceinline__ explicit LanesF32(int lane)
      : a_row(lane & 15),
        a_col((lane >> 4) * 4),
        b_row((lane & 7) + ((lane >> 4) << 3)),
        b_col(((lane >> 3) & 1) * 4),
        g(lane >> 2),
        t(lane & 3) {}
};

// An operand's A fragments over D (16 rows of a tile, k8 step ks): held in
// registers split (SPLIT: xb, xs) or raw (RAW: xb, split as used), or read
// from the tile X in shared memory and split (SMEM).
enum AFrom { SPLIT, RAW, SMEM };

template <int D, AFrom FROM>
__device__ __forceinline__ void afrag_tf32(uint32_t ab[4], uint32_t as[4],
                                           const uint32_t (*xb)[4], const uint32_t (*xs)[4],
                                           const float* X, int x0, int ks, const LanesF32& ln) {
  uint32_t r[4];
  if constexpr (FROM == SPLIT) {
#pragma unroll
    for (int i = 0; i < 4; ++i) ab[i] = xb[ks][i], as[i] = xs[ks][i];
    return;
  } else if constexpr (FROM == RAW) {
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = xb[ks][i];
  } else {
    ldsm_x4_f32(r, X + (x0 + ln.a_row) * ldf<D>() + 8 * ks + ln.a_col);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), ab[i], as[i]);
}

// the raw A fragments of rows [x0, x0 + 16) of an f32 tile, over D
template <int D>
__device__ __forceinline__ void load_afrags_f32(uint32_t (*xr)[4], const float* X, int x0,
                                                const LanesF32& ln) {
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks)
    ldsm_x4_f32(xr[ks], X + (x0 + ln.a_row) * ldf<D>() + 8 * ks + ln.a_col);
}

// s[j] += X[16 rows] . Y[y0 + 8j .. + 8)^T over D, for j 0, 1, in 3xTF32:
// X's A fragments as FROM says, Y's rows (the other side's tile) from
// shared memory: its split copies Yb and Ys when PRE, else the raw tile Yb
// split as it is read.  The small terms gather apart from the big ones.
template <int D, AFrom FROM, bool PRE>
__device__ __forceinline__ void scores16_tf32(float s[2][4], const uint32_t (*xb)[4],
                                              const uint32_t (*xs)[4], const float* X, int x0,
                                              const float* Yb, const float* Ys, int y0,
                                              const LanesF32& ln) {
  float sm[2][4] = {};
  steps<D / 8, FROM == SMEM ? score_group<D>() : D>([&](int ks) {
    uint32_t ab[4], as[4], yb[4], ys[4];
    afrag_tf32<D, FROM>(ab, as, xb, xs, X, x0, ks, ln);
    const int off = (y0 + ln.b_row) * ldf<D>() + 8 * ks + ln.b_col;
    if constexpr (PRE) {
      ldsm_x4_f32(yb, Yb + off);
      ldsm_x4_f32(ys, Ys + off);
    } else {
      uint32_t y[4];
      ldsm_x4_f32(y, Yb + off);
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(y[i]), yb[i], ys[i]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mma_tf32(sm[j], as, yb[2 * j], yb[2 * j + 1]);
      mma_tf32(sm[j], ab, ys[2 * j], ys[2 * j + 1]);
      mma_tf32(s[j], ab, yb[2 * j], yb[2 * j + 1]);
    }
  });
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += sm[j][e];
}

// acc[n] += x . Z[z0 .. z0 + 16)[8n .. 8n + 8) for every n8 tile of the NC
// columns from Z (rows of D), in 3xTF32: x is 16 rows x 16 of the k axis
// held as two n8 accumulators, each the A fragment of one k8 step with k
// permuted (its columns 2t and 2t + 1 at k positions t and t + 4), and Z's
// rows are read in the same order, from its split copies Zb and Zs when PRE,
// else from the raw tile Zb.  The piece's 6 products go into a fresh
// accumulator, added to acc by one f32 add.
template <int D, bool PRE, int NC = D>
__device__ __forceinline__ void accumulate16_tf32(float (*acc)[4], const float x[2][4],
                                                  const float* Zb, const float* Zs, int z0,
                                                  const LanesF32& ln) {
  uint32_t ab[2][4], as[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    split_tf32(x[j][0], ab[j][0], as[j][0]);  // row g, k position t: column 2t
    split_tf32(x[j][2], ab[j][1], as[j][1]);  // row g + 8, column 2t
    split_tf32(x[j][1], ab[j][2], as[j][2]);  // row g, k position t + 4: column 2t + 1
    split_tf32(x[j][3], ab[j][3], as[j][3]);  // row g + 8, column 2t + 1
  }
  const int off = (z0 + 2 * ln.t) * ldf<D>() + ln.g;
#pragma unroll
  for (int n = 0; n < NC / 8; ++n) {
    float c[4] = {};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int o0 = off + 8 * j * ldf<D>() + 8 * n, o1 = o0 + ldf<D>();
      uint32_t b0b, b0s, b1b, b1s;
      if constexpr (PRE) {
        b0b = __float_as_uint(Zb[o0]), b0s = __float_as_uint(Zs[o0]);
        b1b = __float_as_uint(Zb[o1]), b1s = __float_as_uint(Zs[o1]);
      } else {
        split_tf32(Zb[o0], b0b, b0s);
        split_tf32(Zb[o1], b1b, b1s);
      }
      mma_3xtf32(c, ab[j], as[j], b0b, b1b, b0s, b1s);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += c[e];
  }
}

// 16 rows x D of f32 accumulators times mul, stored at rows r0 + lane/4
// {, + 8} of one head; rows at or past T skipped
template <int D>
__device__ __forceinline__ void store_rows_f32(float* dst, float (*acc)[4], float mul, int r0,
                                               const Geom& g, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + lane / 4 + 8 * half;
    if (r >= g.t) continue;
    float* row = dst + (long long)r * g.st + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(mul * acc[n][2 * half], mul * acc[n][2 * half + 1]);
  }
}

// p = exp(s.scale - x), x the backward's lse or the forward's running max,
// from one FMA (one rounding, so the argument's error stays relative to its
// own small size) and exp2
__device__ __forceinline__ float prob_f32(float s, float scale, float x) {
  return exp2f(fmaf(s, scale, -x) * LOG2E);
}

// The streamed side of a tf32 kernel: two tiles (K and V, or Q and dO) a
// step, from raw copies double-buffered (!presplit) or from split copies
// refilled from one raw copy each (presplit).  Its shared memory: 6 tiles
// of F32Tile<D>::R rows.
template <int D>
struct Stream {
  static constexpr int LT = F32Tile<D>::R * ldf<D>();
  float* base;
  // the raw tile j (0, 1) that step `it`'s copies go to
  __device__ __forceinline__ float* raw(int j, int it) const {
    return presplit<D>() ? base + j * LT : base + (2 * j + (it & 1)) * LT;
  }
  // the big and small tiles j that step `it` computes on (small: null, the
  // raw tile split as it is read, when !presplit)
  __device__ __forceinline__ const float* big(int j, int it) const {
    return presplit<D>() ? base + (2 + 2 * j) * LT : raw(j, it);
  }
  __device__ __forceinline__ const float* small(int j) const {
    return presplit<D>() ? base + (3 + 2 * j) * LT : nullptr;
  }
  // after step `it`'s raw copies landed and a __syncthreads(): split them
  // (the caller syncs again before they are read)
  __device__ __forceinline__ void split(int it) const {
    if constexpr (presplit<D>()) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        split_tile<D>(base + (2 + 2 * j) * LT, base + (3 + 2 * j) * LT, raw(j, it));
    }
  }
};

// f32 dQ: one block per (q tile, batch-head), each warp 16 query rows,
// looping over the live k tiles:
//   p = exp(s - lse), ds = p (dp - delta), dq = scale * sum_k ds.K
// Q's and dO's split A fragments are held in registers at D <= 64 (2 D
// registers; their tiles' room then takes the split K and V); at D 128
// they are re-read from shared memory and split there.
template <int D>
__global__ void __launch_bounds__(F32Tile<D>::NT)
    dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dq, Geom g, float scale, int causal) {
  constexpr int R = F32Tile<D>::R;  // rows of a tile
  constexpr int LT = R * ldf<D>();   // floats of one tile
  constexpr bool PRE = presplit<D>();
  constexpr AFrom FROM = PRE ? SPLIT : SMEM;
  constexpr int NF = PRE ? D / 8 : 1;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  // !PRE: [Q, dO, K 2 stages, V 2 stages]; PRE: [K, V raw, K big, small,
  // V big, small], Q and dO first in the split tiles' room
  float* Qs = PRE ? sm + 2 * LT : sm;
  float* dOs = Qs + LT;
  const Stream<D> kv{PRE ? sm : sm + 2 * LT};

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const LanesF32 ln(lane);
  const int nt = (g.t + R - 1) / R;
  const int qb = nt - 1 - blockIdx.x;  // the longest causal rows start first
  const int b = blockIdx.y / g.h, h = blockIdx.y % g.h;
  const long long base = b * g.sb + (long long)h * D;
  const int q0 = qb * R;
  const int k_end = causal ? qb + 1 : nt;

  load_tile_f32<D>(Qs, q + base, q0, g);
  load_tile_f32<D>(dOs, dout + base, q0, g);
  load_tile_f32<D>(kv.raw(0, 0), k + base, 0, g);
  load_tile_f32<D>(kv.raw(1, 0), v + base, 0, g);
  cp_async_commit();

  const int w0 = q0 + warp * 16;  // this warp's first row
  float lse_r[2], delta_r[2];     // rows w0 + lane/4 and + 8
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = w0 + lane / 4 + 8 * half;
    const long long si = ((long long)b * g.t + qi) * g.h + h;
    lse_r[half] = qi < g.t ? lse[si] : 0.f;
    delta_r[half] = qi < g.t ? delta[si] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  cp_async_wait_all();
  __syncthreads();
  uint32_t qfb[NF][4], qfs[NF][4], dofb[NF][4], dofs[NF][4];
  if constexpr (PRE) {
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      afrag_tf32<D, SMEM>(qfb[ks], qfs[ks], nullptr, nullptr, Qs, warp * 16, ks, ln);
      afrag_tf32<D, SMEM>(dofb[ks], dofs[ks], nullptr, nullptr, dOs, warp * 16, ks, ln);
    }
    __syncthreads();  // Q and dO read: their room takes the split tiles
    kv.split(0);
    __syncthreads();
  }

  for (int kb = 0; kb < k_end; ++kb) {
    if (kb + 1 < k_end) {  // the next tile's copies, in flight during this one
      load_tile_f32<D>(kv.raw(0, kb + 1), k + base, (kb + 1) * R, g);
      load_tile_f32<D>(kv.raw(1, kb + 1), v + base, (kb + 1) * R, g);
      cp_async_commit();
    }
    const int k0 = kb * R;
#pragma unroll
    for (int c = 0; c < R / 16; ++c) {
      const int kc = k0 + 16 * c;  // this piece's first key
      // wholly masked for this warp: past the diagonal, past T
      if ((causal && kc > w0 + 15) || kc >= g.t || w0 >= g.t) continue;
      float s[2][4] = {}, dp[2][4] = {};
      scores16_tf32<D, FROM, PRE>(s, qfb, qfs, Qs, warp * 16, kv.big(0, kb), kv.small(0),
                                  16 * c, ln);
      scores16_tf32<D, FROM, PRE>(dp, dofb, dofs, dOs, warp * 16, kv.big(1, kb), kv.small(1),
                                  16 * c, ln);
      // s -> ds = p (dp - delta); the index mask only where the piece
      // crosses the diagonal or the end of the sequence
      auto to_ds = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = prob_f32(s[j][e], scale, lse_r[e >> 1]);
            if constexpr (decltype(masked)::value) {
              const int qi = w0 + lane / 4 + 8 * (e >> 1);
              const int ki = kc + 8 * j + 2 * (lane % 4) + (e & 1);
              p = valid(qi, ki, g.t, causal) ? p : 0.f;
            }
            s[j][e] = p * (dp[j][e] - delta_r[e >> 1]);
          }
      };
      if ((causal && kc + 15 > w0) || kc + 16 > g.t || w0 + 16 > g.t)
        to_ds(std::true_type{});
      else
        to_ds(std::false_type{});
      accumulate16_tf32<D, PRE>(acc, s, kv.big(0, kb), kv.small(0), 16 * c, ln);
    }
    cp_async_wait_all();
    __syncthreads();  // the next tile has landed; this one is consumed
    if (PRE && kb + 1 < k_end) {
      kv.split(kb + 1);
      __syncthreads();
    }
  }
  store_rows_f32<D>(dq + base, acc, scale, w0, g, lane);
}

// f32 dK/dV: one block per (k tile, batch-head, column part), each warp 16
// keys, looping over the live q tiles, key-major: s^T = K.Q^T, dp^T =
// V.dO^T; dv = sum_q p^T.dout, dk = scale sum_q ds^T.q, on the block's NC
// columns of dk and dv (all D but above 128: dkv_splits).  K's and V's raw A
// fragments are held in registers at D <= 64 (D registers; their tiles'
// room then takes the split Q and dO) and split as they are used; at D 128,
// with the dk and dv accumulators taking 128 registers, they are re-read
// from shared memory, and so at D 256 (32-row tiles; a block's 128 columns
// of dk and dv take those 128 registers there).
template <int D>
__global__ void __launch_bounds__(F32Tile<D>::NT)
    dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dk, float* __restrict__ dv, Geom g, float scale,
                    int causal) {
  constexpr int R = F32Tile<D>::R;          // rows of a tile
  constexpr int LT = R * ldf<D>();
  constexpr bool PRE = presplit<D>();
  constexpr AFrom FROM = PRE ? RAW : SMEM;
  constexpr int NF = PRE ? D / 8 : 1;
  constexpr int NC = D / dkv_splits<D>();  // this block's output columns
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  // !PRE: [K, V, Q 2 stages, dO 2 stages]; PRE: [Q, dO raw, Q big, small,
  // dO big, small], K and V first in the split tiles' room; then lse and
  // delta, 2 stages
  float* Ks = PRE ? sm + 2 * LT : sm;
  float* Vs = Ks + LT;
  const Stream<D> qdo{PRE ? sm : sm + 2 * LT};
  float* stat = sm + 6 * LT;  // [2 stages][lse 64, delta 64]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const LanesF32 ln(lane);
  const int nt = (g.t + R - 1) / R;
  const int kb = blockIdx.x;  // the longest causal columns start first
  const int b = blockIdx.y / g.h, h = blockIdx.y % g.h;
  const long long base = b * g.sb + (long long)h * D;
  const int k0 = kb * R;
  const int q_begin = causal ? kb : 0;
  const int c0 = blockIdx.z * NC;  // the first of them

  // step it's (q tile qb's) Q, dO, lse and delta
  auto load_q_tile = [&](int qb, int it) {
    const int q0 = qb * R;
    load_tile_f32<D>(qdo.raw(0, it), q + base, q0, g);
    load_tile_f32<D>(qdo.raw(1, it), dout + base, q0, g);
    const int r = threadIdx.x % R, qi = q0 + r;
    const float* src = threadIdx.x < R ? lse : delta;
    const long long si = ((long long)b * g.t + qi) * g.h + h;
    cp_async4(stat + (it & 1) * 2 * R + threadIdx.x, qi < g.t ? src + si : src, qi < g.t);
  };

  load_tile_f32<D>(Ks, k + base, k0, g);
  load_tile_f32<D>(Vs, v + base, k0, g);
  load_q_tile(q_begin, 0);
  cp_async_commit();

  const int w0 = k0 + warp * 16;  // this warp's first key
  float dk_acc[NC / 8][4], dv_acc[NC / 8][4];
#pragma unroll
  for (int n = 0; n < NC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  cp_async_wait_all();
  __syncthreads();
  uint32_t kf[NF][4], vf[NF][4];
  if constexpr (PRE) {
    load_afrags_f32<D>(kf, Ks, warp * 16, ln);
    load_afrags_f32<D>(vf, Vs, warp * 16, ln);
    __syncthreads();  // K and V read: their room takes the split tiles
    qdo.split(0);
    __syncthreads();
  }

  for (int qb = q_begin; qb < nt; ++qb) {
    const int it = qb - q_begin;
    if (qb + 1 < nt) {  // the next q tile's copies, in flight during this one
      load_q_tile(qb + 1, it + 1);
      cp_async_commit();
    }
    const float* lse_c = stat + (it & 1) * 2 * R;
    const float* delta_c = lse_c + R;
    const int q0 = qb * R;
#pragma unroll
    for (int c = 0; c < R / 16; ++c) {
      const int qc = q0 + 16 * c;  // this piece's first query
      // wholly masked for this warp: before the diagonal, past T
      if ((causal && qc + 15 < w0) || qc >= g.t || w0 >= g.t) continue;
      float st[2][4] = {}, dpt[2][4] = {};  // [key][query]
      scores16_tf32<D, FROM, PRE>(st, kf, nullptr, Ks, warp * 16, qdo.big(0, it), qdo.small(0),
                                  16 * c, ln);
      scores16_tf32<D, FROM, PRE>(dpt, vf, nullptr, Vs, warp * 16, qdo.big(1, it),
                                  qdo.small(1), 16 * c, ln);
      // s^T -> p^T, dp^T -> ds^T; the index mask only where the piece
      // crosses the diagonal or the end of the sequence
      auto to_p_ds = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 16 * c + 8 * j + 2 * (lane % 4);  // this thread's queries: col, col + 1
          const float2 l2 = *reinterpret_cast<const float2*>(lse_c + col);
          const float2 d2 = *reinterpret_cast<const float2*>(delta_c + col);
          const float lq[2] = {l2.x, l2.y}, dlt[2] = {d2.x, d2.y};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = prob_f32(st[j][e], scale, lq[e & 1]);
            if constexpr (decltype(masked)::value) {
              const int ki = w0 + lane / 4 + 8 * (e >> 1);
              const int qi = q0 + col + (e & 1);
              p = valid(qi, ki, g.t, causal) ? p : 0.f;
            }
            dpt[j][e] = p * (dpt[j][e] - dlt[e & 1]);
            st[j][e] = p;
          }
        }
      };
      if ((causal && qc < w0 + 15) || qc + 16 > g.t || w0 + 16 > g.t)
        to_p_ds(std::true_type{});
      else
        to_p_ds(std::false_type{});
      // this block's columns of dO and Q (c0 is 0 where split copies are read)
      accumulate16_tf32<D, PRE, NC>(dv_acc, st, qdo.big(1, it) + c0, qdo.small(1), 16 * c, ln);
      accumulate16_tf32<D, PRE, NC>(dk_acc, dpt, qdo.big(0, it) + c0, qdo.small(0), 16 * c, ln);
    }
    cp_async_wait_all();
    __syncthreads();  // the next tile has landed; this one is consumed
    if (PRE && qb + 1 < nt) {
      qdo.split(it + 1);
      __syncthreads();
    }
  }
  store_rows_f32<NC>(dk + base + c0, dk_acc, scale, w0, g, lane);
  store_rows_f32<NC>(dv + base + c0, dv_acc, 1.f, w0, g, lane);
}

// f32 forward: one block per (q tile, batch-head), each warp 16 query rows, in
// 3xTF32, with the bf16 forward's online softmax over the live k tiles kept
// on the score accumulators:
//   s = Q.K^T, m = running row max of s.scale, p = exp(s.scale - m),
//   l = running row sum of p, acc = alpha acc + p.V with alpha = exp(m_old - m),
//   out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))
// m is kept in natural units and p is f32, the backward's prob_f32 against
// the running max; l sums the unrounded p.  All 64 keys of a tile are scored
// before the row max, the small and big terms of each 16-key piece in two
// accumulators; p enters P.V from the accumulators with k permuted, each
// piece's products in a fresh accumulator added in f32.  Q's split A
// fragments are held in registers at D <= 64 (D registers; its tile's room
// then takes the split K and V); at D 128 and 256 (32-row tiles there) they
// are re-read from shared memory and split there, and K and V are
// double-buffered raw.  Rows at or past T (m NEG_INF, l 0) are not written.
template <int D>
__global__ void __launch_bounds__(F32Tile<D>::NT)
    fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                    Geom g, float scale, int causal) {
  constexpr int R = F32Tile<D>::R;  // rows of a tile
  constexpr int LT = R * ldf<D>();
  constexpr bool PRE = presplit<D>();
  constexpr AFrom FROM = PRE ? SPLIT : SMEM;
  constexpr int NF = PRE ? D / 8 : 1;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  // !PRE: [Q, K 2 stages, V 2 stages]; PRE: [K, V raw, K big, small, V big,
  // small], Q first in the split tiles' room
  float* Qs = PRE ? sm + 2 * LT : sm;
  const Stream<D> kv{PRE ? sm : sm + LT};

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const LanesF32 ln(lane);
  const int nt = (g.t + R - 1) / R;
  const int qb = nt - 1 - blockIdx.x;  // the longest causal rows start first
  const int b = blockIdx.y / g.h, h = blockIdx.y % g.h;
  const long long base = b * g.sb + (long long)h * D;
  const int q0 = qb * R;
  const int k_end = causal ? qb + 1 : nt;

  load_tile_f32<D>(Qs, q + base, q0, g);
  load_tile_f32<D>(kv.raw(0, 0), k + base, 0, g);
  load_tile_f32<D>(kv.raw(1, 0), v + base, 0, g);
  cp_async_commit();

  const int w0 = q0 + warp * 16;     // this warp's first row
  float m[2] = {NEG_INF, NEG_INF};  // rows w0 + lane/4 and + 8
  float l[2] = {0.f, 0.f};  // this thread's columns' share of the row sums
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  cp_async_wait_all();
  __syncthreads();
  uint32_t qfb[NF][4], qfs[NF][4];
  if constexpr (PRE) {
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks)
      afrag_tf32<D, SMEM>(qfb[ks], qfs[ks], nullptr, nullptr, Qs, warp * 16, ks, ln);
    __syncthreads();  // Q read: its room takes the split tiles
    kv.split(0);
    __syncthreads();
  }

  for (int kb = 0; kb < k_end; ++kb) {
    if (kb + 1 < k_end) {  // the next tile's copies, in flight during this one
      load_tile_f32<D>(kv.raw(0, kb + 1), k + base, (kb + 1) * R, g);
      load_tile_f32<D>(kv.raw(1, kb + 1), v + base, (kb + 1) * R, g);
      cp_async_commit();
    }
    const KeyPieces<R> pc{kb * R, w0, g.t, causal, lane};

    float s[R / 8][4] = {};  // 16 rows x R keys: n8 tile 2c + j is keys 16c + 8j ..
#pragma unroll
    for (int c = 0; c < R / 16; ++c)
      if (!pc.dead(c))
        scores16_tf32<D, FROM, PRE>(&s[2 * c], qfb, qfs, Qs, warp * 16, kv.big(0, kb),
                                    kv.small(0), 16 * c, ln);

    // the rows' maxima of s.scale over this tile: the thread's 16 values a
    // row, then the 4 lanes that share the row (lane/4)
    float mx[2] = {NEG_INF, NEG_INF};
    pc.each_live([&](int c, auto masked) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (pc.ok(masked, c, j, e)) mx[e >> 1] = fmaxf(mx[e >> 1], s[2 * c + j][e] * scale);
    });
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float x = mx[half];
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[half], x);
      const float alpha = exp2f((m[half] - m_new) * LOG2E);
      m[half] = m_new;
      l[half] *= alpha;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * half] *= alpha;
        acc[n][2 * half + 1] *= alpha;
      }
    }

    // p in f32, summed into l; masked entries exactly 0 (selected by index)
    pc.each_live([&](int c, auto masked) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = prob_f32(s[2 * c + j][e], scale, m[e >> 1]);
          p = pc.ok(masked, c, j, e) ? p : 0.f;
          s[2 * c + j][e] = p;
          l[e >> 1] += p;
        }
      accumulate16_tf32<D, PRE>(acc, &s[2 * c], kv.big(1, kb), kv.small(1), 16 * c, ln);
    });
    cp_async_wait_all();
    __syncthreads();  // the next tile has landed; this one is consumed
    if (PRE && kb + 1 < k_end) {
      kv.split(kb + 1);
      __syncthreads();
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float lt = l[half];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt = fmaxf(lt, L_FLOOR);  // padded rows have zero mass
    const int qi = w0 + lane / 4 + 8 * half;
    if (qi >= g.t) continue;
    if (lane % 4 == 0) lse[((long long)b * g.t + qi) * g.h + h] = m[half] + logf(lt);
    float* row = o + base + (long long)qi * g.st + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) =
          make_float2(acc[n][2 * half] / lt, acc[n][2 * half + 1] / lt);
  }
}

// ---------------------------------------------------------------------------
// launchers

constexpr size_t SMEM_MAX = 232448;  // a block's dynamic shared memory on Hopper
template <int D>
constexpr size_t fwd_mma_smem() { return 5 * TILE * ldb<D>() * sizeof(bf16); }
static_assert(fwd_mma_smem<128>() <= SMEM_MAX && fwd_mma_smem<256>() <= SMEM_MAX,
              "forward tile exceeds a block's shared memory");
template <int D>
constexpr size_t dq_mma_smem() { return 6 * TILE * ldb<D>() * sizeof(bf16); }
static_assert(dq_mma_smem<128>() <= SMEM_MAX && dq_mma_smem<256>() <= SMEM_MAX,
              "dQ tile exceeds a block's shared memory");
template <int D>
constexpr size_t dkv_mma_smem() { return 6 * TILE * ldb<D>() * sizeof(bf16) + 4 * TILE * sizeof(float); }
static_assert(dkv_mma_smem<128>() <= SMEM_MAX && dkv_mma_smem<256>() <= SMEM_MAX,
              "dK/dV tile exceeds a block's shared memory");
template <int D>
constexpr size_t tile_f32_bytes() { return F32Tile<D>::R * ldf<D>() * sizeof(float); }
template <int D>
constexpr size_t fwd_tf32_smem() {  // the split K and V and two raw tiles, or Q and two stages
  return (presplit<D>() ? 6 : 5) * tile_f32_bytes<D>();
}
static_assert(fwd_tf32_smem<128>() <= SMEM_MAX && fwd_tf32_smem<256>() <= SMEM_MAX,
              "f32 forward tile exceeds a block's shared memory");
template <int D>
constexpr size_t dq_tf32_smem() { return 6 * tile_f32_bytes<D>(); }
static_assert(dq_tf32_smem<128>() <= SMEM_MAX && dq_tf32_smem<256>() <= SMEM_MAX,
              "f32 dQ tile exceeds a block's shared memory");
template <int D>
constexpr size_t dkv_tf32_smem() {
  return 6 * tile_f32_bytes<D>() + 4 * F32Tile<D>::R * sizeof(float);
}
static_assert(dkv_tf32_smem<128>() <= SMEM_MAX && dkv_tf32_smem<256>() <= SMEM_MAX,
              "f32 dK/dV tile exceeds a block's shared memory");

Geom make_geom(int t, int h, int d) {
  Geom g;
  g.t = t;
  g.h = h;
  g.st = (long long)h * d;
  g.sb = (long long)t * h * d;
  return g;
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// a kernel's grid: its q (or k) tiles of `rows` rows, the (batch, head)
// pairs, and the column parts
dim3 grid_of(int t, int b, int h, int rows, int parts = 1) {
  return dim3((t + rows - 1) / rows, b * h, parts);
}

template <typename T, int D>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int b, int t,
                    int h, int causal, float scale, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>) {
    const dim3 grid = grid_of(t, b, h, TILE);
    const size_t smem = fwd_mma_smem<D>();
    cudaError_t e = prepare(fwd_mma_kernel<D>, smem);
    if (e != cudaSuccess) return e;
    fwd_mma_kernel<D><<<grid, MMA_NT, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), static_cast<float*>(lse), make_geom(t, h, D), scale, causal);
    return cudaGetLastError();
  } else {
    const dim3 grid = grid_of(t, b, h, F32Tile<D>::R);
    const size_t smem = fwd_tf32_smem<D>();
    cudaError_t e = prepare(fwd_tf32_kernel<D>, smem);
    if (e != cudaSuccess) return e;
    fwd_tf32_kernel<D><<<grid, F32Tile<D>::NT, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), static_cast<float*>(lse), make_geom(t, h, D), scale, causal);
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t run_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* delta, void* dq, int b, int t, int h, int causal, float scale,
                   cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>) {
    const dim3 grid = grid_of(t, b, h, TILE);
    const size_t smem = dq_mma_smem<D>();
    cudaError_t e = prepare(dq_mma_kernel<D>, smem);
    if (e != cudaSuccess) return e;
    dq_mma_kernel<D><<<grid, MMA_NT, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dq), make_geom(t, h, D), scale,
        causal);
    return cudaGetLastError();
  } else {
    const dim3 grid = grid_of(t, b, h, F32Tile<D>::R);
    const size_t smem = dq_tf32_smem<D>();
    cudaError_t e = prepare(dq_tf32_kernel<D>, smem);
    if (e != cudaSuccess) return e;
    dq_tf32_kernel<D><<<grid, F32Tile<D>::NT, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<float*>(dq), make_geom(t, h, D), scale,
        causal);
    return cudaGetLastError();
  }
}

template <typename T, int D>
cudaError_t run_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int b, int t, int h,
                    int causal, float scale, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, bf16>) {
    const dim3 grid = grid_of(t, b, h, TILE, dkv_splits<D>());
    const size_t smem = dkv_mma_smem<D>();
    cudaError_t e = prepare(dkv_mma_kernel<D>, smem);
    if (e != cudaSuccess) return e;
    dkv_mma_kernel<D><<<grid, MMA_NT, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
        make_geom(t, h, D), scale, causal);
    return cudaGetLastError();
  } else {
    const dim3 grid = grid_of(t, b, h, F32Tile<D>::R, dkv_splits<D>());
    const size_t smem = dkv_tf32_smem<D>();
    cudaError_t e = prepare(dkv_tf32_kernel<D>, smem);
    if (e != cudaSuccess) return e;
    dkv_tf32_kernel<D><<<grid, F32Tile<D>::NT, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv),
        make_geom(t, h, D), scale, causal);
    return cudaGetLastError();
  }
}

// dtype: 0 float32, 1 bfloat16; d: 16, 32, 64, 128 or 256
#define ZNICZ_DISPATCH(dtype, d, CALL)                                  \
  do {                                                                  \
    if ((dtype) == 0) {                                                 \
      using T = float;                                                  \
      switch (d) {                                                      \
        case 16: { constexpr int D = 16; return (int)(CALL); }          \
        case 32: { constexpr int D = 32; return (int)(CALL); }          \
        case 64: { constexpr int D = 64; return (int)(CALL); }          \
        case 128: { constexpr int D = 128; return (int)(CALL); }        \
        case 256: { constexpr int D = 256; return (int)(CALL); }        \
      }                                                                 \
    } else if ((dtype) == 1) {                                          \
      using T = __nv_bfloat16;                                          \
      switch (d) {                                                      \
        case 16: { constexpr int D = 16; return (int)(CALL); }          \
        case 32: { constexpr int D = 32; return (int)(CALL); }          \
        case 64: { constexpr int D = 64; return (int)(CALL); }          \
        case 128: { constexpr int D = 128; return (int)(CALL); }        \
        case 256: { constexpr int D = 256; return (int)(CALL); }        \
      }                                                                 \
    }                                                                   \
    return (int)cudaErrorInvalidValue;                                  \
  } while (0)

}  // namespace

extern "C" {

int znicz_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int b,
                    int t, int h, int d, int dtype, int causal, float scale, void* stream) {
  ZNICZ_DISPATCH(dtype, d,
                 (run_fwd<T, D>(q, k, v, o, lse, b, t, h, causal, scale,
                                static_cast<cudaStream_t>(stream))));
}

int znicz_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int b, int t, int h, int d,
                   int dtype, int causal, float scale, void* stream) {
  ZNICZ_DISPATCH(dtype, d,
                 (run_dq<T, D>(q, k, v, dout, lse, delta, dq, b, t, h, causal, scale,
                               static_cast<cudaStream_t>(stream))));
}

int znicz_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int b, int t, int h,
                    int d, int dtype, int causal, float scale, void* stream) {
  ZNICZ_DISPATCH(dtype, d,
                 (run_dkv<T, D>(q, k, v, dout, lse, delta, dk, dv, b, t, h, causal, scale,
                                static_cast<cudaStream_t>(stream))));
}

// dynamic shared memory a block of kernel `which` (0 fwd, 1 dq, 2 dkv)
// asks for at head dim d and dtype (0 float32, 1 bfloat16); -1 for a head
// dim without a kernel
int znicz_flash_smem_bytes(int which, int d, int dtype) {
#define ZNICZ_SMEM(D)                                                              \
  return (int)(which == 0   ? (dtype == 1 ? fwd_mma_smem<D>() : fwd_tf32_smem<D>()) \
               : which == 1 ? (dtype == 1 ? dq_mma_smem<D>() : dq_tf32_smem<D>())   \
                            : (dtype == 1 ? dkv_mma_smem<D>() : dkv_tf32_smem<D>()))
  switch (d) {
    case 16: ZNICZ_SMEM(16);
    case 32: ZNICZ_SMEM(32);
    case 64: ZNICZ_SMEM(64);
    case 128: ZNICZ_SMEM(128);
    case 256: ZNICZ_SMEM(256);
  }
#undef ZNICZ_SMEM
  return -1;
}

const char* znicz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
