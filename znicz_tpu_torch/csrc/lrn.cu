// Cross-channel LRN backward for Hopper (sm_90a), in CUDA C++.
//
// Replaces the pl.pallas_call of znicz_tpu/ops/pallas/lrn.py:
//   _lrn_bwd / _bwd_kernel (:138-152, kernel at :80)
// For x and the output gradient g, both viewed as [rows, C] with C
// contiguous, f32 or bf16, all math in f32 with casts at load and store:
//   lo = n / 2, hi = n - 1 - n / 2
//   s_c   = k + alpha * sum_{c' = c - lo}^{c + hi} x_{c'}^2
//   dx_c  = g_c s_c^-beta
//           - 2 alpha beta x_c * sum_{c' = c - hi}^{c + lo} g_{c'} x_{c'} s_{c'}^(-beta - 1)
// zero outside [0, C).  The second window has the first's extents swapped
// (its adjoint), which matters for even n.  s^-beta takes the chains of
// ops/kernels/lrn.py::_inv_pow (rsqrt, then sqrt, for beta 0.75; rsqrt for
// 0.5; sqrt of rsqrt for 0.25; 1 / s for 1; exp/log otherwise) on the
// special-function unit's approximations, flushing subnormals to zero, as
// is the division by s; every other product and sum is rounded where the
// plain version rounds it.  Each window is summed directly, term by term
// from the lowest channel up, in the plain version's order; nothing uses
// atomics, so a launch gives the same bits every run.
//
// What bounds it on an H100: device-memory bytes.  It reads x and g once
// and writes dx once, 6 bytes an element in bf16 (AlexNet's norm1,
// [128, 55, 55, 96]: 223 MB, 0.0666 ms at 3.35 TB/s) against ~30
// operations an element, far below the f32 rate.  But in bf16 that leaves
// an SM ~60 issue slots an element at the bound, so the instructions count
// too: with IEEE-rounded sqrt and division (~8 instructions and a branch
// each) and s^-beta chosen by a switch an element, a version of this kernel
// had 221 SASS instructions an element and took 0.14 ms at norm1 on an
// H100 (tools/ab_lrn_kernels.py counts and times them); this one has 53,
// the next tile's loads included.  So the
// design moves each byte once, in wide coalesced accesses, keeps every
// intermediate (s, the inner term g x s^(-beta-1)) on chip, spends few
// instructions an element, and keeps loads in flight through the arithmetic.
//
// Design: the main path is halo_kernel, templated on the beta chain.  Each
// thread owns a vector of VEC consecutive channels of one row: 16 bytes (8
// bf16 or 4 f32) where C and the pointers allow it, so C 96 and 256 waste
// no lane; otherwise the wrapper picks a narrower instantiation (8 or 4
// bytes) of the same kernel.  A tile is rows_per_block whole rows
// (rows_per_block x C / VEC threads, rounded up to a warp), so every window
// lies inside it; a block walks HALO_TILES tiles one after the other.  A
// thread loads its x and g vectors (one 16-byte ld.global.nc each), and
// before it computes a tile it issues the next tile's two loads, so they are
// in flight through the tile's arithmetic and barriers.  It trades only the
// windows' halos with its row neighbours through shared memory: its first
// two and last two x^2, then, after s and the inner term, its first two and
// last two inner values (one float2 each, indexed by thread: conflict-free).
// Two barriers a tile; no value goes back to device memory.  It takes
// n <= 5 (halos of at most two channels), VEC >= 2 and C / VEC <= 1024.
//
// rows_kernel takes everything else (n > 5, odd C or 2-byte alignment, C
// past 1024 vectors): the block's rows of x^2 and then of the inner term
// sit whole in shared memory (two f32 rows of C each, so C <= 29056 fills
// a block's 227 KB), each window is read from there with its bounds clamped
// to the row, and the threads walk the tile's vectors in strides, loading x
// and g again (from the caches) rather than keeping them in registers.
//
// The C entry returns cudaGetLastError() after the launch (or the error of
// its checks); the Python wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_THREADS = 1024;  // a block
constexpr int ROWS_THREADS = 256;  // a rows_kernel block
constexpr int HALO = 2;            // halo_kernel's largest window extent: n <= 5
constexpr int HALO_TILES = 4;      // tiles a halo_kernel block walks

enum BetaKind { BETA_075 = 0, BETA_05 = 1, BETA_025 = 2, BETA_1 = 3, BETA_ANY = 4 };

// The special-function unit's approximations, flushing subnormal inputs
// and results to zero (a few ulp each; s >= k > 0 in any LRN that is used).
// The IEEE-rounded sqrtf and division cost ~8 instructions and a branch
// each, which made the main path issue-bound in bf16.
__device__ __forceinline__ float rsqrt_ftz(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float sqrt_ftz(float v) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float div_ftz(float a, float b) {
  float r;
  asm("div.approx.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// s^-beta, the chains of ops/kernels/lrn.py::_inv_pow.  KIND is a template
// parameter of the main path's kernel: a branch an element would keep the
// compiler from interleaving the VEC elements' chains.
template <int KIND>
__device__ __forceinline__ float inv_pow(float s, float neg_beta) {
  if constexpr (KIND == BETA_075) {
    const float t = rsqrt_ftz(s);
    return __fmul_rn(t, sqrt_ftz(t));
  } else if constexpr (KIND == BETA_05) {
    return rsqrt_ftz(s);
  } else if constexpr (KIND == BETA_025) {
    return sqrt_ftz(rsqrt_ftz(s));
  } else if constexpr (KIND == BETA_1) {
    return div_ftz(1.0f, s);
  } else {
    return expf(__fmul_rn(neg_beta, logf(s)));
  }
}

// the same with the kind at run time (the general path)
__device__ __forceinline__ float inv_pow(float s, int kind, float neg_beta) {
  switch (kind) {
    case BETA_075: return inv_pow<BETA_075>(s, neg_beta);
    case BETA_05: return inv_pow<BETA_05>(s, neg_beta);
    case BETA_025: return inv_pow<BETA_025>(s, neg_beta);
    case BETA_1: return inv_pow<BETA_1>(s, neg_beta);
    default: return inv_pow<BETA_ANY>(s, neg_beta);
  }
}

// the per-element steps, each product and sum rounded where the plain
// version rounds it (no contraction into FMAs, which measured slower):
// s = k + alpha * sum, inner = ((g x) s^-beta) / s and
// dx = g s^-beta - (2 alpha beta x) * wsum
__device__ __forceinline__ float s_of(float k, float alpha, float sum) {
  return __fadd_rn(k, __fmul_rn(alpha, sum));
}

__device__ __forceinline__ float inner_of(float g, float x, float sn, float s) {
  return div_ftz(__fmul_rn(__fmul_rn(g, x), sn), s);
}

__device__ __forceinline__ float dx_of(float g, float x, float sn, float two_ab, float wsum) {
  return __fsub_rn(__fmul_rn(g, sn), __fmul_rn(__fmul_rn(two_ab, x), wsum));
}

// -- vectors of VEC elements: raw loads and stores, f32 or bf16 ----------------

template <int BYTES>
struct RawOf;
template <>
struct RawOf<16> { using T = uint4; };
template <>
struct RawOf<8> { using T = uint2; };
template <>
struct RawOf<4> { using T = unsigned int; };
template <>
struct RawOf<2> { using T = unsigned short; };

template <bool BF16, int VEC>
struct Vec {
  static constexpr int BYTES = VEC * (BF16 ? 2 : 4);
  static constexpr int WORDS = BYTES >= 4 ? BYTES / 4 : 1;
  using Raw = typename RawOf<BYTES>::T;

  // VEC elements at p (aligned to BYTES), one access through the read-only path
  static __device__ __forceinline__ Raw load_raw(const void* p) {
    return __ldg(static_cast<const Raw*>(p));
  }

  // the raw elements in f32
  static __device__ __forceinline__ void unpack(const Raw& raw, float (&out)[VEC]) {
    uint32_t w[WORDS];
    if constexpr (BYTES == 16) {
      w[0] = raw.x, w[1] = raw.y, w[2] = raw.z, w[3] = raw.w;
    } else if constexpr (BYTES == 8) {
      w[0] = raw.x, w[1] = raw.y;
    } else {
      w[0] = raw;
    }
    if constexpr (BF16) {
      if constexpr (VEC == 1) {
        out[0] = __uint_as_float(w[0] << 16);
      } else {
#pragma unroll
        for (int i = 0; i < WORDS; ++i) {
          out[2 * i] = __uint_as_float(w[i] << 16);
          out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) out[i] = __uint_as_float(w[i]);
    }
  }

  static __device__ __forceinline__ void load(const void* p, float (&out)[VEC]) {
    unpack(load_raw(p), out);
  }

  // VEC f32 values to p (aligned to BYTES), rounded to nearest even for bf16
  static __device__ __forceinline__ void store(void* p, const float (&v)[VEC]) {
    uint32_t w[WORDS];
    if constexpr (BF16) {
      if constexpr (VEC == 1) {
        w[0] = __bfloat16_as_ushort(__float2bfloat16_rn(v[0]));
      } else {
#pragma unroll
        for (int i = 0; i < WORDS; ++i) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
          w[i] = *reinterpret_cast<const uint32_t*>(&h);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) w[i] = __float_as_uint(v[i]);
    }
    if constexpr (BYTES == 16) {
      *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (BYTES == 8) {
      *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else if constexpr (BYTES == 4) {
      *static_cast<unsigned int*>(p) = w[0];
    } else {
      *static_cast<unsigned short*>(p) = static_cast<unsigned short>(w[0]);
    }
  }
};

// -- the main path: one vector a thread, halos through shared memory -----------

// sum_{d = -lo_ext}^{hi_ext} w[HALO + j + d] for each of the VEC channels,
// from the lowest channel up; w holds the HALO values left of the vector,
// its VEC own values, then the HALO values right of it (zeros past the
// row).  lo_ext, hi_ext <= HALO are uniform, so the skipped terms cost a
// predicate, not a branch.
template <int VEC>
__device__ __forceinline__ void window(const float (&w)[VEC + 2 * HALO], int lo_ext, int hi_ext,
                                       float (&out)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int d = -HALO; d <= HALO; ++d) {
      if (d >= -lo_ext && d <= hi_ext) acc = __fadd_rn(acc, w[HALO + j + d]);
    }
    out[j] = acc;
  }
}

// the window's input: the left neighbour's last HALO values (zero at the
// row's start), the thread's own VEC, the right neighbour's first HALO
// values (zero at the row's end)
template <int VEC>
__device__ __forceinline__ void gather(const float2* first, const float2* last, int q, bool left,
                                       bool right, const float (&own)[VEC],
                                       float (&w)[VEC + 2 * HALO]) {
  const float2 l = left ? last[q - 1] : make_float2(0.0f, 0.0f);
  const float2 r = right ? first[q + 1] : make_float2(0.0f, 0.0f);
  w[0] = l.x, w[1] = l.y;
#pragma unroll
  for (int j = 0; j < VEC; ++j) w[HALO + j] = own[j];
  w[HALO + VEC] = r.x, w[HALO + VEC + 1] = r.y;
}

// A block of blockDim.x threads walks HALO_TILES tiles of rows_per_block
// whole rows, one after the other; thread q owns the channels [c0, c0 + VEC)
// of row q / vpr of each tile, and loads the next tile's x and g before it
// computes the current one, so that a block keeps its loads in flight
// through its arithmetic and barriers.  The threads past rows_per_block *
// vpr (the last warp's padding) and past the last row take part in the
// barriers and store nothing.  Dynamic shared memory: four float2 a thread
// (first and last two x^2, first and last two inner), reused tile after
// tile (the two barriers of a tile order its reads before the next
// tile's writes).
template <bool BF16, int VEC, int KIND>
__global__ void __launch_bounds__(MAX_THREADS)
    halo_kernel(const void* __restrict__ x, const void* __restrict__ g, void* __restrict__ dx,
                long long rows, int c, int rows_per_block, int lo, int hi, float alpha, float k,
                int /*kind: KIND*/, float neg_beta, float two_ab) {
  static_assert(VEC >= HALO, "a vector holds its own halo values");
  using V = Vec<BF16, VEC>;
  extern __shared__ float2 edges[];
  const int nt = blockDim.x;
  float2* sq_first = edges;
  float2* sq_last = edges + nt;
  float2* in_first = edges + 2 * nt;
  float2* in_last = edges + 3 * nt;
  constexpr int ESIZE = BF16 ? 2 : 4;

  const int q = threadIdx.x;
  const int vpr = c / VEC;
  const int r = q / vpr;
  const int c0 = (q - r * vpr) * VEC;
  const bool left = c0 > 0, right = c0 + VEC < c;
  long long row0 = static_cast<long long>(blockIdx.x) * HALO_TILES * rows_per_block;
  const long long step = static_cast<long long>(rows_per_block) * c * ESIZE;  // bytes a tile
  long long off = ((row0 + r) * c + c0) * ESIZE;                                // bytes
  bool live = r < rows_per_block && row0 + r < rows;
  typename V::Raw xr{}, gr{};
  if (live) {
    xr = V::load_raw(static_cast<const char*>(x) + off);
    gr = V::load_raw(static_cast<const char*>(g) + off);
  }
  for (int t = 0; t < HALO_TILES && row0 < rows; ++t, row0 += rows_per_block, off += step) {
    float xv[VEC], gv[VEC];
    V::unpack(xr, xv);
    V::unpack(gr, gv);
    const bool owns = live;
    live = t + 1 < HALO_TILES && r < rows_per_block && row0 + rows_per_block + r < rows;
    if (live) {  // the next tile's loads, in flight through this tile's work
      xr = V::load_raw(static_cast<const char*>(x) + off + step);
      gr = V::load_raw(static_cast<const char*>(g) + off + step);
    }

    float sq[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) sq[j] = __fmul_rn(xv[j], xv[j]);
    sq_first[q] = make_float2(sq[0], sq[1]);
    sq_last[q] = make_float2(sq[VEC - 2], sq[VEC - 1]);
    __syncthreads();

    float w[VEC + 2 * HALO], sn[VEC], in[VEC];
    gather<VEC>(sq_first, sq_last, q, left, right, sq, w);
    window<VEC>(w, lo, hi, in);  // the sums of x^2
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float s = s_of(k, alpha, in[j]);
      sn[j] = inv_pow<KIND>(s, neg_beta);
      in[j] = inner_of(gv[j], xv[j], sn[j], s);
    }
    in_first[q] = make_float2(in[0], in[1]);
    in_last[q] = make_float2(in[VEC - 2], in[VEC - 1]);
    __syncthreads();

    float wsum[VEC];
    gather<VEC>(in_first, in_last, q, left, right, in, w);
    window<VEC>(w, hi, lo, wsum);  // adjoint: extents swapped
    if (owns) {
      float out[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) out[j] = dx_of(gv[j], xv[j], sn[j], two_ab, wsum[j]);
      V::store(static_cast<char*>(dx) + off, out);
    }
  }
}

// -- the general path: whole rows in shared memory -----------------------------

// sum_{c' = max(0, cc - before)}^{min(c - 1, cc + after)} row[c'], from the
// lowest channel up (the terms it skips are the plain version's zeros)
__device__ __forceinline__ float row_window(const float* row, int c, int cc, int before,
                                            int after) {
  const int a = cc - before > 0 ? cc - before : 0;
  const int b = cc + after < c - 1 ? cc + after : c - 1;
  float acc = 0.0f;
  for (int i = a; i <= b; ++i) acc = __fadd_rn(acc, row[i]);
  return acc;
}

// A block owns rows_per_block rows (fewer at the end); dynamic shared
// memory: their x^2, then their inner terms, rows_per_block x C f32 each.
template <bool BF16, int VEC>
__global__ void __launch_bounds__(ROWS_THREADS)
    rows_kernel(const void* __restrict__ x, const void* __restrict__ g, void* __restrict__ dx,
                long long rows, int c, int rows_per_block, int lo, int hi, float alpha, float k,
                int kind, float neg_beta, float two_ab) {
  extern __shared__ float tile[];
  float* sq = tile;
  float* inner = tile + static_cast<long long>(rows_per_block) * c;
  constexpr int ESIZE = BF16 ? 2 : 4;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const int nrows = rows - row0 < rows_per_block ? static_cast<int>(rows - row0) : rows_per_block;
  const int vpr = c / VEC;
  const int nv = nrows * vpr;
  const char* xb = static_cast<const char*>(x) + row0 * c * ESIZE;
  const char* gb = static_cast<const char*>(g) + row0 * c * ESIZE;
  char* dxb = static_cast<char*>(dx) + row0 * c * ESIZE;

  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    const int e = v * VEC;  // the vector's first element in the tile
    float xv[VEC];
    Vec<BF16, VEC>::load(xb + static_cast<long long>(e) * ESIZE, xv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) sq[e + j] = __fmul_rn(xv[j], xv[j]);
  }
  __syncthreads();
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    const int e = v * VEC, r = v / vpr, c0 = e - r * c;
    float xv[VEC], gv[VEC];
    Vec<BF16, VEC>::load(xb + static_cast<long long>(e) * ESIZE, xv);
    Vec<BF16, VEC>::load(gb + static_cast<long long>(e) * ESIZE, gv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float s = s_of(k, alpha, row_window(sq + r * c, c, c0 + j, lo, hi));
      inner[e + j] = inner_of(gv[j], xv[j], inv_pow(s, kind, neg_beta), s);
    }
  }
  __syncthreads();
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    const int e = v * VEC, r = v / vpr, c0 = e - r * c;
    float xv[VEC], gv[VEC], out[VEC];
    Vec<BF16, VEC>::load(xb + static_cast<long long>(e) * ESIZE, xv);
    Vec<BF16, VEC>::load(gb + static_cast<long long>(e) * ESIZE, gv);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float s = s_of(k, alpha, row_window(sq + r * c, c, c0 + j, lo, hi));
      const float wsum = row_window(inner + r * c, c, c0 + j, hi, lo);  // adjoint
      out[j] = dx_of(gv[j], xv[j], inv_pow(s, kind, neg_beta), two_ab, wsum);
    }
    Vec<BF16, VEC>::store(dxb + static_cast<long long>(e) * ESIZE, out);
  }
}

// -- launch ---------------------------------------------------------------------

using Kernel = void (*)(const void*, const void*, void*, long long, int, int, int, int, float,
                        float, int, float, float);

template <bool BF16, int VEC>
Kernel pick_halo(int kind) {
  switch (kind) {
    case BETA_075: return halo_kernel<BF16, VEC, BETA_075>;
    case BETA_05: return halo_kernel<BF16, VEC, BETA_05>;
    case BETA_025: return halo_kernel<BF16, VEC, BETA_025>;
    case BETA_1: return halo_kernel<BF16, VEC, BETA_1>;
    default: return halo_kernel<BF16, VEC, BETA_ANY>;
  }
}

template <bool BF16>
Kernel pick(bool halo, int vec, int kind) {
  if (halo) {
    switch (vec) {
      case 2: return pick_halo<BF16, 2>(kind);
      case 4: return pick_halo<BF16, 4>(kind);
      case 8:
        if constexpr (BF16) return pick_halo<true, 8>(kind);
        return nullptr;
      default: return nullptr;
    }
  }
  switch (vec) {
    case 1: return rows_kernel<BF16, 1>;
    case 2: return rows_kernel<BF16, 2>;
    case 4: return rows_kernel<BF16, 4>;
    case 8:
      if constexpr (BF16) return rows_kernel<true, 8>;
      return nullptr;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// dx = the LRN input gradient of x and g, all three [rows, C] contiguous,
// f32 (bf16 0) or bf16 (bf16 1).  beta_kind: 0 for beta 0.75, 1 for 0.5, 2
// for 0.25, 3 for 1, 4 for any other (exp/log, with neg_beta = -beta);
// two_ab = 2 alpha beta.  The launch's geometry comes from the wrapper
// (ops/kernels/lrn.py::launch_geometry): halo 1 for halo_kernel (n <= 5,
// vec >= 2, rows_per_block * C / vec <= threads), 0 for rows_kernel; vec
// elements a thread's access, dividing C, every pointer aligned to vec
// elements; threads a multiple of 32, at most 1024 (256 for rows_kernel).
int znicz_lrn_bwd(const void* x, const void* g, void* dx, long long rows, int c, int n,
                  float alpha, float k, int beta_kind, float neg_beta, float two_ab, int bf16,
                  int halo, int vec, int rows_per_block, int threads, void* stream) {
  const int esize = bf16 ? 2 : 4;
  if (rows < 1 || c < 1 || n < 1 || beta_kind < 0 || beta_kind > BETA_ANY || rows_per_block < 1 ||
      vec < 1 || vec * esize > 16 || c % vec != 0 || threads < 32 || threads % 32 != 0 ||
      threads > (halo ? MAX_THREADS : ROWS_THREADS)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t bytes = static_cast<uintptr_t>(vec * esize);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
       reinterpret_cast<uintptr_t>(dx)) % bytes != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int lo = n / 2, hi = n - 1 - n / 2;
  const long long tiles = (rows + rows_per_block - 1) / rows_per_block;
  const long long grid = halo ? (tiles + HALO_TILES - 1) / HALO_TILES : tiles;
  if (grid > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem;
  if (halo) {
    if (n > 2 * HALO + 1 || vec < HALO ||
        static_cast<long long>(rows_per_block) * (c / vec) > threads) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    smem = 4 * sizeof(float2) * threads;
  } else {
    smem = 2 * sizeof(float) * static_cast<size_t>(rows_per_block) * c;
  }
  const Kernel kernel = bf16 ? pick<true>(halo, vec, beta_kind) : pick<false>(halo, vec, beta_kind);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    int device = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(grid), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, g, dx, rows, c, rows_per_block, lo, hi, alpha, k, beta_kind, neg_beta, two_ab);
  return static_cast<int>(cudaGetLastError());
}

const char* znicz_lrn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
