// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the three pl.pallas_call's of znicz_tpu/ops/pallas/attention.py:
//   _flash_fwd_impl / _fwd_kernel (:212)  ->  fwd_kernel
//   _flash_bwd / _dq_kernel        (:265)  ->  dq_kernel
//   _flash_bwd / _dkv_kernel       (:277)  ->  dkv_kernel
//
// Layout: q, k, v, out, dout and the gradients are [B, T, H, D] contiguous,
// read in place through their strides (no [B*H, T, D] transposes); lse and
// delta are [B, T, H] float32.  D is 16, 32, 64 or 128 (a template
// argument); T is any length: the ragged last tile is masked by index.
//
// What bounds these on an H100: operations.  At the LM slice (B*H = 128,
// T = 2048, D = 64, causal) the forward does 2 products over the T(T+1)/2
// live (q, k) pairs a head, ~69 GFLOP, against ~0.13 GB of q, k, v, out.
// Design for that, kept simple: one block of 256 threads owns a 64-row
// tile and loops over the other side's 64-row tiles in shared memory (the
// TPU grid's sequential k axis becomes this loop); each thread computes a
// 4 x 4 register tile of every 64 x 64 product with f32 FMAs, feeding them
// from shared memory with one 16-byte load per 16 FMAs (the row tiles are
// kept transposed, [D][64 + 4], so a thread's 4 rows are one vector).
// Inputs of either type are widened to f32 in shared memory: f32 runs in
// full f32 (no TF32) and bf16 takes the same FMA path, with p and ds
// rounded to bf16 before their products as the TPU kernels cast them.
// wgmma, TMA and warp specialisation are left for later work.
//
// Causal: the k loop of a q tile stops at the diagonal tile, and the q loop
// of a k tile (dK/dV) starts there (the TPU kernels' _live skip).  Masked
// probabilities are exactly 0 (selected, never computed from the NEG_INF
// sentinel).  dK/dV has one owner per k tile and dQ one per q tile: no
// atomics, deterministic results.
//
// Each C entry returns cudaGetLastError() (or the error of its set-up
// call); the Python wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;          // rows of a q tile and of a k tile
constexpr int NT = 256;           // threads a block: 16 x 16, 4 x 4 outputs each
constexpr int LD = TILE + 4;      // row of a transposed tile; 16-byte aligned
constexpr float NEG_INF = -1e30f;  // the TPU kernels' sentinel
constexpr float L_FLOOR = 1e-30f;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}

// x rounded to T's precision (the casts before a product), kept in f32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

struct Geom {
  int t;           // sequence length
  int h;           // heads
  long long sb;    // element stride of the batch axis (T * H * D)
  long long st;    // element stride of the time axis (H * D)
};

// rows [r0, r0 + 64) of one head into dst[d * LD + r] (transposed), zero
// past the end of the sequence
template <typename T, int D>
__device__ __forceinline__ void load_t(float* dst, const T* src, int r0, const Geom& g) {
  for (int i = threadIdx.x; i < TILE * D; i += NT) {
    const int r = i / D, d = i % D;
    const int t = r0 + r;
    dst[d * LD + r] = t < g.t ? to_f<T>(src[(long long)t * g.st + d]) : 0.f;
  }
}

// rows [r0, r0 + 64) of one head into dst[r * D + d]
template <typename T, int D>
__device__ __forceinline__ void load_n(float* dst, const T* src, int r0, const Geom& g) {
  for (int i = threadIdx.x; i < TILE * D; i += NT) {
    const int r = i / D, d = i % D;
    const int t = r0 + r;
    dst[i] = t < g.t ? to_f<T>(src[(long long)t * g.st + d]) : 0.f;
  }
}

// acc[i][j] = sum_d A[d][ty*4 + i] * B[d][tx*4 + j] over transposed tiles
template <int D>
__device__ __forceinline__ void tile_abt(float acc[4][4], const float* A, const float* B,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 a = *reinterpret_cast<const float4*>(A + d * LD + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(B + d * LD + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// The D / 16 output columns a thread owns: 16-byte groups spread 64 apart
// when there are 4 or more (each vector load is contiguous across the 16
// threads of a row), else tx * C + c.
template <int D>
__device__ __forceinline__ int out_col(int c, int tx) {
  constexpr int C = D / 16;
  if constexpr (C >= 4) {
    return (c / 4) * 64 + tx * 4 + (c % 4);
  } else {
    return tx * C + c;
  }
}

// acc[i][c] += sum_r P[r][ty*4 + i] * X[r][out_col(c)], P transposed
// ([r][LD]) and X natural ([r][D]), r over the 64 rows of the tile
template <int D>
__device__ __forceinline__ void tile_atx(float acc[4][D / 16], const float* P, const float* X,
                                         int ty, int tx) {
  constexpr int C = D / 16;
#pragma unroll 4
  for (int r = 0; r < TILE; ++r) {
    const float4 p = *reinterpret_cast<const float4*>(P + r * LD + ty * 4);
    const float pv[4] = {p.x, p.y, p.z, p.w};
    float xv[C];
    const float* row = X + r * D;
    if constexpr (C >= 4) {
#pragma unroll
      for (int gi = 0; gi < C / 4; ++gi) {
        const float4 x = *reinterpret_cast<const float4*>(row + gi * 64 + tx * 4);
        xv[gi * 4 + 0] = x.x;
        xv[gi * 4 + 1] = x.y;
        xv[gi * 4 + 2] = x.z;
        xv[gi * 4 + 3] = x.w;
      }
    } else if constexpr (C == 2) {
      const float2 x = *reinterpret_cast<const float2*>(row + tx * 2);
      xv[0] = x.x;
      xv[1] = x.y;
    } else {
      xv[0] = row[tx];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] = fmaf(pv[i], xv[c], acc[i][c]);
  }
}

// sum / max over the 16 threads of a row (lanes differing in bits 0..3)
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// write a 4 x 4 register tile v[i][j] (row ty*4+i, col tx*4+j) transposed:
// dst[(tx*4 + j) * LD + ty*4 + i], each value rounded to T
template <typename T>
__device__ __forceinline__ void store_t(float* dst, float v[4][4], int ty, int tx) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<float4*>(dst + (tx * 4 + j) * LD + ty * 4) =
        make_float4(round_to<T>(v[0][j]), round_to<T>(v[1][j]), round_to<T>(v[2][j]),
                    round_to<T>(v[3][j]));
  }
}

__device__ __forceinline__ bool valid(int qi, int ki, int t, int causal) {
  return ki < t && qi < t && (!causal || ki <= qi);
}

// ---------------------------------------------------------------------------
// forward: one block per (q tile, batch-head); online softmax over k tiles

template <typename T, int D>
__global__ void __launch_bounds__(NT) fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                                 const T* __restrict__ v, T* __restrict__ o,
                                                 float* __restrict__ lse, Geom g, float scale,
                                                 int causal) {
  constexpr int C = D / 16;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][LD]
  float* Kt = Qt + D * LD;                      // [D][LD]
  float* Vs = Kt + D * LD;                      // [64][D]
  float* Pt = Vs + TILE * D;                    // [64 keys][LD queries]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nt = (g.t + TILE - 1) / TILE;
  const int qb = nt - 1 - blockIdx.x;  // the longest causal rows start first
  const int b = blockIdx.y / g.h, h = blockIdx.y % g.h;
  const long long base = b * g.sb + (long long)h * D;
  const int q0 = qb * TILE;

  load_t<T, D>(Qt, q + base, q0, g);
  float m[4], l[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? qb + 1 : nt;
  for (int kb = 0; kb < k_end; ++kb) {
    const int k0 = kb * TILE;
    __syncthreads();  // the previous tile's Kt, Vs and Pt are consumed
    load_t<T, D>(Kt, k + base, k0, g);
    load_n<T, D>(Vs, v + base, k0, g);
    __syncthreads();

    float s[4][4];
    tile_abt<D>(s, Qt, Kt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = valid(qi, k0 + tx * 4 + j, g.t, causal);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // masked entries carry zero mass even when the whole row is masked
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += s[i][j];
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
    }
    store_t<T>(Pt, s, ty, tx);  // p cast to v's type before p.V
    __syncthreads();
    tile_atx<D>(acc, Pt, Vs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= g.t) continue;
    const float li = fmaxf(l[i], L_FLOOR);
    T* orow = o + base + (long long)qi * g.st;
#pragma unroll
    for (int c = 0; c < C; ++c) orow[out_col<D>(c, tx)] = from_f<T>(acc[i][c] / li);
    if (tx == 0) lse[((long long)b * g.t + qi) * g.h + h] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (q tile, batch-head), looping over the live k tiles:
//   p = exp(s - lse), ds = p (dp - delta), dq = scale * sum_k ds.K

template <typename T, int D>
__global__ void __launch_bounds__(NT) dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                                const T* __restrict__ v, const T* __restrict__ dout,
                                                const float* __restrict__ lse,
                                                const float* __restrict__ delta,
                                                T* __restrict__ dq, Geom g, float scale,
                                                int causal) {
  constexpr int C = D / 16;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][LD]
  float* dOt = Qt + D * LD;                     // [D][LD]
  float* Kt = dOt + D * LD;                     // [D][LD]
  float* Vt = Kt + D * LD;                      // [D][LD]
  float* Ks = Vt + D * LD;                      // [64][D]
  float* dSt = Ks + TILE * D;                   // [64 keys][LD queries]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nt = (g.t + TILE - 1) / TILE;
  const int qb = nt - 1 - blockIdx.x;
  const int b = blockIdx.y / g.h, h = blockIdx.y % g.h;
  const long long base = b * g.sb + (long long)h * D;
  const int q0 = qb * TILE;

  load_t<T, D>(Qt, q + base, q0, g);
  load_t<T, D>(dOt, dout + base, q0, g);
  float lse_r[4], delta_r[4], acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    const long long si = ((long long)b * g.t + qi) * g.h + h;
    lse_r[i] = qi < g.t ? lse[si] : 0.f;
    delta_r[i] = qi < g.t ? delta[si] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  const int k_end = causal ? qb + 1 : nt;
  for (int kb = 0; kb < k_end; ++kb) {
    const int k0 = kb * TILE;
    __syncthreads();
    load_t<T, D>(Kt, k + base, k0, g);
    load_t<T, D>(Vt, v + base, k0, g);
    load_n<T, D>(Ks, k + base, k0, g);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_abt<D>(s, Qt, Kt, ty, tx);
    tile_abt<D>(dp, dOt, Vt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = valid(qi, k0 + tx * 4 + j, g.t, causal);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        s[i][j] = p * (dp[i][j] - delta_r[i]);  // ds
      }
    }
    store_t<T>(dSt, s, ty, tx);  // ds cast to k's type before ds.K
    __syncthreads();
    tile_atx<D>(acc, dSt, Ks, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= g.t) continue;
    T* row = dq + base + (long long)qi * g.st;
#pragma unroll
    for (int c = 0; c < C; ++c) row[out_col<D>(c, tx)] = from_f<T>(scale * acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (k tile, batch-head), looping over the live q tiles
// (the transposed traversal): dv = sum_q p^T.dout, dk = scale sum_q ds^T.q

template <typename T, int D>
__global__ void __launch_bounds__(NT) dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                                 const T* __restrict__ v,
                                                 const T* __restrict__ dout,
                                                 const float* __restrict__ lse,
                                                 const float* __restrict__ delta,
                                                 T* __restrict__ dk, T* __restrict__ dv, Geom g,
                                                 float scale, int causal) {
  constexpr int C = D / 16;
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // [D][LD] (rows: this block's keys)
  float* Vt = Kt + D * LD;                      // [D][LD]
  float* Qt = Vt + D * LD;                      // [D][LD] (cols: the q tile)
  float* dOt = Qt + D * LD;                     // [D][LD]
  float* Qs = dOt + D * LD;                     // [64][D]
  float* dOs = Qs + TILE * D;                   // [64][D]
  float* Ps = dOs + TILE * D;                   // [64 queries][LD keys]: p, then ds
  float* lse_s = Ps + TILE * LD;                // [64]
  float* delta_s = lse_s + TILE;                // [64]

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int nt = (g.t + TILE - 1) / TILE;
  const int kb = blockIdx.x;  // the longest causal columns start first
  const int b = blockIdx.y / g.h, h = blockIdx.y % g.h;
  const long long base = b * g.sb + (long long)h * D;
  const int k0 = kb * TILE;

  load_t<T, D>(Kt, k + base, k0, g);
  load_t<T, D>(Vt, v + base, k0, g);
  float dk_acc[4][C], dv_acc[4][C];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int qb = causal ? kb : 0; qb < nt; ++qb) {
    const int q0 = qb * TILE;
    __syncthreads();
    load_t<T, D>(Qt, q + base, q0, g);
    load_t<T, D>(dOt, dout + base, q0, g);
    load_n<T, D>(Qs, q + base, q0, g);
    load_n<T, D>(dOs, dout + base, q0, g);
    if (threadIdx.x < TILE) {
      const int qi = q0 + threadIdx.x;
      const long long si = ((long long)b * g.t + qi) * g.h + h;
      lse_s[threadIdx.x] = qi < g.t ? lse[si] : 0.f;
      delta_s[threadIdx.x] = qi < g.t ? delta[si] : 0.f;
    }
    __syncthreads();

    float st[4][4], ds[4][4];  // [key ty*4+i][query tx*4+j]
    tile_abt<D>(st, Kt, Qt, ty, tx);
    tile_abt<D>(ds, Vt, dOt, ty, tx);  // dp^T
    const float4 l4 = *reinterpret_cast<const float4*>(lse_s + tx * 4);
    const float4 d4 = *reinterpret_cast<const float4*>(delta_s + tx * 4);
    const float lv[4] = {l4.x, l4.y, l4.z, l4.w};
    const float dv4[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ki = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = valid(q0 + tx * 4 + j, ki, g.t, causal);
        const float p = ok ? expf(st[i][j] * scale - lv[j]) : 0.f;
        ds[i][j] = p * (ds[i][j] - dv4[j]);
        st[i][j] = p;
      }
    }
    store_t<T>(Ps, st, ty, tx);  // p -> Ps[query][key], cast to dout's type
    __syncthreads();
    tile_atx<D>(dv_acc, Ps, dOs, ty, tx);
    __syncthreads();
    store_t<T>(Ps, ds, ty, tx);  // ds -> Ps[query][key], cast to q's type
    __syncthreads();
    tile_atx<D>(dk_acc, Ps, Qs, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ki = k0 + ty * 4 + i;
    if (ki >= g.t) continue;
    T* krow = dk + base + (long long)ki * g.st;
    T* vrow = dv + base + (long long)ki * g.st;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      krow[out_col<D>(c, tx)] = from_f<T>(scale * dk_acc[i][c]);
      vrow[out_col<D>(c, tx)] = from_f<T>(dv_acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers

template <int D>
constexpr size_t fwd_smem() { return (2 * D * LD + TILE * D + TILE * LD) * sizeof(float); }
template <int D>
constexpr size_t dq_smem() { return (4 * D * LD + TILE * D + TILE * LD) * sizeof(float); }
template <int D>
constexpr size_t dkv_smem() {
  return (4 * D * LD + 2 * TILE * D + TILE * LD + 2 * TILE) * sizeof(float);
}
static_assert(dkv_smem<128>() <= 232448, "dK/dV tile exceeds a block's shared memory");

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

template <typename T, int D>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int b, int t,
                    int h, int causal, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem<D>();
  cudaError_t e = prepare(fwd_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((t + TILE - 1) / TILE, b * h);
  fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), make_geom(t, h, D), scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* delta, void* dq, int b, int t, int h, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = dq_smem<D>();
  cudaError_t e = prepare(dq_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((t + TILE - 1) / TILE, b * h);
  dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), make_geom(t, h, D), scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int b, int t, int h,
                    int causal, float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem<D>();
  cudaError_t e = prepare(dkv_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((t + TILE - 1) / TILE, b * h);
  dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
      make_geom(t, h, D), scale, causal);
  return cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16; d: 16, 32, 64 or 128
#define ZNICZ_DISPATCH(dtype, d, CALL)                                  \
  do {                                                                  \
    if ((dtype) == 0) {                                                 \
      using T = float;                                                  \
      switch (d) {                                                      \
        case 16: { constexpr int D = 16; return (int)(CALL); }          \
        case 32: { constexpr int D = 32; return (int)(CALL); }          \
        case 64: { constexpr int D = 64; return (int)(CALL); }          \
        case 128: { constexpr int D = 128; return (int)(CALL); }        \
      }                                                                 \
    } else if ((dtype) == 1) {                                          \
      using T = __nv_bfloat16;                                          \
      switch (d) {                                                      \
        case 16: { constexpr int D = 16; return (int)(CALL); }          \
        case 32: { constexpr int D = 32; return (int)(CALL); }          \
        case 64: { constexpr int D = 64; return (int)(CALL); }          \
        case 128: { constexpr int D = 128; return (int)(CALL); }        \
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
// asks for at head dim d; -1 for a head dim without a kernel
int znicz_flash_smem_bytes(int which, int d) {
#define ZNICZ_SMEM(D) \
  return (int)(which == 0 ? fwd_smem<D>() : which == 1 ? dq_smem<D>() : dkv_smem<D>())
  switch (d) {
    case 16: ZNICZ_SMEM(16);
    case 32: ZNICZ_SMEM(32);
    case 64: ZNICZ_SMEM(64);
    case 128: ZNICZ_SMEM(128);
  }
#undef ZNICZ_SMEM
  return -1;
}

const char* znicz_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
