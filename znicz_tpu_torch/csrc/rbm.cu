// Fused RBM CD-k statistics for Hopper (sm_90a).
//
// Replaces the pl.pallas_call of znicz_tpu/ops/pallas/rbm.py:
//   _statistics / _cd_kernel (:161, kernel at :59)
// For v0 [B, V], the row mask [B], W [V, H], vbias [V], hbias [H]:
//   h0p = sigmoid(v0 W + hb),   h = (u < h0p)
//   k times:  vp = sigmoid(h W^T + vb),  v = (u < vp),
//             hp = sigmoid(v W + hb),    h = (u < hp)
//   dW  = (v0 m)^T h0p - (vp m)^T hp            [V, H]
//   dvb = sum_b (v0 - vp) m,  dhb = sum_b (h0p - hp) m
//   stats = (sum_b mean_v (v0 - vp)^2 m,  sum_b m)
// The lr / n_valid update runs outside, in PyTorch.
//
// Random numbers.  The TPU kernel samples with the TPU's hardware PRNG,
// which nothing else reproduces.  Here every uniform is a counter-based
// draw: Philox4x32-10 with key (seed, stream) at counter (n, 0, 0, 0),
// where n is the element's flat index in uh [1 + k, B, H] (stream 0, the
// hidden draws) or uv [k, B, V] (stream 1, the visible draws), and the
// uniform is the first output word's 24 low bits times 2^-24, as the TPU
// kernel's _uniform makes it.  ops/kernels/rbm.py has a bit-identical
// PyTorch twin, so the card and the CPU draw the same numbers.  Given uh
// and uv (non-null), the kernel reads them instead: the JAX kernel's
// interpret-mode contract, which the tests use.
//
// What bounds it on an H100: operations.  CD-k does (2k + 3) products of
// 2 B V H flops (k = 1, B 1024, 784 x 1024: 8.2 GFLOP, 0.12 ms at the f32
// peak) against ~10 MB of inputs and outputs.  At the model's shape (B 100,
// 784 x 128, k 1: 0.1 GFLOP) a step is below a launch's fixed cost.  The
// TPU kernel holds everything in VMEM (its 10 MiB fits_vmem budget); that
// has no meaning here, where a block has 227 KB of shared memory and W
// alone is 3.2 MB at 784 x 1024.  Design, simple first, in two launches
// and with no atomics, so a step gives the same bits every run:
//   1. chain_kernel: a block runs the whole chain for ROWS (4, 8 or 16)
//      batch rows.  Their visible and hidden states stay in shared memory,
//      transposed ([unit][row]); each product streams W from L2 through a
//      32 x 64 shared tile, 256 threads each own one column and ROWS / 4
//      rows, and sum over the reduction axis in order, so the results do
//      not depend on ROWS.  It writes h0p, vp, hp and each row's error.
//   2. stats_kernel: a block owns a 64 x 64 tile of dW and loops over the
//      batch in a fixed order, 32 rows at a time (4 x 4 register tiles of
//      both products); its edge blocks also sum dvb and dhb, and block
//      (0, 0) the two statistics, in a fixed order.
// f32 FMAs throughout (no tensor cores, no TF32).  Masked rows run the
// chain and contribute nothing.  Limit: (V + H) rounded up to 32 each,
// times 16 bytes (ROWS 4), must fit the block's shared memory: V + H up to
// about 14,000.
//
// Each C entry returns cudaGetLastError() (or the error of its set-up
// call); the Python wrapper raises on a non-zero code.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;       // threads a block
constexpr int TN = 64;        // output columns of a chain product tile
constexpr int TK = 32;        // reduction chunk of a chain product
constexpr int LDB = TN + 1;   // row of the shared W tile
constexpr int ST = 64;        // dW tile edge
constexpr int SB = 32;        // batch rows a chunk of stats_kernel

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

__host__ __device__ constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }

// RPT consecutive floats of shared memory (16- or 8-byte aligned for 4, 2)
__device__ __forceinline__ void load_rows(const float* p, float (&a)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  a[0] = t.x; a[1] = t.y; a[2] = t.z; a[3] = t.w;
}
__device__ __forceinline__ void load_rows(const float* p, float (&a)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  a[0] = t.x; a[1] = t.y;
}
__device__ __forceinline__ void load_rows(const float* p, float (&a)[1]) { a[0] = *p; }

// out(r, n) = sum_k a[k * ROWS + r] B(k, n) with B(k, n) = bm[k * sk + n * sn]
// (one of sk, sn is 1), for the block's ROWS rows and every n < N, 64
// columns a tile; epi(q, r, n, sum) for each output, where r = tr * RPT + q.
// `a` must hold round_up(K, TK) rows (zero past K).
template <int ROWS, typename Epi>
__device__ __forceinline__ void block_product(const float* a, const float* __restrict__ bm,
                                              int sk, int sn, int K, int N, float* bt, Epi epi) {
  constexpr int RPT = ROWS / 4;
  const int tid = threadIdx.x, tn = tid % TN, tr = tid / TN;
  for (int n0 = 0; n0 < N; n0 += TN) {
    float acc[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) acc[q] = 0.f;
    for (int k0 = 0; k0 < K; k0 += TK) {
      // the W tile, read along whichever axis is contiguous
      if (sn == 1) {
        for (int e = tid; e < TK * TN; e += NT) {
          const int kk = e / TN, nn = e % TN, gk = k0 + kk, gn = n0 + nn;
          bt[kk * LDB + nn] = (gk < K && gn < N) ? bm[(size_t)gk * sk + gn] : 0.f;
        }
      } else {
        for (int e = tid; e < TK * TN; e += NT) {
          const int nn = e / TK, kk = e % TK, gk = k0 + kk, gn = n0 + nn;
          bt[kk * LDB + nn] = (gk < K && gn < N) ? bm[(size_t)gn * sn + gk] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < TK; ++kk) {
        const float bv = bt[kk * LDB + tn];
        float av[RPT];
        load_rows(a + (size_t)(k0 + kk) * ROWS + tr * RPT, av);
#pragma unroll
        for (int q = 0; q < RPT; ++q) acc[q] = fmaf(av[q], bv, acc[q]);
      }
      __syncthreads();
    }
    const int n = n0 + tn;
    if (n < N) {
#pragma unroll
      for (int q = 0; q < RPT; ++q) epi(q, tr * RPT + q, n, acc[q]);
    }
  }
}

struct Chain {
  const float* v0;
  const float* w;
  const float* vb;
  const float* hb;
  const float* uh;  // [1 + k, B, H] or null: draw in the kernel
  const float* uv;  // [k, B, V] or null
  float* h0p;       // [B, H]
  float* vp;        // [B, V], the last step's
  float* hp;        // [B, H], the last step's
  float* err_row;   // [B]: mean_v (v0 - vp)^2
  int b, v, h, cd_k;
  uint32_t seed;
};

size_t chain_smem_bytes(int rows, int v, int h) {
  return ((size_t)round_up(v, TK) + round_up(h, TK)) * rows * sizeof(float) +
         (size_t)TK * LDB * sizeof(float);
}

template <int ROWS>
__global__ void __launch_bounds__(NT) chain_kernel(Chain c) {
  constexpr int RPT = ROWS / 4;
  extern __shared__ __align__(16) float smem[];
  const int v_rows = round_up(c.v, TK), h_rows = round_up(c.h, TK);
  float* vs = smem;                        // [v_rows][ROWS] visible state
  float* hs = vs + (size_t)v_rows * ROWS;  // [h_rows][ROWS] hidden state
  float* bt = hs + (size_t)h_rows * ROWS;  // [TK][LDB] W tile
  const int tid = threadIdx.x, tn = tid % TN, tr = tid / TN;
  const int r0 = blockIdx.x * ROWS;

  for (int e = tid; e < ROWS * v_rows; e += NT) {
    const int r = e / v_rows, i = e % v_rows, g = r0 + r;
    vs[(size_t)i * ROWS + r] = (g < c.b && i < c.v) ? c.v0[(size_t)g * c.v + i] : 0.f;
  }
  for (int e = tid; e < ROWS * h_rows; e += NT) hs[e] = 0.f;
  __syncthreads();

  // h0p and the first hidden sample: B(k = i, n = j) = W[i, j]
  block_product<ROWS>(vs, c.w, c.h, 1, c.v, c.h, bt, [&](int, int r, int n, float s) {
    const int g = r0 + r;
    float sample = 0.f;
    if (g < c.b) {
      const float p = sigmoid(s + c.hb[n]);
      const size_t idx = (size_t)g * c.h + n;
      c.h0p[idx] = p;
      const float u = c.uh ? c.uh[idx] : uniform_at(idx, c.seed, 0u);
      sample = u < p ? 1.f : 0.f;
    }
    hs[(size_t)n * ROWS + r] = sample;
  });
  __syncthreads();

  for (int step = 0; step < c.cd_k; ++step) {
    const bool last = step == c.cd_k - 1;
    float errp[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) errp[q] = 0.f;
    // visible: B(k = j, n = i) = W[i, j]
    block_product<ROWS>(hs, c.w, 1, c.h, c.h, c.v, bt, [&](int q, int r, int n, float s) {
      const int g = r0 + r;
      float sample = 0.f;
      if (g < c.b) {
        const float p = sigmoid(s + c.vb[n]);
        const size_t idx = ((size_t)step * c.b + g) * c.v + n;
        const float u = c.uv ? c.uv[idx] : uniform_at(idx, c.seed, 1u);
        sample = u < p ? 1.f : 0.f;
        if (last) {
          c.vp[(size_t)g * c.v + n] = p;
          const float d = c.v0[(size_t)g * c.v + n] - p;
          errp[q] = fmaf(d, d, errp[q]);
        }
      }
      vs[(size_t)n * ROWS + r] = sample;
    });
    __syncthreads();
    if (last) {  // each row's error: its 64 column partials, in order
#pragma unroll
      for (int q = 0; q < RPT; ++q) bt[(tr * RPT + q) * TN + tn] = errp[q];
      __syncthreads();
      if (tid < ROWS && r0 + tid < c.b) {
        float s = 0.f;
        for (int t = 0; t < TN; ++t) s += bt[tid * TN + t];
        c.err_row[r0 + tid] = s / static_cast<float>(c.v);
      }
      __syncthreads();
    }
    // hidden: B(k = i, n = j) = W[i, j]; the last step's sample is not used
    block_product<ROWS>(vs, c.w, c.h, 1, c.v, c.h, bt, [&](int, int r, int n, float s) {
      const int g = r0 + r;
      float sample = 0.f;
      if (g < c.b) {
        const float p = sigmoid(s + c.hb[n]);
        if (last) {
          c.hp[(size_t)g * c.h + n] = p;
        } else {
          const size_t idx = ((size_t)(step + 1) * c.b + g) * c.h + n;
          const float u = c.uh ? c.uh[idx] : uniform_at(idx, c.seed, 0u);
          sample = u < p ? 1.f : 0.f;
        }
      }
      hs[(size_t)n * ROWS + r] = sample;
    });
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT)
    stats_kernel(const float* __restrict__ v0, const float* __restrict__ vp,
                 const float* __restrict__ h0p, const float* __restrict__ hp,
                 const float* __restrict__ mask, const float* __restrict__ err_row,
                 float* __restrict__ dw, float* __restrict__ dvb, float* __restrict__ dhb,
                 float* __restrict__ stats, int b, int v, int h) {
  __shared__ float a0[SB][ST], a1[SB][ST];  // v0 and vp rows of the tile
  __shared__ float b0[SB][ST], b1[SB][ST];  // h0p and hp rows of the tile
  __shared__ float ms[SB];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int j0 = blockIdx.x * ST, i0 = blockIdx.y * ST;
  const bool sum_dvb = blockIdx.x == 0 && tid < ST;
  const bool sum_dhb = blockIdx.y == 0 && tid >= ST && tid < 2 * ST;
  float pos[4][4] = {}, neg[4][4] = {};
  float bias = 0.f;
  for (int g0 = 0; g0 < b; g0 += SB) {
    if (tid < SB) ms[tid] = g0 + tid < b ? mask[g0 + tid] : 0.f;
    for (int e = tid; e < SB * ST; e += NT) {
      const int r = e / ST, col = e % ST, g = g0 + r, iv = i0 + col, jh = j0 + col;
      const bool ok_v = g < b && iv < v, ok_h = g < b && jh < h;
      a0[r][col] = ok_v ? v0[(size_t)g * v + iv] : 0.f;
      a1[r][col] = ok_v ? vp[(size_t)g * v + iv] : 0.f;
      b0[r][col] = ok_h ? h0p[(size_t)g * h + jh] : 0.f;
      b1[r][col] = ok_h ? hp[(size_t)g * h + jh] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < SB; ++r) {
      const float m = ms[r];
      float x0[4], x1[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        x0[a] = a0[r][ty + 16 * a] * m;
        x1[a] = a1[r][ty + 16 * a] * m;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float y0 = b0[r][tx + 16 * cc], y1 = b1[r][tx + 16 * cc];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pos[a][cc] = fmaf(x0[a], y0, pos[a][cc]);
          neg[a][cc] = fmaf(x1[a], y1, neg[a][cc]);
        }
      }
    }
    if (sum_dvb) {
      for (int r = 0; r < SB; ++r) bias += (a0[r][tid] - a1[r][tid]) * ms[r];
    } else if (sum_dhb) {
      for (int r = 0; r < SB; ++r) bias += (b0[r][tid - ST] - b1[r][tid - ST]) * ms[r];
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= v) continue;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int j = j0 + tx + 16 * cc;
      if (j < h) dw[(size_t)i * h + j] = pos[a][cc] - neg[a][cc];
    }
  }
  if (sum_dvb && i0 + tid < v) dvb[i0 + tid] = bias;
  if (sum_dhb && j0 + tid - ST < h) dhb[j0 + tid - ST] = bias;
  if (blockIdx.x == 0 && blockIdx.y == 0) {  // (sum_b err_b m_b, sum_b m_b)
    __shared__ float re[NT], rm[NT];
    float e = 0.f, mm = 0.f;
    for (int g = tid; g < b; g += NT) {
      e += err_row[g] * mask[g];
      mm += mask[g];
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
      stats[0] = re[0];
      stats[1] = rm[0];
    }
  }
}

__global__ void uniforms_kernel(float* out, long long n, uint32_t seed, uint32_t stream) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    out[i] = uniform_at(static_cast<unsigned long long>(i), seed, stream);
  }
}

int max_smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return bytes;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 1;
  return n;
}

// rows a chain block takes: the largest of 16, 8, 4 that still gives every
// SM a block, else 4; 0 when even 4 rows do not fit in shared memory
int chain_rows(int b, int v, int h) {
  const size_t limit = static_cast<size_t>(max_smem_optin());
  const int sms = sm_count();
  for (int rows = 16; rows >= 4; rows /= 2) {
    if (chain_smem_bytes(rows, v, h) <= limit && (b + rows - 1) / rows >= sms) return rows;
  }
  return chain_smem_bytes(4, v, h) <= limit ? 4 : 0;
}

template <int ROWS>
cudaError_t launch_chain(const Chain& c, cudaStream_t s) {
  const size_t bytes = chain_smem_bytes(ROWS, c.v, c.h);
  static size_t opted_in = 48 * 1024;
  if (bytes > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        chain_kernel<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    opted_in = bytes;
  }
  chain_kernel<ROWS><<<(c.b + ROWS - 1) / ROWS, NT, bytes, s>>>(c);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The ROWS the launcher picks for this shape on the current device (0: the
// shape does not fit) and the dynamic shared memory a chain block asks for.
int znicz_rbm_chain_rows(int b, int v, int h) { return chain_rows(b, v, h); }

long long znicz_rbm_chain_smem_bytes(int rows, int v, int h) {
  return static_cast<long long>(chain_smem_bytes(rows, v, h));
}

// h0p, hp [B, H], vp [B, V] and err_row [B] are scratch the wrapper
// allocates; dw [V, H], dvb [V], dhb [H] and stats [2] are written whole.
// uh, uv: null to draw in the kernel from `seed`.  B, V, H, cd_k >= 1.
int znicz_rbm_cd(const float* v0, const float* mask, const float* w, const float* vb,
                 const float* hb, const float* uh, const float* uv, float* h0p, float* vp,
                 float* hp, float* err_row, float* dw, float* dvb, float* dhb, float* stats,
                 int b, int v, int h, int cd_k, unsigned int seed, void* stream) {
  if (b < 1 || v < 1 || h < 1 || cd_k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Chain c{v0, w, vb, hb, uh, uv, h0p, vp, hp, err_row, b, v, h, cd_k, seed};
  cudaError_t err;
  switch (chain_rows(b, v, h)) {
    case 16: err = launch_chain<16>(c, s); break;
    case 8: err = launch_chain<8>(c, s); break;
    case 4: err = launch_chain<4>(c, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  dim3 grid((h + ST - 1) / ST, (v + ST - 1) / ST);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  stats_kernel<<<grid, NT, 0, s>>>(v0, vp, h0p, hp, mask, err_row, dw, dvb, dhb, stats, b, v, h);
  return (int)cudaGetLastError();
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
