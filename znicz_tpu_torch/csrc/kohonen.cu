// Fused Kohonen batch-SOM statistics for Hopper (sm_90a).
//
// Replaces the pl.pallas_call of znicz_tpu/ops/pallas/kohonen.py:
//   _accumulate / _accum_kernel (:93, kernel at :36)
// For x [B, F], the map w [M, F], the row mask [B], the pairwise squared
// grid distances d2m [M, M] and 2 sigma^2 (a host float):
//   win_b  = argmax_j (x_b . w_j - |w_j|^2 / 2)        (first index on ties)
//   h_bj   = exp(-d2m[win_b, j] / (2 sigma^2)) * mask_b
//   num    = h^T x  [M, F]          den = sum_b h_b  [M]
// The weight update w + lr (num / den - w) runs outside, in PyTorch.
//
// What bounds it on an H100: at the model's shape (B 100, M 64, F 784) a
// step is ~20 MFLOP, below a launch's fixed cost, so launch latency is its
// time; at B 4096, M 1024, F 784 it is ~13 GFLOP (4 B M F flops: the
// scores and num) against ~17 MB of inputs, operations by far.  Design,
// simple first, in two launches, with no atomics so the sums do not depend
// on scheduling and a step's update is the same bits every run:
//   1. winners_kernel: a block takes 32 batch rows and streams the map
//      through shared memory in 64-unit x 32-feature tiles; each thread
//      keeps a 2 x 4 register tile of scores, the tile's |w|^2 is summed
//      from the same shared tile, and a running (best, index) per row is
//      reduced across the 16 threads of a row at the end.  It writes
//      win [B] (int32).
//   2. accum_kernel: a block owns a [32 units x 64 features] tile of num
//      (and den for its units) and loops over the whole batch in a fixed
//      order, 32 rows at a time: h is rebuilt from win and d2m into shared
//      memory next to the x tile, each thread keeps a 2 x 4 register tile.
// f32 FMAs throughout (no tensor cores, no TF32); a ragged batch, map or
// feature tile is masked by index, so nothing is padded or copied.  M has
// no limit beyond memory.
//
// Each C entry returns cudaGetLastError() after its launches; the Python
// wrapper raises on a non-zero code.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int NT = 256;  // threads a block: 16 x 16

// winners_kernel tiles
constexpr int WR = 32;  // batch rows a block (2 a thread)
constexpr int WU = 64;  // map units a tile (4 a thread)
constexpr int WK = 32;  // features a chunk

// accum_kernel tiles
constexpr int AU = 32;  // map units a block (2 a thread)
constexpr int AF = 64;  // features a block (4 a thread)
constexpr int AB = 32;  // batch rows a chunk

__global__ void __launch_bounds__(NT)
    winners_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   int* __restrict__ win, int b, int m, int f) {
  __shared__ float xs[WK][WR + 1];  // x chunk, transposed
  __shared__ float ws[WK][WU + 1];  // w chunk, transposed
  __shared__ float half_sq[WU];     // |w_j|^2 / 2 of the tile
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * WR;
  float best[2] = {-INFINITY, -INFINITY};
  int best_i[2] = {INT_MAX, INT_MAX};
  for (int u0 = 0; u0 < m; u0 += WU) {
    float acc[2][4] = {};
    float sq = 0.f;  // this thread's share of |w_u|^2, u = tid / 4
    for (int k0 = 0; k0 < f; k0 += WK) {
      for (int e = tid; e < WR * WK; e += NT) {
        const int r = e / WK, k = e % WK, gr = r0 + r, gk = k0 + k;
        xs[k][r] = (gr < b && gk < f) ? x[(size_t)gr * f + gk] : 0.f;
      }
      for (int e = tid; e < WU * WK; e += NT) {
        const int u = e / WK, k = e % WK, gu = u0 + u, gk = k0 + k;
        ws[k][u] = (gu < m && gk < f) ? w[(size_t)gu * f + gk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = tid % 4; k < WK; k += 4) {
        const float v = ws[k][tid / 4];
        sq = fmaf(v, v, sq);
      }
#pragma unroll 8
      for (int k = 0; k < WK; ++k) {
        const float a0 = xs[k][ty], a1 = xs[k][ty + 16];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float bv = ws[k][tx + 16 * j];
          acc[0][j] = fmaf(a0, bv, acc[0][j]);
          acc[1][j] = fmaf(a1, bv, acc[1][j]);
        }
      }
      __syncthreads();
    }
    // the four partial sums of one unit sit in neighbouring lanes
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    if (tid % 4 == 0) half_sq[tid / 4] = 0.5f * sq;
    __syncthreads();
    // units in increasing order: a strict > keeps the first of equal scores
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int u = u0 + tx + 16 * j;
      if (u < m) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float s = acc[i][j] - half_sq[tx + 16 * j];
          if (s > best[i]) {
            best[i] = s;
            best_i[i] = u;
          }
        }
      }
    }
    __syncthreads();  // half_sq is rewritten by the next tile
  }
  // argmax across the 16 threads of a row (one half-warp), lower index on ties
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[i], off, 16);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i[i], off, 16);
      if (ov > best[i] || (ov == best[i] && oi < best_i[i])) {
        best[i] = ov;
        best_i[i] = oi;
      }
    }
    const int r = r0 + ty + 16 * i;
    // a row whose scores are all -inf or NaN keeps unit 0, a valid index
    if (tx == 0 && r < b) win[r] = best_i[i] == INT_MAX ? 0 : best_i[i];
  }
}

__global__ void __launch_bounds__(NT)
    accum_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                 const int* __restrict__ win, const float* __restrict__ d2m,
                 float* __restrict__ num, float* __restrict__ den, int b, int m, int f,
                 float two_sigma_sq) {
  __shared__ float hs[AB][AU + 1];  // h chunk [rows][units]
  __shared__ float xs[AB][AF];      // x chunk [rows][features]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int f0 = blockIdx.x * AF, u0 = blockIdx.y * AU;
  float acc[2][4] = {};
  float dacc[2] = {0.f, 0.f};
  for (int b0 = 0; b0 < b; b0 += AB) {
    for (int e = tid; e < AB * AU; e += NT) {
      const int r = e / AU, u = e % AU, gr = b0 + r, gu = u0 + u;
      float hv = 0.f;
      if (gr < b && gu < m) {
        hv = expf(-d2m[(size_t)win[gr] * m + gu] / two_sigma_sq) * mask[gr];
      }
      hs[r][u] = hv;
    }
    for (int e = tid; e < AB * AF; e += NT) {
      const int r = e / AF, c = e % AF, gr = b0 + r, gc = f0 + c;
      xs[r][c] = (gr < b && gc < f) ? x[(size_t)gr * f + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < AB; ++r) {
      const float h0 = hs[r][ty], h1 = hs[r][ty + 16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xv = xs[r][tx + 16 * j];
        acc[0][j] = fmaf(h0, xv, acc[0][j]);
        acc[1][j] = fmaf(h1, xv, acc[1][j]);
      }
      dacc[0] += h0;
      dacc[1] += h1;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int u = u0 + ty + 16 * i;
    if (u >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = f0 + tx + 16 * j;
      if (c < f) num[(size_t)u * f + c] = acc[i][j];
    }
    if (blockIdx.x == 0 && tx == 0) den[u] = dacc[i];
  }
}

}  // namespace

extern "C" {

// win: int32 [B] scratch the wrapper allocates (it holds the winners after
// the call); num [M, F] and den [M] are written whole.  B, M, F >= 1.
int znicz_kohonen_accumulate(const float* x, const float* w, const float* mask,
                             const float* d2m, int* win, float* num, float* den, int b,
                             int m, int f, float two_sigma_sq, void* stream) {
  if (b < 1 || m < 1 || f < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  winners_kernel<<<(b + WR - 1) / WR, NT, 0, s>>>(x, w, win, b, m, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((f + AF - 1) / AF, (m + AU - 1) / AU);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  accum_kernel<<<grid, NT, 0, s>>>(x, mask, win, d2m, num, den, b, m, f, two_sigma_sq);
  return (int)cudaGetLastError();
}

const char* znicz_kohonen_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
