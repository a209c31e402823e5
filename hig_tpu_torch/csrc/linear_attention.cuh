// Device code shared by the fused-block (B1), projected-attention (B2) and
// efficient-attention (B3) kernels: a shared-memory-tiled float32 FMA GEMM
// with a LayerNorm / AdaLN prologue and a bias / residual epilogue, and the
// per-(sequence, head) linear-attention core.
//
// Layouts: activations are row-major (rows = N sequences x T tokens,
// columns = features); weights are torch Linear (out, in) row-major; heads
// are 64-wide column slices. The core reads q, k and v through a base
// pointer and a row stride each: B1 and B2 pass the column blocks of their
// (N*T, 3*D) q | k | v buffer (stride 3*D), B3 passes three (N, T, D)
// tensors (stride D).
//
// Assumptions, checked by the Python wrappers: K % 16 == 0, D % 64 == 0,
// head dim 64, every pointer 16-byte aligned, float32 throughout.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "common.cuh"

namespace hig {

constexpr int BM = 64;             // GEMM rows per block
constexpr int BN = 64;             // GEMM columns per block
constexpr int BK = 16;             // GEMM depth per shared-memory stage
constexpr int GEMM_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int HD = 64;             // head dim
constexpr int CORE_THREADS = 256;
constexpr int TC = 32;             // key rows per chunk in the core
constexpr float LN_EPS = 1e-6f;
constexpr float MASK_BIAS = -1000000.0f;

// QKV_PLAIN: q/k/v projections of already-normalized sources (B2).
// QKV_LN:    LayerNorm prologue, then the q/k/v projections (B1 stage a).
// OUT_STYL:  LayerNorm + AdaLN (1+scale, shift) + SiLU prologue, Wo
//            projection, bias + residual epilogue (B1 stage c).
enum GemmMode { QKV_PLAIN = 0, QKV_LN = 1, OUT_STYL = 2 };

struct GemmArgs {
  const float* a0;     // (M, K) source of output segment 0 (queries / input)
  const float* a1;     // (M, K) source of segments 1, 2 (keys, values)
  const float* w0;     // (D, K) weight of segment 0
  const float* w1;
  const float* w2;
  const float* b0;     // (D,) bias of segment 0
  const float* b1;
  const float* b2;
  const float* ln_g;   // (K,) LayerNorm weight      (QKV_LN, OUT_STYL)
  const float* ln_b;   // (K,) LayerNorm bias
  const float* scale;  // (M / T, K) AdaLN scale      (OUT_STYL)
  const float* shift;  // (M / T, K) AdaLN shift
  const float* resid;  // (M, D) residual             (OUT_STYL)
  float* out;          // (M, ldo)
  int M, K, D, T, ldo;
};

// grid (ldo / BN, ceil(M / BM)); a column block never straddles two
// segments because D % BN == 0.
template <int MODE>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(const GemmArgs p) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN + 4];
  __shared__ float row_mu[BM];
  __shared__ float row_rs[BM];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int seg = col0 / p.D;
  const int wrow0 = col0 - seg * p.D;
  const float* A = seg == 0 ? p.a0 : p.a1;
  const float* W = seg == 0 ? p.w0 : (seg == 1 ? p.w1 : p.w2);
  const float* bias = seg == 0 ? p.b0 : (seg == 1 ? p.b1 : p.b2);

  if (MODE != QKV_PLAIN) {
    // LayerNorm statistics of this block's rows: one warp per row, two
    // passes (mean, then centred variance) as the plain LayerNorm does.
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < BM; r += GEMM_THREADS / 32) {
      const int row = row0 + r;
      float mu = 0.f, rs = 0.f;
      if (row < p.M) {
        const float* xr = A + (size_t)row * p.K;
        float s = 0.f;
        for (int k = lane; k < p.K; k += 32) s += xr[k];
        mu = warp_sum(s) / p.K;
        float v = 0.f;
        for (int k = lane; k < p.K; k += 32) {
          const float d = xr[k] - mu;
          v = fmaf(d, d, v);
        }
        rs = rsqrtf(warp_sum(v) / p.K + LN_EPS);
      }
      if (lane == 0) {
        row_mu[r] = mu;
        row_rs[r] = rs;
      }
    }
    __syncthreads();
  }

  const int ty = tid >> 4, tx = tid & 15;
  const int lr = tid >> 2;        // tile row (A) / tile column (B) loaded
  const int lk = (tid & 3) * 4;   // first of the 4 depth indices loaded
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    {
      const int row = row0 + lr;
      float e[4] = {0.f, 0.f, 0.f, 0.f};
      if (row < p.M) {
        const float4 v = *reinterpret_cast<const float4*>(A + (size_t)row * p.K + k0 + lk);
        e[0] = v.x; e[1] = v.y; e[2] = v.z; e[3] = v.w;
        if (MODE != QKV_PLAIN) {
          const float mu = row_mu[lr], rs = row_rs[lr];
          const int n = row / p.T;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = k0 + lk + j;
            float a = (e[j] - mu) * rs * p.ln_g[k] + p.ln_b[k];
            if (MODE == OUT_STYL) {
              a = a * (1.f + p.scale[(size_t)n * p.K + k]) + p.shift[(size_t)n * p.K + k];
              a = a / (1.f + expf(-a));
            }
            e[j] = a;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) As[lk + j][lr] = e[j];
    }
    {
      const float4 w = *reinterpret_cast<const float4*>(W + (size_t)(wrow0 + lr) * p.K + k0 + lk);
      Bs[lk + 0][lr] = w.x;
      Bs[lk + 1][lr] = w.y;
      Bs[lk + 2][lr] = w.z;
      Bs[lk + 3][lr] = w.w;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= p.M) continue;
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[j] = acc[i][j] + bias[wrow0 + tx * 4 + j];
      if (MODE == OUT_STYL) o[j] += p.resid[(size_t)row * p.D + col0 + tx * 4 + j];
    }
    *reinterpret_cast<float4*>(p.out + (size_t)row * p.ldo + col0 + tx * 4) =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

// One block per (head, sequence): grid (H, N).
//   k += (1 - mask) * -1e6;  v *= mask              (the keys' mask)
//   state[d][l] = sum_t softmax_t(k)[t][d] * v[t][l]
//   y[t] = softmax_d(q[t]) . state
// q has Tq rows per sequence at row stride ldq; k and v have Tk rows at
// row stride ldkv; the mask is (N, Tk); y is (N, Tq, D). k, v and the mask
// come from sequence n ^ 1 when `interaction` is set (the other actor of
// the pair in the (B, 2) layout), else from n.
__global__ void __launch_bounds__(CORE_THREADS) linear_attention_core(
    const float* __restrict__ qp, const float* __restrict__ kp,
    const float* __restrict__ vp, const float* __restrict__ mask,
    float* __restrict__ y, int Tq, int Tk, int D, int ldq, int ldkv, int interaction) {
  __shared__ float e_s[TC][HD];
  __shared__ float v_s[TC][HD];
  __shared__ float state[HD][HD];
  __shared__ float red[CORE_THREADS / HD][HD];
  __shared__ float colmax[HD];
  __shared__ float qs[CORE_THREADS / 32][HD];

  const int h = blockIdx.x, n = blockIdx.y;
  const int src = interaction ? (n ^ 1) : n;
  const float* q = qp + (size_t)n * Tq * ldq + h * HD;
  const float* k = kp + (size_t)src * Tk * ldkv + h * HD;
  const float* v = vp + (size_t)src * Tk * ldkv + h * HD;
  const float* m = mask + (size_t)src * Tk;
  const int tid = threadIdx.x;

  // pass 1: column max of the masked keys over time
  {
    const int d = tid & (HD - 1), g = tid / HD;
    float mx = -INFINITY;
    for (int t = g; t < Tk; t += CORE_THREADS / HD)
      mx = fmaxf(mx, k[(size_t)t * ldkv + d] + (1.f - m[t]) * MASK_BIAS);
    red[g][d] = mx;
    __syncthreads();
    if (tid < HD) {
      float r = red[0][tid];
      for (int i = 1; i < CORE_THREADS / HD; ++i) r = fmaxf(r, red[i][tid]);
      colmax[tid] = r;
    }
    __syncthreads();
  }

  // pass 2: stream T in chunks, accumulate exp(k - max)^T v and the
  // column sums; each thread owns 16 state entries of one row d.
  const int sd = tid >> 2, sl0 = (tid & 3) * 16;
  float acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0.f;
  float z = 0.f;
  for (int t0 = 0; t0 < Tk; t0 += TC) {
    for (int i = tid; i < TC * HD; i += CORE_THREADS) {
      const int r = i / HD, c = i & (HD - 1), t = t0 + r;
      float ev = 0.f, vv = 0.f;
      if (t < Tk) {
        const float mt = m[t];
        ev = expf(k[(size_t)t * ldkv + c] + (1.f - mt) * MASK_BIAS - colmax[c]);
        vv = v[(size_t)t * ldkv + c] * mt;
      }
      e_s[r][c] = ev;
      v_s[r][c] = vv;
    }
    __syncthreads();
    for (int r = 0; r < TC; ++r) {
      const float ev = e_s[r][sd];
      z += ev;
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] = fmaf(ev, v_s[r][sl0 + j], acc[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) state[sd][sl0 + j] = acc[j] / z;
  __syncthreads();

  // pass 3: one warp per query row; feature softmax, then q . state
  const int warp = tid >> 5, lane = tid & 31;
  for (int t = warp; t < Tq; t += CORE_THREADS / 32) {
    const float* qr = q + (size_t)t * ldq;
    const float a0 = qr[lane], a1 = qr[lane + 32];
    const float mx = warp_max(fmaxf(a0, a1));
    const float e0 = expf(a0 - mx), e1 = expf(a1 - mx);
    const float s = warp_sum(e0 + e1);
    qs[warp][lane] = e0 / s;
    qs[warp][lane + 32] = e1 / s;
    __syncwarp();
    float y0 = 0.f, y1 = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float w = qs[warp][d];
      y0 = fmaf(w, state[d][lane], y0);
      y1 = fmaf(w, state[d][lane + 32], y1);
    }
    float* yr = y + ((size_t)n * Tq + t) * D + h * HD;
    yr[lane] = y0;
    yr[lane + 32] = y1;
    __syncwarp();
  }
}

inline void launch_gemm(int mode, const GemmArgs& p, int ncols, cudaStream_t stream) {
  const dim3 grid(ncols / BN, (p.M + BM - 1) / BM);
  if (mode == QKV_PLAIN)
    gemm_kernel<QKV_PLAIN><<<grid, GEMM_THREADS, 0, stream>>>(p);
  else if (mode == QKV_LN)
    gemm_kernel<QKV_LN><<<grid, GEMM_THREADS, 0, stream>>>(p);
  else
    gemm_kernel<OUT_STYL><<<grid, GEMM_THREADS, 0, stream>>>(p);
}

inline void launch_core(const float* q, const float* k, const float* v, const float* mask,
                        float* y, int N, int Tq, int Tk, int D, int ldq, int ldkv,
                        int interaction, cudaStream_t stream) {
  const dim3 grid(D / HD, N);
  linear_attention_core<<<grid, CORE_THREADS, 0, stream>>>(q, k, v, mask, y, Tq, Tk, D, ldq,
                                                           ldkv, interaction);
}

// The core over a (N*T, 3*D) q | k | v buffer, as B1 and B2 produce it.
inline void launch_core_qkv(const float* qkv, const float* mask, float* y, int N, int T,
                            int D, int interaction, cudaStream_t stream) {
  launch_core(qkv, qkv + D, qkv + 2 * D, mask, y, N, T, T, D, 3 * D, 3 * D, interaction,
              stream);
}

}  // namespace hig
