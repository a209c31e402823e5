// Device code shared by the fused-block (B1), projected-attention (B2) and
// efficient-attention (B3) kernels, which replace the Pallas TPU kernels
// hig_tpu/ops/fused_block.py::_block_kernel, pallas_attention.py::_proj_kernel
// and pallas_attention.py::_kernel: a row LayerNorm pass, a 3xTF32
// tensor-core GEMM with a bias or bias + residual epilogue, and the
// per-(sequence, head) linear-attention core.
//
// Numerics: every product runs on the tensor cores as 3xTF32 (common.cuh):
// each float32 operand is split into a TF32 high part cvt.rna(x) and a TF32
// low part cvt.rna(x - hi), and a * b is summed as lo*hi + hi*lo + hi*hi in
// float32 accumulators, which keeps float32-level error. mma.sync m16n8k8 is
// used rather than wgmma: wgmma takes TF32 B (and a shared-memory A) only
// from shared memory in its own swizzled layout, so 3xTF32 would need hi and
// lo copies of both tiles written back to shared memory, while mma.sync
// splits each fragment in registers right after it is loaded. On an H100
// SXM (700 W) two wgmma forms of the GEMM were slower per B1 call: A split
// in registers with W split once per tile into shared memory (0.125 ms),
// and both split into double-buffered shared-memory planes (0.154 ms),
// against 0.115 ms for this one.
//
// Bound on the H100 at the serving shape (M = N*T = 1456 rows, D = 512): the
// QKV GEMM is 2.29 GFLOP and the Wo GEMM 0.76 GFLOP against a few MB, so
// both are bound by operations: 3xTF32 costs three TF32 products, 165
// TFLOP/s of float32-accurate products against 67 TFLOP/s for FFMA.
//
// GEMM. C (M, ldo) = A (M, K) W (Ncols, K)^T: activations and torch Linear
// weights (out, in) are both row-major over K, so neither is transposed.
// Block tile BM x BN x 32, 2 x 2 warps, a 3-stage cp.async ring in dynamic
// shared memory (row stride 40 floats: the 64-bit fragment loads are free
// of bank conflicts); each warp splits the fragments it loads and issues
// the three products of all its tiles term by term, so consecutive mma
// instructions go to different accumulators. Within each 8-deep step the k
// index is permuted (logical k c and c + 4 are columns 2c and 2c + 1)
// identically for A and W, so each fragment pair is one 64-bit load. Tiles
// at M = 1456 on 132 SMs: the QKV GEMM (Ncols = 1536) takes 96 x 64 tiles,
// 16 x 24 = 384 blocks of 76.8 KB, 2 resident per SM (1.45 waves of 264);
// the Wo GEMM (Ncols = 512) 32 x 64 tiles, 46 x 8 = 368 blocks of 46 KB, 4
// resident per SM (one wave of 528). Larger warp tiles, 3 x 2 or 4 x 2
// warps, 2 stages or 16-deep stages measured slower on the H100.
//
// Core. One block of 4 warps per (head, sequence, 32 query rows): grid
// (H, N, ceil(Tq / 32)), 384 blocks at the serving shape. Each block
// builds the head's 64 x 64 state softmax_time(k)^T v on the tensor cores
// (every query block of a head recomputes it from L2: 0.75 MFLOP) while
// the next 32-key chunk of k and v arrives by cp.async (two stages), then
// multiplies its 32 softmaxed query rows by the state.
//
// Layouts: activations are row-major (rows = N sequences x T tokens,
// columns = features); heads are HD-wide column slices. The core reads q, k
// and v through a base pointer and a row stride each: B1 and B2 pass the
// column blocks of their (N*T, 3*D) q | k | v buffer (stride 3*D), B3
// passes three (N, T, D) tensors (stride D).
//
// bfloat16 forms. The row pass reads float32 or bfloat16 rows and writes
// either (statistics in float32 always, as the Pallas kernel keeps them);
// B1-bf16 takes it beside its own wgmma kernels (fused_block.cu). B2-bf16
// and B2-bf16a (projected_attention.cu) and B3-bf16 (efficient_attention.cu)
// are kernels of their own.
//
// Head width. The core takes HD (common.cuh, 64 or 128) from its library:
// HD / 16 warps, each building 16 rows of the HD x HD state over all HD
// columns, and a block's query rows split over them; at HD = 128 its
// shared memory (CORE_BUF, 86 KB) is past the 48 KB of a static array.
// At head widths 16 and 32 a block takes one 64-column tile of HPB packed
// heads (common.cuh): the width-64 core, its feature softmax taken per
// head's lanes, its state zeroed off the block diagonal.
//
// Assumptions, checked by the Python wrappers: D % HD == 0 (B1: D % 128 ==
// 0 and D <= 1024 for the row pass), head dim HD, every pointer 16-byte
// aligned, every row stride a multiple of 4 floats, float32 throughout
// except the bfloat16 forms' activations and weights.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "common.cuh"

namespace hig {

constexpr int BK = 32;             // GEMM depth per pipeline stage
constexpr int SK = BK + 8;         // shared-memory row stride of a GEMM tile
constexpr int STAGES = 3;          // cp.async ring depth
constexpr int WARPS_M = 2;         // GEMM warps along M
constexpr int WARPS_N = 2;         // GEMM warps along N
constexpr int GEMM_THREADS = 32 * WARPS_M * WARPS_N;
constexpr int NORM_THREADS = 256;  // one warp per row
constexpr int CORE_THREADS = 2 * HD;  // HD / 16 warps: one per 16 state rows
constexpr int CORE_WARPS = CORE_THREADS / 32;
constexpr int CORE_BQ = 32;        // query rows per core block
constexpr int TC = 32;             // key rows per chunk in the core
constexpr int KS = HD + 8;         // row stride of the k, v chunks and the state
constexpr int QS = HD + 4;         // row stride of the softmaxed queries
// The core's dynamic shared memory (floats): two stages of (k chunk, v
// chunk), which the normalized state [HD][KS] and the softmaxed queries
// [CORE_BQ][QS] take over after the key loop.
constexpr int CORE_BUF = 2 * 2 * TC * KS > HD * KS + CORE_BQ * QS ? 2 * 2 * TC * KS
                                                                  : HD * KS + CORE_BQ * QS;
constexpr float LN_EPS = 1e-6f;
constexpr float MASK_BIAS = -1000000.0f;

// BIAS:       out = A W^T + bias                  (the q | k | v projections)
// BIAS_RESID: out = A W^T + bias + resid          (Wo of B1)
enum Epilogue { BIAS = 0, BIAS_RESID = 1 };

struct GemmArgs {
  const float* a0;     // (M, K) source of output segment 0 (queries / input)
  const float* a1;     // (M, K) source of segments 1, 2 (keys, values)
  const float* w0;     // (D, K) weight of segment 0
  const float* w1;
  const float* w2;
  const float* b0;     // (D,) bias of segment 0
  const float* b1;
  const float* b2;
  const float* resid;  // (M, D) residual             (BIAS_RESID)
  float* out;          // (M, ldo)
  int M, K, D, ldo;
};

// LayerNorm of each row of `in` (M, D) with weight g and bias b into `out`;
// with STYL also out = SiLU(out * (1 + scale[n]) + shift[n]), n = row / T.
// One warp per row, read once into registers (D <= NORM_MAX_D, D % 128 ==
// 0), statistics in two passes (mean, then centred variance) as the plain
// LayerNorm takes them. `in` may equal `out`.
// TI, TO: the element types of `in` and `out`; TP: of g, b, scale, shift.
constexpr int NORM_MAX_D = 1024;
template <bool STYL, typename TI = float, typename TO = float, typename TP = float>
__global__ void __launch_bounds__(NORM_THREADS) row_norm_kernel(
    const TI* in, TO* out, const TP* __restrict__ g, const TP* __restrict__ b,
    const TP* __restrict__ scale, const TP* __restrict__ shift, int M, int D, int T) {
  constexpr int VPL = NORM_MAX_D / 128;  // float4s per lane at most
  const int row = blockIdx.x * (NORM_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const int nv = D / 128;
  const TI* xr = in + (size_t)row * D;
  float4 x[VPL];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (i < nv) {
      x[i] = load4(xr + 4 * (lane + 32 * i));
      s += (x[i].x + x[i].y) + (x[i].z + x[i].w);
    }
  }
  const float mu = warp_sum(s) / D;
  float var = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (i < nv) {
      var = fmaf(x[i].x - mu, x[i].x - mu, var);
      var = fmaf(x[i].y - mu, x[i].y - mu, var);
      var = fmaf(x[i].z - mu, x[i].z - mu, var);
      var = fmaf(x[i].w - mu, x[i].w - mu, var);
    }
  }
  const float rs = rsqrtf(warp_sum(var) / D + LN_EPS);
  const size_t nD = (size_t)(row / T) * D;
  TO* orow = out + (size_t)row * D;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    if (i < nv) {
      const int c4 = lane + 32 * i;
      const float4 gg = load4(g + 4 * c4);
      const float4 bb = load4(b + 4 * c4);
      float e[4] = {(x[i].x - mu) * rs * gg.x + bb.x, (x[i].y - mu) * rs * gg.y + bb.y,
                    (x[i].z - mu) * rs * gg.z + bb.z, (x[i].w - mu) * rs * gg.w + bb.w};
      if (STYL) {
        const float4 sc = load4(scale + nD + 4 * c4);
        const float4 sh = load4(shift + nD + 4 * c4);
        const float scv[4] = {sc.x, sc.y, sc.z, sc.w}, shv[4] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float a = e[j] * (1.f + scv[j]) + shv[j];
          e[j] = a / (1.f + expf(-a));
        }
      }
      store4(orow + 4 * c4, make_float4(e[0], e[1], e[2], e[3]));
    }
  }
}

// grid (ldo / BN, ceil(M / BM)); a column block never straddles two output
// segments because D % BN == 0. Dynamic shared memory: gemm_smem(BM, BN).
template <int BM, int BN, int EPI>
__global__ void __launch_bounds__(GEMM_THREADS) gemm_kernel(const GemmArgs p) {
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // warp tile
  constexpr int MT = WM / 16, NT = WN / 8;  // m16 and n8 tiles per warp
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                          // [STAGES][BM][SK]
  float* Bs = smem + STAGES * BM * SK;       // [STAGES][BN][SK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int seg = col0 / p.D;
  const int wrow0 = col0 - seg * p.D;
  const float* A = seg == 0 ? p.a0 : p.a1;
  const float* W = seg == 0 ? p.w0 : (seg == 1 ? p.w1 : p.w2);
  const float* bias = seg == 0 ? p.b0 : (seg == 1 ? p.b1 : p.b2);
  const int KT = p.K / BK;

  auto load_stage = [&](int kt, int s) {
    const int k0 = kt * BK;
    float* as = As + s * BM * SK;
    float* bs = Bs + s * BN * SK;
#pragma unroll
    for (int i = tid; i < BM * (BK / 4); i += GEMM_THREADS) {
      const int r = i / (BK / 4), q = (i % (BK / 4)) * 4;
      const int row = row0 + r;
      const bool ok = row < p.M;
      cp_async16(as + r * SK + q, A + (size_t)(ok ? row : 0) * p.K + k0 + q, ok);
    }
#pragma unroll
    for (int i = tid; i < BN * (BK / 4); i += GEMM_THREADS) {
      const int r = i / (BK / 4), q = (i % (BK / 4)) * 4;
      cp_async16(bs + r * SK + q, W + (size_t)(wrow0 + r) * p.K + k0 + q, true);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    if (kt + STAGES - 1 < KT) load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const float* as = As + (kt % STAGES) * BM * SK + (wm * WM + g) * SK + 2 * c;
    const float* bs = Bs + (kt % STAGES) * BN * SK + (wn * WN + g) * SK + 2 * c;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      Split a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float2 r0 = *reinterpret_cast<const float2*>(as + (i * 16) * SK + kk);
        const float2 r8 = *reinterpret_cast<const float2*>(as + (i * 16 + 8) * SK + kk);
        a[i][0] = split_tf32(r0.x);
        a[i][2] = split_tf32(r0.y);
        a[i][1] = split_tf32(r8.x);
        a[i][3] = split_tf32(r8.y);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 w = *reinterpret_cast<const float2*>(bs + (j * 8) * SK + kk);
        b[j][0] = split_tf32(w.x);
        b[j][1] = split_tf32(w.y);
      }
      mma_3xtf32<MT, NT>(&acc[0][0][0], &a[0][0], &b[0][0]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + wm * WM + i * 16 + g + 8 * half;
      if (row >= p.M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = wn * WN + j * 8 + 2 * c;  // within the block
        float o0 = acc[i][j][2 * half] + bias[wrow0 + col];
        float o1 = acc[i][j][2 * half + 1] + bias[wrow0 + col + 1];
        if (EPI == BIAS_RESID) {
          const float2 r = *reinterpret_cast<const float2*>(
              p.resid + (size_t)row * p.D + col0 + col);
          o0 += r.x;
          o1 += r.y;
        }
        *reinterpret_cast<float2*>(p.out + (size_t)row * p.ldo + col0 + col) =
            make_float2(o0, o1);
      }
    }
  }
}

// Max and sum over the lanes of one packed head: the HW lanes (HW < 64)
// around this one.
__device__ __forceinline__ float seg_max(float v) {
#pragma unroll
  for (int o = HW / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float seg_sum(float v) {
#pragma unroll
  for (int o = HW / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block per (head, sequence, CORE_BQ query rows): grid (H, N, ceil(Tq / CORE_BQ)).
// (At HW < 64 a "head" of the grid is one 64-column tile of HPB packed heads.)
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
  // Two stages of (k chunk, v chunk); after the key loop the same memory
  // holds the normalized state [HD][KS] and the softmaxed queries [CORE_BQ][QS].
  extern __shared__ __align__(16) float buf[];  // [CORE_BUF]
  __shared__ float red[2][HD];
  __shared__ float colmax[HD];
  __shared__ float zinv[HD];  // 1 / column sums

  const int h = blockIdx.x, n = blockIdx.y, t0q = blockIdx.z * CORE_BQ;
  const int src = interaction ? (n ^ 1) : n;
  const float* q = qp + (size_t)n * Tq * ldq + h * HD;
  const float* k = kp + (size_t)src * Tk * ldkv + h * HD;
  const float* v = vp + (size_t)src * Tk * ldkv + h * HD;
  const float* m = mask + (size_t)src * Tk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int nchunks = (Tk + TC - 1) / TC;

  auto load_chunk = [&](int chunk, int s) {
    float* ks = buf + s * 2 * TC * KS;
    float* vs = ks + TC * KS;
    for (int i = tid; i < TC * (HD / 4); i += CORE_THREADS) {
      const int r = i / (HD / 4), col = (i % (HD / 4)) * 4, t = chunk * TC + r;
      const bool ok = t < Tk;
      const size_t off = (size_t)(ok ? t : 0) * ldkv + col;
      cp_async16(ks + r * KS + col, k + off, ok);
      cp_async16(vs + r * KS + col, v + off, ok);
    }
  };
  load_chunk(0, 0);
  cp_async_commit();

  // This warp's query rows for pass 3, loaded now so that their latency
  // hides behind the key passes; lane l holds columns l + 32 i.
  constexpr int QROWS = CORE_BQ / CORE_WARPS, QCOLS = HD / 32;
  float qv[QROWS][QCOLS];
#pragma unroll
  for (int i = 0; i < QROWS; ++i) {
    const int t = t0q + warp + i * CORE_WARPS;
    const float* qr = q + (size_t)(t < Tq ? t : 0) * ldq;
#pragma unroll
    for (int j = 0; j < QCOLS; ++j) qv[i][j] = qr[lane + 32 * j];
  }

  // pass 1: column max of the masked keys over time
  const int d = tid & (HD - 1), r0 = tid / HD;  // this thread's column and first row
  {
    float mx = -INFINITY;
#pragma unroll 16
    for (int t = r0; t < Tk; t += CORE_THREADS / HD)
      mx = fmaxf(mx, k[(size_t)t * ldkv + d] + (1.f - m[t]) * MASK_BIAS);
    red[r0][d] = mx;
    __syncthreads();
    if (tid < HD) colmax[tid] = fmaxf(red[0][tid], red[1][tid]);
  }

  // pass 2: state = E^T V over 32-key chunks on the tensor cores, E =
  // exp(k - colmax) formed in place in shared memory; warp w owns state
  // rows 16w .. 16w + 15, all HD columns (HD / 8 n8 tiles).
  constexpr int NT = HD / 8;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float z = 0.f;
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    const int s = chunk & 1;
    if (chunk + 1 < nchunks) load_chunk(chunk + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // chunk `chunk` is in; colmax is visible
    float* ks = buf + s * 2 * TC * KS;
    float* vs = ks + TC * KS;
    const float cm = colmax[d];
    for (int r = r0; r < TC; r += CORE_THREADS / HD) {
      const int t = chunk * TC + r;
      float ev = 0.f, vv = 0.f;
      if (t < Tk) {
        const float mt = m[t];
        ev = expf(ks[r * KS + d] + (1.f - mt) * MASK_BIAS - cm);
        vv = vs[r * KS + d] * mt;
      }
      ks[r * KS + d] = ev;
      vs[r * KS + d] = vv;
      z += ev;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TC; kk += 8) {
      const float* e0 = ks + (kk + c) * KS + warp * 16 + g;
      Split a[4] = {split_tf32(e0[0]), split_tf32(e0[8]), split_tf32(e0[4 * KS]),
                    split_tf32(e0[4 * KS + 8])};
      Split b[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* v0 = vs + (kk + c) * KS + j * 8 + g;
        b[j][0] = split_tf32(v0[0]);
        b[j][1] = split_tf32(v0[4 * KS]);
      }
      mma_3xtf32<1, NT>(&acc[0][0], a, &b[0][0]);
    }
    __syncthreads();  // done reading stage s before it is refilled
  }

  red[r0][d] = z;
  __syncthreads();
  if (tid < HD) zinv[tid] = 1.f / (red[0][tid] + red[1][tid]);
  __syncthreads();
  float* state = buf;             // [HD][KS]
  float* qs = buf + HD * KS;      // [CORE_BQ][QS]
  {
    const int dr = warp * 16 + g;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int l = j * 8 + 2 * c;
      // packed heads (HW < 64): zero off the block diagonal
      const float z0 = same_head(dr, l) ? zinv[dr] : 0.f;
      const float z1 = same_head(dr + 8, l) ? zinv[dr + 8] : 0.f;
      *reinterpret_cast<float2*>(state + dr * KS + l) =
          make_float2(acc[j][0] * z0, acc[j][1] * z0);
      *reinterpret_cast<float2*>(state + (dr + 8) * KS + l) =
          make_float2(acc[j][2] * z1, acc[j][3] * z1);
    }
  }
  // pass 3: feature softmax of this block's query rows (one warp per row),
  // then y = qs . state; warp w takes rows 16 (w & 1) .. + 15 and output
  // columns 32 (w >> 1) .. + 31.
#pragma unroll
  for (int i = 0; i < QROWS; ++i) {
    const int r = warp + i * CORE_WARPS, t = t0q + r;
    float e[QCOLS];
#pragma unroll
    for (int j = 0; j < QCOLS; ++j) e[j] = 0.f;
    if (t < Tq) {
      if constexpr (HPB == 1) {
        float mx = qv[i][0];
#pragma unroll
        for (int j = 1; j < QCOLS; ++j) mx = fmaxf(mx, qv[i][j]);
        mx = warp_max(mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < QCOLS; ++j) {
          e[j] = expf(qv[i][j] - mx);
          sum = j == 0 ? e[0] : sum + e[j];
        }
        const float inv = 1.f / warp_sum(sum);
#pragma unroll
        for (int j = 0; j < QCOLS; ++j) e[j] *= inv;
      } else {
        // packed heads: column lane + 32 j is in head (lane + 32 j) / HW, so
        // each head is the HW lanes of one j (HW 32) or of a half-warp (16)
#pragma unroll
        for (int j = 0; j < QCOLS; ++j) {
          const float mx = seg_max(qv[i][j]);
          e[j] = expf(qv[i][j] - mx);
          e[j] *= 1.f / seg_sum(e[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < QCOLS; ++j) qs[r * QS + lane + 32 * j] = e[j];
  }
  __syncthreads();
  const int mt = warp & 1, nt0 = (warp >> 1) * 4;
  float out[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 8) {
    const float* a0 = qs + (mt * 16 + g) * QS + kk + c;
    Split a[4] = {split_tf32(a0[0]), split_tf32(a0[8 * QS]), split_tf32(a0[4]),
                  split_tf32(a0[8 * QS + 4])};
    Split b[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* s0 = state + (kk + c) * KS + (nt0 + j) * 8 + g;
      b[j][0] = split_tf32(s0[0]);
      b[j][1] = split_tf32(s0[4 * KS]);
    }
    mma_3xtf32<1, 4>(&out[0][0], a, &b[0][0]);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = t0q + mt * 16 + g + 8 * half;
    if (t >= Tq) continue;
    float* yr = y + ((size_t)n * Tq + t) * D + h * HD;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store2(yr + (nt0 + j) * 8 + 2 * c, out[j][2 * half], out[j][2 * half + 1]);
  }
}

constexpr size_t gemm_smem(int bm, int bn) {
  return sizeof(float) * STAGES * (bm + bn) * SK;
}

template <int BM, int BN, int EPI>
cudaError_t launch_gemm_tiles(const GemmArgs& p, int ncols, cudaStream_t stream) {
  // Set on every launch, not once through a static: a static local of an
  // inline function is one object across every library loaded in the
  // process, and each library has its own copy of the kernel.
  constexpr size_t smem = gemm_smem(BM, BN);
  const cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel<BM, BN, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(ncols / BN, (p.M + BM - 1) / BM);
  gemm_kernel<BM, BN, EPI><<<grid, GEMM_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The q | k | v projections: out (M, 3 * D) at ldo = 3 * D.
inline cudaError_t launch_gemm_qkv(const GemmArgs& p, cudaStream_t stream) {
  return launch_gemm_tiles<96, 64, BIAS>(p, 3 * p.D, stream);
}

// One (D, D) projection with the bias and residual: out (M, D).
inline cudaError_t launch_gemm_out(const GemmArgs& p, cudaStream_t stream) {
  return launch_gemm_tiles<32, 64, BIAS_RESID>(p, p.D, stream);
}

template <typename T>
struct NoDeduce {  // keeps a parameter out of template deduction (a nullptr scale)
  using type = T;
};

template <bool STYL, typename TI = float, typename TO = float, typename TP = float>
cudaError_t launch_row_norm(const TI* in, TO* out, const TP* g, const TP* b,
                            const typename NoDeduce<TP>::type* scale,
                            const typename NoDeduce<TP>::type* shift, int M, int D, int T,
                            cudaStream_t stream) {
  constexpr int rows = NORM_THREADS / 32;
  row_norm_kernel<STYL, TI, TO, TP><<<(M + rows - 1) / rows, NORM_THREADS, 0, stream>>>(
      in, out, g, b, scale, shift, M, D, T);
  return cudaGetLastError();
}

inline cudaError_t launch_core(const float* q, const float* k, const float* v, const float* mask,
                               float* y, int N, int Tq, int Tk, int D, int ldq, int ldkv,
                               int interaction, cudaStream_t stream) {
  constexpr int smem = CORE_BUF * (int)sizeof(float);
  const cudaError_t attr = cudaFuncSetAttribute(
      linear_attention_core, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(D / HD, N, (Tq + CORE_BQ - 1) / CORE_BQ);
  linear_attention_core<<<grid, CORE_THREADS, smem, stream>>>(
      q, k, v, mask, y, Tq, Tk, D, ldq, ldkv, interaction);
  return cudaGetLastError();
}

// The core over a (N*T, 3*D) q | k | v buffer, as B1 and B2 produce it.
inline cudaError_t launch_core_qkv(const float* qkv, const float* mask, float* y, int N, int T,
                                   int D, int interaction, cudaStream_t stream) {
  return launch_core(qkv, qkv + D, qkv + 2 * D, mask, y, N, T, T, D, 3 * D, 3 * D, interaction,
                     stream);
}

}  // namespace hig
