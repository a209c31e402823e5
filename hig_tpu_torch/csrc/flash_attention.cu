// B4: quadratic (softmax) attention with an online softmax, forward.
// Replaces hig_tpu/ops/flash_attention.py::_flash_kernel (Pallas TPU).
//
//   s[t][j] = (q[t] / sqrt(64)) . k[j] + (1 - mask[j]) * -1e6
//             + (-1e6 if causal and j > t)
//   out[t]  = softmax_j(s[t]) . v          per (sequence, head)
//
// Layout: the model's (rows, features) layout, read in place. q has Tq rows
// per sequence at row stride ldq, k and v have Tk rows at row stride ldkv,
// out is (N, Tq, ldo); head h is columns h*64 .. h*64+63 of each. So
// self-attention reads the three column blocks of one merged (N*T, 3*D)
// q | k | v product (ldq = ldkv = 3*D) and nothing is transposed or padded.
// With `partner` set, k, v and the (N, Tk) key mask come from sequence
// n ^ 1, the other actor of the pair in the (B, 2) layout, so the
// interaction block needs no flipped copy.
//
// Numerics: q k^T and P v run on the tensor cores in 3xTF32 (common.cuh:
// hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), lo*hi + hi*lo + hi*hi in
// float32 accumulators), which keeps float32-level error. mma.sync m16n8k8
// rather than wgmma: a 16-row tile per warp wastes at most 15 rows of a
// ragged T (wgmma's 64-row tiles would waste 37 of 128 at T = 91), and the
// softmax stays in the accumulator registers, where P becomes the A operand
// of P v without a trip through shared memory.
//
// Design. One block per (sequence, head, up to 128 query rows), one warp per
// 16 query rows: at N = 16, H = 8, T = 91 that is 128 blocks of 6 warps (768
// warps, 5 idle rows). A warp keeps its 16 rows of q (scaled by 1/8, exact)
// split into hi and lo fragments in registers. The block copies the head's
// keys and values into dynamic shared memory once (cp.async, one commit
// group per 32 keys, so the first keys are scored while the rest arrive;
// up to 256 keys at a time, longer key ranges in tiles of 256), and every
// warp streams them in steps of 32 keys with an online softmax in float32
// registers inside the product's fragment layout. Within each 8-deep step
// the depth index is permuted (logical k c and c + 4 are the pair 2c, 2c + 1)
// identically on both operands: q and k fragments are then 64-bit loads, and
// the S accumulator of 8 keys is exactly P's A fragment for P v, with v's
// rows taken in the same order. Row strides (72 floats for k, 68 for v) make
// every fragment load free of bank conflicts. When causal and key 0 is
// unmasked, blocks and warps skip key steps past their last query: those
// keys' weights are exp(-1e6 + ...) = 0 in float32 exactly. Key 0 keeps
// every running max finite, so exp never sees -inf - -inf.
//
// Bound on this card at N = 16, H = 8, T = 91: 4 * N * H * T^2 * 64 = 0.27
// GFLOP (1.6 us in 3xTF32 at 495 / 3 TFLOP/s) against 11.9 MB of q, k, v,
// mask and out (3.6 us at 3.35 TB/s): bytes.
#include <math.h>
#include <stddef.h>

#include "common.cuh"

namespace hig {

constexpr int FA_HD = 64;        // head dim
constexpr int FA_MAX_WARPS = 8;  // 16 query rows each
constexpr int FA_STEP = 32;      // keys per online-softmax step
constexpr int FA_TILE = 256;     // most keys resident in shared memory at once
constexpr int FA_KS = FA_HD + 8; // row stride of k in shared memory
constexpr int FA_VS = FA_HD + 4; // row stride of v
constexpr float FA_SCALE = 0.125f;  // 1 / sqrt(FA_HD), exact in float32
constexpr float FA_MASK_BIAS = -1000000.0f;

constexpr size_t fa_smem(int rows) {
  return sizeof(float) * (size_t)rows * (FA_KS + FA_VS + 1);
}

// Wait until at most n of this thread's cp.async groups are pending.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

__global__ void __launch_bounds__(FA_MAX_WARPS * 32) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ mask, float* __restrict__ out, int H, int Tq, int Tk,
    int ldq, int ldkv, int ldo, int partner, int causal, int tile) {
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                         // [tile][FA_KS]
  float* v_s = k_s + tile * FA_KS;           // [tile][FA_VS]
  float* bias_s = v_s + tile * FA_VS;        // [tile]

  const int n = blockIdx.x / H, h = blockIdx.x % H;
  const int src = partner ? (n ^ 1) : n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int nthreads = blockDim.x;
  const int bq = blockDim.x / 2;  // 16 query rows per warp
  const int tb0 = blockIdx.y * bq;
  const int tw0 = tb0 + warp * 16;  // first query row of this warp
  const int t_lo = tw0 + g, t_hi = tw0 + g + 8;
  const float* kb = k + (size_t)src * Tk * ldkv + h * FA_HD;
  const float* vb = v + (size_t)src * Tk * ldkv + h * FA_HD;
  const float* mb = mask + (size_t)src * Tk;

  // Past the last query, causal keys weigh exactly 0 as long as key 0 is
  // unmasked (the row max is then at least key 0's score).
  const bool skip = causal && mb[0] != 0.f;
  const int kv_end = skip ? min(Tk, min(Tq, tb0 + bq)) : Tk;
  const int warp_end = skip ? min(Tk, tw0 + 16) : Tk;
  const bool warp_rows = tw0 < Tq;

  // q fragments, scaled, split once: qa[kk][*] for depth 8 kk .. 8 kk + 7.
  Split qa[FA_HD / 8][4];
  {
    const float* q0 = q + ((size_t)n * Tq + min(t_lo, Tq - 1)) * ldq + h * FA_HD + 2 * c;
    const float* q1 = q + ((size_t)n * Tq + min(t_hi, Tq - 1)) * ldq + h * FA_HD + 2 * c;
#pragma unroll
    for (int kk = 0; kk < FA_HD / 8; ++kk) {
      const float2 a = *reinterpret_cast<const float2*>(q0 + 8 * kk);
      const float2 b = *reinterpret_cast<const float2*>(q1 + 8 * kk);
      qa[kk][0] = split_tf32(a.x * FA_SCALE);
      qa[kk][2] = split_tf32(a.y * FA_SCALE);
      qa[kk][1] = split_tf32(b.x * FA_SCALE);
      qa[kk][3] = split_tf32(b.y * FA_SCALE);
    }
  }

  float o[FA_HD / 8][4];
#pragma unroll
  for (int j = 0; j < FA_HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  for (int kt0 = 0; kt0 < kv_end; kt0 += tile) {
    const int steps = (min(tile, kv_end - kt0) + FA_STEP - 1) / FA_STEP;
    for (int s = 0; s < steps; ++s) {
      for (int i = tid; i < FA_STEP * (FA_HD / 4); i += nthreads) {
        const int r = s * FA_STEP + i / (FA_HD / 4), col = (i % (FA_HD / 4)) * 4;
        const int key = kt0 + r;
        const bool ok = key < Tk;
        const size_t off = (size_t)(ok ? key : 0) * ldkv + col;
        cp_async16(k_s + r * FA_KS + col, kb + off, ok);
        cp_async16(v_s + r * FA_VS + col, vb + off, ok);
      }
      cp_async_commit();
    }
    for (int r = tid; r < steps * FA_STEP; r += nthreads) {
      const int key = kt0 + r;
      bias_s[r] = key < Tk ? (1.f - mb[key]) * FA_MASK_BIAS : -INFINITY;
    }

    for (int s = 0; s < steps; ++s) {
      cp_async_wait_upto(steps - 1 - s);
      __syncthreads();  // keys of step s (and the bias) are in for every warp
      const int key0 = kt0 + s * FA_STEP;
      if (!warp_rows || key0 >= warp_end) continue;
      const int r0 = s * FA_STEP;

      // S = q k^T for 32 keys: 4 n8 tiles, keys key0 + 8 j + {2c, 2c + 1}.
      float sc[FA_STEP / 8][4];
#pragma unroll
      for (int j = 0; j < FA_STEP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < FA_HD / 8; ++kk) {
        Split b[FA_STEP / 8][2];
#pragma unroll
        for (int j = 0; j < FA_STEP / 8; ++j) {
          const float2 kv = *reinterpret_cast<const float2*>(
              k_s + (r0 + 8 * j + g) * FA_KS + 8 * kk + 2 * c);
          b[j][0] = split_tf32(kv.x);
          b[j][1] = split_tf32(kv.y);
        }
        mma_3xtf32<1, FA_STEP / 8>(&sc[0][0], qa[kk], &b[0][0]);
      }

      // Bias, masks and the online softmax of rows t_lo (e = 0, 1) and
      // t_hi (e = 2, 3); the four lanes of a quad hold one row's 32 keys.
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int j = 0; j < FA_STEP / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + 8 * j + 2 * c + (e & 1);
          const int key = kt0 + r;
          const int t = e < 2 ? t_lo : t_hi;
          float x = sc[j][e] + bias_s[r];
          if (causal && key > t) x += FA_MASK_BIAS;
          sc[j][e] = x;
          if (e < 2) mx_lo = fmaxf(mx_lo, x); else mx_hi = fmaxf(mx_hi, x);
        }
      }
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      const float al_lo = expf(m_lo - mn_lo), al_hi = expf(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      l_lo *= al_lo;
      l_hi *= al_hi;
#pragma unroll
      for (int j = 0; j < FA_STEP / 8; ++j) {
        sc[j][0] = expf(sc[j][0] - mn_lo);
        sc[j][1] = expf(sc[j][1] - mn_lo);
        sc[j][2] = expf(sc[j][2] - mn_hi);
        sc[j][3] = expf(sc[j][3] - mn_hi);
        l_lo += sc[j][0] + sc[j][1];
        l_hi += sc[j][2] + sc[j][3];
      }
#pragma unroll
      for (int j = 0; j < FA_HD / 8; ++j) {
        o[j][0] *= al_lo;
        o[j][1] *= al_lo;
        o[j][2] *= al_hi;
        o[j][3] *= al_hi;
      }

      // O += P v: the S tile of keys 8 j .. 8 j + 7 is P's A fragment for
      // depth step j, with logical k c <-> key 2c and c + 4 <-> key 2c + 1.
#pragma unroll
      for (int j = 0; j < FA_STEP / 8; ++j) {
        const Split a[4] = {split_tf32(sc[j][0]), split_tf32(sc[j][2]),
                            split_tf32(sc[j][1]), split_tf32(sc[j][3])};
        const float* v0 = v_s + (r0 + 8 * j + 2 * c) * FA_VS + g;
        Split b[FA_HD / 8][2];
#pragma unroll
        for (int jn = 0; jn < FA_HD / 8; ++jn) {
          b[jn][0] = split_tf32(v0[8 * jn]);
          b[jn][1] = split_tf32(v0[FA_VS + 8 * jn]);
        }
        mma_3xtf32<1, FA_HD / 8>(&o[0][0], a, &b[0][0]);
      }
    }
    __syncthreads();  // every warp is done with this tile before the next one
  }

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  if (t_lo < Tq) {
    float* orow = out + ((size_t)n * Tq + t_lo) * ldo + h * FA_HD + 2 * c;
#pragma unroll
    for (int j = 0; j < FA_HD / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(o[j][0] * inv_lo, o[j][1] * inv_lo);
  }
  if (t_hi < Tq) {
    float* orow = out + ((size_t)n * Tq + t_hi) * ldo + h * FA_HD + 2 * c;
#pragma unroll
    for (int j = 0; j < FA_HD / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(o[j][2] * inv_hi, o[j][3] * inv_hi);
  }
}

// B4-bf16: the kernel above for bfloat16 q, k, v and out, rounding where
// the Pallas kernel rounds for dt = bfloat16 (hig_tpu/ops/flash_attention.py:
// 53-86): scores and the online softmax in float32 over the Pallas key
// blocks of `bk` keys (min(128, Tk rounded up to 8)); in each block
// p = exp(s - running max) is rounded to bfloat16 for P v. Where p rounds
// depends on the running max, so the key blocks are the Pallas kernel's:
// each warp scores a whole block (up to 128 keys) on mma.sync m16n8k16
// bfloat16 with float32 accumulators: a product of two bfloat16 values is
// exact in float32, so these are the products of the Pallas kernel's
// upcast q and k, summed in float32. It takes the block's row max, rescales
// its running sums, and runs P v on the same instruction, P taken from the
// score registers (an S tile pair of 16 keys is P's A fragment).
// Keys past Tk inside a block score -1e6 (the Pallas kernel's zero
// padding with a zero mask); keys past the block, up to the next multiple
// of 16, score -inf and weigh exactly 0. out = acc / l rounded to bfloat16.
// One block per (sequence, head, up to 128 query rows), one warp per 16
// rows, a Pallas key block in shared memory at a time.
constexpr int FB_BLOCK = 128;         // the Pallas kernel's largest key block
constexpr int FB_RS = FA_HD + 8;      // bfloat16 row stride of k and v in shared memory
constexpr int FB_TILES = FB_BLOCK / 8;  // n8 score tiles of a block

__global__ void __launch_bounds__(FA_MAX_WARPS * 32) flash_attention_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ mask, bf16* __restrict__ out, int H, int Tq, int Tk,
    int ldq, int ldkv, int ldo, int partner, int causal, int bk) {
  __shared__ __align__(16) bf16 k_s[FB_BLOCK * FB_RS];
  __shared__ __align__(16) bf16 v_s[FB_BLOCK * FB_RS];
  __shared__ float bias_s[FB_BLOCK];

  const int n = blockIdx.x / H, h = blockIdx.x % H;
  const int src = partner ? (n ^ 1) : n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int nthreads = blockDim.x;
  const int tw0 = blockIdx.y * (blockDim.x / 2) + warp * 16;  // first query row of this warp
  const int t_lo = tw0 + g, t_hi = tw0 + g + 8;
  const bool warp_rows = tw0 < Tq;
  const bf16* kb = k + (size_t)src * Tk * ldkv + h * FA_HD;
  const bf16* vb = v + (size_t)src * Tk * ldkv + h * FA_HD;
  const float* mb = mask + (size_t)src * Tk;
  const int steps = (bk + 15) / 16;  // k16 steps of P v per block

  // q fragments: the A operand of m16n8k16, bfloat16 pairs read in place
  // (rows t_lo and t_hi; depth 2c, 2c + 1 and 2c + 8, 2c + 9 of each
  // 16-deep step). The scale 1/8 goes on the float32 scores, where it is
  // exact, as on q in the Pallas kernel.
  uint32_t qa[FA_HD / 16][4];
  {
    const bf16* q0 = q + ((size_t)n * Tq + min(t_lo, Tq - 1)) * ldq + h * FA_HD + 2 * c;
    const bf16* q1 = q + ((size_t)n * Tq + min(t_hi, Tq - 1)) * ldq + h * FA_HD + 2 * c;
#pragma unroll
    for (int kk = 0; kk < FA_HD / 16; ++kk) {
      qa[kk][0] = *reinterpret_cast<const uint32_t*>(q0 + 16 * kk);
      qa[kk][1] = *reinterpret_cast<const uint32_t*>(q1 + 16 * kk);
      qa[kk][2] = *reinterpret_cast<const uint32_t*>(q0 + 16 * kk + 8);
      qa[kk][3] = *reinterpret_cast<const uint32_t*>(q1 + 16 * kk + 8);
    }
  }

  float o[FA_HD / 8][4];
#pragma unroll
  for (int j = 0; j < FA_HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_lo = -1e30f, m_hi = -1e30f, l_lo = 0.f, l_hi = 0.f;  // Pallas's m0

  for (int j0 = 0; j0 < Tk; j0 += bk) {
    for (int i = tid; i < steps * 16 * (FA_HD / 8); i += nthreads) {
      const int r = i / (FA_HD / 8), col = (i % (FA_HD / 8)) * 8;
      const int key = j0 + r;
      const bool ok = r < bk && key < Tk;
      const size_t off = (size_t)(ok ? key : 0) * ldkv + col;
      cp_async16(k_s + r * FB_RS + col, kb + off, ok);
      cp_async16(v_s + r * FB_RS + col, vb + off, ok);
    }
    cp_async_commit();
    for (int r = tid; r < steps * 16; r += nthreads) {
      const int key = j0 + r;
      bias_s[r] = r >= bk ? -INFINITY : key < Tk ? (1.f - mb[key]) * FA_MASK_BIAS
                                                 : FA_MASK_BIAS;
    }
    cp_async_wait<0>();
    __syncthreads();  // the block's keys, values and biases are in

    if (warp_rows) {
      // S = q k^T over the block: n8 tiles of keys j0 + 8 j + {2c, 2c + 1}
      float sc[FB_TILES][4];
#pragma unroll
      for (int j = 0; j < FB_TILES; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < FA_HD / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < FB_TILES; ++j) {
          if (j < 2 * steps) {
            const bf16* kr = k_s + (8 * j + g) * FB_RS + 16 * kk + 2 * c;
            const uint32_t b[2] = {*reinterpret_cast<const uint32_t*>(kr),
                                   *reinterpret_cast<const uint32_t*>(kr + 8)};
            mma_bf16(sc[j], qa[kk], b);
          }
        }
      }
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int j = 0; j < FB_TILES; ++j) {
        if (j < 2 * steps) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 8 * j + 2 * c + (e & 1);
            const int t = e < 2 ? t_lo : t_hi;
            float x = sc[j][e] * FA_SCALE + bias_s[r];
            if (causal && j0 + r > t) x += FA_MASK_BIAS;
            sc[j][e] = x;
            if (e < 2) mx_lo = fmaxf(mx_lo, x); else mx_hi = fmaxf(mx_hi, x);
          }
        }
      }
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
      const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
      const float al_lo = expf(m_lo - mn_lo), al_hi = expf(m_hi - mn_hi);
      m_lo = mn_lo;
      m_hi = mn_hi;
      l_lo *= al_lo;
      l_hi *= al_hi;
#pragma unroll
      for (int j = 0; j < FB_TILES; ++j) {
        if (j < 2 * steps) {
          sc[j][0] = expf(sc[j][0] - mn_lo);
          sc[j][1] = expf(sc[j][1] - mn_lo);
          sc[j][2] = expf(sc[j][2] - mn_hi);
          sc[j][3] = expf(sc[j][3] - mn_hi);
          l_lo += sc[j][0] + sc[j][1];
          l_hi += sc[j][2] + sc[j][3];
        }
      }
#pragma unroll
      for (int j = 0; j < FA_HD / 8; ++j) {
        o[j][0] *= al_lo;
        o[j][1] *= al_lo;
        o[j][2] *= al_hi;
        o[j][3] *= al_hi;
      }
      // O += P v, 16 keys a step: tiles 2s and 2s + 1 of S are P's A
      // fragment (rows g, g + 8; keys 2c, 2c + 1 and 2c + 8, 2c + 9)
#pragma unroll
      for (int st = 0; st < FB_TILES / 2; ++st) {
        if (st < steps) {
          const uint32_t a[4] = {pack_bf16(sc[2 * st][0], sc[2 * st][1]),
                                 pack_bf16(sc[2 * st][2], sc[2 * st][3]),
                                 pack_bf16(sc[2 * st + 1][0], sc[2 * st + 1][1]),
                                 pack_bf16(sc[2 * st + 1][2], sc[2 * st + 1][3])};
          const bf16* v0 = v_s + (16 * st + 2 * c) * FB_RS + g;
#pragma unroll
          for (int jn = 0; jn < FA_HD / 8; ++jn) {
            const bf16* vc = v0 + 8 * jn;
            const uint32_t b[2] = {
                pack_bf16(to_float(vc[0]), to_float(vc[FB_RS])),
                pack_bf16(to_float(vc[8 * FB_RS]), to_float(vc[9 * FB_RS]))};
            mma_bf16(o[jn], a, b);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this block before the next one
  }

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float d_lo = fmaxf(l_lo, 1e-30f), d_hi = fmaxf(l_hi, 1e-30f);
  if (t_lo < Tq) {
    bf16* orow = out + ((size_t)n * Tq + t_lo) * ldo + h * FA_HD + 2 * c;
#pragma unroll
    for (int j = 0; j < FA_HD / 8; ++j) store2(orow + 8 * j, o[j][0] / d_lo, o[j][1] / d_lo);
  }
  if (t_hi < Tq) {
    bf16* orow = out + ((size_t)n * Tq + t_hi) * ldo + h * FA_HD + 2 * c;
#pragma unroll
    for (int j = 0; j < FA_HD / 8; ++j) store2(orow + 8 * j, o[j][2] / d_hi, o[j][3] / d_hi);
  }
}

}  // namespace hig

extern "C" int hig_flash_attention(
    const float* q, const float* k, const float* v, const float* mask, float* out,
    int N, int H, int Tq, int Tk, int ldq, int ldkv, int ldo, int partner, int causal,
    void* stream_ptr) {
  const cudaError_t attr = cudaFuncSetAttribute(
      hig::flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)hig::fa_smem(hig::FA_TILE));
  if (attr != cudaSuccess) return attr;
  const int tiles = (Tq + 15) / 16;
  const int warps = tiles < hig::FA_MAX_WARPS ? tiles : hig::FA_MAX_WARPS;
  const int keys = (Tk + hig::FA_STEP - 1) / hig::FA_STEP * hig::FA_STEP;
  const int tile = keys < hig::FA_TILE ? keys : hig::FA_TILE;
  const dim3 grid(N * H, (tiles + warps - 1) / warps);
  hig::flash_attention_kernel<<<grid, 32 * warps, hig::fa_smem(tile),
                                static_cast<cudaStream_t>(stream_ptr)>>>(
      q, k, v, mask, out, H, Tq, Tk, ldq, ldkv, ldo, partner, causal, tile);
  return cudaGetLastError();
}

extern "C" int hig_flash_attention_bf16(
    const hig::bf16* q, const hig::bf16* k, const hig::bf16* v, const float* mask,
    hig::bf16* out, int N, int H, int Tq, int Tk, int ldq, int ldkv, int ldo, int partner,
    int causal, void* stream_ptr) {
  const int tiles = (Tq + 15) / 16;
  const int warps = tiles < hig::FA_MAX_WARPS ? tiles : hig::FA_MAX_WARPS;
  const int keys8 = (Tk + 7) / 8 * 8;
  const int bk = keys8 < hig::FB_BLOCK ? keys8 : hig::FB_BLOCK;  // the Pallas key block
  const dim3 grid(N * H, (tiles + warps - 1) / warps);
  hig::flash_attention_bf16_kernel<<<grid, 32 * warps, 0,
                                     static_cast<cudaStream_t>(stream_ptr)>>>(
      q, k, v, mask, out, H, Tq, Tk, ldq, ldkv, ldo, partner, causal, bk);
  return cudaGetLastError();
}
