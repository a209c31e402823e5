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
#include "hopper.cuh"

namespace hig {

// Head width FA_HD (common.cuh's HW: 16, 32, 64 or 128). Each 16-row query
// tile of a block is owned by FA_PARTS warps, each holding FA_WD of q's
// depth (split into TF32 parts once) and of O's columns: one warp up to
// width 64; at 128 a pair, so that q, O and S fit the registers as at 64
// (the width-128 form that gave one warp all 128 columns took 255
// registers, spilled 352 bytes and split q at every step). A pair's two
// partial S tiles of each 32-key step meet in a shared-memory slot under a
// pair barrier (named barrier 1 + the pair), each warp adds the other's
// partial to its own (a + b = b + a exactly, so both hold the same S), and
// both run the same online softmax, so m and l agree bit for bit; each
// multiplies P by its own 64 columns of v. At 128 the most keys resident at
// once halve (k, v and the biases stay at 137 KB; a slot a warp adds 16 KB).
constexpr int FA_HD = HW;        // head dim
constexpr int FA_PARTS = HW == 128 ? 2 : 1;  // warps a 16-row query tile
constexpr int FA_WD = FA_HD / FA_PARTS;      // q depth and O columns a warp owns
constexpr int FA_MAX_WARPS = 8;  // 16 query rows each (with FA_PARTS = 1)
constexpr int FA_STEP = 32;      // keys per online-softmax step
constexpr int FA_TILE = HW == 128 ? 128 : 256;  // most keys resident in shared memory at once
constexpr int FA_KS = FA_HD + 8; // row stride of k in shared memory
constexpr int FA_VS = FA_HD + 4; // row stride of v
// 1 / sqrt(FA_HD) in float32: exact at 16 (1/4) and 64 (1/8); at 32 and 128
// the float32 of 2^-2.5 and 2^-3.5, as JAX's Python scale becomes in its
// float32 product with q
constexpr float FA_SCALE = HW == 16   ? 0.25f
                           : HW == 32 ? 0.1767766952966369f
                           : HW == 64 ? 0.125f
                                      : 0.0883883461356163f;
constexpr float FA_MASK_BIAS = -1000000.0f;
constexpr int FA_XCH = 16 * 32;  // a warp's partial S tile in the pair exchange (floats)

// Dynamic shared memory for `rows` resident keys and `warps` warps: k, v,
// the key biases, and (pairs) one exchange slot a warp.
constexpr size_t fa_smem(int rows, int warps) {
  return sizeof(float) * ((size_t)rows * (FA_KS + FA_VS + 1) +
                          (FA_PARTS == 2 ? (size_t)warps * FA_XCH : 0));
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
  float* x_s = bias_s + tile;                // pairs: [warps][FA_XCH]

  const int n = blockIdx.x / H, h = blockIdx.x % H;
  const int src = partner ? (n ^ 1) : n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int nthreads = blockDim.x, warps = nthreads >> 5;
  const int part = warp % FA_PARTS;  // this warp's share of the depth and of O's columns
  const int bq = 16 * (warps / FA_PARTS);  // query rows of the block
  const int tb0 = blockIdx.y * bq;
  const int tw0 = tb0 + (warp / FA_PARTS) * 16;  // first query row of this warp
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

  // q fragments of this warp's depth, scaled, split once: qa[kk][*] for
  // depth FA_WD part + 8 kk .. + 7
  Split qa[FA_WD / 8][4];
  {
    const int col = h * FA_HD + FA_WD * part + 2 * c;
    const float* q0 = q + ((size_t)n * Tq + min(t_lo, Tq - 1)) * ldq + col;
    const float* q1 = q + ((size_t)n * Tq + min(t_hi, Tq - 1)) * ldq + col;
#pragma unroll
    for (int kk = 0; kk < FA_WD / 8; ++kk) {
      const float2 a = *reinterpret_cast<const float2*>(q0 + 8 * kk);
      const float2 b = *reinterpret_cast<const float2*>(q1 + 8 * kk);
      qa[kk][0] = split_tf32(a.x * FA_SCALE);
      qa[kk][2] = split_tf32(a.y * FA_SCALE);
      qa[kk][1] = split_tf32(b.x * FA_SCALE);
      qa[kk][3] = split_tf32(b.y * FA_SCALE);
    }
  }

  float o[FA_WD / 8][4];  // this warp's FA_WD output columns
#pragma unroll
  for (int j = 0; j < FA_WD / 8; ++j)
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
      if (!warp_rows || key0 >= warp_end) continue;  // uniform over a pair
      const int r0 = s * FA_STEP;

      // S = q k^T for 32 keys (this warp's depth): 4 n8 tiles, keys key0 +
      // 8 j + {2c, 2c + 1}.
      float sc[FA_STEP / 8][4];
#pragma unroll
      for (int j = 0; j < FA_STEP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < FA_WD / 8; ++kk) {
        Split b[FA_STEP / 8][2];
#pragma unroll
        for (int j = 0; j < FA_STEP / 8; ++j) {
          const float2 kv = *reinterpret_cast<const float2*>(
              k_s + (r0 + 8 * j + g) * FA_KS + FA_WD * part + 8 * kk + 2 * c);
          b[j][0] = split_tf32(kv.x);
          b[j][1] = split_tf32(kv.y);
        }
        mma_3xtf32<1, FA_STEP / 8>(&sc[0][0], qa[kk], &b[0][0]);
      }
      if constexpr (FA_PARTS == 2) {  // the pair's two partial tiles, summed
        // (the step's __syncthreads orders the partner's read of a slot
        // before the slot's next write)
        float* mine = x_s + warp * FA_XCH + lane;
        const float* other = x_s + (warp ^ 1) * FA_XCH + lane;
#pragma unroll
        for (int i = 0; i < 16; ++i) mine[32 * i] = sc[i >> 2][i & 3];
        named_barrier(1 + warp / 2, 64);
#pragma unroll
        for (int i = 0; i < 16; ++i) sc[i >> 2][i & 3] += other[32 * i];
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
      for (int j = 0; j < FA_WD / 8; ++j) {
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
        const float* v0 = v_s + (r0 + 8 * j + 2 * c) * FA_VS + FA_WD * part + g;
        Split b[FA_WD / 8][2];
#pragma unroll
        for (int jn = 0; jn < FA_WD / 8; ++jn) {
          b[jn][0] = split_tf32(v0[8 * jn]);
          b[jn][1] = split_tf32(v0[FA_VS + 8 * jn]);
        }
        mma_3xtf32<1, FA_WD / 8>(&o[0][0], a, &b[0][0]);
      }
    }
    __syncthreads();  // every warp is done with this tile before the next one
  }

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  const int ocol = h * FA_HD + FA_WD * part + 2 * c;
  if (t_lo < Tq) {
    float* orow = out + ((size_t)n * Tq + t_lo) * ldo + ocol;
#pragma unroll
    for (int j = 0; j < FA_WD / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(o[j][0] * inv_lo, o[j][1] * inv_lo);
  }
  if (t_hi < Tq) {
    float* orow = out + ((size_t)n * Tq + t_hi) * ldo + ocol;
#pragma unroll
    for (int j = 0; j < FA_WD / 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(o[j][2] * inv_hi, o[j][3] * inv_hi);
  }
}

// B4-bf16: the kernel above for bfloat16 q, k, v and out, rounding where
// the Pallas kernel rounds for dt = bfloat16 (hig_tpu/ops/flash_attention.py:
// 53-86): scores and the online softmax in float32 over the Pallas key
// blocks of `bk` keys (min(128, Tk rounded up to 8)); in each block
// p = exp(s - running max) is rounded to bfloat16 for P v; out = acc / l
// rounded to bfloat16. Keys past Tk inside a block score -1e6 (the Pallas
// kernel's zero padding with a zero mask); keys past the block, up to 128,
// score -inf and weigh exactly 0.
//
// Bound on this card: at N = 104, H = 8, T = 196 the work is 2.6 GFLOP of
// bfloat16 products (2.6 us at 989 TFLOP/s) against 83 MB of q, k, v, mask
// and out (25 us at 3.35 TB/s); at the serving shape 1.8 us, also bytes. So
// the design reads each byte once and keeps the loads in flight under the
// products:
// - A work item is one (sequence, head) with all its query rows, 64 per
//   consumer warpgroup (up to 4; longer query ranges in passes), so K and
//   V are read once per (sequence, head). Blocks are persistent, one per
//   SM, and walk over the items, so one item's loads overlap the previous
//   item's products.
// - Each Pallas key block (128 rows of k and of v, rows past Tk
//   zero-filled by TMA) comes by TMA into a 2-stage ring with
//   mbarriers: block j + 1 (of this item or the next) loads while block j
//   is computed. Thread 0 issues the loads and refills a stage once every
//   warpgroup has released it; each warpgroup's q tiles come by TMA into a
//   double buffer, the next tile's while this one is computed. (Beside four
//   consumer warpgroups a producer warp makes ptxas allocate registers as
//   for 640 threads, and spill; a producer warpgroup that hands its
//   registers over with setmaxnreg ran slower.)
// - Both products run on wgmma: S = q k^T (m64n128k16, q and k from
//   128-byte-swizzled shared memory) and O += P v (m64n64k16), P the
//   register A operand taken from the score registers once p is rounded,
//   v the MN-major B operand; nothing of S or P goes to shared memory.
// - Head widths 16 and 32: the item's q, k and v tiles are the 64-column
//   tile that holds its head (HPB packed heads, common.cuh; the TMA boxes
//   and descriptors of width 64); S takes the head's HW / 16 depth steps of
//   it, O = P v runs over the tile's 64 columns and only the head's HW are
//   stored (simple: the other columns' products are wasted work).
// - Head width HD (64 or 128): q, k and v tiles are NH column halves of 64
//   (one swizzle atom a row each, one TMA box each). S takes HD / 16 depth
//   steps, the first four from half 0; O is NH m64n64 accumulators, one per
//   half of v. At 128 two consumer warpgroups (the q double buffers, the
//   ring and O fit: 194 KB, 64 + 64 accumulators a thread).
// - The 1/8 scale goes on the float32 scores, where it is exact, as on q
//   in the Pallas kernel. Rows past Tq read as zeros and are not stored.
constexpr int FB_BLOCK = 128;  // the Pallas kernel's largest key block, one ring stage
constexpr int FB_BQ = 64;      // query rows per consumer warpgroup
constexpr int FB_MAX_WG = HD == 64 ? 4 : 2;  // consumer warpgroups
constexpr int FB_STAGES = 2;
constexpr uint32_t FB_Q_BYTES = FB_BQ * HD * 2;      // 8 KB a half
constexpr uint32_t FB_KV_BYTES = FB_BLOCK * HD * 2;  // 16 KB a half, each of k and v

struct FlashBf16Smem {  // at a 1024-byte boundary
  bf16 q[FB_MAX_WG][2][FB_BQ * HD];
  bf16 k[FB_STAGES][FB_BLOCK * HD];
  bf16 v[FB_STAGES][FB_BLOCK * HD];
  float bias[FB_MAX_WG][2][FB_BLOCK];  // each warpgroup's key biases, by block parity
  uint64_t kfull[FB_STAGES], vfull[FB_STAGES], empty[FB_STAGES], qfull[FB_MAX_WG][2];
};

constexpr float FB_LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (float32-level error, results below
// 2^-126 flushed to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <bool CAUSAL>
__global__ void __launch_bounds__(FB_MAX_WG * 128, 1) flash_attention_bf16_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const float* __restrict__ mask,
    bf16* __restrict__ out, int H, int Tq, int Tk, int ldo, int partner, int bk, int nwg,
    int items) {
  extern __shared__ unsigned char smem_raw[];
  FlashBf16Smem& sm = *reinterpret_cast<FlashBf16Smem*>(align1024(smem_raw));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, c = lane & 3;
  const int qtiles = (Tq + FB_BQ - 1) / FB_BQ;
  const int passes = (qtiles + nwg - 1) / nwg;
  const int kblocks = (Tk + bk - 1) / bk;
  const int my_items = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int loads = my_items * passes * kblocks;  // key blocks through the ring
  const int wsteps = (qtiles - wg + nwg - 1) / nwg;  // this warpgroup's q tiles of an item

  auto item_of = [&](int k) { return (int)blockIdx.x + k * (int)gridDim.x; };
  auto load_block = [&](int it) {  // ring position it: stage it % FB_STAGES
    const int st = it % FB_STAGES, j0 = (it % kblocks) * bk;
    const int item = item_of(it / (passes * kblocks)), n = item / H;
    const int src = partner ? (n ^ 1) : n;
    // k on one barrier, v on another: S runs while v arrives
    mbar_arrive_expect_tx(&sm.kfull[st], FB_KV_BYTES);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
      tma_load_3d(sm.k[st] + hh * FB_BLOCK * 64, &tk, &sm.kfull[st],
                  (item % H) / HPB * HD + 64 * hh, j0, src);
    mbar_arrive_expect_tx(&sm.vfull[st], FB_KV_BYTES);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
      tma_load_3d(sm.v[st] + hh * FB_BLOCK * 64, &tv, &sm.vfull[st],
                  (item % H) / HPB * HD + 64 * hh, j0, src);
  };
  auto load_q = [&](int w, int idx) {  // warpgroup w's q tile idx into buffer idx & 1
    const int ws = (qtiles - w + nwg - 1) / nwg;
    const int item = item_of(idx / ws), tile = (idx % ws) * nwg + w;
    uint64_t* bar = &sm.qfull[w][idx & 1];
    mbar_arrive_expect_tx(bar, FB_Q_BYTES);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
      tma_load_3d(sm.q[w][idx & 1] + hh * FB_BQ * 64, &tq, bar,
                  (item % H) / HPB * HD + 64 * hh, tile * FB_BQ, item / H);
  };

  if (tid == 0) {
    prefetch_tensormap(&tq);
    prefetch_tensormap(&tk);
    prefetch_tensormap(&tv);
    for (int s = 0; s < FB_STAGES; ++s) {
      mbar_init(&sm.kfull[s], 1);
      mbar_init(&sm.vfull[s], 1);
      mbar_init(&sm.empty[s], 128 * nwg);
    }
    for (int w = 0; w < FB_MAX_WG; ++w) {
      mbar_init(&sm.qfull[w][0], 1);
      mbar_init(&sm.qfull[w][1], 1);
    }
    fence_barrier_init();
    for (int w = 0; w < nwg; ++w) load_q(w, 0);
    for (int it = 0; it < loads && it < FB_STAGES; ++it) load_block(it);
  }
  __syncthreads();

  // The next ring block's (local item, pass, key block) and its item's mask
  // row; each thread reads the mask value of its key r = tid % 128 one block
  // ahead.
  int nk = 0, npass = 0, njb = 0;
  auto mask_row = [&](int k) {
    const int n = item_of(k) / H;
    return mask + (size_t)(partner ? (n ^ 1) : n) * Tk;
  };
  const float* nrow = mask_row(0);
  auto next_mask = [&]() {  // the value for block (nk, npass, njb), then advance
    const int key = njb * bk + (tid & 127);
    const float m = nk < my_items && key < Tk ? nrow[key] : 0.f;
    if (++njb == kblocks) {
      njb = 0;
      if (++npass == passes) {
        npass = 0;
        if (++nk < my_items) nrow = mask_row(nk);
      }
    }
    return m;
  };
  float mnext = next_mask();

  int it = 0, idx = 0;  // ring position; this warpgroup's q tiles so far
  for (int k = 0; k < my_items; ++k) {
    const int item = item_of(k), n = item / H, h = item % H;
    // packed heads (HW < 64): the head's first 16-deep step and n8 tile
    // in its tile
    const int k0 = (h % HPB) * (HW / 16), j0h = (h % HPB) * (HW / 8);
    for (int pass = 0; pass < passes; ++pass) {
      const int tile = pass * nwg + wg;
      const bool active = tile < qtiles;  // uniform over the warpgroup
      if (active) {
        named_barrier(1 + wg, 128);  // the warpgroup is done with buffer (idx + 1) & 1
        if ((tid & 127) == 0 && idx + 1 < my_items * wsteps) load_q(wg, idx + 1);
        mbar_wait(&sm.qfull[wg][idx & 1], (idx >> 1) & 1);
      }
      const uint64_t dq = sw128_desc(sm.q[wg][idx & 1]);
      const int t_lo = tile * FB_BQ + 16 * wl + g, t_hi = t_lo + 8;
      float o[32 * NH];  // column 64 hh + 8 j + 2 c + e % 2 at o[32 hh + 4 j + e]
#pragma unroll
      for (int i = 0; i < 32 * NH; ++i) o[i] = 0.f;
      float m_lo = -1e30f, m_hi = -1e30f, l_lo = 0.f, l_hi = 0.f;  // Pallas's m0
      const bool warp_rows = tile * FB_BQ + 16 * wl < Tq;
      bool key0 = false;  // key 0 of the sequence unmasked (read with block 0)

      for (int jb = 0; jb < kblocks; ++jb, ++it) {
        const int st = it % FB_STAGES, j0 = jb * bk;
        const uint32_t parity = (it / FB_STAGES) & 1;
        {  // the block's key biases into this warpgroup's buffer; the next block's
           // mask value goes in flight
          const int r = tid & 127;
          sm.bias[wg][it & 1][r] = r >= bk ? -INFINITY
                                   : j0 + r < Tk ? fmaf(mnext, -FA_MASK_BIAS, FA_MASK_BIAS)
                                                 : FA_MASK_BIAS;
          mnext = next_mask();
          named_barrier(1 + wg, 128);
        }
        mbar_wait(&sm.kfull[st], parity);
        if (active) {
          // S = q k^T over the block's 128 rows: sc[4 j + e] is row t_lo / t_hi
          // (e / 2), key j0 + 8 j + 2 c + (e % 2)
          float sc[64];
          const uint64_t dk = sw128_desc(sm.k[st]);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < HW / 16; ++kk) {  // the head's depth steps in its tile
            const int ks = k0 + kk;
            wgmma_m64n128_ss<0, 0>(sc, desc_add(dq, FB_BQ * 128 * (ks / 4) + 32 * (ks % 4)),
                                   desc_add(dk, FB_BLOCK * 128 * (ks / 4) + 32 * (ks % 4)), kk);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<64>(sc);

          // x = s / 8 + the Pallas kernel's key bias ((1 - mask) * -1e6; -1e6
          // past Tk), -inf past the block. Only the 16-key steps that can
          // weigh anything are taken: keys below bk and, once key 0 of the
          // sequence has mask 1 (every row max is then at least its finite
          // score, and a padded key's weight exp(-1e6 - max) is exactly 0),
          // below Tk (causal: and at or before the warp's last row); a warp
          // whose 16 rows all lie past Tq takes none. p =
          // exp(x - max) is taken as exp2 of the scaled difference on the
          // special-function unit (float32-level error) and rounded to
          // bfloat16.
          const float* bias = sm.bias[wg][it & 1];
          if (jb == 0) key0 = bias[0] == 0.f;
          int kend = key0 ? min(bk, Tk - j0) : bk;
          // causal: keys past the warp's last row weigh exactly 0 too
          if (CAUSAL && key0) kend = min(kend, tile * FB_BQ + 16 * wl + 16 - j0);
          const int jt = warp_rows && kend > 0 ? 2 * ((kend + 15) / 16) : 0;  // 8-key tiles taken
          // causal: key j0 + r is masked for row t when r > t - j0; tiles whose
          // keys all lie at or before the warp's first row need no test
          const int wrow = tile * FB_BQ + 16 * wl - j0;
          const int lim_lo = t_lo - j0 - 2 * c, lim_hi = t_hi - j0 - 2 * c;
          float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
          for (int j = 0; j < FB_BLOCK / 8; ++j) {
            if (j < jt) {
              const int r = 8 * j + 2 * c;
              const float2 bv = *reinterpret_cast<const float2*>(bias + r);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                float x = fmaf(sc[4 * j + e], FA_SCALE, (e & 1) ? bv.y : bv.x);
                if (CAUSAL && 8 * j + 7 > wrow && 8 * j + (e & 1) > (e < 2 ? lim_lo : lim_hi))
                  x += FA_MASK_BIAS;
                sc[4 * j + e] = x;
                if (e < 2) mx_lo = fmaxf(mx_lo, x); else mx_hi = fmaxf(mx_hi, x);
              }
            }
          }
          mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
          mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
          mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
          mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
          const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
          const float al_lo = exp2_approx((m_lo - mn_lo) * FB_LOG2E);
          const float al_hi = exp2_approx((m_hi - mn_hi) * FB_LOG2E);
          m_lo = mn_lo;
          m_hi = mn_hi;
          l_lo *= al_lo;
          l_hi *= al_hi;
          uint32_t pa[FB_BLOCK / 16][4];  // P, rounded, as the A operand of each 16-key step
#pragma unroll
          for (int j = 0; j < FB_BLOCK / 8; ++j) {
            uint32_t lo = 0u, hi = 0u;
            if (j < jt) {
              const float p0 = exp2_approx((sc[4 * j] - mn_lo) * FB_LOG2E);
              const float p1 = exp2_approx((sc[4 * j + 1] - mn_lo) * FB_LOG2E);
              const float p2 = exp2_approx((sc[4 * j + 2] - mn_hi) * FB_LOG2E);
              const float p3 = exp2_approx((sc[4 * j + 3] - mn_hi) * FB_LOG2E);
              l_lo += p0 + p1;
              l_hi += p2 + p3;
              lo = pack_bf16(p0, p1);
              hi = pack_bf16(p2, p3);
            }
            pa[j >> 1][2 * (j & 1)] = lo;
            pa[j >> 1][2 * (j & 1) + 1] = hi;
          }
#pragma unroll
          for (int j = 0; j < HD / 8; ++j) {
            o[4 * j] *= al_lo;
            o[4 * j + 1] *= al_lo;
            o[4 * j + 2] *= al_hi;
            o[4 * j + 3] *= al_hi;
          }
          mbar_wait(&sm.vfull[st], parity);
          const uint64_t dv = sw128_desc(sm.v[st]);
          fence_regs<32 * NH>(o);
          wgmma_fence();
#pragma unroll
          for (int s = 0; s < FB_BLOCK / 16; ++s)
#pragma unroll
            for (int hh = 0; hh < NH; ++hh)
              wgmma_m64n64_rs<1>(o + 32 * hh, pa[s],
                                 desc_add(dv, FB_BLOCK * 128 * hh + 2048 * s), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs<32 * NH>(o);
        }
        mbar_arrive(&sm.empty[st]);
        if (tid == 0 && it + FB_STAGES < loads) {  // refill the stage once all are done
          mbar_wait(&sm.empty[st], (it / FB_STAGES) & 1);
          load_block(it + FB_STAGES);
        }
      }

      if (!active) continue;
      ++idx;
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
      const float d_lo = fmaxf(l_lo, 1e-30f), d_hi = fmaxf(l_hi, 1e-30f);
      // the head's columns of O (packed heads: n8 tiles j0h .. j0h + HW / 8 - 1
      // of the tile; the other heads' columns are P v of this head's P, unused)
      const int tcol = h / HPB * HD + 2 * c;
      if (t_lo < Tq) {
        bf16* orow = out + ((size_t)n * Tq + t_lo) * ldo + tcol;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          if (HPB == 1 || (j >= j0h && j < j0h + HW / 8))
            store2(orow + 8 * j, o[4 * j] / d_lo, o[4 * j + 1] / d_lo);
      }
      if (t_hi < Tq) {
        bf16* orow = out + ((size_t)n * Tq + t_hi) * ldo + tcol;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          if (HPB == 1 || (j >= j0h && j < j0h + HW / 8))
            store2(orow + 8 * j, o[4 * j + 2] / d_hi, o[4 * j + 3] / d_hi);
      }
    }
  }
}

}  // namespace hig

extern "C" int hig_flash_attention(
    const float* q, const float* k, const float* v, const float* mask, float* out,
    int N, int H, int Tq, int Tk, int ldq, int ldkv, int ldo, int partner, int causal,
    void* stream_ptr) {
  using namespace hig;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)fa_smem(FA_TILE, FA_MAX_WARPS));
  if (attr != cudaSuccess) return attr;
  const int tiles = (Tq + 15) / 16;  // 16-row query tiles
  // query tiles a block: up to FA_MAX_WARPS / FA_PARTS; pairs spread a
  // sequence's tiles evenly over its blocks
  constexpr int most = FA_MAX_WARPS / FA_PARTS;
  int per = tiles < most ? tiles : most;
  if (FA_PARTS == 2) {
    const int blocks = (tiles + most - 1) / most;
    per = (tiles + blocks - 1) / blocks;
  }
  const int warps = per * FA_PARTS;
  const int keys = (Tk + FA_STEP - 1) / FA_STEP * FA_STEP;
  const int tile = keys < FA_TILE ? keys : FA_TILE;
  const dim3 grid(N * H, (tiles + per - 1) / per);
  flash_attention_kernel<<<grid, 32 * warps, fa_smem(tile, warps),
                           static_cast<cudaStream_t>(stream_ptr)>>>(
      q, k, v, mask, out, H, Tq, Tk, ldq, ldkv, ldo, partner, causal, tile);
  return cudaGetLastError();
}

extern "C" int hig_flash_attention_bf16(
    const hig::bf16* q, const hig::bf16* k, const hig::bf16* v, const float* mask,
    hig::bf16* out, int N, int H, int Tq, int Tk, int ldq, int ldkv, int ldo, int partner,
    int causal, void* stream_ptr) {
  using namespace hig;
  const int D = H * HW;
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_tile_map(&mq, q, D, Tq, N, ldq, FB_BQ);
  if (err == cudaSuccess) err = make_tile_map(&mk, k, D, Tk, N, ldkv, FB_BLOCK);
  if (err == cudaSuccess) err = make_tile_map(&mv, v, D, Tk, N, ldkv, FB_BLOCK);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int qtiles = (Tq + FB_BQ - 1) / FB_BQ;
  const int nwg = qtiles < FB_MAX_WG ? qtiles : FB_MAX_WG;
  const int keys8 = (Tk + 7) / 8 * 8;
  const int bk = keys8 < FB_BLOCK ? keys8 : FB_BLOCK;  // the Pallas key block
  const int items = N * H, grid = items < sms ? items : sms;
  const int smem = (int)sizeof(FlashBf16Smem) + 1024;
  auto kernel = causal ? flash_attention_bf16_kernel<true> : flash_attention_bf16_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 128 * nwg, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      mq, mk, mv, mask, out, H, Tq, Tk, ldo, partner, bk, nwg, items);
  return cudaGetLastError();
}
