// B1: one whole efficient self-attention or interaction block, forward.
// Replaces hig_tpu/ops/fused_block.py::_block_kernel (Pallas TPU).
//
//   xn = LN_attn(x); q, k, v = xn Wq + bq, xn Wk + bk, xn Wv + bv
//   (k, v and the key mask taken from the partner sequence n ^ 1 in the
//    interaction variant: LayerNorm and the projections are per token, so
//    projecting x and reading the partner's rows equals projecting flip(x))
//   k += (1 - mask) * -1e6; v *= mask
//   per head: y_h = softmax_feat(q_h) . [softmax_time(k_h)^T v_h]
//   out = x + SiLU(LN_styl(y) * (1 + scale) + shift) Wo + bo
//
// Five launches on the caller's stream (linear_attention.cuh has the
// design): (1) a row pass writes xn = LN_attn(x) into `y`; (2) the 3xTF32
// QKV GEMM reads xn and writes `qkv` (N*T, 3*D); (3) the attention core
// writes y; (4) a row pass turns y in place into
// SiLU(LN_styl(y) * (1 + scale) + shift); (5) the 3xTF32 Wo GEMM adds bo and
// the residual x into `out`. Each row is normalized once, so the GEMMs'
// main loops do copies and products only. Returns the first cudaError_t.
#include "linear_attention.cuh"
#include "qkv_core.cuh"

extern "C" int hig_fused_block(
    const float* x, const float* mask, const float* scale, const float* shift,
    const float* ln_g, const float* ln_b,
    const float* wq, const float* bq, const float* wk, const float* bk,
    const float* wv, const float* bv,
    const float* styl_g, const float* styl_b, const float* wo, const float* bo,
    float* qkv, float* y, float* out,
    int N, int T, int D, int interaction, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int M = N * T;

  cudaError_t err = hig::launch_row_norm<false>(x, y, ln_g, ln_b, nullptr, nullptr, M, D, T,
                                                stream);
  if (err != cudaSuccess) return err;

  hig::GemmArgs a{};
  a.a0 = y; a.a1 = y;
  a.w0 = wq; a.w1 = wk; a.w2 = wv;
  a.b0 = bq; a.b1 = bk; a.b2 = bv;
  a.out = qkv;
  a.M = M; a.K = D; a.D = D; a.ldo = 3 * D;
  err = hig::launch_gemm_qkv(a, stream);
  if (err != cudaSuccess) return err;

  err = hig::launch_core_qkv(qkv, mask, y, N, T, D, interaction, stream);
  if (err != cudaSuccess) return err;

  err = hig::launch_row_norm<true>(y, y, styl_g, styl_b, scale, shift, M, D, T, stream);
  if (err != cudaSuccess) return err;

  hig::GemmArgs c{};
  c.a0 = y; c.a1 = y;
  c.w0 = wo; c.w1 = wo; c.w2 = wo;
  c.b0 = bo; c.b1 = bo; c.b2 = bo;
  c.resid = x;
  c.out = out;
  c.M = M; c.K = D; c.D = D; c.ldo = D;
  return hig::launch_gemm_out(c, stream);
}

// B1-bf16: the same block on bfloat16 activations and weights, rounding
// where the Pallas kernel rounds for dt = bfloat16 (hig_tpu/ops/
// fused_block.py:56-96): xn is bfloat16; q | k | v are float32 with the
// bias; softmax_time(k) is normalized, then rounded; v, the state and
// softmax_feat(q) are rounded; the products of rounded values are exact
// (bfloat16 products in float32 accumulators); z is bfloat16; out is
// rounded once after the bias and the float32 residual.
//
// Bound on this card: at N = 104, T = 196, D = 512 the block is 45 GFLOP
// of bfloat16 products (46 us at 989 TFLOP/s) against 44 MB of x, weights
// and out (13 us): operations; at the serving shape 3.3 us. What the
// Pallas kernel keeps in VMEM, the float32 q | k | v above all (125 MB
// written and read back at 104 x 196, 1.6x the whole bound), stays on the
// chip here. Four launches:
//   (1) the row pass writes xn = LN_attn(x) as bfloat16 into `xz`;
//   (2) qkv_core_bf16_kernel, one block per (sequence, head): it projects
//       the partner's (or its own) xn rows onto the head's 128 columns of
//       Wk | Wv and its own rows onto the 64 of Wq on wgmma, fed by a TMA
//       ring from one producer warp; keeps k (float32) and the rounded v in
//       shared memory; takes the column max and sums over all T keys once;
//       builds the rounded 64 x 64 state once (wgmma, softmax_time(k)^T as
//       the MN-major A operand); then softmaxes each 64-row q tile in its
//       accumulator registers, rounds it and multiplies it by the state as
//       the register A operand, and writes float32 y (its producer,
//       projection loop, column statistics and feature softmax are
//       qkv_core.cuh's, shared with B2-bf16);
//   (3) the row pass writes z = SiLU(LN_styl(y) * (1 + scale) + shift) as
//       bfloat16 into `xz`;
//   (4) out_gemm_bf16_kernel: z Wo^T on wgmma from a TMA ring, + bo + x in
//       float32, rounded once.
// mask is float32 (N, T); scale and shift bfloat16 (N, D).

namespace hig {

// Head width HW (16, 32, 64 or 128; the library's): at 16 and 32 a block
// takes one 64-column tile of HPB packed heads (common.cuh), the width-64
// kernel with the feature softmax per head and the state zeroed off its
// block diagonal. At 128 phase 0 projects k and
// then v in two passes (qkv_core.cuh), E and v are held as two 64-column
// halves, warpgroup dh builds state rows 64 dh .. + 63 as two m64n64
// chains (one a half of v), the state is four 64 x 64 tiles, and y is two
// m64n64 chains over eight 16-deep steps. The whole form holds up to
// qc_whole_max_t(1, 2) key rows (320 at HD 64, 128 at 128).
//
// The streaming form (STREAM; B1-bf16 past the whole form's rows, any T):
// the same block and producer, and the same rounding points in the same
// order, so the two agree bit for bit where both run. Its projection
// writes each key row's float32 k (with the bias and the mask's bias) and
// rounded v to a device scratch of its (sequence, head) (kscr, vscr; tpad
// rows, L2-resident at the shapes that need it) instead of shared memory;
// the column max and sums read the scratch in the whole form's thread
// order; then a 64-row tile at a time E = softmax_time(k), rounded, and v
// go into one of two shared buffers while the state's wgmma steps on the
// other run, one accumulator chain in the whole form's step order; the
// queries' phase is the whole form's. E is rounded after its division by
// the sum over all T keys, so the sums must be complete before any E is
// built: hence the scratch rather than an online softmax.
constexpr int QCS_ROWS = 128;  // the streaming form's E and v buffers: two 64-row tiles

__host__ __device__ constexpr int qcs_fixed_smem() {
  return 2 * QCS_ROWS * HD * 2 + (QC_RG * HD + 2 * HD) * 4 + 2 * QC_MAX_STAGES * 8;
}

template <bool STREAM>
__global__ void __launch_bounds__(QC_THREADS, 1) qkv_core_bf16_kernel(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap twq,
    const __grid_constant__ CUtensorMap twk, const __grid_constant__ CUtensorMap twv,
    const bf16* __restrict__ bq, const bf16* __restrict__ bk, const bf16* __restrict__ bv,
    const float* __restrict__ mask, float* __restrict__ y, float* __restrict__ kscr,
    bf16* __restrict__ vscr, int T, int D, int H, int interaction, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);  // [stages]: xn tile 0, xn tile 1, W (128 rows)
  const int tiles = (T + 63) / 64, tpad = 64 * tiles;
  const int erows = STREAM ? QCS_ROWS : tpad;  // rows of the E and v halves
  float* ks = reinterpret_cast<float*>(ring + stages * QC_STAGE_BYTES);  // [tpad][HD] k (whole)
  unsigned char* es = STREAM ? reinterpret_cast<unsigned char*>(ks)
                             : reinterpret_cast<unsigned char*>(ks) + tpad * HD * 4;  // E, bf16
  unsigned char* vs = es + erows * HD * 2;                                 // v, bf16
  float* red = reinterpret_cast<float*>(vs + erows * HD * 2);              // [QC_RG][HD]
  float* cm = red + QC_RG * HD;                                            // column max
  float* zs = cm + HD;                                                     // column sums
  uint64_t* full = reinterpret_cast<uint64_t*>(zs + HD);
  uint64_t* empty = full + QC_MAX_STAGES;
  // once E is built (whole: over k; streaming: over the E buffers), bf16,
  // NH x NH tiles of 64 x 64: tile (dh, lh) at 8192 (NH dh + lh)
  unsigned char* state = STREAM ? es : reinterpret_cast<unsigned char*>(ks);

  const int n = blockIdx.x / H, h = blockIdx.x % H;
  const int src = interaction ? (n ^ 1) : n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rounds = (tiles + QC_WG - 1) / QC_WG, kchunks = D / 64;
  // the streaming form's scratch rows of this (sequence, head)
  float* kh = STREAM ? kscr + (size_t)blockIdx.x * tpad * HD : nullptr;
  bf16* vh = STREAM ? vscr + (size_t)blockIdx.x * tpad * HD : nullptr;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], QC_CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * QC_WG) {  // producer: k | v chunks of every round, then q's
    if (lane == 0)
      qc_produce(&tx, &tx, QcWeights{&twq, &twk, &twv, HD * h, HD * h, HD * h}, src, n, ring,
                 full, empty, stages, tiles, kchunks);
    return;
  }

  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, c = lane & 3;
  int it = 0;

  // k | v = kvn [Wk | Wv]^T + [bk | bv]: 64-row tiles of the key rows
  for (int r = 0; r < rounds; ++r) {
    const int tile = QC_WG * r + wg;
    const bool active = tile < tiles;  // uniform over the warpgroup
    for (int pass = 0; pass < QC_KV_PASSES; ++pass) {
      float acc[64];
      qc_project<128>(acc, ring, full, empty, it, stages, kchunks, wg, active);
      if (!active) continue;
      fence_regs<64>(acc);
      // k += (1 - mask) * -1e6 into k (float32); v * mask, rounded, into v;
      // rows past T: v = 0 (and k unread)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = 64 * tile + 16 * wl + g + 8 * half;
        const bool valid = t < T;
        const float mt = valid ? mask[(size_t)src * T + t] : 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const bool is_k = HD == 64 ? j < 8 : pass == 0;
          const int col = 8 * (HD == 64 ? (j & 7) : j) + 2 * c;
          const float a0 = acc[4 * j + 2 * half], a1 = acc[4 * j + 2 * half + 1];
          if (is_k) {
            const float2 b = load2(bk + h * HD + col);
            const float2 kv = make_float2(a0 + b.x + (1.f - mt) * MASK_BIAS,
                                          a1 + b.y + (1.f - mt) * MASK_BIAS);
            if (!STREAM)
              *reinterpret_cast<float2*>(ks + t * HD + col) = kv;
            else if (valid)
              *reinterpret_cast<float2*>(kh + (size_t)t * HD + col) = kv;
          } else {
            const float2 b = load2(bv + h * HD + col);
            const uint32_t pv = valid ? pack_bf16((a0 + b.x) * mt, (a1 + b.y) * mt) : 0u;
            if (!STREAM)
              *reinterpret_cast<uint32_t*>(vs + half_swz(t, col, tpad)) = pv;
            else
              *reinterpret_cast<uint32_t*>(vh + (size_t)t * HD + col) = pv;
          }
        }
      }
    }
  }
  if (STREAM) __threadfence_block();  // the scratch rows, for the other consumer threads
  named_barrier(1, QC_CONSUMERS);

  // column max and sums over the T keys, then E = softmax_time(k) rounded
  const float* kk = STREAM ? kh : ks;
  qc_column_stats(kk, T, tid, red, cm, zs, [](int t, int d) { return t * HD + d; });
  auto e_pair = [&](int t, int d2) {
    return t < T ? pack_bf16(expf(kk[(size_t)t * HD + d2] - cm[d2]) / zs[d2],
                             expf(kk[(size_t)t * HD + d2 + 1] - cm[d2 + 1]) / zs[d2 + 1])
                 : 0u;
  };
  float sacc[NH][32];  // warpgroup dh < NH: state rows 64 dh .. + 63, one chain a half of v
  if constexpr (!STREAM) {
    for (int i = tid; i < tpad * (HD / 2); i += QC_CONSUMERS) {
      const int t = i / (HD / 2), d2 = 2 * (i % (HD / 2));
      *reinterpret_cast<uint32_t*>(es + half_swz(t, d2, tpad)) = e_pair(t, d2);
    }
    fence_proxy_async();
    named_barrier(1, QC_CONSUMERS);

    // state = E^T v (HD x HD, the depth is time), rounded, over ks
    if (wg < NH) {
      const uint64_t de = sw128_desc(es + wg * tpad * 128);
      wgmma_fence();
      for (int s = 0; s < tpad / 16; ++s)
#pragma unroll
        for (int lh = 0; lh < NH; ++lh)
          wgmma_m64n64_ss<1, 1>(sacc[lh], desc_add(de, 2048 * s),
                                desc_add(sw128_desc(vs + lh * tpad * 128), 2048 * s), s > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<32 * NH>(&sacc[0][0]);
    }
  } else {
    // a tile at a time into buffer i & 1 (rows 64 (i & 1) .. of the halves)
    for (int i = 0; i < tiles; ++i) {
      const int b = i & 1;
      named_barrier(1, QC_CONSUMERS);  // tile i - 2's steps are done: buffer b is free
      for (int j = tid; j < 64 * (HD / 2); j += QC_CONSUMERS) {
        const int r = j / (HD / 2), d2 = 2 * (j % (HD / 2));
        *reinterpret_cast<uint32_t*>(es + half_swz(64 * b + r, d2, QCS_ROWS)) =
            e_pair(64 * i + r, d2);
      }
      for (int j = tid; j < 64 * (HD / 8); j += QC_CONSUMERS) {
        const int r = j / (HD / 8), c8 = 8 * (j % (HD / 8));
        *reinterpret_cast<uint4*>(vs + half_swz(64 * b + r, c8, QCS_ROWS)) =
            *reinterpret_cast<const uint4*>(vh + (size_t)(64 * i + r) * HD + c8);
      }
      fence_proxy_async();
      named_barrier(1, QC_CONSUMERS);
      if (wg < NH) {
        const uint64_t de = sw128_desc(es + wg * QCS_ROWS * 128 + b * 8192);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int lh = 0; lh < NH; ++lh)
            wgmma_m64n64_ss<1, 1>(
                sacc[lh], desc_add(de, 2048 * s),
                desc_add(sw128_desc(vs + lh * QCS_ROWS * 128 + b * 8192), 2048 * s),
                i > 0 || s > 0);
        wgmma_commit();
        wgmma_wait<1>();  // tile i - 1's steps are done
      }
    }
    if (wg < NH) {
      wgmma_wait<0>();
      fence_regs<32 * NH>(&sacc[0][0]);
    }
    named_barrier(1, QC_CONSUMERS);  // every step is done with the buffers: the state goes there
  }
  if (wg < NH) {
#pragma unroll
    for (int lh = 0; lh < NH; ++lh)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = 16 * wl + g + 8 * half, col = 8 * j + 2 * c;
          // packed heads (HW < 64): zero off the block diagonal
          *reinterpret_cast<uint32_t*>(state + (wg * NH + lh) * 8192 + swz128(row, col)) =
              same_head(row, col) ? pack_bf16(sacc[lh][4 * j + 2 * half],
                                              sacc[lh][4 * j + 2 * half + 1])
                                  : 0u;
        }
    fence_proxy_async();
  }
  named_barrier(1, QC_CONSUMERS);

  // y = softmax_feat(q) (rounded) . state, per 64-row tile of this sequence
  for (int r = 0; r < rounds; ++r) {
    const int tile = QC_WG * r + wg;
    const bool active = tile < tiles;
    float qa[HD / 2];
    qc_project<HD>(qa, ring, full, empty, it, stages, kchunks, wg, active);
    if (!active) continue;
    fence_regs<HD / 2>(qa);
    qc_feature_softmax(qa, bq + h * HD, c);
    uint32_t pa[HD / 16][4];  // softmax_feat(q), rounded: the A operand of each 16-deep step
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      pa[j >> 1][2 * (j & 1)] = pack_bf16(qa[4 * j], qa[4 * j + 1]);
      pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(qa[4 * j + 2], qa[4 * j + 3]);
    }
    float ya[32 * NH];  // column 64 lh + 8 j + 2 c + e % 2 at ya[32 lh + 4 j + e]
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < HD / 16; ++s)
#pragma unroll
      for (int lh = 0; lh < NH; ++lh)
        wgmma_m64n64_rs<1>(ya + 32 * lh, pa[s],
                           desc_add(sw128_desc(state + ((s / 4) * NH + lh) * 8192),
                                    2048 * (s % 4)),
                           s > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32 * NH>(ya);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = 64 * tile + 16 * wl + g + 8 * half;
      if (t >= T) continue;
      float* yr = y + ((size_t)n * T + t) * D + h * HD + 2 * c;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(yr + 8 * j) =
            make_float2(ya[4 * j + 2 * half], ya[4 * j + 2 * half + 1]);
    }
  }
}

// out = (z Wo^T + bo) + x, rounded once: 128 x 64 tiles, two consumer
// warpgroups of 64 rows and a producer warp with a 4-stage TMA ring.
constexpr int WO_BM = 128, WO_BN = 64, WO_STAGES = 4;
constexpr uint32_t WO_A_BYTES = WO_BM * 64 * 2, WO_W_BYTES = WO_BN * 64 * 2;
constexpr uint32_t WO_STAGE_BYTES = WO_A_BYTES + WO_W_BYTES;
constexpr int WO_SMEM = WO_STAGES * WO_STAGE_BYTES + 2 * WO_STAGES * 8 + 1024;

__global__ void __launch_bounds__(QC_THREADS, 1) out_gemm_bf16_kernel(
    const __grid_constant__ CUtensorMap tz, const __grid_constant__ CUtensorMap two,
    const bf16* __restrict__ bo, const bf16* __restrict__ resid, bf16* __restrict__ out, int M,
    int D) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + WO_STAGES * WO_STAGE_BYTES);
  uint64_t* empty = full + WO_STAGES;
  const int n0 = blockIdx.x * WO_BN, m0 = blockIdx.y * WO_BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kchunks = D / 64;
  if (tid == 0) {
    for (int s = 0; s < WO_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (warp == 8) {
    if (lane == 0) {
      for (int kc = 0; kc < kchunks; ++kc) {
        const int st = kc % WO_STAGES;
        mbar_wait(&empty[st], ((kc / WO_STAGES) & 1) ^ 1);
        unsigned char* sb = ring + st * WO_STAGE_BYTES;
        mbar_arrive_expect_tx(&full[st], WO_STAGE_BYTES);
        tma_load_3d(sb, &tz, &full[st], 64 * kc, m0, 0);
        tma_load_3d(sb + WO_A_BYTES, &two, &full[st], 64 * kc, n0, 0);
      }
    }
    return;
  }
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, c = lane & 3;
  float acc[32];
  for (int kc = 0; kc < kchunks; ++kc) {
    const int st = kc % WO_STAGES;
    mbar_wait(&full[st], (kc / WO_STAGES) & 1);
    unsigned char* sb = ring + st * WO_STAGE_BYTES;
    const uint64_t da = sw128_desc(sb + wg * (WO_A_BYTES / 2)), dw = sw128_desc(sb + WO_A_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64_ss<0, 0>(acc, desc_add(da, 32 * kk), desc_add(dw, 32 * kk), kc > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous chunk's products are done: release its stage
    if (kc > 0) mbar_arrive(&empty[(kc - 1) % WO_STAGES]);
  }
  wgmma_wait<0>();
  mbar_arrive(&empty[(kchunks - 1) % WO_STAGES]);
  fence_regs<32>(acc);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + 64 * wg + 16 * wl + g + 8 * half;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + 8 * j + 2 * c;
      const float2 b = load2(bo + col);
      const float2 x = load2(resid + (size_t)row * D + col);
      store2(out + (size_t)row * D + col, (acc[4 * j + 2 * half] + b.x) + x.x,
             (acc[4 * j + 2 * half + 1] + b.y) + x.y);
    }
  }
}


// The q|k|v + core launch of either form (scratch: the streaming form's).
template <bool STREAM>
cudaError_t launch_qkv_core_bf16(const bf16* xz, const bf16* wq, const bf16* bq,
                                 const bf16* wk, const bf16* bk, const bf16* wv,
                                 const bf16* bv, const float* mask, float* y, float* kscr,
                                 bf16* vscr, int N, int T, int D, int interaction,
                                 cudaStream_t stream) {
  const int tpad = (T + 63) / 64 * 64;
  if (!STREAM && tpad > qc_whole_max_t(1, 2)) return cudaErrorInvalidValue;
  CUtensorMap mx, mq, mk, mv;
  cudaError_t err = make_tile_map(&mx, xz, D, T, N, D, 64);
  if (err == cudaSuccess) err = make_tile_map(&mq, wq, D, D, 1, D, 64);
  if (err == cudaSuccess) err = make_tile_map(&mk, wk, D, D, 1, D, 64);
  if (err == cudaSuccess) err = make_tile_map(&mv, wv, D, D, 1, D, 64);
  if (err != cudaSuccess) return err;
  int stages, smem;
  if (STREAM) {
    const int fit = (SMEM_MAX - 1024 - qcs_fixed_smem()) / (int)QC_STAGE_BYTES;
    stages = fit < QC_MAX_STAGES ? fit : QC_MAX_STAGES;
    smem = 1024 + stages * (int)QC_STAGE_BYTES + qcs_fixed_smem();
  } else {
    stages = qc_stages(tpad);
    smem = qc_smem(tpad);
  }
  err = cudaFuncSetAttribute(qkv_core_bf16_kernel<STREAM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  qkv_core_bf16_kernel<STREAM><<<N * (D / HD), QC_THREADS, smem, stream>>>(
      mx, mq, mk, mv, bq, bk, bv, mask, y, kscr, vscr, T, D, D / HD, interaction, stages);
  return cudaGetLastError();
}

// part < 0 runs the four launches in order; part 0..3 only that launch (to
// time each one). kscr and vscr: the streaming form's scratch (STREAM).
template <bool STREAM>
int fused_block_bf16(const bf16* x, const float* mask, const bf16* scale, const bf16* shift,
                     const bf16* ln_g, const bf16* ln_b, const bf16* wq, const bf16* bq,
                     const bf16* wk, const bf16* bk, const bf16* wv, const bf16* bv,
                     const bf16* styl_g, const bf16* styl_b, const bf16* wo, const bf16* bo,
                     bf16* xz, float* y, bf16* out, float* kscr, bf16* vscr, int N, int T,
                     int D, int interaction, int part, cudaStream_t stream) {
  const int M = N * T;
  if (D % HD) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;

  if (part < 0 || part == 0) {
    err = launch_row_norm<false>(x, xz, ln_g, ln_b, nullptr, nullptr, M, D, T, stream);
    if (err != cudaSuccess) return err;
  }
  if (part < 0 || part == 1) {
    err = launch_qkv_core_bf16<STREAM>(xz, wq, bq, wk, bk, wv, bv, mask, y, kscr, vscr, N, T,
                                       D, interaction, stream);
    if (err != cudaSuccess) return err;
  }
  if (part < 0 || part == 2) {
    err = launch_row_norm<true>(static_cast<const float*>(y), xz, styl_g, styl_b, scale, shift,
                                M, D, T, stream);
    if (err != cudaSuccess) return err;
  }
  if (part < 0 || part == 3) {
    CUtensorMap mz, mo;
    err = make_tile_map(&mz, xz, D, M, 1, D, WO_BM);
    if (err == cudaSuccess) err = make_tile_map(&mo, wo, D, D, 1, D, 64);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(out_gemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WO_SMEM);
    if (err != cudaSuccess) return err;
    const dim3 grid(D / WO_BN, (M + WO_BM - 1) / WO_BM);
    out_gemm_bf16_kernel<<<grid, QC_THREADS, WO_SMEM, stream>>>(mz, mo, bo, x, out, M, D);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace hig

// B1-bf16's whole form (T up to hig_fused_block_bf16_max_t's rows).
// Returns the first cudaError_t.
extern "C" int hig_fused_block_bf16(
    const hig::bf16* x, const float* mask, const hig::bf16* scale, const hig::bf16* shift,
    const hig::bf16* ln_g, const hig::bf16* ln_b,
    const hig::bf16* wq, const hig::bf16* bq, const hig::bf16* wk, const hig::bf16* bk,
    const hig::bf16* wv, const hig::bf16* bv,
    const hig::bf16* styl_g, const hig::bf16* styl_b, const hig::bf16* wo,
    const hig::bf16* bo, hig::bf16* xz, float* y, hig::bf16* out,
    int N, int T, int D, int interaction, int part, void* stream_ptr) {
  return hig::fused_block_bf16<false>(x, mask, scale, shift, ln_g, ln_b, wq, bq, wk, bk, wv, bv,
                                      styl_g, styl_b, wo, bo, xz, y, out, nullptr, nullptr, N,
                                      T, D, interaction, part,
                                      static_cast<cudaStream_t>(stream_ptr));
}

// B1-bf16's streaming form, any T: kscr (N * D / HD, tpad, HD) float32 and
// vscr (the same) bfloat16 scratch, tpad = T rounded up to 64.
extern "C" int hig_fused_block_bf16_stream(
    const hig::bf16* x, const float* mask, const hig::bf16* scale, const hig::bf16* shift,
    const hig::bf16* ln_g, const hig::bf16* ln_b,
    const hig::bf16* wq, const hig::bf16* bq, const hig::bf16* wk, const hig::bf16* bk,
    const hig::bf16* wv, const hig::bf16* bv,
    const hig::bf16* styl_g, const hig::bf16* styl_b, const hig::bf16* wo,
    const hig::bf16* bo, hig::bf16* xz, float* y, hig::bf16* out, float* kscr,
    hig::bf16* vscr, int N, int T, int D, int interaction, int part, void* stream_ptr) {
  return hig::fused_block_bf16<true>(x, mask, scale, shift, ln_g, ln_b, wq, bq, wk, bk, wv, bv,
                                     styl_g, styl_b, wo, bo, xz, y, out, kscr, vscr, N, T, D,
                                     interaction, part, static_cast<cudaStream_t>(stream_ptr));
}

// The most key rows of B1-bf16's whole form at this library's head width.
extern "C" int hig_fused_block_bf16_max_t() { return hig::qc_whole_max_t(1, 2); }
