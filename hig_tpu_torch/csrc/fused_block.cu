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
// mask is float32 (N, T); scale and shift bfloat16 (N, D). T <= QC_MAX_T
// (the rows of one sequence that shared memory holds).

namespace hig {

__global__ void __launch_bounds__(QC_THREADS, 1) qkv_core_bf16_kernel(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap twq,
    const __grid_constant__ CUtensorMap twk, const __grid_constant__ CUtensorMap twv,
    const bf16* __restrict__ bq, const bf16* __restrict__ bk, const bf16* __restrict__ bv,
    const float* __restrict__ mask, float* __restrict__ y, int T, int D, int H,
    int interaction, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);  // [stages]: xn tile 0, xn tile 1, W (128 rows)
  const int tiles = (T + 63) / 64, tpad = 64 * tiles;
  float* ks = reinterpret_cast<float*>(ring + stages * QC_STAGE_BYTES);  // [tpad][64] k
  unsigned char* es = reinterpret_cast<unsigned char*>(ks) + tpad * 256;  // softmax_t(k), bf16
  unsigned char* vs = es + tpad * 128;                                     // v, bf16
  float* red = reinterpret_cast<float*>(vs + tpad * 128);                  // [4][64]
  float* cm = red + 4 * 64;                                                // column max
  float* zs = cm + 64;                                                     // column sums
  uint64_t* full = reinterpret_cast<uint64_t*>(zs + 64);
  uint64_t* empty = full + QC_MAX_STAGES;
  unsigned char* state = reinterpret_cast<unsigned char*>(ks);  // once E is built, bf16 64 x 64

  const int n = blockIdx.x / H, h = blockIdx.x % H;
  const int src = interaction ? (n ^ 1) : n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rounds = (tiles + QC_WG - 1) / QC_WG, kchunks = D / 64;

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
      qc_produce(&tx, &tx, QcWeights{&twq, &twk, &twv, 64 * h, 64 * h, 64 * h}, src, n, ring,
                 full, empty, stages, tiles, kchunks);
    return;
  }

  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, c = lane & 3;
  int it = 0;

  // k | v = kvn [Wk | Wv]^T + [bk | bv]: 64-row tiles of the key rows
  for (int r = 0; r < rounds; ++r) {
    const int tile = QC_WG * r + wg;
    const bool active = tile < tiles;  // uniform over the warpgroup
    float acc[64];
    qc_project<128>(acc, ring, full, empty, it, stages, kchunks, wg, active);
    if (active) {
      fence_regs<64>(acc);
      // k += (1 - mask) * -1e6 into ks (float32); v * mask, rounded, into vs;
      // rows past T: v = 0 (and k unread)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = 64 * tile + 16 * wl + g + 8 * half;
        const bool valid = t < T;
        const float mt = valid ? mask[(size_t)src * T + t] : 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = 8 * (j & 7) + 2 * c;
          const float a0 = acc[4 * j + 2 * half], a1 = acc[4 * j + 2 * half + 1];
          if (j < 8) {
            const float2 b = load2(bk + h * HD + col);
            *reinterpret_cast<float2*>(ks + t * 64 + col) =
                make_float2(a0 + b.x + (1.f - mt) * MASK_BIAS, a1 + b.y + (1.f - mt) * MASK_BIAS);
          } else {
            const float2 b = load2(bv + h * HD + col);
            *reinterpret_cast<uint32_t*>(vs + swz128(t, col)) =
                valid ? pack_bf16((a0 + b.x) * mt, (a1 + b.y) * mt) : 0u;
          }
        }
      }
    }
  }
  named_barrier(1, QC_CONSUMERS);

  // column max and sums over the T keys, then E = softmax_time(k) rounded
  qc_column_stats(ks, T, tid, red, cm, zs, [](int t, int d) { return t * 64 + d; });
  for (int i = tid; i < tpad * 32; i += QC_CONSUMERS) {
    const int t = i >> 5, d2 = 2 * (i & 31);
    uint32_t e = 0u;
    if (t < T)
      e = pack_bf16(expf(ks[t * 64 + d2] - cm[d2]) / zs[d2],
                    expf(ks[t * 64 + d2 + 1] - cm[d2 + 1]) / zs[d2 + 1]);
    *reinterpret_cast<uint32_t*>(es + swz128(t, d2)) = e;
  }
  fence_proxy_async();
  named_barrier(1, QC_CONSUMERS);

  // state = E^T v (64 x 64, the depth is time), rounded, over ks
  if (wg == 0) {
    float sacc[32];
    const uint64_t de = sw128_desc(es), dv = sw128_desc(vs);
    wgmma_fence();
    for (int s = 0; s < tpad / 16; ++s)
      wgmma_m64n64_ss<1, 1>(sacc, desc_add(de, 2048 * s), desc_add(dv, 2048 * s), s > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(sacc);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<uint32_t*>(state + swz128(16 * wl + g + 8 * half, 8 * j + 2 * c)) =
            pack_bf16(sacc[4 * j + 2 * half], sacc[4 * j + 2 * half + 1]);
    fence_proxy_async();
  }
  named_barrier(1, QC_CONSUMERS);

  // y = softmax_feat(q) (rounded) . state, per 64-row tile of this sequence
  const uint64_t dst = sw128_desc(state);
  for (int r = 0; r < rounds; ++r) {
    const int tile = QC_WG * r + wg;
    const bool active = tile < tiles;
    float qa[32];
    qc_project<64>(qa, ring, full, empty, it, stages, kchunks, wg, active);
    if (!active) continue;
    fence_regs<32>(qa);
    qc_feature_softmax(qa, bq + h * HD, c);
    uint32_t pa[4][4];  // softmax_feat(q), rounded: the A operand of each 16-deep step
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pa[j >> 1][2 * (j & 1)] = pack_bf16(qa[4 * j], qa[4 * j + 1]);
      pa[j >> 1][2 * (j & 1) + 1] = pack_bf16(qa[4 * j + 2], qa[4 * j + 3]);
    }
    float ya[32];
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) wgmma_m64n64_rs<1>(ya, pa[s], desc_add(dst, 2048 * s), s > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<32>(ya);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = 64 * tile + 16 * wl + g + 8 * half;
      if (t >= T) continue;
      float* yr = y + ((size_t)n * T + t) * D + h * HD + 2 * c;
#pragma unroll
      for (int j = 0; j < 8; ++j)
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

}  // namespace hig

// part < 0 runs the four launches in order; part 0..3 only that launch (to
// time each one). Returns the first cudaError_t.
extern "C" int hig_fused_block_bf16(
    const hig::bf16* x, const float* mask, const hig::bf16* scale, const hig::bf16* shift,
    const hig::bf16* ln_g, const hig::bf16* ln_b,
    const hig::bf16* wq, const hig::bf16* bq, const hig::bf16* wk, const hig::bf16* bk,
    const hig::bf16* wv, const hig::bf16* bv,
    const hig::bf16* styl_g, const hig::bf16* styl_b, const hig::bf16* wo,
    const hig::bf16* bo, hig::bf16* xz, float* y, hig::bf16* out,
    int N, int T, int D, int interaction, int part, void* stream_ptr) {
  using namespace hig;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int M = N * T;
  if (T > QC_MAX_T || D % 64) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;

  if (part < 0 || part == 0) {
    err = launch_row_norm<false>(x, xz, ln_g, ln_b, nullptr, nullptr, M, D, T, stream);
    if (err != cudaSuccess) return err;
  }
  if (part < 0 || part == 1) {
    CUtensorMap mx, mq, mk, mv;
    err = make_tile_map(&mx, xz, D, T, N, D, 64);
    if (err == cudaSuccess) err = make_tile_map(&mq, wq, D, D, 1, D, 64);
    if (err == cudaSuccess) err = make_tile_map(&mk, wk, D, D, 1, D, 64);
    if (err == cudaSuccess) err = make_tile_map(&mv, wv, D, D, 1, D, 64);
    if (err != cudaSuccess) return err;
    const int tpad = (T + 63) / 64 * 64, smem = qc_smem(tpad);
    err = cudaFuncSetAttribute(qkv_core_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    qkv_core_bf16_kernel<<<N * (D / HD), QC_THREADS, smem, stream>>>(
        mx, mq, mk, mv, bq, bk, bv, mask, y, T, D, D / HD, interaction, qc_stages(tpad));
    err = cudaGetLastError();
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
