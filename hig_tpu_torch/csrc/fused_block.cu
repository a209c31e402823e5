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
// fused_block.py:56-96): (1) the row pass reads x, takes LayerNorm in
// float32 and writes xn as bfloat16 into `xz`; (2) the bfloat16 QKV GEMM
// writes float32 q | k | v with the bias; (3) the ROUND core writes float32
// y from the rounded softmax_t(k), v, state and softmax_d(q); (4) the row
// pass writes z = SiLU(LN_styl(y) * (1 + scale) + shift), float32 inside,
// as bfloat16 into `xz`; (5) the bfloat16 Wo GEMM adds bo and x in float32
// and stores `out` as bfloat16. mask is float32 (N, T); scale and shift
// bfloat16 (N, D). Returns the first cudaError_t.
extern "C" int hig_fused_block_bf16(
    const hig::bf16* x, const float* mask, const hig::bf16* scale, const hig::bf16* shift,
    const hig::bf16* ln_g, const hig::bf16* ln_b,
    const hig::bf16* wq, const hig::bf16* bq, const hig::bf16* wk, const hig::bf16* bk,
    const hig::bf16* wv, const hig::bf16* bv,
    const hig::bf16* styl_g, const hig::bf16* styl_b, const hig::bf16* wo,
    const hig::bf16* bo, hig::bf16* xz, float* qkv, float* y, hig::bf16* out,
    int N, int T, int D, int interaction, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int M = N * T;

  cudaError_t err = hig::launch_row_norm<false>(x, xz, ln_g, ln_b, nullptr, nullptr, M, D, T,
                                                stream);
  if (err != cudaSuccess) return err;

  hig::GemmArgsBf16 a{};
  a.a0 = xz; a.a1 = xz;
  a.w0 = wq; a.w1 = wk; a.w2 = wv;
  a.b0 = bq; a.b1 = bk; a.b2 = bv;
  a.out = qkv;
  a.M = M; a.K = D; a.D = D; a.ldo = 3 * D;
  err = hig::launch_gemm_bf16_qkv(a, stream);
  if (err != cudaSuccess) return err;

  err = hig::launch_core_qkv<true>(qkv, mask, y, N, T, D, interaction, stream);
  if (err != cudaSuccess) return err;

  err = hig::launch_row_norm<true>(static_cast<const float*>(y), xz, styl_g, styl_b, scale,
                                   shift, M, D, T, stream);
  if (err != cudaSuccess) return err;

  hig::GemmArgsBf16 c{};
  c.a0 = xz; c.a1 = xz;
  c.w0 = wo; c.w1 = wo; c.w2 = wo;
  c.b0 = bo; c.b1 = bo; c.b2 = bo;
  c.resid = x;
  c.out = out;
  c.M = M; c.K = D; c.D = D; c.ldo = D;
  return hig::launch_gemm_bf16_out(c, stream);
}
