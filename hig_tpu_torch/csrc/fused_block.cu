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
