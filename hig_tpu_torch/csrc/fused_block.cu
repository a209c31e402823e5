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
// Three launches on the caller's stream: (a) LN + QKV GEMM into `qkv`,
// (b) the attention core into `y`, (c) LN + AdaLN + SiLU + Wo GEMM with the
// bias and residual into `out`. Returns the cudaError_t of the launches.
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

  hig::GemmArgs a{};
  a.a0 = x; a.a1 = x;
  a.w0 = wq; a.w1 = wk; a.w2 = wv;
  a.b0 = bq; a.b1 = bk; a.b2 = bv;
  a.ln_g = ln_g; a.ln_b = ln_b;
  a.out = qkv;
  a.M = M; a.K = D; a.D = D; a.T = T; a.ldo = 3 * D;
  hig::launch_gemm(hig::QKV_LN, a, 3 * D, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  hig::launch_core_qkv(qkv, mask, y, N, T, D, interaction, stream);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  hig::GemmArgs c{};
  c.a0 = y; c.a1 = y;
  c.w0 = wo; c.w1 = wo; c.w2 = wo;
  c.b0 = bo; c.b1 = bo; c.b2 = bo;
  c.ln_g = styl_g; c.ln_b = styl_b;
  c.scale = scale; c.shift = shift;
  c.resid = x;
  c.out = out;
  c.M = M; c.K = D; c.D = D; c.T = T; c.ldo = D;
  hig::launch_gemm(hig::OUT_STYL, c, D, stream);
  return cudaGetLastError();
}
