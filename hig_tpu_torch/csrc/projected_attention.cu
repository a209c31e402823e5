// B2: efficient attention with the Q/K/V projections fused in, forward.
// Replaces hig_tpu/ops/pallas_attention.py::_proj_kernel (Pallas TPU).
//
//   q = q_src Wq + bq;  k, v = kv_src Wk + bk, kv_src Wv + bv
//   k += (1 - mask) * -1e6; v *= mask
//   per head: y_h = softmax_feat(q_h) . [softmax_time(k_h)^T v_h]
//
// Two launches on the caller's stream (linear_attention.cuh has the
// design): the 3xTF32 QKV GEMM (q columns from q_src, k/v columns from
// kv_src) into `qkv`, then the attention core into `out` (N, T, D).
// Returns the first cudaError_t.
#include "linear_attention.cuh"

extern "C" int hig_projected_attention(
    const float* q_src, const float* kv_src,
    const float* wq, const float* bq, const float* wk, const float* bk,
    const float* wv, const float* bv, const float* mask,
    float* qkv, float* out, int N, int T, int D, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);

  hig::GemmArgs a{};
  a.a0 = q_src; a.a1 = kv_src;
  a.w0 = wq; a.w1 = wk; a.w2 = wv;
  a.b0 = bq; a.b1 = bk; a.b2 = bv;
  a.out = qkv;
  a.M = N * T; a.K = D; a.D = D; a.ldo = 3 * D;
  const cudaError_t err = hig::launch_gemm_qkv(a, stream);
  if (err != cudaSuccess) return err;
  return hig::launch_core_qkv(qkv, mask, out, N, T, D, 0, stream);
}

// B2-bf16: bfloat16 activations and weights, as the Pallas kernel computes
// them for dt = bfloat16 (hig_tpu/ops/pallas_attention.py:116-137): the
// bfloat16 QKV GEMM writes float32 q | k | v with the bias into `qkv`, the
// float32 core (no cast inside, as in Pallas) stores y as bfloat16 into
// `out` (N, T, D). Returns the first cudaError_t.
extern "C" int hig_projected_attention_bf16(
    const hig::bf16* q_src, const hig::bf16* kv_src,
    const hig::bf16* wq, const hig::bf16* bq, const hig::bf16* wk, const hig::bf16* bk,
    const hig::bf16* wv, const hig::bf16* bv, const float* mask,
    float* qkv, hig::bf16* out, int N, int T, int D, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);

  hig::GemmArgsBf16 a{};
  a.a0 = q_src; a.a1 = kv_src;
  a.w0 = wq; a.w1 = wk; a.w2 = wv;
  a.b0 = bq; a.b1 = bk; a.b2 = bv;
  a.out = qkv;
  a.M = N * T; a.K = D; a.D = D; a.ldo = 3 * D;
  const cudaError_t err = hig::launch_gemm_bf16_qkv(a, stream);
  if (err != cudaSuccess) return err;
  return hig::launch_core_qkv(qkv, mask, out, N, T, D, 0, stream);
}
