// The ordered bfloat16 sum of the port's bfloat16 backwards: the sum over one
// axis of bfloat16 values, rounded to bfloat16 after every add, in the order
// XLA's CPU backend adds a bfloat16 array that it does not upcast (its
// tree-reduction rewriter): up to 32 terms in turn; a longer axis is
// zero-padded to a multiple of 32, the zeros split between its two ends (the
// smaller half first), each window of 32 summed in turn, and the window sums
// summed in turn. softmax_vjp (models/embeddings.py) takes it in every
// bfloat16 softmax's gradient: B3-bf16's and B4-bf16's backwards and the
// model's bfloat16 softmaxes. A float32 sum rounded once sits 0.3-0.7 of the
// bfloat16 effect from XLA's gradients (PERF.md), so the order is kept.
//
// One thread per output element walks its axis; the input is a contiguous
// float32 array (outer, n, inner) holding bfloat16 values, the output
// (outer, inner). Neighbouring threads take neighbouring inner elements, so
// the loads coalesce where inner > 1. n <= 32 * 32 (two levels of windows).
#include "common.cuh"

namespace hig {

constexpr int SUM_WINDOW = 32;
constexpr int SUM_THREADS = 256;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(SUM_THREADS)
    bf16_sum_kernel(const float* __restrict__ x, float* __restrict__ out, int outer, int n,
                    int inner) {
  const long long t = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (t >= (long long)outer * inner) return;
  const long long o = t / inner, j = t % inner;
  const float* p = x + o * n * inner + j;
  if (n <= SUM_WINDOW) {
    float acc = round_bf16(p[0]);
    for (int i = 1; i < n; ++i) acc = round_bf16(acc + round_bf16(p[(long long)i * inner]));
    out[t] = acc;
    return;
  }
  const int lead = (SUM_WINDOW - n % SUM_WINDOW) % SUM_WINDOW / 2;  // zeros before x[0]
  const int windows = (n + SUM_WINDOW - 1) / SUM_WINDOW;
  float total = 0.f;
  for (int w = 0; w < windows; ++w) {
    float acc = 0.f;
    for (int c = 0; c < SUM_WINDOW; ++c) {
      const int i = w * SUM_WINDOW + c - lead;
      const float v = (i >= 0 && i < n) ? round_bf16(p[(long long)i * inner]) : 0.f;
      acc = c == 0 ? v : round_bf16(acc + v);
    }
    total = w == 0 ? acc : round_bf16(total + acc);
  }
  out[t] = total;
}

}  // namespace hig

extern "C" int hig_bf16_sum(const float* x, float* out, int outer, int n, int inner,
                            void* stream_ptr) {
  using namespace hig;
  if (n > SUM_WINDOW * SUM_WINDOW) return cudaErrorInvalidValue;
  const long long threads = (long long)outer * inner;
  if (threads == 0) return cudaSuccess;
  bf16_sum_kernel<<<(unsigned)((threads + SUM_THREADS - 1) / SUM_THREADS), SUM_THREADS, 0,
                    static_cast<cudaStream_t>(stream_ptr)>>>(x, out, outer, n, inner);
  return cudaGetLastError();
}
