// The ordered bfloat16 sum of the port's bfloat16 backwards: the sum over one
// axis of bfloat16 values, rounded to bfloat16 after every add, in the order
// XLA's CPU backend adds a bfloat16 array that it does not upcast (its
// tree-reduction rewriter): up to 32 terms in turn; a longer axis is
// zero-padded to a multiple of 32, the zeros split between its two ends (the
// smaller half first), each window of 32 summed in turn, and the window sums
// summed the same way, level after level. softmax_vjp (models/embeddings.py) takes it in every
// bfloat16 softmax's gradient: B3-bf16's and B4-bf16's backwards and the
// model's bfloat16 softmaxes. A float32 sum rounded once sits 0.3-0.7 of the
// bfloat16 effect from XLA's gradients (PERF.md), so the order is kept.
//
// Replaces no TPU kernel (XLA's reduce in the VJPs). Bound on this card:
// bytes, each input read once (one B3-bf16 backward's two sums at 128 x 91:
// 48 MB, 0.0144 ms). The input is a contiguous float32 array (outer, n,
// inner) holding bfloat16 values, the output (outer, inner). One kernel, so
// that a profile names one kernel: up to 32 * 32 terms (two levels of
// windows) one launch, with a thread per (output, window of 32) and
// blockDim (outputs, windows): every thread issues its window's 32 loads before its chain of
// rounded adds, and thread y = 0 of each output chains the window totals in
// order through shared memory. Where the axis is strided (inner > 1: the
// time softmax's 91 terms 512 apart, the key softmax's 8 apart),
// neighbouring threads take neighbouring inner elements, so every load
// coalesces. Where it is contiguous (inner == 1: the feature softmax's 64
// terms), a block first stages its rows in shared memory with coalesced
// 16-byte loads, each row at an odd stride so that 32 threads reading 32
// rows hit 32 banks, and its threads walk the rows there. Past 32 * 32
// terms each level of windows that more terms need comes first, one launch
// of the same kernel each (`partial`: a thread per (output, window) writes
// the window's sum into a scratch array (outer, windows, inner), which the
// next level sums), until at most 32 * 32 sums are left for the launch
// above: 2 launches up to 32^3 terms.
#include "common.cuh"

namespace hig {

constexpr int SUM_WINDOW = 32;
constexpr int SUM_MAX_TERMS = SUM_WINDOW * SUM_WINDOW;
constexpr int SUM_THREADS = 256;  // a block's threads, about
constexpr int SUM_ROWS_FLOATS = 10240;  // staged rows (inner == 1): 40 KB

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Window w of one output whose terms are term(i), i in [0, n): its 32 terms
// (zeros where the padded axis lies past either end) loaded first, then
// added in turn, each add rounded; up to 32 terms, the n terms alone.
template <typename Term>
__device__ __forceinline__ float window_sum(Term term, int n, int w, int lead) {
  float v[SUM_WINDOW];
#pragma unroll
  for (int c = 0; c < SUM_WINDOW; ++c) {
    const int i = w * SUM_WINDOW + c - lead;
    v[c] = (i >= 0 && i < n) ? round_bf16(term(i)) : 0.f;
  }
  const int terms = n < SUM_WINDOW ? n : SUM_WINDOW;
  float acc = v[0];
#pragma unroll
  for (int c = 1; c < SUM_WINDOW; ++c)
    if (c < terms) acc = round_bf16(acc + v[c]);
  return acc;
}

// A level of `windows` window sums a output past SUM_MAX_TERMS terms, one
// thread each (neighbouring threads: neighbouring outputs of one window),
// into out (outer, windows, inner). Not inlined, so that the kernel's
// one-launch path keeps its own registers and code.
__device__ __noinline__ void bf16_sum_level(const float* __restrict__ x,
                                            float* __restrict__ out, int outer, int n,
                                            int inner, int lead, int windows) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long outputs = (long long)outer * inner;
  if (i >= outputs * windows) return;
  const long long o = i % outputs, a = o / inner, b = o % inner;
  const int w = (int)(i / outputs);
  const float* p = x + a * n * inner + b;
  out[(a * windows + w) * inner + b] =
      window_sum([&](int k) { return p[(long long)k * inner]; }, n, w, lead);
}

// blockDim (ox, windows); `lead` zeros pad the axis before x[0]; `stride`
// is a staged row's (inner == 1). partial > 0: a level of `partial` window
// sums (bf16_sum_level).
__global__ void __launch_bounds__(SUM_WINDOW * SUM_WINDOW)
    bf16_sum_kernel(const float* __restrict__ x, float* __restrict__ out, int outer, int n,
                    int inner, int lead, int stride, int partial) {
  extern __shared__ float sm[];  // inner == 1: [ox][stride] rows; then [windows][ox] sums
  if (partial) {
    bf16_sum_level(x, out, outer, n, inner, lead, partial);
    return;
  }
  const int ox = blockDim.x, windows = blockDim.y, xo = threadIdx.x, w = threadIdx.y;
  const long long o = (long long)blockIdx.x * ox + xo, outputs = (long long)outer * inner;
  float s = 0.f;
  if (inner == 1) {
    const long long r0 = (long long)blockIdx.x * ox;
    const int rows = (int)(outer - r0 < ox ? outer - r0 : ox), count = rows * n;
    const int tid = w * ox + xo, threads = ox * windows;
    const float* base = x + r0 * n;
    if (n % 4 == 0 && (reinterpret_cast<size_t>(base) & 15) == 0) {
#pragma unroll 4
      for (int j = tid; j < count / 4; j += threads) {
        const float4 f = load4(base + 4 * j);
        const int r = 4 * j / n;
        float* d = sm + r * stride + (4 * j - r * n);
        d[0] = f.x;
        d[1] = f.y;
        d[2] = f.z;
        d[3] = f.w;
      }
    } else {
#pragma unroll 4
      for (int j = tid; j < count; j += threads) {
        const int r = j / n;
        sm[r * stride + (j - r * n)] = base[j];
      }
    }
    __syncthreads();
    const float* row = sm + xo * stride;
    if (xo < rows) s = window_sum([&](int i) { return row[i]; }, n, w, lead);
  } else if (o < outputs) {
    const float* p = x + (o / inner) * n * inner + o % inner;
    s = window_sum([&](int i) { return p[(long long)i * inner]; }, n, w, lead);
  }
  if (windows == 1) {
    if (o < outputs) out[o] = s;
    return;
  }
  float* part = sm + (inner == 1 ? ox * stride : 0);
  part[w * ox + xo] = s;
  __syncthreads();
  if (w == 0 && o < outputs) {
    float total = part[xo];
    for (int k = 1; k < windows; ++k) total = round_bf16(total + part[k * ox + xo]);
    out[o] = total;
  }
}

}  // namespace hig

namespace hig {

// The sum of n <= SUM_MAX_TERMS terms in one launch.
inline cudaError_t launch_bf16_sum(const float* x, float* out, int outer, int n, int inner,
                                   cudaStream_t stream) {
  const long long outputs = (long long)outer * inner;
  const int windows = n <= SUM_WINDOW ? 1 : (n + SUM_WINDOW - 1) / SUM_WINDOW;
  const int lead = (SUM_WINDOW - n % SUM_WINDOW) % SUM_WINDOW / 2 * (windows > 1);
  // outputs a block: strided, a multiple of 32 (whole warps of neighbouring
  // inner elements); staged, as many rows as SUM_ROWS_FLOATS holds
  int ox = SUM_THREADS / windows / 32 * 32, stride = 0;
  if (ox < 32) ox = 32;
  if (inner == 1) {
    stride = n | 1;
    ox = SUM_THREADS / windows;
    if (ox * stride > SUM_ROWS_FLOATS) ox = SUM_ROWS_FLOATS / stride;
  }
  const int smem = 4 * (ox * stride + (windows > 1 ? windows * ox : 0));
  bf16_sum_kernel<<<(unsigned)((outputs + ox - 1) / ox), dim3(ox, windows), smem, stream>>>(
      x, out, outer, n, inner, lead, stride, 0);
  return cudaGetLastError();
}

}  // namespace hig

// scratch: (outer, sum of each level's windows, inner) floats for the
// levels past SUM_MAX_TERMS (none up to it; ops/bf16_sum.py sizes it).
extern "C" int hig_bf16_sum(const float* x, float* out, float* scratch, int outer, int n,
                            int inner, void* stream_ptr) {
  using namespace hig;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1) return cudaErrorInvalidValue;
  const long long outputs = (long long)outer * inner;
  if (outputs == 0) return cudaSuccess;
  const float* src = x;
  while (n > SUM_MAX_TERMS) {  // a level of window sums into the scratch
    const int windows = (n + SUM_WINDOW - 1) / SUM_WINDOW;
    const int lead = (SUM_WINDOW - n % SUM_WINDOW) % SUM_WINDOW / 2;
    const long long threads = outputs * windows;
    bf16_sum_kernel<<<(unsigned)((threads + SUM_THREADS - 1) / SUM_THREADS), SUM_THREADS, 0,
                      stream>>>(src, scratch, outer, n, inner, lead, 0, windows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    src = scratch;
    scratch += outputs * windows;
    n = windows;
  }
  return launch_bf16_sum(src, out, outer, n, inner, stream);
}
