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
// Design. Grid (N*H, ceil(Tq / 64)); 256 threads; each query row belongs to
// a quad of 4 lanes. A thread keeps its row of q (scaled) in 64 registers
// and 16 of the row's 64 output columns in registers; the quad shares the
// running max and sum of the online softmax through shuffles. Keys stream
// through shared memory in chunks of 32 rows of k and v (8 + 8 KB, k rows
// padded to 68 floats so the 4 lanes of a quad read 4 different banks);
// the lane at quad position p scores keys p, p + 4, ..., p + 28 of a
// chunk, and the quad hands the probabilities to each other by shuffle for
// the P . V product. Keys past Tk score -inf; a chunk always ends with the row's max
// finite because key 0 exists, so exp never sees -inf - -inf. Products are
// float32 FMAs; the output is written once.
//
// Bound on this card: at N = 16, H = 8, T = 91 the work is
// 4 * N * H * T^2 * 64 = 0.27 GFLOP against 12 MB of q, k, v and out, i.e.
// ~4 us at the 67 TFLOP/s float32 FMA rate and ~3.6 us at 3.35 TB/s. The
// kernel is latency bound at that size: 256 blocks of 3 chunks each.
// wgmma, TMA and bf16 are left for later work.
#include <math.h>
#include <stddef.h>

#include "common.cuh"

namespace hig {

constexpr int FA_HD = 64;       // head dim
constexpr int FA_BQ = 64;       // query rows per block
constexpr int FA_BK = 32;       // key rows per chunk
constexpr int FA_THREADS = 256; // 4 lanes per query row
constexpr int FA_KPAD = FA_HD + 4;
constexpr float FA_SCALE = 0.125f;  // 1 / sqrt(FA_HD), exact in float32
constexpr float FA_MASK_BIAS = -1000000.0f;

__global__ void __launch_bounds__(FA_THREADS) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ mask, float* __restrict__ out, int H, int Tq, int Tk,
    int ldq, int ldkv, int ldo, int partner, int causal) {
  __shared__ __align__(16) float k_s[FA_BK][FA_KPAD];
  __shared__ __align__(16) float v_s[FA_BK][FA_HD];
  __shared__ float bias_s[FA_BK];

  const int n = blockIdx.x / H, h = blockIdx.x % H;
  const int src = partner ? (n ^ 1) : n;
  const int tid = threadIdx.x, lane = tid & 31;
  const int part = tid & 3;  // this lane's quarter of the keys and output columns
  const int t = blockIdx.y * FA_BQ + (tid >> 2);  // query row
  const bool valid = t < Tq;
  const float* kb = k + (size_t)src * Tk * ldkv + h * FA_HD;
  const float* vb = v + (size_t)src * Tk * ldkv + h * FA_HD;
  const float* mb = mask + (size_t)src * Tk;

  float qr[FA_HD];
  {
    const float4* qp = reinterpret_cast<const float4*>(q + ((size_t)n * Tq + t) * ldq + h * FA_HD);
#pragma unroll
    for (int i = 0; i < FA_HD / 4; ++i) {
      const float4 a = valid ? qp[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[4 * i + 0] = a.x * FA_SCALE;
      qr[4 * i + 1] = a.y * FA_SCALE;
      qr[4 * i + 2] = a.z * FA_SCALE;
      qr[4 * i + 3] = a.w * FA_SCALE;
    }
  }
  // acc[4 * c + e] is output column 16 * c + 4 * part + e: the quad's four
  // float4 reads of a v row are then 64 contiguous bytes.
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += FA_BK) {
    for (int i = tid; i < FA_BK * FA_HD / 4; i += FA_THREADS) {
      const int r = i / (FA_HD / 4), c = (i % (FA_HD / 4)) * 4;
      const int key = k0 + r;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (key < Tk) {
        kk = *reinterpret_cast<const float4*>(kb + (size_t)key * ldkv + c);
        vv = *reinterpret_cast<const float4*>(vb + (size_t)key * ldkv + c);
      }
      *reinterpret_cast<float4*>(&k_s[r][c]) = kk;
      *reinterpret_cast<float4*>(&v_s[r][c]) = vv;
    }
    if (tid < FA_BK) {
      const int key = k0 + tid;
      bias_s[tid] = key < Tk ? (1.f - mb[key]) * FA_MASK_BIAS : -INFINITY;
    }
    __syncthreads();

    float s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = 0.f;
#pragma unroll
    for (int d = 0; d < FA_HD; d += 4) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kk = *reinterpret_cast<const float4*>(&k_s[part + 4 * j][d]);
        s[j] = fmaf(qr[d + 0], kk.x, s[j]);
        s[j] = fmaf(qr[d + 1], kk.y, s[j]);
        s[j] = fmaf(qr[d + 2], kk.z, s[j]);
        s[j] = fmaf(qr[d + 3], kk.w, s[j]);
      }
    }
    float cmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = k0 + part + 4 * j;
      float sj = s[j] + bias_s[part + 4 * j];
      if (causal && key > t) sj += FA_MASK_BIAS;
      s[j] = sj;
      cmax = fmaxf(cmax, sj);
    }
    cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 1));
    cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, 2));
    const float m_new = fmaxf(m, cmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] *= alpha;

#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float pw = __shfl_sync(0xffffffffu, s[j], (lane & ~3) | p);
        const float* vr = &v_s[p + 4 * j][4 * part];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + 16 * c);
          acc[4 * c + 0] = fmaf(pw, vv.x, acc[4 * c + 0]);
          acc[4 * c + 1] = fmaf(pw, vv.y, acc[4 * c + 1]);
          acc[4 * c + 2] = fmaf(pw, vv.z, acc[4 * c + 2]);
          acc[4 * c + 3] = fmaf(pw, vv.w, acc[4 * c + 3]);
        }
      }
    }
    __syncthreads();
  }

  if (valid) {
    const float inv = 1.f / l;
    float* o = out + ((size_t)n * Tq + t) * ldo + h * FA_HD + 4 * part;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(o + 16 * c) =
          make_float4(acc[4 * c] * inv, acc[4 * c + 1] * inv, acc[4 * c + 2] * inv,
                      acc[4 * c + 3] * inv);
  }
}

}  // namespace hig

extern "C" int hig_flash_attention(
    const float* q, const float* k, const float* v, const float* mask, float* out,
    int N, int H, int Tq, int Tk, int ldq, int ldkv, int ldo, int partner, int causal,
    void* stream_ptr) {
  const dim3 grid(N * H, (Tq + hig::FA_BQ - 1) / hig::FA_BQ);
  hig::flash_attention_kernel<<<grid, hig::FA_THREADS, 0,
                                static_cast<cudaStream_t>(stream_ptr)>>>(
      q, k, v, mask, out, H, Tq, Tk, ldq, ldkv, ldo, partner, causal);
  return cudaGetLastError();
}
