// Helpers shared by every kernel library of the port: warp reductions, the
// 3xTF32 tensor-core product, cp.async copies, and the error string a
// wrapper reports when a launch returns a cudaError_t.
//
// 3xTF32. A float32 x is split into hi = cvt.rna.tf32(x) and
// lo = cvt.rna.tf32(x - hi); a product a * b is taken as
// a_lo * b_hi + a_hi * b_lo + a_hi * b_hi on the tensor cores
// (mma.sync m16n8k8, float32 accumulators). Only lo * lo (~2^-22 of the
// product) is dropped, so the result keeps float32-level error, where one
// plain TF32 product keeps ~2^-11.
//
// bfloat16. Every bfloat16 form rounds float32 values to bfloat16 with
// round-to-nearest-even (what XLA's convert does) and moves bfloat16 data
// through the same float4/float2-sized loads and stores. B1-bf16, B2-bf16,
// B2-bf16a, B3-bf16 and B4-bf16 run their bfloat16 products on wgmma
// (hopper.cuh); the float32 core of B2-bf16 and B2-bf16a is 3xTF32 on
// mma.sync.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The head width of this translation unit's attention kernels: each
// library is built once per width (ops/_build.py passes -DHIG_HD=w for
// every width but 64), and every kernel takes its tile shapes from it.
// HW is the head width; HD is the width of the column tile a block or a
// warp owns. A 128-wide head is two 64-column halves (NH) wherever a
// layout is 64 columns wide. Heads of 16 and 32 are packed 64 / HW side
// by side into one 64-column tile (HD = 64, HPB heads a tile), so the
// 128-byte swizzle, the TMA boxes and the wgmma descriptors of width 64
// serve unchanged: the column softmax over time is per column anyway, the
// feature softmax takes each head's HW columns apart (its segments), and a
// linear-attention state keeps only its block-diagonal HW x HW pieces
// (same_head), so each head's output reads its own depth only.
#ifndef HIG_HD
#define HIG_HD 64
#endif

namespace hig {

constexpr int HW = HIG_HD;
static_assert(HW == 16 || HW == 32 || HW == 64 || HW == 128,
              "the kernels take head widths 16, 32, 64 and 128");
constexpr int HD = HW < 64 ? 64 : HW;  // a tile's columns
constexpr int NH = HD / 64;
constexpr int HPB = HD / HW;           // heads a tile holds

// Whether tile columns d and l belong to one head (always, from width 64).
__host__ __device__ __forceinline__ constexpr bool same_head(int d, int l) {
  return HPB == 1 || d / HW == l / HW;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// A float32 operand as the high and low TF32 parts of the 3xTF32 product.
struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split_tf32(float x) {
  const uint32_t hi = to_tf32(x);
  return {hi, to_tf32(x - __uint_as_float(hi))};
}

// d += a * b for one m16n8k8 tile, TF32 inputs, float32 accumulators.
// Fragments (g = lane / 4, c = lane % 4): a[0] (row g, k c), a[1] (g + 8, c),
// a[2] (g, c + 4), a[3] (g + 8, c + 4); b[0] (k c, col g), b[1] (c + 4, g);
// d[0] (row g, col 2c), d[1] (g, 2c + 1), d[2] (g + 8, 2c), d[3] (g + 8, 2c + 1).
// Not volatile, so the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[i][j] += a[i] * b[j] in 3xTF32 for I x J tiles: acc is [I][J][4], a
// [I][4] and b [J][2] split fragments. Each accumulator takes lo*hi, then
// hi*lo, then hi*hi, and the three terms run over every tile in turn, so
// consecutive products go to different accumulators instead of waiting on
// each other.
template <int I, int J>
__device__ __forceinline__ void mma_3xtf32(float* acc, const Split* a, const Split* b) {
#pragma unroll
  for (int term = 0; term < 3; ++term)
#pragma unroll
    for (int i = 0; i < I; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        uint32_t af[4], bf[2];
#pragma unroll
        for (int r = 0; r < 4; ++r) af[r] = term == 0 ? a[4 * i + r].lo : a[4 * i + r].hi;
#pragma unroll
        for (int r = 0; r < 2; ++r) bf[r] = term == 1 ? b[2 * j + r].lo : b[2 * j + r].hi;
        mma_tf32(acc + 4 * (J * i + j), af, bf);
      }
}

using bf16 = __nv_bfloat16;

// Two floats as one register of two bfloat16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// Four consecutive elements (16-byte aligned for float, 8 for bfloat16)
// as a float4, and back.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = unpack_bf16(u.x), b = unpack_bf16(u.y);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const bf16* p) {
  return unpack_bf16(*reinterpret_cast<const uint32_t*>(p));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// 16-byte asynchronous copy global -> shared; `valid` false writes zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

}  // namespace hig

extern "C" const char* hig_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
