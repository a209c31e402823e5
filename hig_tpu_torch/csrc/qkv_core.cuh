// The parts that B1-bf16's q|k|v + core kernel (fused_block.cu) and
// B2-bf16's kernel (projected_attention.cu) share: one block per
// (sequence, head), two consumer warpgroups of 64 rows each and one
// producer warp that feeds them through a TMA ring (hopper.cuh).
//
// The producer loads, for every round of two 64-row tiles, the key/value
// source's rows with the head's 64 rows of Wk and of Wv (phase 0), then
// the query source's rows with the head's 64 rows of Wq (phase 1), in
// 64-column chunks of the model width D. Each consumer warpgroup projects
// its tile on wgmma (qc_project: k | v as m64n128, q as m64n64) and
// releases each ring stage once its products are done. The keys' column
// statistics and the queries' feature softmax are shared too; what each
// kernel keeps in shared memory, and at what precision it builds the state
// and y, is its own.
#pragma once

#include <math.h>

#include "hopper.cuh"

namespace hig {

constexpr int QC_WG = 2;                     // consumer warpgroups, one 64-row tile each
constexpr int QC_CONSUMERS = 128 * QC_WG;
constexpr int QC_THREADS = QC_CONSUMERS + 32;  // and one producer warp
constexpr int QC_MAX_T = 320;
constexpr int QC_MAX_STAGES = 4;
constexpr uint32_t QC_TILE_BYTES = 64 * 64 * 2;   // 64 rows x 64 deep, bfloat16
constexpr uint32_t QC_STAGE_BYTES = 4 * QC_TILE_BYTES;  // two source tiles, 128 weight rows
constexpr int SMEM_MAX = 232448;             // a block's shared memory on the H100

// Shared memory past the ring, for tpad rows: 512 bytes a key row (B1-bf16:
// k, E and v; B2-bf16: k and v), the column statistics and the barriers.
__host__ __device__ constexpr int qc_fixed_smem(int tpad) {
  return tpad * 512 + 6 * 64 * 4 + 2 * QC_MAX_STAGES * 8;
}

// The ring stages that fit beside qc_fixed_smem(tpad), at most QC_MAX_STAGES,
// and the dynamic shared memory to request for them.
inline int qc_stages(int tpad) {
  const int s = (SMEM_MAX - 1024 - qc_fixed_smem(tpad)) / (int)QC_STAGE_BYTES;
  return s < QC_MAX_STAGES ? s : QC_MAX_STAGES;
}

inline int qc_smem(int tpad) {
  return 1024 + qc_stages(tpad) * (int)QC_STAGE_BYTES + qc_fixed_smem(tpad);
}

// The producer warp's lane 0: phase 0 loads the rows of sequence `skv` of
// `tkv` with Wk and Wv, phase 1 those of sequence `sq` of `tq` with Wq.
__device__ __forceinline__ void qc_produce(
    const CUtensorMap* tkv, const CUtensorMap* tq, const CUtensorMap* twq,
    const CUtensorMap* twk, const CUtensorMap* twv, int skv, int sq, int h,
    unsigned char* ring, uint64_t* full, uint64_t* empty, int stages, int tiles, int kchunks) {
  const int rounds = (tiles + QC_WG - 1) / QC_WG;
  int it = 0;
  for (int phase = 0; phase < 2; ++phase) {
    const CUtensorMap* tx = phase == 0 ? tkv : tq;
    const int seq = phase == 0 ? skv : sq;
    for (int r = 0; r < rounds; ++r) {
      const bool two = QC_WG * r + 1 < tiles;
      for (int kc = 0; kc < kchunks; ++kc, ++it) {
        const int st = it % stages;
        mbar_wait(&empty[st], ((it / stages) & 1) ^ 1);
        unsigned char* sb = ring + st * QC_STAGE_BYTES;
        mbar_arrive_expect_tx(&full[st], ((two ? 2 : 1) + (phase == 0 ? 2 : 1)) *
                                             QC_TILE_BYTES);
        tma_load_3d(sb, tx, &full[st], 64 * kc, 64 * QC_WG * r, seq);
        if (two) tma_load_3d(sb + QC_TILE_BYTES, tx, &full[st], 64 * kc, 64 * (QC_WG * r + 1), seq);
        if (phase == 0) {
          tma_load_3d(sb + 2 * QC_TILE_BYTES, twk, &full[st], 64 * kc, 64 * h, 0);
          tma_load_3d(sb + 3 * QC_TILE_BYTES, twv, &full[st], 64 * kc, 64 * h, 0);
        } else {
          tma_load_3d(sb + 2 * QC_TILE_BYTES, twq, &full[st], 64 * kc, 64 * h, 0);
        }
      }
    }
  }
}

// One tile's projection, acc = src rows . W^T over the D / 64 chunks (NC
// 128: the k | v columns, 64: q), for warpgroup `wg`; `it` counts the ring
// stages consumed. An inactive warpgroup (its tile lies past T) only
// releases the stages.
template <int NC>
__device__ __forceinline__ void qc_project(float* acc, unsigned char* ring, uint64_t* full,
                                           uint64_t* empty, int& it, int stages, int kchunks,
                                           int wg, bool active) {
  for (int kc = 0; kc < kchunks; ++kc, ++it) {
    const int st = it % stages;
    mbar_wait(&full[st], (it / stages) & 1);
    if (!active) {
      mbar_arrive(&empty[st]);
      continue;
    }
    unsigned char* sb = ring + st * QC_STAGE_BYTES;
    const uint64_t da = sw128_desc(sb + wg * QC_TILE_BYTES);
    const uint64_t dw = sw128_desc(sb + 2 * QC_TILE_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (NC == 128)
        wgmma_m64n128_ss<0, 0>(acc, desc_add(da, 32 * kk), desc_add(dw, 32 * kk),
                               kc > 0 || kk > 0);
      else
        wgmma_m64n64_ss<0, 0>(acc, desc_add(da, 32 * kk), desc_add(dw, 32 * kk),
                              kc > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(&empty[st]);
  }
}

// Column max (cm) and sum of exp(k - cm) (zs) over the T rows of the keys,
// element (t, d) at ks[idx(t, d)], by the consumer threads (barrier 1).
template <typename Idx>
__device__ __forceinline__ void qc_column_stats(const float* ks, int T, int tid, float* red,
                                                float* cm, float* zs, Idx idx) {
  const int d = tid & 63, r0 = tid >> 6;
  float mx = -INFINITY;
  for (int t = r0; t < T; t += 4) mx = fmaxf(mx, ks[idx(t, d)]);
  red[r0 * 64 + d] = mx;
  named_barrier(1, QC_CONSUMERS);
  if (tid < 64)
    cm[tid] = fmaxf(fmaxf(red[tid], red[64 + tid]), fmaxf(red[128 + tid], red[192 + tid]));
  named_barrier(1, QC_CONSUMERS);
  const float cmd = cm[d];
  float sum = 0.f;
  for (int t = r0; t < T; t += 4) sum += expf(ks[idx(t, d)] - cmd);
  red[r0 * 64 + d] = sum;
  named_barrier(1, QC_CONSUMERS);
  if (tid < 64) zs[tid] = (red[tid] + red[64 + tid]) + (red[128 + tid] + red[192 + tid]);
  named_barrier(1, QC_CONSUMERS);
}

// q += bq (the head's 64 biases), then softmax over the 64 columns of each
// row of a warpgroup's m64n64 accumulator (hopper.cuh's layout), in place.
__device__ __forceinline__ void qc_feature_softmax(float* qa, const bf16* bq, int c) {
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 b = load2(bq + 8 * j + 2 * c);
    qa[4 * j] += b.x;
    qa[4 * j + 1] += b.y;
    qa[4 * j + 2] += b.x;
    qa[4 * j + 3] += b.y;
    mx_lo = fmaxf(mx_lo, fmaxf(qa[4 * j], qa[4 * j + 1]));
    mx_hi = fmaxf(mx_hi, fmaxf(qa[4 * j + 2], qa[4 * j + 3]));
  }
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
  mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
  mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
  float s_lo = 0.f, s_hi = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    qa[4 * j] = expf(qa[4 * j] - mx_lo);
    qa[4 * j + 1] = expf(qa[4 * j + 1] - mx_lo);
    qa[4 * j + 2] = expf(qa[4 * j + 2] - mx_hi);
    qa[4 * j + 3] = expf(qa[4 * j + 3] - mx_hi);
    s_lo += qa[4 * j] + qa[4 * j + 1];
    s_hi += qa[4 * j + 2] + qa[4 * j + 3];
  }
  s_lo += __shfl_xor_sync(0xffffffffu, s_lo, 1);
  s_lo += __shfl_xor_sync(0xffffffffu, s_lo, 2);
  s_hi += __shfl_xor_sync(0xffffffffu, s_hi, 1);
  s_hi += __shfl_xor_sync(0xffffffffu, s_hi, 2);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    qa[4 * j] /= s_lo;
    qa[4 * j + 1] /= s_lo;
    qa[4 * j + 2] /= s_hi;
    qa[4 * j + 3] /= s_hi;
  }
}

}  // namespace hig
