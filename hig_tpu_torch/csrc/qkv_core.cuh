// The parts that B1-bf16's q|k|v + core kernel (fused_block.cu) and the
// kernels of B2-bf16 and B2-bf16a (projected_attention.cu) share: one block
// per (sequence, head), two consumer warpgroups of 64 rows each and one
// producer warp that feeds them through a TMA ring (hopper.cuh).
//
// The producer loads, for every round of two 64-row tiles, the key/value
// source's rows with the head's 64 rows of Wk and of Wv (phase 0), then
// the query source's rows with the head's 64 rows of Wq (phase 1), in
// 64-column chunks of the model width D. At head width HD = 128 phase 0 is
// two passes over each round's rows, the head's 128 rows of Wk, then of Wv
// (so a stage holds 128 weight rows at either width, and a warpgroup's k
// or v accumulator is m64n128, 64 registers), and phase 1 loads the 128
// rows of Wq. A weight comes in NP bfloat16
// pieces (NP = 1: a bfloat16 weight; NP = 3: a float32 weight split into
// hi + mid + lo, each product with a bfloat16 row exact in float32), and a
// ring stage holds the two source tiles and every piece of the chunk. Each
// consumer warpgroup projects its tile on wgmma (qc_project: k | v as
// m64n128, q as m64n64, the pieces smallest first into the same float32
// accumulators) and releases each ring stage once its products are done.
// The keys' column statistics and the queries' feature softmax are shared
// too; what each kernel keeps in shared memory, and at what precision it
// builds the state and y, is its own.
#pragma once

#include <math.h>

#include "hopper.cuh"

namespace hig {

constexpr int QC_WG = 2;                     // consumer warpgroups, one 64-row tile each
constexpr int QC_CONSUMERS = 128 * QC_WG;
constexpr int QC_THREADS = QC_CONSUMERS + 32;  // and one producer warp
constexpr int QC_MAX_STAGES = 4;
constexpr int QC_KV_PASSES = NH;  // phase 0's passes a round: k | v together, or k then v
constexpr int QC_RG = QC_CONSUMERS / HD;  // row groups of the column statistics
constexpr uint32_t QC_TILE_BYTES = 64 * 64 * 2;   // 64 rows x 64 deep, bfloat16
constexpr int SMEM_MAX = 232448;             // a block's shared memory on the H100

// A ring stage: two source tiles, then 128 weight rows (two tiles) of each
// of the NP pieces; piece p's rows start at tile 2 + 2 p.
__host__ __device__ constexpr uint32_t qc_stage_bytes(int np) {
  return (2 + 2 * np) * QC_TILE_BYTES;
}
constexpr uint32_t QC_STAGE_BYTES = qc_stage_bytes(1);

// Shared memory past the ring, for tpad rows: 8 HD bytes a key row
// (B1-bf16: k, E and v; B2-bf16a: k and v), the column statistics and the
// barriers.
__host__ __device__ constexpr int qc_fixed_smem(int tpad) {
  return tpad * 8 * HD + (QC_RG * HD + 2 * HD) * 4 + 2 * QC_MAX_STAGES * 8;
}

// The ring stages of NP pieces that fit beside qc_fixed_smem(tpad), at most
// QC_MAX_STAGES, and the dynamic shared memory to request for them.
inline int qc_stages(int tpad, int np = 1) {
  const int s = (SMEM_MAX - 1024 - qc_fixed_smem(tpad)) / (int)qc_stage_bytes(np);
  return s < QC_MAX_STAGES ? s : QC_MAX_STAGES;
}

inline int qc_smem(int tpad, int np = 1) {
  return 1024 + qc_stages(tpad, np) * (int)qc_stage_bytes(np) + qc_fixed_smem(tpad);
}

// The most key rows a whole form holds: the largest multiple of 64 with at
// least `min_stages` ring stages of NP pieces beside its qc_fixed_smem
// (B1-bf16: 2, so that a stage loads while another is used, 320 rows at HD
// = 64 and 128 at 128; B2-bf16a: 1, 320 and 128). ops/pallas_attention.py's
// WHOLE_MAX_T holds the value (a cuda test holds the two equal).
inline int qc_whole_max_t(int np, int min_stages) {
  int tpad = 64;
  while (qc_stages(tpad + 64, np) >= min_stages) tpad += 64;
  return tpad;
}

// Byte offset of element (t, col), col < HD, of a bfloat16 operand of tpad
// rows held as NH 128-byte-swizzled column halves of tpad rows each.
__host__ __device__ __forceinline__ uint32_t half_swz(int t, int col, int tpad) {
  return (NH == 1 ? 0 : (col >> 6) * tpad * 128) +
         (t * 128 + ((((col >> 3) ^ t) & 7) << 4) + (col & 7) * 2);
}

// Where the producer finds the head's weight rows: one tensor map each for
// Wq, Wk and Wv, the first row of the head's HD in each, and pieces
// 0 .. NP - 1 at the map's outermost coordinate (boxes of 64 rows).
struct QcWeights {
  const CUtensorMap *q, *k, *v;
  int rq, rk, rv;
};

// The producer warp's lane 0: phase 0 loads the rows of sequence `skv` of
// `tkv` with every piece of Wk and Wv, phase 1 those of sequence `sq` of
// `tq` with every piece of Wq.
template <int NP = 1>
__device__ __forceinline__ void qc_produce(const CUtensorMap* tkv, const CUtensorMap* tq,
                                           const QcWeights& w, int skv, int sq,
                                           unsigned char* ring, uint64_t* full, uint64_t* empty,
                                           int stages, int tiles, int kchunks) {
  constexpr uint32_t stage_bytes = qc_stage_bytes(NP);
  const int rounds = (tiles + QC_WG - 1) / QC_WG;
  int it = 0;
  for (int phase = 0; phase < 2; ++phase) {
    const CUtensorMap* tx = phase == 0 ? tkv : tq;
    const int seq = phase == 0 ? skv : sq;
    for (int r = 0; r < rounds; ++r) {
      const bool two = QC_WG * r + 1 < tiles;
      for (int pass = 0; pass < (phase == 0 ? QC_KV_PASSES : 1); ++pass) {
        // the weight tiles of this pass: Wk | Wv (HD 64), Wk or Wv (128), Wq
        const int wtiles = phase == 0 ? 2 : NH;
        for (int kc = 0; kc < kchunks; ++kc, ++it) {
          const int st = it % stages, col = 64 * kc;
          mbar_wait(&empty[st], ((it / stages) & 1) ^ 1);
          unsigned char* sb = ring + st * stage_bytes;
          mbar_arrive_expect_tx(&full[st], ((two ? 2 : 1) + NP * wtiles) * QC_TILE_BYTES);
          tma_load_3d(sb, tx, &full[st], col, 64 * QC_WG * r, seq);
          if (two)
            tma_load_3d(sb + QC_TILE_BYTES, tx, &full[st], col, 64 * (QC_WG * r + 1), seq);
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            unsigned char* wb = sb + (2 + 2 * p) * QC_TILE_BYTES;
            if (phase == 0 && HD == 64) {
              tma_load_3d(wb, w.k, &full[st], col, w.rk, p);
              tma_load_3d(wb + QC_TILE_BYTES, w.v, &full[st], col, w.rv, p);
            } else {
              const CUtensorMap* wm = phase == 1 ? w.q : pass == 0 ? w.k : w.v;
              const int r0 = phase == 1 ? w.rq : pass == 0 ? w.rk : w.rv;
#pragma unroll
              for (int hh = 0; hh < NH; ++hh)
                tma_load_3d(wb + hh * QC_TILE_BYTES, wm, &full[st], col, r0 + 64 * hh, p);
            }
          }
        }
      }
    }
  }
}

// One tile's projection, acc = src rows . W^T over the D / 64 chunks (NC
// 128: the k | v columns at HD 64, k or v at 128, and q at 128; 64: q at
// 64), for warpgroup `wg`; `it` counts the ring
// stages consumed. Each chunk takes the NP pieces smallest first (lo, mid,
// hi). An inactive warpgroup (its tile lies past T) only releases the
// stages.
template <int NC, int NP = 1>
__device__ __forceinline__ void qc_project(float* acc, unsigned char* ring, uint64_t* full,
                                           uint64_t* empty, int& it, int stages, int kchunks,
                                           int wg, bool active) {
  constexpr uint32_t stage_bytes = qc_stage_bytes(NP);
  for (int kc = 0; kc < kchunks; ++kc, ++it) {
    const int st = it % stages;
    mbar_wait(&full[st], (it / stages) & 1);
    if (!active) {
      mbar_arrive(&empty[st]);
      continue;
    }
    unsigned char* sb = ring + st * stage_bytes;
    const uint64_t da = sw128_desc(sb + wg * QC_TILE_BYTES);
    wgmma_fence();
#pragma unroll
    for (int p = NP - 1; p >= 0; --p) {
      const uint64_t dw = sw128_desc(sb + (2 + 2 * p) * QC_TILE_BYTES);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int acc_in = kc > 0 || kk > 0 || p < NP - 1;
        if constexpr (NC == 128)
          wgmma_m64n128_ss<0, 0>(acc, desc_add(da, 32 * kk), desc_add(dw, 32 * kk), acc_in);
        else
          wgmma_m64n64_ss<0, 0>(acc, desc_add(da, 32 * kk), desc_add(dw, 32 * kk), acc_in);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    mbar_arrive(&empty[st]);
  }
}

// Column max (cm) and sum of exp(k - cm) (zs) over the T rows of the keys,
// element (t, d) at ks[idx(t, d)], by the consumer threads (barrier 1):
// thread (d, r0) takes rows r0, r0 + QC_RG, ... in turn, and the QC_RG
// partials (4 at HD 64, 2 at 128) are combined pairwise. ks may be
// shared or (a streaming form's scratch) device memory.
template <typename Idx>
__device__ __forceinline__ void qc_column_stats(const float* ks, int T, int tid, float* red,
                                                float* cm, float* zs, Idx idx) {
  const int d = tid & (HD - 1), r0 = tid / HD;
  float mx = -INFINITY;
  for (int t = r0; t < T; t += QC_RG) mx = fmaxf(mx, ks[idx(t, d)]);
  red[r0 * HD + d] = mx;
  named_barrier(1, QC_CONSUMERS);
  if (tid < HD)
    cm[tid] = QC_RG == 4 ? fmaxf(fmaxf(red[tid], red[HD + tid]),
                                 fmaxf(red[2 * HD + tid], red[3 * HD + tid]))
                         : fmaxf(red[tid], red[HD + tid]);
  named_barrier(1, QC_CONSUMERS);
  const float cmd = cm[d];
  float sum = 0.f;
  for (int t = r0; t < T; t += QC_RG) sum += expf(ks[idx(t, d)] - cmd);
  red[r0 * HD + d] = sum;
  named_barrier(1, QC_CONSUMERS);
  if (tid < HD)
    zs[tid] = QC_RG == 4 ? (red[tid] + red[HD + tid]) + (red[2 * HD + tid] + red[3 * HD + tid])
                         : red[tid] + red[HD + tid];
  named_barrier(1, QC_CONSUMERS);
}

// q += bq (the tile's HD biases, float32 or bfloat16), then softmax over
// the HW columns of each head of each row of a warpgroup's m64nHD
// accumulator (hopper.cuh's layout; at HW < 64 the tile's HPB packed heads
// apart, head s over n8 tiles JS s .. JS s + JS - 1), in place.
template <typename BiasT>
__device__ __forceinline__ void qc_feature_softmax(float* qa, const BiasT* bq, int c) {
  constexpr int J = HD / 8, JS = J / HPB;  // n8 tiles a row, a head
  float mx_lo[HPB], mx_hi[HPB], s_lo[HPB], s_hi[HPB];
#pragma unroll
  for (int s = 0; s < HPB; ++s) {
    mx_lo[s] = mx_hi[s] = -INFINITY;
    s_lo[s] = s_hi[s] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float2 b = load2(bq + 8 * j + 2 * c);
    qa[4 * j] += b.x;
    qa[4 * j + 1] += b.y;
    qa[4 * j + 2] += b.x;
    qa[4 * j + 3] += b.y;
    mx_lo[j / JS] = fmaxf(mx_lo[j / JS], fmaxf(qa[4 * j], qa[4 * j + 1]));
    mx_hi[j / JS] = fmaxf(mx_hi[j / JS], fmaxf(qa[4 * j + 2], qa[4 * j + 3]));
  }
#pragma unroll
  for (int s = 0; s < HPB; ++s) {
    mx_lo[s] = fmaxf(mx_lo[s], __shfl_xor_sync(0xffffffffu, mx_lo[s], 1));
    mx_lo[s] = fmaxf(mx_lo[s], __shfl_xor_sync(0xffffffffu, mx_lo[s], 2));
    mx_hi[s] = fmaxf(mx_hi[s], __shfl_xor_sync(0xffffffffu, mx_hi[s], 1));
    mx_hi[s] = fmaxf(mx_hi[s], __shfl_xor_sync(0xffffffffu, mx_hi[s], 2));
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    qa[4 * j] = expf(qa[4 * j] - mx_lo[j / JS]);
    qa[4 * j + 1] = expf(qa[4 * j + 1] - mx_lo[j / JS]);
    qa[4 * j + 2] = expf(qa[4 * j + 2] - mx_hi[j / JS]);
    qa[4 * j + 3] = expf(qa[4 * j + 3] - mx_hi[j / JS]);
    s_lo[j / JS] += qa[4 * j] + qa[4 * j + 1];
    s_hi[j / JS] += qa[4 * j + 2] + qa[4 * j + 3];
  }
#pragma unroll
  for (int s = 0; s < HPB; ++s) {
    s_lo[s] += __shfl_xor_sync(0xffffffffu, s_lo[s], 1);
    s_lo[s] += __shfl_xor_sync(0xffffffffu, s_lo[s], 2);
    s_hi[s] += __shfl_xor_sync(0xffffffffu, s_hi[s], 1);
    s_hi[s] += __shfl_xor_sync(0xffffffffu, s_hi[s], 2);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    qa[4 * j] /= s_lo[j / JS];
    qa[4 * j + 1] /= s_lo[j / JS];
    qa[4 * j + 2] /= s_hi[j / JS];
    qa[4 * j + 3] /= s_hi[j / JS];
  }
}

}  // namespace hig
