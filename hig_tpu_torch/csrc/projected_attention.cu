// B2: efficient attention with the Q/K/V projections fused in, forward.
// Replaces hig_tpu/ops/pallas_attention.py::_proj_kernel (Pallas TPU).
//
//   q = q_src Wq + bq;  k, v = kv_src Wk + bk, kv_src Wv + bv
//   k += (1 - mask) * -1e6; v *= mask
//   per head: y_h = softmax_feat(q_h) . [softmax_time(k_h)^T v_h]
//
// Every form takes an output width Dout = 64 H apart from the input width
// D: the (Dout, D) weights hold the columns of H heads, so a tensor-parallel
// rank with D / S of the columns (and H / S heads) runs its own heads
// through the same kernels, which only change shape: tensor maps of (Dout,
// D) weights, N x H blocks, y rows of Dout. The square model is Dout = D.
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
    float* qkv, float* out, int N, int T, int D, int Dout, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (D % 32 || Dout % hig::HD) return cudaErrorInvalidValue;

  hig::GemmArgs a{};
  a.a0 = q_src; a.a1 = kv_src;
  a.w0 = wq; a.w1 = wk; a.w2 = wv;
  a.b0 = bq; a.b1 = bk; a.b2 = bv;
  a.out = qkv;
  a.M = N * T; a.K = D; a.D = Dout; a.ldo = 3 * Dout;
  const cudaError_t err = hig::launch_gemm_qkv(a, stream);
  if (err != cudaSuccess) return err;
  return hig::launch_core_qkv(qkv, mask, out, N, T, Dout, 0, stream);
}

// B2-bf16: bfloat16 activations and weights, as the Pallas kernel computes
// them for dt = bfloat16 (hig_tpu/ops/pallas_attention.py:116-137): q, k, v
// are float32 dots with the bias added in float32, the whole core is
// float32 (its dots take no cast), and y is stored in bfloat16.
//
// Bound on this card: at N = 104, T = 196, D = 512 the projections are 31
// GFLOP of bfloat16 products (32 us at 989 TFLOP/s) and the core 0.8 GFLOP
// of float32-accurate ones (15 us at 495 / 3 TFLOP/s in 3xTF32) against 31
// MB of q_src, kv_src, weights and y (9 us): operations, 0.049 ms; at the
// serving shape 0.0035 ms. The Pallas kernel keeps the float32 q | k | v in
// VMEM (125 MB written and read back at 104 x 196, were it in device
// memory); here it stays on the chip too. One launch,
// projected_core_kernel, one block per (sequence, head), laid out as
// B1-bf16's q|k|v + core kernel (qkv_core.cuh): a producer warp feeds a TMA
// ring with 64-column chunks of kv_src's rows and the head's rows of
// Wk | Wv, then of q_src's rows and Wq, through two tensor maps; two
// consumer warpgroups project 64-row tiles on wgmma (float32 accumulators)
// and keep k (+ the mask bias) and v (* the mask) in float32 in shared
// memory, 512 bytes a key row (at HD = 64); the column max and sums
// over all T keys are taken once and softmax_time(k) is written in place
// over k; the state E^T v is built once per (sequence, head) at 3xTF32 on
// mma.sync m16n8k8 straight from the float32 tiles (tf32 wgmma would take
// only K-major shared-memory operands), split into TF32 high and low parts
// once; then each 64-row q tile is softmaxed over the features in its
// accumulator registers and multiplied by the state at 3xTF32, the
// accumulator handed over as mma.sync's A operand with the depth index
// permuted alike in A and in the state (depth 8j + 2c is k index c, 8j +
// 2c + 1 is c + 4), and y is rounded once. The float32 tiles are
// [tpad][64] with the 8-float group j of row t at j ^ (t % 4): the state
// product's fragment loads and the accumulators' stores are free of bank
// conflicts.
//
// That whole-sequence form (B2-bf16a's below) holds one sequence's float32
// k and v at once, so it takes T up to qc_whole_max_t(3, 1) rows (320 at
// HD = 64, 128 at 128); a --single_transformer
// model's merged timeline is 2 x 196 = 392 rows at the evaluation length.
// B2-bf16 takes the streaming form of the kernel (STREAM) at every T: each
// round's two 64-row key tiles are projected into a 128-row k | v buffer
// (64 KB) and the state is built round by round as an online softmax over
// time. Per column d it keeps the running max m_d and sum l_d of
// exp(k - m_d); a round whose max raises m_d rescales the state's row d and
// l_d by exp(m_old - m_new), then adds the round's exp(k - m_new)^T v at
// 3xTF32 into the same registers; at the end row d of the state is divided
// by l_d. That is softmax_time(k) over all T keys, the float32 core of the
// Pallas kernel, in another order of float32 operations. The query phase
// is the same; the ring has 4 stages at any T (2 for the whole-sequence
// form at T = 196). On the H100 the streaming form took 0.0220 ms at 16 x
// 91 and 0.263 at 104 x 196 against the whole-sequence form's 0.0244 and
// 0.280 on the same inputs, so no form is kept for short sequences. Bound
// at 104 x 392: 64 GFLOP of bfloat16 products and 5.3 GFLOP of 3xTF32
// ones against 127 MB: operations, 0.097 ms.
//
// B2-bf16a: bfloat16 activations with float32 weights and biases (a
// bfloat16 model's unfused blocks on float32 master weights), as the Pallas
// kernel computes them for those dtypes: jnp.dot of a bfloat16 row and a
// float32 weight promotes the row, so q, k and v are float32 products plus
// the float32 bias, the core is float32, and y is rounded to bfloat16 once.
// The same kernel, with each weight split into three bfloat16 pieces, hi =
// bf16(w), mid = bf16(w - hi), lo = bf16(w - hi - mid) (split_pieces_kernel,
// one pass a call: 3 MB read, 4.5 MB written at D = 512): hi + mid + lo = w
// exactly for 2^-110 <= |w| <= 3.39e38 (the largest bfloat16), and a
// bfloat16 activation times a piece is exact in float32, so each 64-column
// chunk takes three wgmmas into the same float32 accumulators, lo first. A
// ring stage then holds the two source tiles and 128 weight rows of each
// piece, 64 KB: 2 stages fit beside the float32 k | v at T <= 192, 1 at
// T <= 320. No float32 q | k | v leaves the chip (the float32 form's two
// launches wrote and read back 143 MB at 256 x 91). Bound: the products at
// 989 / 3 TFLOP/s (three bfloat16 products each), the core at 3xTF32:
// 0.130 ms at 256 x 91, operations. Past the whole form's rows B2-bf16a
// takes its streaming form (projected_core_kernel<3, float, true, true>,
// SCRATCH): the whole form's float32 order, so the two agree bit for bit
// where both run. Its projection writes each key row's float32 k (with the
// bias and the mask's bias) and v (times the mask) to a device scratch of
// its (sequence, head) (kscr, vscr; L2-resident at the shapes that need
// it); the column max and sums over all T keys read the scratch in the
// whole form's thread order; then 128 rows at a time E = softmax_time(k)
// and v go into the shared tiles and the state's 3xTF32 steps run over
// them in the whole form's order into the same accumulators. (B2-bf16's
// online softmax is another order of float32 operations.)
//
// Head width HW (16, 32, 64 or 128; the library's): at 16 and 32 a block
// takes one 64-column tile of HPB packed heads (common.cuh), the width-64
// kernel with the feature softmax per head and the state zeroed off its
// block diagonal, in every form (and the float32 form's core likewise,
// linear_attention.cuh). Tile width HD: at 128 the k | v projection is
// two passes (qkv_core.cuh); the float32 tiles are [rows][HD]; consumer
// warp w holds state rows 16 (w % (HD / 16)) .. + 15 and HD / (8 / (HD /
// 16)) columns (32 at 64, all 128 at 128); y's product takes its output
// columns in 64-wide halves. The whole form's float32 k | v rows are at
// least HD, so the split state ((HD / 2) depth pairs x HD columns of hi
// and lo, 128 KB at HD 128) fits over them.
#include "qkv_core.cuh"

namespace hig {

// Element (t, col) of a swizzled float32 [.][HD] tile.
__device__ __forceinline__ int f32_tile(int t, int col) {
  return t * HD + (col ^ ((t & 3) << 3));
}

// The consumer warps' share of the HD x HD float32 state: PC_DW warps along
// its rows (16 each), PC_LW along its columns, PC_LJ n8 tiles a warp.
constexpr int PC_DW = HD / 16, PC_LW = 8 / PC_DW, PC_LJ = HD / PC_LW / 8;

// Key rows in shared memory of the streaming form: one round of tiles.
constexpr int PC_STREAM_ROWS = 64 * QC_WG;

// Shared memory past the ring of the streaming form: its k | v rows, the
// column statistics with the rescale factors, and the barriers.
__host__ __device__ constexpr int pc_stream_fixed_smem() {
  return PC_STREAM_ROWS * 8 * HD + (QC_RG * HD + 3 * HD) * 4 + 2 * QC_MAX_STAGES * 8;
}

// One 64-row key tile's projection `acc` (a warpgroup's m64n128
// accumulator: k | v columns of the head at HD 64; at 128 k in pass 0, v in
// pass 1) into the float32 tiles: k + bk + (1 - mask) * -1e6 and (v + bv) *
// mask, key t0 + r at tile row t0l + r (rows past T: v = 0). bk and bv are
// the head's HD biases.
template <bool PLAIN = false, typename BiasT>
__device__ __forceinline__ void pc_store_kv(const float* acc, float* ks, float* vs,
                                            const BiasT* bk, const BiasT* bv,
                                            const float* mask, int n, int T, int t0, int t0l,
                                            int wl, int g, int c, int pass) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = 16 * wl + g + 8 * half, t = t0 + r, tl = t0l + r;
    const float mt = t < T ? mask[(size_t)n * T + t] : 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * (HD == 64 ? (j & 7) : j) + 2 * c;
      const float a0 = acc[4 * j + 2 * half], a1 = acc[4 * j + 2 * half + 1];
      if (HD == 64 ? j < 8 : pass == 0) {
        const float2 b = load2(bk + col);
        *reinterpret_cast<float2*>(ks + (PLAIN ? tl * HD + col : f32_tile(tl, col))) =
            make_float2(a0 + b.x + (1.f - mt) * MASK_BIAS, a1 + b.y + (1.f - mt) * MASK_BIAS);
      } else {
        const float2 b = load2(bv + col);
        *reinterpret_cast<float2*>(vs + (PLAIN ? tl * HD + col : f32_tile(tl, col))) =
            make_float2((a0 + b.x) * mt, (a1 + b.y) * mt);
      }
    }
  }
}

// sacc += E^T v over tile rows [0, t8) at 3xTF32 (the depth is time):
// consumer warp w holds state rows d0 = 16 (w % PC_DW) .. + 15 and columns
// l0 = HD / PC_LW (w / PC_DW) .. (PC_LJ n8 tiles), row d0 + g + 8 (e / 2)
// in sacc[.][e].
__device__ __forceinline__ void pc_state_mma(float (&sacc)[PC_LJ][4], const float* ks,
                                             const float* vs, int t8, int d0, int l0, int g,
                                             int c) {
  for (int t0 = 0; t0 < t8; t0 += 8) {
    const int ta = t0 + c, tb = t0 + c + 4;
    Split a[4] = {split_tf32(ks[f32_tile(ta, d0 + g)]), split_tf32(ks[f32_tile(ta, d0 + g + 8)]),
                  split_tf32(ks[f32_tile(tb, d0 + g)]), split_tf32(ks[f32_tile(tb, d0 + g + 8)])};
    Split b[PC_LJ][2];
#pragma unroll
    for (int j = 0; j < PC_LJ; ++j) {
      b[j][0] = split_tf32(vs[f32_tile(ta, l0 + 8 * j + g)]);
      b[j][1] = split_tf32(vs[f32_tile(tb, l0 + 8 * j + g)]);
    }
    mma_3xtf32<1, PC_LJ>(&sacc[0][0], a, &b[0][0]);
  }
}

// The state's TF32 high and low parts into `state` (the layout at its
// declaration), each row d divided by zs[d] first when DIV.
template <bool DIV>
__device__ __forceinline__ void pc_store_state(const float (&sacc)[PC_LJ][4], uint4* state,
                                               const float* zs, int d0, int l0, int g, int c) {
  uint32_t* sw = reinterpret_cast<uint32_t*>(state);
#pragma unroll
  for (int j = 0; j < PC_LJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = d0 + g + 8 * (e >> 1), l = l0 + 8 * j + 2 * c + (e & 1), p = d >> 1;
      // packed heads (HW < 64): zero off the block diagonal
      const Split s = same_head(d, l) ? split_tf32(DIV ? sacc[j][e] / zs[d] : sacc[j][e])
                                      : Split{0u, 0u};
      uint32_t* u = sw + 4 * (p * HD + (l ^ (2 * (p & 3))));
      u[d & 1] = s.hi;
      u[2 + (d & 1)] = s.lo;
    }
}

// NP weight pieces (1: bfloat16 weights, the maps twq, twk, twv; 3: float32
// weights split, one map over the [3 pieces][3 D rows: Wq, Wk, Wv][D]
// pieces) and biases of BiasT; STREAM: a streaming form (header note),
// B2-bf16's online softmax, or with SCRATCH B2-bf16a's past its whole form
// (kscr, vscr its scratch); else one sequence's keys whole (B2-bf16a's, T
// up to qc_whole_max_t(3, 1)).
template <int NP, typename BiasT, bool STREAM = false, bool SCRATCH = false>
__global__ void __launch_bounds__(QC_THREADS, 1) projected_core_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tkv,
    const __grid_constant__ CUtensorMap twq, const __grid_constant__ CUtensorMap twk,
    const __grid_constant__ CUtensorMap twv, const BiasT* __restrict__ bq,
    const BiasT* __restrict__ bk, const BiasT* __restrict__ bv, const float* __restrict__ mask,
    bf16* __restrict__ y, float* __restrict__ kscr, float* __restrict__ vscr, int T, int D,
    int H, int stages, int wrows) {
  // D: the input width (64-column chunks of the projections); the output
  // has H heads of HD, rows of HD H
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);  // [stages]: source tiles 0 and 1, W pieces
  const int tiles = (T + 63) / 64, tpad = 64 * tiles;
  // key rows held at once (whole: at least HD, for the split state below)
  const int krows = STREAM ? PC_STREAM_ROWS : max(tpad, HD);
  float* ks = reinterpret_cast<float*>(ring + stages * qc_stage_bytes(NP));  // [krows][HD] k, then E
  float* vs = ks + krows * HD;                                           // [krows][HD] v
  float* red = vs + krows * HD;                                          // [QC_RG][HD]
  float* cm = red + QC_RG * HD;                                          // column max
  float* zs = cm + HD;                                                   // column sums
  float* al = zs + HD;  // STREAM: the round's rescale factors exp(m_old - m_new)
  uint64_t* full = reinterpret_cast<uint64_t*>(zs + (STREAM ? 2 * HD : HD));
  uint64_t* empty = full + QC_MAX_STAGES;
  // once the state is built, over ks (and vs): [HD / 2 depth pairs][HD columns] of
  // {hi(2p), hi(2p + 1), lo(2p), lo(2p + 1)}, column n of pair p at n ^ 2 (p % 4)
  uint4* state = reinterpret_cast<uint4*>(ks);

  const int n = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rounds = (tiles + QC_WG - 1) / QC_WG, kchunks = D / 64;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], QC_CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4 * QC_WG) {  // producer: k | v chunks of every round, then q's
    if (lane == 0)
      qc_produce<NP>(&tkv, &tq,
                     QcWeights{&twq, &twk, &twv, HD * h, wrows + HD * h, 2 * wrows + HD * h},
                     n, n, ring, full, empty, stages, tiles, kchunks);
    return;
  }

  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, c = lane & 3;
  const int d0 = 16 * (warp % PC_DW), l0 = (HD / PC_LW) * (warp / PC_DW);
  int it = 0;
  float sacc[PC_LJ][4];
#pragma unroll
  for (int j = 0; j < PC_LJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;

  if constexpr (SCRATCH) {
    // the whole form's steps, its key rows in the scratch of this block
    float* kh = kscr + (size_t)blockIdx.x * tpad * HD;
    float* vh = vscr + (size_t)blockIdx.x * tpad * HD;
    for (int r = 0; r < rounds; ++r) {
      const int tile = QC_WG * r + wg;
      const bool active = tile < tiles;
      for (int pass = 0; pass < QC_KV_PASSES; ++pass) {
        float acc[64];
        qc_project<128, NP>(acc, ring, full, empty, it, stages, kchunks, wg, active);
        if (!active) continue;
        fence_regs<64>(acc);
        pc_store_kv<true>(acc, kh, vh, bk + h * HD, bv + h * HD, mask, n, T, 64 * tile,
                          64 * tile, wl, g, c, pass);
      }
    }
    __threadfence_block();  // the scratch rows, for the other consumer threads
    named_barrier(1, QC_CONSUMERS);
    qc_column_stats(kh, T, tid, red, cm, zs, [](int t, int d) { return t * HD + d; });
    const int t8 = (T + 7) / 8 * 8;
    for (int r0 = 0; r0 < t8; r0 += PC_STREAM_ROWS) {  // E and v, 128 rows at a time
      const int rows = min(PC_STREAM_ROWS, t8 - r0);
      for (int i = tid; i < rows * HD; i += QC_CONSUMERS) {
        const int tl = i / HD, d = i % HD, t = r0 + tl, at = f32_tile(tl, d);
        ks[at] = t < T ? expf(kh[(size_t)t * HD + d] - cm[d]) / zs[d] : 0.f;
        vs[at] = vh[(size_t)t * HD + d];
      }
      named_barrier(1, QC_CONSUMERS);
      pc_state_mma(sacc, ks, vs, rows, d0, l0, g, c);
      named_barrier(1, QC_CONSUMERS);  // every warp is done with these rows
    }
    pc_store_state<false>(sacc, state, zs, d0, l0, g, c);
  } else if constexpr (!STREAM) {
    // k | v = kv_src [Wk | Wv]^T + [bk | bv]: 64-row tiles of the key rows
    for (int r = 0; r < rounds; ++r) {
      const int tile = QC_WG * r + wg;
      const bool active = tile < tiles;  // uniform over the warpgroup
      for (int pass = 0; pass < QC_KV_PASSES; ++pass) {
        float acc[64];
        qc_project<128, NP>(acc, ring, full, empty, it, stages, kchunks, wg, active);
        if (!active) continue;
        fence_regs<64>(acc);
        pc_store_kv(acc, ks, vs, bk + h * HD, bv + h * HD, mask, n, T, 64 * tile, 64 * tile,
                    wl, g, c, pass);
      }
    }
    named_barrier(1, QC_CONSUMERS);

    // column max and sums over the T keys, then E = softmax_time(k) over k
    // (rows past T: 0)
    qc_column_stats(ks, T, tid, red, cm, zs, [](int t, int d) { return f32_tile(t, d); });
    for (int i = tid; i < tpad * HD; i += QC_CONSUMERS) {
      const int t = i / HD, d = i % HD, at = f32_tile(t, d);
      ks[at] = t < T ? expf(ks[at] - cm[d]) / zs[d] : 0.f;
    }
    named_barrier(1, QC_CONSUMERS);
    pc_state_mma(sacc, ks, vs, (T + 7) / 8 * 8, d0, l0, g, c);
    named_barrier(1, QC_CONSUMERS);  // every warp is done with E and v
    pc_store_state<false>(sacc, state, zs, d0, l0, g, c);
  } else {
    // a round at a time: k | v of its two tiles, the round's column max, the
    // running max m (cm) and sum l (zs) of exp(k - m), the state rescaled
    // by exp(m_old - m_new) and the round's E^T v added
    const int d = tid & (HD - 1), r0 = tid / HD;
    if (tid < HD) {
      cm[tid] = -INFINITY;
      zs[tid] = 0.f;
    }
    for (int r = 0; r < rounds; ++r) {
      const int tile = QC_WG * r + wg;
      const bool active = tile < tiles;
      for (int pass = 0; pass < QC_KV_PASSES; ++pass) {
        float acc[64];
        qc_project<128, NP>(acc, ring, full, empty, it, stages, kchunks, wg, active);
        if (active) {
          fence_regs<64>(acc);
          pc_store_kv(acc, ks, vs, bk + h * HD, bv + h * HD, mask, n, T, 64 * tile, 64 * wg,
                      wl, g, c, pass);
        }
      }
      named_barrier(1, QC_CONSUMERS);
      const int rows = min(PC_STREAM_ROWS, T - PC_STREAM_ROWS * r);  // keys of the round
      float mx = -INFINITY;
      for (int t = r0; t < rows; t += QC_RG) mx = fmaxf(mx, ks[f32_tile(t, d)]);
      red[r0 * HD + d] = mx;
      named_barrier(1, QC_CONSUMERS);
      if (tid < HD) {
        const float m_old = cm[tid];
        const float m_new = fmaxf(m_old, QC_RG == 4
                                             ? fmaxf(fmaxf(red[tid], red[HD + tid]),
                                                     fmaxf(red[2 * HD + tid], red[3 * HD + tid]))
                                             : fmaxf(red[tid], red[HD + tid]));
        al[tid] = expf(m_old - m_new);  // 0 in the first round
        cm[tid] = m_new;
      }
      named_barrier(1, QC_CONSUMERS);
      // E = exp(k - m) in place (rows past the round's keys: 0); each thread
      // sums the rows it writes
      const float cmd = cm[d];
      float sum = 0.f;
      for (int t = r0; t < PC_STREAM_ROWS; t += QC_RG) {
        const int at = f32_tile(t, d);
        const float e = t < rows ? expf(ks[at] - cmd) : 0.f;
        ks[at] = e;
        sum += e;
      }
      red[r0 * HD + d] = sum;
      named_barrier(1, QC_CONSUMERS);
      if (tid < HD)
        zs[tid] = zs[tid] * al[tid] +
                  (QC_RG == 4 ? (red[tid] + red[HD + tid]) + (red[2 * HD + tid] + red[3 * HD + tid])
                              : red[tid] + red[HD + tid]);
#pragma unroll
      for (int j = 0; j < PC_LJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] *= al[d0 + g + 8 * (e >> 1)];
      pc_state_mma(sacc, ks, vs, (rows + 7) / 8 * 8, d0, l0, g, c);
      named_barrier(1, QC_CONSUMERS);  // every warp is done with the round's E and v
    }
    pc_store_state<true>(sacc, state, zs, d0, l0, g, c);
  }
  named_barrier(1, QC_CONSUMERS);

  // y = softmax_feat(q) . state at 3xTF32, per 64-row tile of this sequence
  for (int r = 0; r < rounds; ++r) {
    const int tile = QC_WG * r + wg;
    const bool active = tile < tiles;
    float qa[HD / 2];
    qc_project<HD, NP>(qa, ring, full, empty, it, stages, kchunks, wg, active);
    if (!active) continue;
    fence_regs<HD / 2>(qa);
    qc_feature_softmax(qa, bq + h * HD, c);
    float ya[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {  // depth 8j .. 8j + 7: k index c is 8j + 2c, c + 4 is 8j + 2c + 1
      const Split a[4] = {split_tf32(qa[4 * j]), split_tf32(qa[4 * j + 2]),
                          split_tf32(qa[4 * j + 1]), split_tf32(qa[4 * j + 3])};
#pragma unroll
      for (int lh = 0; lh < NH; ++lh) {  // the output's 64-column halves
        Split b[8][2];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const uint4 u = state[(4 * j + c) * HD + ((64 * lh + 8 * nt + g) ^ (2 * c))];
          b[nt][0] = {u.x, u.z};
          b[nt][1] = {u.y, u.w};
        }
        mma_3xtf32<1, 8>(&ya[8 * lh][0], a, &b[0][0]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = 64 * tile + 16 * wl + g + 8 * half;
      if (t >= T) continue;
      bf16* yr = y + ((size_t)n * T + t) * (H * HD) + h * HD + 2 * c;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) store2(yr + 8 * j, ya[j][2 * half], ya[j][2 * half + 1]);
    }
  }
}

// The three bfloat16 pieces of the float32 weights w0, w1, w2 (n elements
// each, n % 4 == 0): hi = bf16(w), mid = bf16(w - hi), lo = bf16(w - hi -
// mid), each rounded to nearest even (the differences are exact in
// float32), into pieces[3][3][n], piece p of weight i at (3 p + i) n.
__global__ void __launch_bounds__(256) split_pieces_kernel(
    const float* __restrict__ w0, const float* __restrict__ w1, const float* __restrict__ w2,
    bf16* __restrict__ pieces, int n) {
  const int per = n / 4, i4 = blockIdx.x * blockDim.x + threadIdx.x;
  if (i4 >= 3 * per) return;
  const int m = i4 / per, j = 4 * (i4 - m * per);
  const float4 x = load4((m == 0 ? w0 : (m == 1 ? w1 : w2)) + j);
  const float xs[4] = {x.x, x.y, x.z, x.w};
  uint32_t bits[3][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bf16 hi = __float2bfloat16_rn(xs[e]);
    const float r = xs[e] - __bfloat162float(hi);
    const bf16 mid = __float2bfloat16_rn(r);
    const bf16 lo = __float2bfloat16_rn(r - __bfloat162float(mid));
    bits[0][e] = __bfloat16_as_ushort(hi);
    bits[1][e] = __bfloat16_as_ushort(mid);
    bits[2][e] = __bfloat16_as_ushort(lo);
  }
#pragma unroll
  for (int p = 0; p < 3; ++p)
    *reinterpret_cast<uint2*>(pieces + (size_t)(3 * p + m) * n + j) =
        make_uint2(bits[p][0] | (bits[p][1] << 16), bits[p][2] | (bits[p][3] << 16));
}

inline cudaError_t launch_split_pieces(const float* w0, const float* w1, const float* w2,
                                       bf16* pieces, int n, cudaStream_t stream) {
  if (n % 4) return cudaErrorInvalidValue;
  const int threads = 3 * (n / 4);
  split_pieces_kernel<<<(threads + 255) / 256, 256, 0, stream>>>(w0, w1, w2, pieces, n);
  return cudaGetLastError();
}

// projected_core_kernel<NP, BiasT, STREAM, SCRATCH> on the caller's maps
// (wrows: the rows of one weight in a pieces' map, 0 for three maps): D
// input columns, Dout = HD H output columns.
template <int NP, typename BiasT, bool STREAM = false, bool SCRATCH = false>
cudaError_t launch_projected_core(const CUtensorMap& mq, const CUtensorMap& mkv,
                                  const CUtensorMap& mwq, const CUtensorMap& mwk,
                                  const CUtensorMap& mwv, const BiasT* bq, const BiasT* bk,
                                  const BiasT* bv, const float* mask, bf16* out, int N, int T,
                                  int D, int Dout, int wrows, cudaStream_t stream,
                                  float* kscr = nullptr, float* vscr = nullptr) {
  const int tpad = (T + 63) / 64 * 64;
  int stages, smem;
  if (STREAM) {
    const int fixed = pc_stream_fixed_smem();
    const int fit = (SMEM_MAX - 1024 - fixed) / (int)qc_stage_bytes(NP);
    stages = fit < QC_MAX_STAGES ? fit : QC_MAX_STAGES;
    smem = 1024 + stages * (int)qc_stage_bytes(NP) + fixed;
  } else {
    const int rows = tpad > HD ? tpad : HD;  // the split state fits over k | v
    stages = qc_stages(rows, NP);
    smem = qc_smem(rows, NP);
  }
  if (stages < 1) return cudaErrorInvalidValue;
  auto kernel = projected_core_kernel<NP, BiasT, STREAM, SCRATCH>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<N * (Dout / HD), QC_THREADS, smem, stream>>>(
      mq, mkv, mwq, mwk, mwv, bq, bk, bv, mask, out, kscr, vscr, T, D, Dout / HD, stages, wrows);
  return cudaGetLastError();
}

// B2-bf16 on bfloat16 weights: the streaming form, at any T.
inline cudaError_t projected_bf16(const bf16* q_src, const bf16* kv_src, const bf16* wq,
                                  const bf16* bq, const bf16* wk, const bf16* bk, const bf16* wv,
                                  const bf16* bv, const float* mask, bf16* out, int N, int T,
                                  int D, int Dout, cudaStream_t stream) {
  if (D % 64 || Dout % HD) return cudaErrorInvalidValue;
  CUtensorMap mq, mkv, mwq, mwk, mwv;
  cudaError_t err = make_tile_map(&mq, q_src, D, T, N, D, 64);
  if (err == cudaSuccess) err = make_tile_map(&mkv, kv_src, D, T, N, D, 64);
  if (err == cudaSuccess) err = make_tile_map(&mwq, wq, D, Dout, 1, D, 64);
  if (err == cudaSuccess) err = make_tile_map(&mwk, wk, D, Dout, 1, D, 64);
  if (err == cudaSuccess) err = make_tile_map(&mwv, wv, D, Dout, 1, D, 64);
  if (err != cudaSuccess) return err;
  return launch_projected_core<1, bf16, true>(mq, mkv, mwq, mwk, mwv, bq, bk, bv, mask, out, N,
                                              T, D, Dout, 0, stream);
}

}  // namespace hig

// B2-bf16 (its streaming form, at any T). Returns the first cudaError_t.
extern "C" int hig_projected_attention_bf16(
    const hig::bf16* q_src, const hig::bf16* kv_src,
    const hig::bf16* wq, const hig::bf16* bq, const hig::bf16* wk, const hig::bf16* bk,
    const hig::bf16* wv, const hig::bf16* bv, const float* mask, hig::bf16* out,
    int N, int T, int D, int Dout, void* stream_ptr) {
  return hig::projected_bf16(q_src, kv_src, wq, bq, wk, bk, wv, bv, mask, out, N, T, D, Dout,
                             static_cast<cudaStream_t>(stream_ptr));
}

// The weight split alone: `pieces` (3, 3 Dout, D) bfloat16 from wq, wk, wv
// (Dout, D) float32. Returns the cudaError_t of the launch.
extern "C" int hig_split_bf16_pieces(const float* wq, const float* wk, const float* wv,
                                     hig::bf16* pieces, int D, int Dout, void* stream_ptr) {
  return hig::launch_split_pieces(wq, wk, wv, pieces, Dout * D,
                                  static_cast<cudaStream_t>(stream_ptr));
}

namespace hig {

// B2-bf16a: the weight split into `pieces` (3, 3 Dout, D) bfloat16 scratch,
// then the kernel on three pieces, its whole form (T up to
// qc_whole_max_t(3, 1)) or its streaming form (kscr, vscr its scratch).
template <bool STREAM>
int projected_bf16a(const bf16* q_src, const bf16* kv_src, const float* wq, const float* bq,
                    const float* wk, const float* bk, const float* wv, const float* bv,
                    const float* mask, bf16* pieces, bf16* out, float* kscr, float* vscr,
                    int N, int T, int D, int Dout, cudaStream_t stream) {
  if ((!STREAM && (T + 63) / 64 * 64 > qc_whole_max_t(3, 1)) || D % 64 || Dout % HD)
    return cudaErrorInvalidValue;
  CUtensorMap mq, mkv, mw;
  cudaError_t err = launch_split_pieces(wq, wk, wv, pieces, Dout * D, stream);
  if (err == cudaSuccess) err = make_tile_map(&mq, q_src, D, T, N, D, 64);
  if (err == cudaSuccess) err = make_tile_map(&mkv, kv_src, D, T, N, D, 64);
  if (err == cudaSuccess) err = make_tile_map(&mw, pieces, D, 3 * Dout, 3, D, 64);
  if (err != cudaSuccess) return err;
  return launch_projected_core<3, float, STREAM, STREAM>(mq, mkv, mw, mw, mw, bq, bk, bv, mask,
                                                         out, N, T, D, Dout, Dout, stream, kscr,
                                                         vscr);
}

}  // namespace hig

// B2-bf16a's whole form. Returns the first cudaError_t.
extern "C" int hig_projected_attention_bf16a(
    const hig::bf16* q_src, const hig::bf16* kv_src,
    const float* wq, const float* bq, const float* wk, const float* bk,
    const float* wv, const float* bv, const float* mask, hig::bf16* pieces, hig::bf16* out,
    int N, int T, int D, int Dout, void* stream_ptr) {
  return hig::projected_bf16a<false>(q_src, kv_src, wq, bq, wk, bk, wv, bv, mask, pieces, out,
                                     nullptr, nullptr, N, T, D, Dout,
                                     static_cast<cudaStream_t>(stream_ptr));
}

// B2-bf16a's streaming form, any T: kscr and vscr (N * Dout / HD, tpad, HD)
// float32 scratch, tpad = T rounded up to 64. Returns the first cudaError_t.
extern "C" int hig_projected_attention_bf16a_stream(
    const hig::bf16* q_src, const hig::bf16* kv_src,
    const float* wq, const float* bq, const float* wk, const float* bk,
    const float* wv, const float* bv, const float* mask, hig::bf16* pieces, hig::bf16* out,
    float* kscr, float* vscr, int N, int T, int D, int Dout, void* stream_ptr) {
  return hig::projected_bf16a<true>(q_src, kv_src, wq, bq, wk, bk, wv, bv, mask, pieces, out,
                                    kscr, vscr, N, T, D, Dout,
                                    static_cast<cudaStream_t>(stream_ptr));
}

// The most key rows of B2-bf16a's whole form at this library's head width.
extern "C" int hig_projected_attention_bf16a_max_t() { return hig::qc_whole_max_t(3, 1); }
