// Single-head blocked dot-product attention for Hopper (sm_90a): kernels B5,
// B6, B10 and B4.
//
// Replaces, in tch_geometric_tpu/ops/attention_blocked.py:
//   B5  _sddmm_kernel and _sddmm_kernel_v2 (sddmm_blocked_pallas[_v2]): the
//       per-lane score s[e] = <x_dst[dst(e)], x_src[src(e)]>, 0 on pad lanes
//       (v1 and v2 differ only in the TPU's lane/sublane orientation);
//   B6  _mz_kernel + _att_kernel (edge_softmax_blocked): the per-dst-row
//       softmax of (T, C) scores, 0 on pad lanes;
//   B10 _sddmm_mz_kernel + _att_w_fused_kernel (attend_blocked_fused): the
//       scores and the row stats (max m, sum z), then each lane normalised,
//       w = exp(s - m) / z, and bf16(w * x_src[src]) added into its row;
//   B4  _flash_kernel_row / _flash_kernel_scalar (attend_blocked_flash):
//       out[r] = sum bf16(e) * x_src[src] / sum e, e the lane's softmax
//       weight against a running max, 0 where the sum is not positive.
//
// What the TPU kernels did.  The Pallas kernels consume a pre-gathered
// (T, C, F) tensor (32.7 GB at ogbn-products size in bf16) and carry a row
// block's stats and output tile across sequential grid steps.  Here the
// kernels read each live lane's row themselves, so nothing of that size
// exists; x_dst rows past dst_rows read as zeros (the TPU padded x_dst to
// B*W rows with a copy).
//
// What bounds them on an H100 (3.35 TB/s), at products size, F=256 bf16,
// x_dst = x_src as the example calls it: x once, the lane metadata once and
// the output once are about 2.0 GB for B5, 0.77 GB for B6 and 4.3 GB for B4
// and B10 (0.60, 0.23 and 1.28 ms; a distinct x_dst adds 1.25 GB); the
// operations (two per lane and column, one exp per lane) are far below the
// float32 rate, so every kernel is bound by bytes.  A gather cannot reach
// that bound: each live lane reads its source row (61.9M lanes x 512 B =
// 31.7 GB, about 9.5 ms from HBM; the Zipf sources' popular rows partly
// come from L2, as for B1).  So B5, B4 and B10 are built as B1 is
// (spmm_blocked.cu): whole rows, many in flight, each read once (B10: once
// for the scores, once for the sum).
//
// B5 and B4: row-grouped chunks (blocked_common.cuh, stage_pass).
//  * One CUDA block per chunk stages the chunk's local_row and edge_src in
//    shared memory (B5 also each lane's position in the chunk), drops the
//    pads and counting-sorts the live lanes by row; chunks wider than
//    kMaxStage lanes are done in passes.  A warp takes a piece of at most
//    kPiece lanes of one row, loads the destination row once into registers
//    (B5: a 256-column slab at a time) and streams the pieces' source rows
//    with the widest vector load that divides F and both row tables'
//    addresses (16, 8, 4 bytes or one element), several rows in flight,
//    float32 sums.
//  * B5 sums each row's dot product by a warp all-reduce (five shuffles a
//    row and slab) and lane j's thread keeps lane j's score; the scores go
//    into the stage at their lanes' positions and the chunk is written back
//    coalesced, pads as 0: every lane is written once, with no atomic and
//    no zero pass.  (32 partial sums a thread and one butterfly
//    reduce-scatter a piece took fewer shuffles but 80 registers and spills,
//    and read 18.2 ms at F=256 bf16 on an NVIDIA H100 80GB HBM3 at 700 W,
//    against 9.3 ms for the all-reduce.)
//  * B4 runs an online softmax per piece in registers.  For F <= 256 (one
//    slab of 8 f32 sums a thread) each batch of rows in flight gives its
//    scores by warp all-reduces; the piece's running max m moves once per
//    batch, the f32 accumulator and z are rescaled by exp(m_old - m_new),
//    then each row adds round_to<T>(exp(s - m)) * x and z the f32 e.  Each
//    source row is read once; there is no (T, C) score scratch and no
//    shared float atomic.  Wider rows take two sweeps over the piece: the
//    first computes its 32 scores as B5 does, so m is the piece's max; the
//    second adds the weighted rows slab by slab.
//  * Owned and split rows (Piece::own, as in B1): an owned row is stored as
//    acc / z into the (B*W, F) output, with its (m, z) in the row stats.
//    Every other piece (each chunk's first and last row, rows of more than
//    kPiece lanes, every piece when a chunk takes several passes) writes
//    (row, m, z, acc) to a slot of the split-row scratch.  A first kernel
//    (flash_count_kernel) counts each chunk's split pieces in the same passes
//    and resets the row stats; the wrapper scans the counts into slot
//    offsets (S slots of F + 3 floats; the host reads S to size the scratch).
//    A last kernel (flash_merge_kernel), one CUDA block per row block,
//    merges each split row's slots by the max rescale (a flash-decoding
//    combine): Z = sum z_p exp(m_p - ref), out = sum acc_p exp(m_p - ref) /
//    max(Z, 1e-20) where Z > 0, added by vector atomics onto the zeroed row;
//    it zeroes the rows no lane reaches.  The three kernels are one B4 call.
//  * Stat modes.  Per row (row_stats) ref is the row's max over its pieces.
//    Per chunk (scalar) the plain version weighs each lane by exp(s -
//    M_chunk) and combines chunks with exp(M - m) factors: in exact
//    arithmetic the weight is exp(s - M_block), M_block the row block's
//    largest lane score.  So the merge takes ref = M_block (the block's
//    largest piece max) for split rows, and rescales an owned row by
//    z exp(m - M_block): 0 sets it to 0, below 1e-20 it follows the plain
//    version's max(z, 1e-20) division.  A row whose scores all sit more
//    than about 104 below M_block (e underflows to 0 in float32) reads 0 in
//    both, whether its chunk's max or its own lies that far below.
//  * Rounding points.  The plain version rounds bf16(e) against the running
//    row max after each chunk (row stats) or against M_chunk (scalar); the
//    kernel rounds it against the piece's running max (one batch of rows at
//    a time), or the piece's max on the wide path.  In exact arithmetic the
//    same function; a bf16 term can round the other way, 2**-9 of it, which
//    the bf16 limit of utils/kernel_gates.py covers.  Between 87 and 104
//    below the reference, the plain version's subnormal e lose bits that the
//    kernel's normal ones keep.  No fast math: the z > 0 guards rely on IEEE
//    exp and subnormals.
//  * Determinism: the counting sort places a row's lanes by shared atomics
//    on its cursor, split pieces take slots by a shared atomic and the merge
//    adds them by global atomics, so each row's summation order, and in B4
//    its running max, can change from run to run.  Against the plain
//    versions the kernels differ by summation order and the rounding points
//    above.
//
// B10: three steps in one call, on B5's and B1's row-grouped chunks.  (a)
// B5's kernel scores the scaled x_dst into the (T, C) scratch s (0.26 GB at
// products size, as the TPU kernel keeps it).  (b) One CUDA block per row
// block takes each row's (m, z) from s in B6's two sweeps (max, then the
// exp-sum; edge_softmax_kernel<true> writes the stats, not the weights).
// (c) B1's row-grouped weighted sum (blocked::rows_kernel, described in
// spmm_blocked.cu) with the SoftmaxLanes policy: at staging each live lane's
// weight softmax_weight(s, m, z) is computed once from its score and its
// row's stats, and a warp adds bf16(w * x_src[src]) over a piece, the
// product rounded on its own, each source row read whole and once; owned
// rows are stored, split rows added by vector atomics onto rows a zero pass
// cleared.  No shared-memory float atomic per lane and column is left; the
// old pass A re-read the destination row for each lane, and pass B added
// each lane's 64-column pieces into a shared tile with two atomics per
// column.  Folding (b) into (a) (each piece's max and sum by warp
// reductions, split pieces combined as B4 does) would save (b)'s two reads
// of s and local_row; it is not done until a measurement shows it faster.
//
// B6 keeps the first design: one CUDA block owns a row block and walks its
// chunks in a loop, with the W rows' (m, z) in shared memory, taken in two
// sweeps (max, then the exp-sum) instead of the online recurrence: the same
// function up to float32 rounding.  Rows in the compute dtype, every sum in
// float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "blocked_common.cuh"

namespace {

using blocked::allow_smem;
using blocked::atomic_max_float;
using blocked::kFull;
using blocked::round_to;
using blocked::softmax_weight;

constexpr int kThreads = 512;            // 16 warps per CUDA block (B6,
                                         // B10's row stats)

// z[r] += exp(s[e] - m[r]) over the valid lanes of [e_begin, e_end).
__device__ __forceinline__ void row_expsum(const float* s,
                                           const int32_t* local_row,
                                           int64_t e_begin, int64_t e_end,
                                           int W, const float* m, float* z) {
  for (int64_t e = e_begin + threadIdx.x; e < e_end; e += kThreads) {
    const int r = local_row[e];
    if (r < W) atomicAdd(z + r, expf(s[e] - m[r]));
  }
}

// ---- B6, and B10's row stats: one CUDA block per row block ---------------
// The per-row softmax of the scores in two sweeps (max, then the exp-sum),
// then each lane's weight into att; with kStats (B10) the W rows' (m, z)
// into m_out and z_out instead.
template <bool kStats>
__global__ void __launch_bounds__(kThreads)
edge_softmax_kernel(const float* __restrict__ scores,
                    const int32_t* __restrict__ local_row,
                    const int32_t* __restrict__ block_start, int C, int W,
                    float* __restrict__ att, float* __restrict__ m_out,
                    float* __restrict__ z_out) {
  extern __shared__ float stats[];
  float* m = stats;                      // W row maxima
  float* z = stats + W;                  // W row sums
  const int b = blockIdx.x;
  for (int r = threadIdx.x; r < W; r += kThreads) {
    m[r] = -CUDART_INF_F;
    z[r] = 0.f;
  }
  __syncthreads();
  const int64_t e_begin = static_cast<int64_t>(block_start[b]) * C;
  const int64_t e_end = static_cast<int64_t>(block_start[b + 1]) * C;
  // pad lanes (local_row == W) are skipped, whatever their score holds
  for (int64_t e = e_begin + threadIdx.x; e < e_end; e += kThreads) {
    const int r = local_row[e];
    if (r < W) atomic_max_float(m + r, scores[e]);
  }
  __syncthreads();
  row_expsum(scores, local_row, e_begin, e_end, W, m, z);
  __syncthreads();
  if constexpr (kStats) {
    for (int r = threadIdx.x; r < W; r += kThreads) {
      m_out[static_cast<int64_t>(b) * W + r] = m[r];
      z_out[static_cast<int64_t>(b) * W + r] = z[r];
    }
  } else {
    for (int64_t e = e_begin + threadIdx.x; e < e_end; e += kThreads) {
      const int r = local_row[e];
      att[e] = r < W ? softmax_weight(scores[e], m[r], z[r]) : 0.f;
    }
  }
}

// B10's Lanes policy of blocked::rows_kernel: each lane's weight
// softmax_weight(s, m, z) from its score and its row's stats, computed once
// at staging; terms bf16(w * x), as B8 rounds them.
struct SoftmaxLanes {
  static constexpr bool kAux = true, kRound = true;
  // as B8's one head (blocked::StagedWeight<true>): 22.7 ms at F=256 bf16
  // against 25.5 with four CUDA blocks an SM (NVIDIA H100 80GB HBM3, 700 W;
  // scripts/time_csrc_variants.py)
  static constexpr int kMinBlocks = 3;
  const float* s;
  const float* m;
  const float* z;
  __device__ int aux(int64_t e, int, int64_t row) const {
    return __float_as_int(softmax_weight(s[e], m[row], z[row]));
  }
  template <int kDepth, int kNV>
  __device__ blocked::LaneWeight weights(const int* aux_s,
                                         blocked::Piece pc, int lane,
                                         int64_t) const {
    return blocked::lane_weight(aux_s, pc, lane);
  }
};

// ---- B5 and B4: row-grouped chunks ----------------------------------------

using blocked::kAcc;
using blocked::kMaxStage;
using blocked::kPiece;
using blocked::kRowThreads;
using blocked::kRowWarps;
using blocked::kSlab;
using blocked::Piece;
using blocked::put;
using blocked::Stage;
using blocked::unpack;
using blocked::Vec;

// 3 CUDA blocks an SM, at most 80 registers a thread.  Against 4 blocks (64
// registers, B5 spilling 24-108 bytes) on an NVIDIA H100 80GB HBM3 at 700 W:
// B5 at F=256 9.3 ms against 10.6 in bf16, 17.0 against 18.1 in f32 (but
// 7.3 against 6.7 at F=100); B4 in f32 21.0 against 22.9.
constexpr int kRowMinBlocks = 3;

using blocked::warp_max;
using blocked::warp_sum;

// This thread's kAcc columns c0 + (k*32 + lane)*kVec .. +kVec, k < kAcc /
// kVec, of the slab at c0 of `row` as floats; 0 where a column does not
// exist or row is null (a destination row past dst_rows).
template <typename T, int kVec>
__device__ __forceinline__ void load_slab(const T* __restrict__ row, int c0,
                                          int F, int lane, float* d) {
  using Raw = typename Vec<T, kVec>::Raw;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) d[i] = 0.f;
  if (row == nullptr) return;            // warp-uniform
#pragma unroll
  for (int k = 0; k < kAcc / kVec; ++k) {
    const int c = c0 + (k * 32 + lane) * kVec;
    if (c < F) unpack(__ldg(reinterpret_cast<const Raw*>(row + c)), d + k * kVec);
  }
}

// Loads the slab at c0 of the source rows of a piece's lanes j .. j+kDepth
// (those below len; my_src is lane `lane`'s source) into v.
template <typename T, int kVec, int kDepth>
__device__ __forceinline__ void load_rows(
    const T* __restrict__ xs, int F, int c0, int my_src, int j, int len,
    int lane, typename Vec<T, kVec>::Raw (&v)[kDepth][kAcc / kVec]) {
  using Raw = typename Vec<T, kVec>::Raw;
#pragma unroll
  for (int u = 0; u < kDepth; ++u) {
    const int64_t src = __shfl_sync(kFull, my_src, (j + u) & 31);
    if (j + u < len) {                   // warp-uniform
      const T* row = xs + src * F;
#pragma unroll
      for (int k = 0; k < kAcc / kVec; ++k) {
        const int c = c0 + (k * 32 + lane) * kVec;
        if (c < F) v[u][k] = __ldg(reinterpret_cast<const Raw*>(row + c));
      }
    }
  }
}

// This thread's part of <d, row> over its columns of the slab at c0.
template <typename T, int kVec>
__device__ __forceinline__ float dot_part(
    const typename Vec<T, kVec>::Raw (&v)[kAcc / kVec], const float* d, int c0,
    int F, int lane) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kAcc / kVec; ++k) {
    if (c0 + (k * 32 + lane) * kVec >= F) continue;
    float f[kVec];
    unpack(v[k], f);
#pragma unroll
    for (int e = 0; e < kVec; ++e) s = fmaf(d[k * kVec + e], f[e], s);
  }
  return s;
}

// acc += w * row over this thread's columns of a slab.
template <typename T, int kVec>
__device__ __forceinline__ void add_row(
    const typename Vec<T, kVec>::Raw (&v)[kAcc / kVec], float w, int c0, int F,
    int lane, float* acc) {
#pragma unroll
  for (int k = 0; k < kAcc / kVec; ++k) {
    if (c0 + (k * 32 + lane) * kVec >= F) continue;
    float f[kVec];
    unpack(v[k], f);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      acc[k * kVec + e] = fmaf(w, f[e], acc[k * kVec + e]);
  }
}

// Writes a slab's sums to o (a row of F floats): acc / z where z > 0, else
// 0 (divide: an owned output row), or acc itself (a split-row slot).
template <int kVec>
__device__ __forceinline__ void store_slab(float* __restrict__ o,
                                           const float* acc, int c0, int F,
                                           int lane, bool divide, float z) {
#pragma unroll
  for (int k = 0; k < kAcc / kVec; ++k) {
    const int c = c0 + (k * 32 + lane) * kVec;
    if (c >= F) continue;
    float r[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float a = acc[k * kVec + e];
      r[e] = !divide ? a : z > 0.f ? a / fmaxf(z, 1e-20f) : 0.f;
    }
    put<kVec>(o + c, r, false);
  }
}

// The scores <xd_row, xs[src]> of a piece's len <= 32 lanes (my_src is lane
// `lane`'s source); thread j returns lane j's, 0 for j >= len.  xd_row null
// reads as a zero row.  Slab by slab: the destination slab in registers,
// then the lanes' rows, kDepth in flight, each row's dot product summed by
// a warp all-reduce and kept by its lane's thread.
template <typename T, int kVec>
__device__ __forceinline__ float piece_scores(const T* xd_row,
                                              const T* __restrict__ xs, int F,
                                              int my_src, int len, int lane) {
  using Raw = typename Vec<T, kVec>::Raw;
  constexpr int kDepth = blocked::load_depth<T, kVec>();
  float my_s = 0.f;
  for (int c0 = 0; c0 < F; c0 += kSlab) {
    float d[kAcc];
    load_slab<T, kVec>(xd_row, c0, F, lane, d);
    for (int j = 0; j < len; j += kDepth) {
      Raw v[kDepth][kAcc / kVec];
      load_rows<T, kVec, kDepth>(xs, F, c0, my_src, j, len, lane, v);
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        if (j + u >= len) continue;      // warp-uniform
        const float s = warp_sum(dot_part<T, kVec>(v[u], d, c0, F, lane));
        if (lane == j + u) my_s += s;
      }
    }
  }
  return my_s;
}

// ---- B5 -------------------------------------------------------------------
template <typename T, int kVec>
__global__ void __launch_bounds__(kRowThreads, kRowMinBlocks)
sddmm_rows_kernel(const T* __restrict__ xd, int64_t nd,
                  const T* __restrict__ xs,
                  const int32_t* __restrict__ edge_src,
                  const int32_t* __restrict__ local_row,
                  const int32_t* __restrict__ chunk_block, int C, int W, int F,
                  int stage, float* __restrict__ out) {
  extern __shared__ int4 smem[];
  const Stage st(smem, stage, W);
  int* src_s = st.lanes;
  int* pos_s = src_s + stage;            // each sorted lane's chunk position
  // once the lanes are sorted, row_s holds the pass's scores by position
  float* score_s = reinterpret_cast<float*>(st.row_s);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t chunk0 = static_cast<int64_t>(blockIdx.x) * C;
  const int64_t dst0 = static_cast<int64_t>(chunk_block[blockIdx.x]) * W;

  for (int s0 = 0; s0 < C; s0 += stage) {
    const int n = min(stage, C - s0);
    const int64_t e0 = chunk0 + s0;
    const int num_pieces = blocked::stage_pass(
        local_row, e0, n, W, false, st,
        [&](int i, int pos) {
          src_s[pos] = edge_src[e0 + i];
          pos_s[pos] = i;
        },
        [&](int i) { score_s[i] = 0.f; });
    for (int p = warp; p < num_pieces; p += kRowWarps) {
      const Piece pc = st.piece[p];
      const int64_t dst = dst0 + pc.row;
      const int my_src = lane < pc.len ? src_s[pc.start + lane] : 0;
      float s = 0.f;                     // a dst row past nd is a zero row
      if (dst < nd)
        s = piece_scores<T, kVec>(xd + dst * F, xs, F, my_src, pc.len, lane);
      if (lane < pc.len) score_s[pos_s[pc.start + lane]] = s;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kRowThreads) out[e0 + i] = score_s[i];
    __syncthreads();                     // the next pass reuses the stage
  }
}

// ---- B4 -------------------------------------------------------------------

// One piece, F <= kSlab: an online softmax over batches of kDepth rows.
// Writes the piece's sums to o (divide: acc / z, an owned row) and returns
// its running max m and sum z.
template <typename T, int kVec>
__device__ __forceinline__ void flash_piece(const T* xd_row,
                                            const T* __restrict__ xs, int F,
                                            int my_src, int len, int lane,
                                            float* __restrict__ o, bool divide,
                                            float& m_out, float& z_out) {
  using Raw = typename Vec<T, kVec>::Raw;
  constexpr int kDepth = blocked::load_depth<T, kVec>();
  float d[kAcc], acc[kAcc];
  load_slab<T, kVec>(xd_row, 0, F, lane, d);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float m = -CUDART_INF_F, z = 0.f;
  for (int j = 0; j < len; j += kDepth) {
    Raw v[kDepth][kAcc / kVec];
    load_rows<T, kVec, kDepth>(xs, F, 0, my_src, j, len, lane, v);
    float s[kDepth];
    float mb = -CUDART_INF_F;
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      s[u] = 0.f;
      if (j + u < len) {                 // warp-uniform
        s[u] = warp_sum(dot_part<T, kVec>(v[u], d, 0, F, lane));
        mb = fmaxf(mb, s[u]);
      }
    }
    // the butterfly leaves every thread the same sums: a warp-uniform branch
    if (mb > m) {
      const float f = expf(m - mb);      // 0 for the first batch
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] *= f;
      z *= f;
      m = mb;
    }
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      if (j + u >= len) continue;
      const float e = expf(s[u] - m);
      z += e;
      add_row<T, kVec>(v[u], blocked::round_to<T>(e), 0, F, lane, acc);
    }
  }
  store_slab<kVec>(o, acc, 0, F, lane, divide, z);
  m_out = m;
  z_out = z;
}

// One piece, F > kSlab: its scores first (piece_scores), so m is the
// piece's max, then a second sweep over its rows adds round_to<T>(e) * x
// slab by slab.
template <typename T, int kVec>
__device__ __forceinline__ void flash_piece_wide(
    const T* xd_row, const T* __restrict__ xs, int F, int my_src, int len,
    int lane, float* __restrict__ o, bool divide, float& m_out,
    float& z_out) {
  using Raw = typename Vec<T, kVec>::Raw;
  constexpr int kDepth = blocked::load_depth<T, kVec>();
  const float s = piece_scores<T, kVec>(xd_row, xs, F, my_src, len, lane);
  const bool live = lane < len;
  const float m = warp_max(live ? s : -CUDART_INF_F);
  const float e = live ? expf(s - m) : 0.f;
  const float z = warp_sum(e);
  const float w = blocked::round_to<T>(e);
  for (int c0 = 0; c0 < F; c0 += kSlab) {
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    for (int j = 0; j < len; j += kDepth) {
      Raw v[kDepth][kAcc / kVec];
      load_rows<T, kVec, kDepth>(xs, F, c0, my_src, j, len, lane, v);
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const float wu = __shfl_sync(kFull, w, (j + u) & 31);
        if (j + u < len) add_row<T, kVec>(v[u], wu, c0, F, lane, acc);
      }
    }
    store_slab<kVec>(o, acc, c0, F, lane, divide, z);
  }
  m_out = m;
  z_out = z;
}

// Before flash_rows_kernel, one CUDA block per chunk: counts the chunk's
// split pieces — every piece flash_rows_kernel will not own, in the same
// passes — into split[t], and when the chunk is its row block's first sets
// the block's row stats to (m, z) = (-inf, 0).
__global__ void __launch_bounds__(kRowThreads)
flash_count_kernel(const int32_t* __restrict__ local_row,
                   const int32_t* __restrict__ chunk_block, int C, int W,
                   int stage, int32_t* __restrict__ split,
                   float* __restrict__ row_m, float* __restrict__ row_z) {
  extern __shared__ int cnt[];           // W lane counts of the pass
  const int t = blockIdx.x;
  const int b = chunk_block[t];
  if (t == 0 || chunk_block[t - 1] != b) {
    for (int r = threadIdx.x; r < W; r += kRowThreads) {
      row_m[static_cast<int64_t>(b) * W + r] = -CUDART_INF_F;
      row_z[static_cast<int64_t>(b) * W + r] = 0.f;
    }
  }
  const blocked::SplitCount sc = blocked::count_split_pieces(
      local_row, static_cast<int64_t>(t) * C, C, W, stage, cnt);
  if (threadIdx.x == 0) split[t] = sc.pieces;
}

// One CUDA block per chunk: stage and sort it, then each warp takes pieces.
// An owned row is stored as acc / z into out, with (m, z) in the row stats;
// a split piece takes the next of the chunk's slots [slot_off[t],
// slot_off[t+1]) for (row, m, z, acc).
template <typename T, int kVec, bool kWide>
__global__ void __launch_bounds__(kRowThreads, kRowMinBlocks)
flash_rows_kernel(const T* __restrict__ xd, int64_t nd,
                  const T* __restrict__ xs,
                  const int32_t* __restrict__ edge_src,
                  const int32_t* __restrict__ local_row,
                  const int32_t* __restrict__ chunk_block,
                  const int32_t* __restrict__ slot_off, int C, int W, int F,
                  int stage, int direct, float* __restrict__ out,
                  float* __restrict__ row_m, float* __restrict__ row_z,
                  int32_t* __restrict__ slot_row, float* __restrict__ slot_m,
                  float* __restrict__ slot_z, float* __restrict__ slot_acc) {
  extern __shared__ int4 smem[];
  const Stage st(smem, stage, W);
  int* src_s = st.lanes;
  __shared__ int next_slot;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x;
  const int64_t chunk0 = static_cast<int64_t>(t) * C;
  const int64_t dst0 = static_cast<int64_t>(chunk_block[t]) * W;
  const int slot_end = slot_off[t + 1];
  if (threadIdx.x == 0) next_slot = slot_off[t];   // stage_pass's barriers
                                                   // publish it
  for (int s0 = 0; s0 < C; s0 += stage) {
    const int n = min(stage, C - s0);
    const int64_t e0 = chunk0 + s0;
    const int num_pieces = blocked::stage_pass(
        local_row, e0, n, W, direct && n == C, st,
        [&](int i, int pos) { src_s[pos] = edge_src[e0 + i]; }, [](int) {});
    for (int p = warp; p < num_pieces; p += kRowWarps) {
      const Piece pc = st.piece[p];
      const int64_t dst = dst0 + pc.row;
      const T* xd_row = dst < nd ? xd + dst * F : nullptr;
      const int my_src = lane < pc.len ? src_s[pc.start + lane] : 0;
      int slot = 0;
      if (!pc.own) {
        if (lane == 0) slot = atomicAdd(&next_slot, 1);
        slot = __shfl_sync(kFull, slot, 0);
        if (slot >= slot_end) __trap();  // the count disagrees: fail loudly
      }
      float* o = pc.own ? out + dst * F
                        : slot_acc + static_cast<int64_t>(slot) * F;
      float m, z;
      if constexpr (kWide)
        flash_piece_wide<T, kVec>(xd_row, xs, F, my_src, pc.len, lane, o,
                                  pc.own, m, z);
      else
        flash_piece<T, kVec>(xd_row, xs, F, my_src, pc.len, lane, o, pc.own,
                             m, z);
      if (lane == 0) {
        if (pc.own) {
          row_m[dst] = m;
          row_z[dst] = z;
        } else {
          slot_row[slot] = pc.row;
          slot_m[slot] = m;
          slot_z[slot] = z;
        }
      }
    }
    __syncthreads();                     // the next pass reuses the stage
  }
}

// Elements per load of both row tables: the widest that divides F and both
// addresses (vec_elems), so each is a power of two dividing the other.
inline int pair_vec(const void* xd, const void* xs, int F, int elem_bytes) {
  return std::min(blocked::vec_elems(xd, F, elem_bytes),
                  blocked::vec_elems(xs, F, elem_bytes));
}

// Lanes staged per pass, and whether a chunk is one pass (owned rows).
inline int row_stage(int C) { return std::min(C, kMaxStage); }

template <typename T, int kVec>
cudaError_t launch_sddmm(const void* xd, int64_t nd, const void* xs,
                         const int32_t* edge_src, const int32_t* local_row,
                         const int32_t* chunk_block, int num_chunks, int C,
                         int W, int F, float* out, cudaStream_t stream) {
  const int stage = row_stage(C);
  const size_t smem = blocked::stage_smem_bytes(stage, W, 2);
  auto kernel = sddmm_rows_kernel<T, kVec>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<num_chunks, kRowThreads, smem, stream>>>(
      static_cast<const T*>(xd), nd, static_cast<const T*>(xs), edge_src,
      local_row, chunk_block, C, W, F, stage, out);
  return cudaGetLastError();
}

template <typename T, int kVec>
cudaError_t launch_flash(const void* xd, int64_t nd, const void* xs,
                         bool row_stats, const int32_t* edge_src,
                         const int32_t* local_row, const int32_t* chunk_block,
                         const int32_t* block_start, const int32_t* slot_off,
                         int num_chunks, int num_blocks, int C, int W, int F,
                         float* row_m, float* row_z, int32_t* slot_row,
                         float* slot_m, float* slot_z, float* slot_acc,
                         float* out, cudaStream_t stream) {
  const int stage = row_stage(C);
  const size_t smem = blocked::stage_smem_bytes(stage, W, 1);
  auto kernel = F > kSlab ? &flash_rows_kernel<T, kVec, true>
                          : &flash_rows_kernel<T, kVec, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<num_chunks, kRowThreads, smem, stream>>>(
      static_cast<const T*>(xd), nd, static_cast<const T*>(xs), edge_src,
      local_row, chunk_block, slot_off, C, W, F, stage, stage == C ? 1 : 0,
      out, row_m, row_z, slot_row, slot_m, slot_z, slot_acc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return blocked::launch_merge(row_stats, block_start, slot_off, num_blocks,
                               W, 1, F, slot_row, slot_m, slot_z, slot_acc,
                               row_m, row_z, out, nullptr, stream);
}

// B5 on the widest load that divides F and both row tables' addresses.
cudaError_t launch_sddmm_vec(const void* xd, int64_t nd, const void* xs,
                             bool bf16, const int32_t* edge_src,
                             const int32_t* local_row,
                             const int32_t* chunk_block, int num_chunks,
                             int C, int W, int F, float* out,
                             cudaStream_t st) {
#define TGT_SDDMM(T, V)                                                    \
  launch_sddmm<T, V>(xd, nd, xs, edge_src, local_row, chunk_block,         \
                     num_chunks, C, W, F, out, st)
  if (bf16) {
    switch (pair_vec(xd, xs, F, 2)) {
      case 8: return TGT_SDDMM(__nv_bfloat16, 8);
      case 4: return TGT_SDDMM(__nv_bfloat16, 4);
      case 2: return TGT_SDDMM(__nv_bfloat16, 2);
      default: return TGT_SDDMM(__nv_bfloat16, 1);
    }
  }
  switch (pair_vec(xd, xs, F, 4)) {
    case 4: return TGT_SDDMM(float, 4);
    case 2: return TGT_SDDMM(float, 2);
    default: return TGT_SDDMM(float, 1);
  }
#undef TGT_SDDMM
}

// B10: (a) the scores of the scaled x_dst into s (B5's kernel); (b) each
// row's (m, z) from them (B6's first two sweeps); (c) the row-grouped sum of
// bf16(softmax_weight(s, m, z) * x_src[src]) (blocked::rows_kernel).
cudaError_t launch_fused(const void* xd, int64_t nd, const void* xs,
                         bool bf16, const blocked::RowsArgs& a, float* s,
                         float* m, float* z, cudaStream_t stream) {
  cudaError_t err = launch_sddmm_vec(xd, nd, xs, bf16, a.edge_src,
                                     a.local_row, a.chunk_block, a.num_chunks,
                                     a.C, a.W, a.F, s, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = 2 * static_cast<size_t>(a.W) * sizeof(float);
  err = allow_smem(edge_softmax_kernel<true>, smem);
  if (err != cudaSuccess) return err;
  edge_softmax_kernel<true><<<a.num_blocks, kThreads, smem, stream>>>(
      s, a.local_row, a.block_start, a.C, a.W, nullptr, m, z);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return blocked::launch_rows_vec(xs, bf16, a.F, a, SoftmaxLanes{s, m, z},
                                  stream);
}

}  // namespace

extern "C" {

// Common arguments: x_dst (dst_rows, F) and x_src (N, F) row-major, both f32
// (x_is_bf16 == 0) or both bf16; rows of x_dst past dst_rows read as zeros.
// edge_src, local_row: (T, C) int32; chunk_block: (T,) int32; block_start:
// (B+1,) int32.  Each function launches on `stream`, returns the cudaError_t
// of its launches (0 on success) and does not synchronise.

// B5: out (T, C) f32, the per-lane scores, 0 on pad lanes.
int tgt_sddmm_blocked(const void* x_dst, int64_t dst_rows, const void* x_src,
                      int x_is_bf16, const int32_t* edge_src,
                      const int32_t* local_row, const int32_t* chunk_block,
                      int num_chunks, int C, int W, int F, float* out,
                      void* stream) {
  if (num_chunks <= 0 || C <= 0 || W <= 0 || F <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_sddmm_vec(
      x_dst, dst_rows, x_src, x_is_bf16 != 0, edge_src, local_row,
      chunk_block, num_chunks, C, W, F, out,
      static_cast<cudaStream_t>(stream)));
}

// B6: att (T, C) f32, the per-row softmax of scores (T, C) f32, 0 on pad
// lanes.
int tgt_edge_softmax_blocked(const float* scores, const int32_t* local_row,
                             const int32_t* block_start, int num_blocks,
                             int C, int W, float* att, void* stream) {
  if (num_blocks <= 0 || C <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(W) * sizeof(float);
  cudaError_t err = allow_smem(edge_softmax_kernel<false>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_softmax_kernel<false><<<num_blocks, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      scores, local_row, block_start, C, W, att, nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// B10: s (T, C) f32 and m, z (B*W,) f32 scratch; out (B*W, F) f32.  x_dst
// carries the scale already.
int tgt_attend_fused(const void* x_dst, int64_t dst_rows, const void* x_src,
                     int x_is_bf16, const int32_t* edge_src,
                     const int32_t* local_row, const int32_t* chunk_block,
                     const int32_t* block_start, int num_chunks,
                     int num_blocks, int C, int W, int F, float* s, float* m,
                     float* z, float* out, void* stream) {
  if (num_chunks <= 0 || num_blocks <= 0 || C <= 0 || W <= 0 || F <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const blocked::RowsArgs a{edge_src,   local_row,  chunk_block,
                            block_start, num_chunks, num_blocks,
                            C,          W,          F,
                            out};
  return static_cast<int>(launch_fused(x_dst, dst_rows, x_src, x_is_bf16 != 0,
                                       a, s, m, z,
                                       static_cast<cudaStream_t>(stream)));
}

// B4, first kernel: split (T,) int32, each chunk's split pieces; row_m,
// row_z (B*W,) f32 reset to (-inf, 0).  The caller scans split into the
// slot offsets and sizes the slots for tgt_attend_flash.
int tgt_attend_flash_count(const int32_t* local_row,
                           const int32_t* chunk_block, int num_chunks, int C,
                           int W, int32_t* split, float* row_m, float* row_z,
                           void* stream) {
  if (num_chunks <= 0 || C <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int stage = row_stage(C);
  const size_t smem = static_cast<size_t>(W) * sizeof(int);
  cudaError_t err = allow_smem(flash_count_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_count_kernel<<<num_chunks, kRowThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      local_row, chunk_block, C, W, stage, split, row_m, row_z);
  return static_cast<int>(cudaGetLastError());
}

// B4, main and merge kernels.  slot_off (T+1,) int32: chunk t's split
// pieces take slots [slot_off[t], slot_off[t+1]); slot_row (S,) int32,
// slot_m, slot_z (S,) and slot_acc (S, F) f32 scratch; row_m, row_z as
// tgt_attend_flash_count left them; out (B*W, F) f32, already divided by z.
// x_dst carries the scale already.  row_stats != 0: the row's max as the
// softmax reference; 0: the row block's max (the per-chunk recurrence).
int tgt_attend_flash(const void* x_dst, int64_t dst_rows, const void* x_src,
                     int x_is_bf16, int row_stats, const int32_t* edge_src,
                     const int32_t* local_row, const int32_t* chunk_block,
                     const int32_t* block_start, const int32_t* slot_off,
                     int num_chunks, int num_blocks, int C, int W, int F,
                     float* row_m, float* row_z, int32_t* slot_row,
                     float* slot_m, float* slot_z, float* slot_acc, float* out,
                     void* stream) {
  if (num_chunks <= 0 || num_blocks <= 0 || C <= 0 || W <= 0 || F <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TGT_FLASH(T, V)                                                     \
  launch_flash<T, V>(x_dst, dst_rows, x_src, row_stats != 0, edge_src,      \
                     local_row, chunk_block, block_start, slot_off,         \
                     num_chunks, num_blocks, C, W, F, row_m, row_z,         \
                     slot_row, slot_m, slot_z, slot_acc, out, st)
  cudaError_t err;
  if (x_is_bf16) {
    switch (pair_vec(x_dst, x_src, F, 2)) {
      case 8: err = TGT_FLASH(__nv_bfloat16, 8); break;
      case 4: err = TGT_FLASH(__nv_bfloat16, 4); break;
      case 2: err = TGT_FLASH(__nv_bfloat16, 2); break;
      default: err = TGT_FLASH(__nv_bfloat16, 1);
    }
  } else {
    switch (pair_vec(x_dst, x_src, F, 4)) {
      case 4: err = TGT_FLASH(float, 4); break;
      case 2: err = TGT_FLASH(float, 2); break;
      default: err = TGT_FLASH(float, 1);
    }
  }
#undef TGT_FLASH
  return static_cast<int>(err);
}

const char* tgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
