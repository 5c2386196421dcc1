// Single-head blocked dot-product attention for Hopper (sm_90a): kernels B5,
// B6, B10 and B4.
//
// Replaces, in tch_geometric_tpu/ops/attention_blocked.py:
//   B5  _sddmm_kernel and _sddmm_kernel_v2 (sddmm_blocked_pallas[_v2]): the
//       per-lane score s[e] = <x_dst[dst(e)], x_src[src(e)]>, 0 on pad lanes
//       (v1 and v2 differ only in the TPU's lane/sublane orientation);
//   B6  _mz_kernel + _att_kernel (edge_softmax_blocked): the per-dst-row
//       softmax of (T, C) scores, 0 on pad lanes;
//   B10 _sddmm_mz_kernel + _att_w_fused_kernel (attend_blocked_fused): pass A
//       writes the scores and the row stats (max m, sum z), pass B
//       normalises each lane and adds bf16(w * x_src[src]) into its row;
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
// come from L2, as for B1).  So B5 and B4 are built as B1 is
// (spmm_blocked.cu): whole rows, many in flight, each read once.
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
// B6 and B10 keep the first design.  One CUDA block owns a row block and
// walks its chunks in a loop; B6 and B10 pass A keep the W rows' (m, z) in
// shared memory and take them in two sweeps (max, then the exp-sum) instead
// of the online recurrence: the same function up to float32 rounding.  B10
// pass A scores a warp's 32 lanes one after another (warp_scores: the
// destination row read again for each lane, two columns per thread).  A
// (W, F) float32 accumulator does not fit in shared memory at W=256, F=256
// (256 KB), so B10 pass B is parallel over (row block, 64-column tile):
// each lane's 64 columns are added into a W x 64 shared tile by shared
// atomics, four lanes' loads in flight.  B10 rounds each term bf16(x * w).
// Rows in the compute dtype, every sum in float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "blocked_common.cuh"

namespace {

using blocked::atomic_max_float;
using blocked::kFull;
using blocked::kTileF;
using blocked::load_cols;
using blocked::round_to;
using blocked::softmax_weight;

constexpr int kThreads = 512;            // 16 warps per CUDA block (B6, B10)
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;               // lanes loaded before their adds
                                         // (8 spills at 40 registers)

// <a, b> over F columns, by a warp: column pairs per thread, then a warp sum
// returned to every thread.
template <typename T>
__device__ __forceinline__ float warp_dot(const T* a, const T* b, int F,
                                          bool even, int lane) {
  float acc = 0.f;
  for (int c = 2 * lane; c < F; c += 64) {
    const float2 u = load_cols(a, c, F, even);
    const float2 v = load_cols(b, c, F, even);
    acc = fmaf(u.x, v.x, acc);
    acc = fmaf(u.y, v.y, acc);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
  return acc;
}

// B10 pass A: the scores of a warp's 32 lanes: each thread brings one lane's local row,
// source and global dst row; the warp computes the live lanes' dot products
// one after another.  Returns this thread's lane's score: 0 on pad lanes
// (row == W) and where the dst row is past dst_rows (a zero row).
template <typename T>
__device__ __forceinline__ float warp_scores(const T* xd, int64_t nd,
                                             const T* xs, int F, bool even,
                                             int my_row, int my_src,
                                             int64_t my_dst, int W, int lane) {
  float my_s = 0.f;
  unsigned live = __ballot_sync(kFull, my_row < W && my_dst < nd);
  while (live) {                         // warp-uniform loop
    const int j = __ffs(live) - 1;
    live &= live - 1;
    const int64_t src = __shfl_sync(kFull, my_src, j);
    const int64_t dst = __shfl_sync(kFull, static_cast<long long>(my_dst), j);
    const float s = warp_dot(xd + dst * F, xs + src * F, F, even, lane);
    if (lane == j) my_s = s;
  }
  return my_s;
}

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

// ---- B6: per-row softmax, one CUDA block per row block -------------------
__global__ void __launch_bounds__(kThreads)
edge_softmax_kernel(const float* __restrict__ scores,
                    const int32_t* __restrict__ local_row,
                    const int32_t* __restrict__ block_start, int C, int W,
                    float* __restrict__ att) {
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
  for (int64_t e = e_begin + threadIdx.x; e < e_end; e += kThreads) {
    const int r = local_row[e];
    att[e] = r < W ? softmax_weight(scores[e], m[r], z[r]) : 0.f;
  }
}

// ---- B10 pass A: scores and row stats, one CUDA block per row block -------
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_stats_kernel(const T* __restrict__ xd, int64_t nd,
                   const T* __restrict__ xs,
                   const int32_t* __restrict__ edge_src,
                   const int32_t* __restrict__ local_row,
                   const int32_t* __restrict__ block_start, int C, int W,
                   int F, float* s, float* __restrict__ m_out,
                   float* __restrict__ z_out) {
  extern __shared__ float stats[];
  float* m = stats;
  float* z = stats + W;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool even = F % 2 == 0;
  for (int r = threadIdx.x; r < W; r += kThreads) {
    m[r] = -CUDART_INF_F;
    z[r] = 0.f;
  }
  __syncthreads();
  const int64_t e_begin = static_cast<int64_t>(block_start[b]) * C;
  const int64_t e_end = static_cast<int64_t>(block_start[b + 1]) * C;
  for (int64_t base = e_begin + warp * 32; base < e_end; base += kThreads) {
    const int64_t e = base + lane;
    int row = W, src = 0;
    if (e < e_end) {
      row = local_row[e];
      src = edge_src[e];
    }
    const float sc = warp_scores(xd, nd, xs, F, even, row, src,
                                 static_cast<int64_t>(b) * W + row, W, lane);
    if (e < e_end) {
      s[e] = sc;
      if (row < W) atomic_max_float(m + row, sc);
    }
  }
  __syncthreads();                       // also publishes s to the block
  row_expsum(s, local_row, e_begin, e_end, W, m, z);
  __syncthreads();
  for (int r = threadIdx.x; r < W; r += kThreads) {
    m_out[static_cast<int64_t>(b) * W + r] = m[r];
    z_out[static_cast<int64_t>(b) * W + r] = z[r];
  }
}

// ---- B10 pass B: normalise + weighted sum, one CUDA block per (row block,
// 64-column tile) ------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
fused_spmm_kernel(const T* __restrict__ xs, const float* __restrict__ s,
                  const float* __restrict__ m_in,
                  const float* __restrict__ z_in,
                  const int32_t* __restrict__ edge_src,
                  const int32_t* __restrict__ local_row,
                  const int32_t* __restrict__ block_start, int C, int W,
                  int F, int num_tiles, float* __restrict__ out) {
  extern __shared__ float acc[];         // W x kTileF tile, then m, z
  float* m = acc + W * kTileF;
  float* z = m + W;
  const int b = blockIdx.x / num_tiles;  // tiles of a block are adjacent
  const int f0 = (blockIdx.x % num_tiles) * kTileF;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < W * kTileF; i += kThreads) acc[i] = 0.f;
  for (int r = threadIdx.x; r < W; r += kThreads) {
    m[r] = m_in[static_cast<int64_t>(b) * W + r];
    z[r] = z_in[static_cast<int64_t>(b) * W + r];
  }
  __syncthreads();
  const int64_t e_begin = static_cast<int64_t>(block_start[b]) * C;
  const int64_t e_end = static_cast<int64_t>(block_start[b + 1]) * C;
  for (int64_t base = e_begin + warp * 32; base < e_end; base += kThreads) {
    const int64_t e = base + lane;
    int row = W, src = 0;
    float w = 0.f;
    if (e < e_end) {
      row = local_row[e];
      src = edge_src[e];
      if (row < W) w = softmax_weight(s[e], m[row], z[row]);
    }
    blocked::warp_accumulate<T, true, true, kUnroll>(
        xs, F, f0 + 2 * lane, row, src, w, W, lane, acc);
  }
  __syncthreads();
  blocked::store_tile(acc, out, static_cast<int64_t>(b) * W, W, F, f0);
}

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

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
                   int stage, int direct, int32_t* __restrict__ split,
                   float* __restrict__ row_m, float* __restrict__ row_z) {
  extern __shared__ int cnt[];           // W lane counts of the pass
  __shared__ int lo, hi, total;
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x;
  const int b = chunk_block[t];
  if (t == 0 || chunk_block[t - 1] != b) {
    for (int r = threadIdx.x; r < W; r += kRowThreads) {
      row_m[static_cast<int64_t>(b) * W + r] = -CUDART_INF_F;
      row_z[static_cast<int64_t>(b) * W + r] = 0.f;
    }
  }
  if (threadIdx.x == 0) total = 0;
  for (int s0 = 0; s0 < C; s0 += stage) {
    const int n = min(stage, C - s0);
    const int64_t e0 = static_cast<int64_t>(t) * C + s0;
    for (int r = threadIdx.x; r < W; r += kRowThreads) cnt[r] = 0;
    if (threadIdx.x == 0) {
      lo = W;
      hi = -1;
    }
    __syncthreads();
    int my_lo = W, my_hi = -1;
    for (int i = threadIdx.x; i < n; i += kRowThreads) {
      const int r = local_row[e0 + i];
      if (r < W) {
        atomicAdd(&cnt[r], 1);
        my_lo = min(my_lo, r);
        my_hi = max(my_hi, r);
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      my_lo = min(my_lo, __shfl_xor_sync(kFull, my_lo, o));
      my_hi = max(my_hi, __shfl_xor_sync(kFull, my_hi, o));
    }
    if (lane == 0) {
      atomicMin(&lo, my_lo);
      atomicMax(&hi, my_hi);
    }
    __syncthreads();
    // Piece::own: whole pass, at most kPiece lanes, neither first nor last
    const bool whole = direct && n == C;
    int mine = 0;
    for (int r = threadIdx.x; r < W; r += kRowThreads) {
      const int c = cnt[r];
      if (c > 0 && (!whole || c > kPiece || r == lo || r == hi))
        mine += (c + kPiece - 1) / kPiece;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) mine += __shfl_xor_sync(kFull, mine, o);
    if (lane == 0) atomicAdd(&total, mine);
    __syncthreads();                     // the next pass resets cnt
  }
  if (threadIdx.x == 0) split[t] = total;
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

// After flash_rows_kernel, one CUDA block per row block b: merges the
// block's split slots into their rows (ref = the row's max over its slots,
// or with scalar stats the block's largest max), rescales or zeroes an
// owned row whose z * exp(m - M_block) is below 1e-20 (scalar stats only),
// and zeroes the rows no lane reaches.  kOut floats per access of a row.
template <int kOut, bool kRowStats>
__global__ void __launch_bounds__(kRowThreads)
flash_merge_kernel(const int32_t* __restrict__ block_start,
                   const int32_t* __restrict__ slot_off, int W, int F,
                   const int32_t* __restrict__ slot_row,
                   const float* __restrict__ slot_m,
                   const float* __restrict__ slot_z,
                   const float* __restrict__ slot_acc,
                   const float* __restrict__ row_m,
                   const float* __restrict__ row_z, float* __restrict__ out) {
  extern __shared__ float mz[];
  float* mr = mz;                        // W row maxima over the slots
  float* zr = mr + W;                    // W merged sums
  int* ns = reinterpret_cast<int*>(zr + W);   // W slot counts
  __shared__ float red[kRowWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int s0 = slot_off[block_start[b]], s1 = slot_off[block_start[b + 1]];
  const int64_t row0 = static_cast<int64_t>(b) * W;
  for (int r = threadIdx.x; r < W; r += kRowThreads) {
    mr[r] = -CUDART_INF_F;
    zr[r] = 0.f;
    ns[r] = 0;
  }
  __syncthreads();
  for (int s = s0 + threadIdx.x; s < s1; s += kRowThreads) {
    const int r = slot_row[s];
    blocked::atomic_max_float(mr + r, slot_m[s]);
    atomicAdd(ns + r, 1);
  }
  __syncthreads();
  float mb = 0.f;                        // M_block (scalar stats)
  if (!kRowStats) {
    float v = -CUDART_INF_F;
    for (int r = threadIdx.x; r < W; r += kRowThreads)
      v = fmaxf(v, fmaxf(mr[r], row_m[row0 + r]));
    v = warp_max(v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    v = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) v = fmaxf(v, red[w]);
    // a block of pad chunks has no score; its rows are zeroed below
    mb = isfinite(v) ? v : 0.f;
  }
  for (int s = s0 + threadIdx.x; s < s1; s += kRowThreads) {
    const int r = slot_row[s];
    atomicAdd(zr + r, slot_z[s] * expf(slot_m[s] - (kRowStats ? mr[r] : mb)));
  }
  __syncthreads();
  for (int r = warp; r < W; r += kRowWarps) {
    const float zo = row_z[row0 + r];
    float scale = 1.f;                   // of an owned row, stored acc / z
    if (ns[r] > 0 || !(zo > 0.f)) {
      scale = 0.f;                       // split (added below) or no lanes
    } else if (!kRowStats) {
      const float zf = zo * expf(row_m[row0 + r] - mb);
      scale = !(zf > 0.f) ? 0.f : zf < 1e-20f ? zf / 1e-20f : 1.f;
    }
    if (scale != 1.f) {                  // warp-uniform
      float* o = out + (row0 + r) * F;
      for (int c = lane; c < F; c += 32) o[c] = scale == 0.f ? 0.f : o[c] * scale;
    }
  }
  __syncthreads();                       // the zeroed rows, before the adds
  for (int s = s0 + warp; s < s1; s += kRowWarps) {
    const int r = slot_row[s];
    const float zs = zr[r];
    if (!(zs > 0.f)) continue;           // the row stays 0
    const float coef = expf(slot_m[s] - (kRowStats ? mr[r] : mb)) /
                       fmaxf(zs, 1e-20f);
    const float* a = slot_acc + static_cast<int64_t>(s) * F;
    float* o = out + (row0 + r) * F;
    for (int c = lane * kOut; c < F; c += 32 * kOut) {
      float v[kOut];
#pragma unroll
      for (int e = 0; e < kOut; ++e) v[e] = a[c + e] * coef;
      put<kOut>(o + c, v, true);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
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
  const size_t msmem = 3 * static_cast<size_t>(W) * sizeof(float);
#define TGT_MERGE(V)                                                        \
  (row_stats ? &flash_merge_kernel<V, true> : &flash_merge_kernel<V, false>)
  auto merge = F % 4 == 0 ? TGT_MERGE(4)
               : F % 2 == 0 ? TGT_MERGE(2) : TGT_MERGE(1);
#undef TGT_MERGE
  err = allow_smem(merge, msmem);
  if (err != cudaSuccess) return err;
  merge<<<num_blocks, kRowThreads, msmem, stream>>>(
      block_start, slot_off, W, F, slot_row, slot_m, slot_z, slot_acc, row_m,
      row_z, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fused(const void* xd, int64_t nd, const void* xs,
                         const int32_t* edge_src, const int32_t* local_row,
                         const int32_t* block_start, int num_blocks, int C,
                         int W, int F, float* s, float* m, float* z,
                         float* out, cudaStream_t stream) {
  const size_t smem_a = 2 * static_cast<size_t>(W) * sizeof(float);
  cudaError_t err = allow_smem(fused_stats_kernel<T>, smem_a);
  if (err != cudaSuccess) return err;
  fused_stats_kernel<T><<<num_blocks, kThreads, smem_a, stream>>>(
      static_cast<const T*>(xd), nd, static_cast<const T*>(xs), edge_src,
      local_row, block_start, C, W, F, s, m, z);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_b =
      (static_cast<size_t>(W) * kTileF + 2 * W) * sizeof(float);
  err = allow_smem(fused_spmm_kernel<T>, smem_b);
  if (err != cudaSuccess) return err;
  const int num_tiles = (F + kTileF - 1) / kTileF;
  const int64_t grid = static_cast<int64_t>(num_blocks) * num_tiles;
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  fused_spmm_kernel<T><<<static_cast<unsigned>(grid), kThreads, smem_b,
                         stream>>>(static_cast<const T*>(xs), s, m, z,
                                   edge_src, local_row, block_start, C, W, F,
                                   num_tiles, out);
  return cudaGetLastError();
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TGT_SDDMM(T, V)                                                    \
  launch_sddmm<T, V>(x_dst, dst_rows, x_src, edge_src, local_row,          \
                     chunk_block, num_chunks, C, W, F, out, st)
  cudaError_t err;
  if (x_is_bf16) {
    switch (pair_vec(x_dst, x_src, F, 2)) {
      case 8: err = TGT_SDDMM(__nv_bfloat16, 8); break;
      case 4: err = TGT_SDDMM(__nv_bfloat16, 4); break;
      case 2: err = TGT_SDDMM(__nv_bfloat16, 2); break;
      default: err = TGT_SDDMM(__nv_bfloat16, 1);
    }
  } else {
    switch (pair_vec(x_dst, x_src, F, 4)) {
      case 4: err = TGT_SDDMM(float, 4); break;
      case 2: err = TGT_SDDMM(float, 2); break;
      default: err = TGT_SDDMM(float, 1);
    }
  }
#undef TGT_SDDMM
  return static_cast<int>(err);
}

// B6: att (T, C) f32, the per-row softmax of scores (T, C) f32, 0 on pad
// lanes.
int tgt_edge_softmax_blocked(const float* scores, const int32_t* local_row,
                             const int32_t* block_start, int num_blocks,
                             int C, int W, float* att, void* stream) {
  if (num_blocks <= 0 || C <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(W) * sizeof(float);
  cudaError_t err = allow_smem(edge_softmax_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_softmax_kernel<<<num_blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      scores, local_row, block_start, C, W, att);
  return static_cast<int>(cudaGetLastError());
}

// B10: s (T, C), m and z (B*W,) f32 scratch, written by pass A; out (B*W, F)
// f32.  x_dst carries the scale already.
int tgt_attend_fused(const void* x_dst, int64_t dst_rows, const void* x_src,
                     int x_is_bf16, const int32_t* edge_src,
                     const int32_t* local_row, const int32_t* block_start,
                     int num_blocks, int C, int W, int F, float* s, float* m,
                     float* z, float* out, void* stream) {
  if (num_blocks <= 0 || C <= 0 || W <= 0 || F <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      x_is_bf16
          ? launch_fused<__nv_bfloat16>(x_dst, dst_rows, x_src, edge_src,
                                        local_row, block_start, num_blocks,
                                        C, W, F, s, m, z, out, st)
          : launch_fused<float>(x_dst, dst_rows, x_src, edge_src, local_row,
                                block_start, num_blocks, C, W, F, s, m, z,
                                out, st));
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
      local_row, chunk_block, C, W, stage, stage == C ? 1 : 0, split, row_m,
      row_z);
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
