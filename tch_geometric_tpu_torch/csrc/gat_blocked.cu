// Multi-head blocked GAT for Hopper (sm_90a): kernels B7, B8 and B9.
//
// Replaces, in tch_geometric_tpu/ops/attention_blocked.py:
//   B7  _mz_mh_kernel + _att_mh_kernel (edge_softmax_blocked_multihead): the
//       per-dst-row softmax of (H, T, C) f32 scores for H heads, 0 on pad
//       lanes;
//   B8  _spmm_mw_kernel (spmm_blocked_multiweighted_pallas): over (N, H*D)
//       head-concatenated rows x and (H, T, C) f32 weights w,
//           out[i, c] = sum_e bf16(x[src(e), c] * w[c / D, e])
//       with f32 sums (each term rounded to the compute dtype);
//   B9  _gat_flash_kernel (gat_attend_blocked_flash): multi-head GATv1 in
//       one traversal, out[i, h, :] = sum_e e h[src(e), h, :] / sum_e e.
// B7 and B8, after logits gathered by torch ops, make gat_attend_blocked
// (the composed route); B9 is gat_attend_blocked_flash.  Both compute the
// function of B3 (gat_packed.cu) with other rounding points.
//
// What the TPU kernels did and what changes here.
// - B7: the TPU carries a (W, H) online (max, expsum) tile across a block's
//   chunks.  Here one CUDA block owns a row block and keeps its W x H
//   (m, z) in shared memory (8 KB at W=256, H=4), taken in two sweeps (max,
//   then the exp-sum) as B6 takes them: the same function up to f32
//   rounding.  Each sweep reads a lane's local_row once for all heads.
// - B8: the TPU gathers a (T, C, H*D) tensor and expands the (C, H) weights
//   over each head's columns with a one-hot matmul.  Here B8 is B1's
//   row-grouped weighted sum (blocked::rows_kernel, blocked_common.cuh;
//   spmm_blocked.cu describes it): one CUDA block per chunk counting-sorts
//   its live lanes by row, a warp takes a piece of at most 32 lanes of one
//   row and reads each source row whole with the widest vector load that
//   divides F, D and x's address (so that no vector straddles two heads:
//   D=36 in bf16 takes 4-element loads), load_depth rows in flight, f32
//   sums in registers; an owned row is stored, a split row added by vector
//   atomics onto a row that a zero pass cleared (chunks wider than
//   kMaxStage lanes: onto a memset output).  With one head (the attend
//   routes, GAT's last layer) each lane's weight is staged in shared memory
//   and shuffled to the warp, as B2's.  With H > 1 heads each lane's
//   position in its chunk is staged instead (H weights a lane would take
//   53 KB more a CUDA block at C=3,328, H=4), and each thread reads the
//   weight of its vectors' heads for every row in flight from the (H, T, C)
//   weights (HeadWeights): a warp touches at most H addresses a row, which
//   L1 serves.  No shared-memory float atomic is left.
// - B9: the TPU gathers (T, C, H*D + H), the rows with alpha_src as H
//   trailing columns in the compute dtype, and keeps a (W, H*D) f32
//   accumulator.  Here one CUDA block owns one (row block, head) pair, as in
//   B3: a W x D f32 tile in shared memory (64 KB at W=256, D=64), the
//   head's D columns of each row, and alpha_src[src, h] read from the (N, H)
//   f32 table and rounded to the compute dtype.  The recurrence is B4's per
//   row, not B3's per-chunk shift: per chunk, each row's max logit; m_new =
//   max(m, chunk max); a row whose max rose has its tile row and z rescaled
//   by exp(m - m_new); then each lane adds e = exp(s - m_new) to z in f32
//   and bf16(e) * x[src] to the tile.  So e is rounded against the same
//   running row max as in the plain version.  The logit is computed again
//   in the second sweep (alpha_src from L1/L2) instead of being kept in
//   shared memory, so that three CUDA blocks fit an SM at D=64.
// - Rounding: B8 rounds each term bf16(x * w), as the TPU kernel does (the
//   port's B2 multiplies in f32): the product is rounded on its own
//   (__fmul_rn, never fused into the add), then to the compute dtype;
//   B9's term bf16(e) * x is exact in f32.
//   No fast math: the z > 0 guards rely on IEEE exp.
//
// Bound on an H100 (3.35 TB/s) at ogbn-products size (W=256, T=19,222,
// C=3,328, N=2,449,029, B*W=2,449,152), each input read once and the output
// written once: B7 at H=4 moves the scores, local_row and the weights,
// 2.30 GB (0.69 ms); B8 at H*D=256 in bf16 moves x, the lane metadata, the
// weights and the f32 output, 5.30 GB (1.58 ms); B9 at H=4, D=64 moves h,
// the lane metadata, both alpha tables and the f32 output, 4.35 GB in bf16
// and 5.61 GB in f32 (1.30 and 1.67 ms).  The operations are far below the
// f32 rate: all three are bound by bytes.  A gather cannot reach that for
// B8 and B9: every live lane reads its row segment, lanes x H*D x bytes in
// all.  B8 reads each live lane's row whole and once (above).  B9: pad lanes
// are dropped by a warp ballot before any row read; a warp reads a lane's
// columns as consecutive loads across its 32 threads; eight lanes' loads are
// in flight before their shared-memory adds; the heads of a row block are
// adjacent in the grid, so its lane metadata and hub rows come from L2
// after the first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "blocked_common.cuh"

namespace {

using blocked::allow_smem;
using blocked::atomic_max_float;
using blocked::kFull;
using blocked::Piece;
using blocked::round_to;
using blocked::softmax_weight;

constexpr int kThreads = 512;            // 16 warps per CUDA block
constexpr int kUnroll = 8;               // lanes loaded before their adds
constexpr int kMaxD = 128;               // B9 columns per head: 4 per thread

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float leaky_relu(float s, float slope) {
  return s > 0.f ? s : slope * s;
}

// ---- B7: per-row softmax of H heads, one CUDA block per row block --------
__global__ void __launch_bounds__(kThreads)
edge_softmax_mh_kernel(const float* __restrict__ scores,
                       const int32_t* __restrict__ local_row,
                       const int32_t* __restrict__ block_start, int64_t TC,
                       int C, int W, int H, float* __restrict__ att) {
  extern __shared__ float stats[];
  float* m = stats;                      // W x H row maxima
  float* z = stats + W * H;              // W x H row sums
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < W * H; i += kThreads) {
    m[i] = -CUDART_INF_F;
    z[i] = 0.f;
  }
  __syncthreads();
  const int64_t e_begin = static_cast<int64_t>(block_start[b]) * C;
  const int64_t e_end = static_cast<int64_t>(block_start[b + 1]) * C;
  // pad lanes (local_row == W) are skipped, whatever their scores hold
  for (int64_t e = e_begin + threadIdx.x; e < e_end; e += kThreads) {
    const int r = local_row[e];
    if (r < W)
      for (int h = 0; h < H; ++h)
        atomic_max_float(m + r * H + h, scores[h * TC + e]);
  }
  __syncthreads();
  for (int64_t e = e_begin + threadIdx.x; e < e_end; e += kThreads) {
    const int r = local_row[e];
    if (r < W)
      for (int h = 0; h < H; ++h)
        atomicAdd(z + r * H + h, expf(scores[h * TC + e] - m[r * H + h]));
  }
  __syncthreads();
  for (int64_t e = e_begin + threadIdx.x; e < e_end; e += kThreads) {
    const int r = local_row[e];
    for (int h = 0; h < H; ++h)
      att[h * TC + e] = r < W ? softmax_weight(scores[h * TC + e],
                                               m[r * H + h], z[r * H + h])
                              : 0.f;
  }
}

// ---- B8: per-head weighted SpMM on row-grouped chunks -------------------

// The weights of a piece's lanes per column: column c of lane e takes
// w[head(c) * TC + e], head(c) = c / D.  kVec divides D, so each of a
// thread's vectors lies in one head: its kNV head offsets are set per slab,
// and in the load phase it reads its kNV weights of each row in flight from
// device memory (a warp reads at most H addresses a row, which L1 serves).
template <int kDepth, int kNV>
struct HeadWeights {
  static constexpr bool kWeighted = true;
  const float* w;                        // the chunk's first lane, head 0
  int64_t TC;                            // lanes of all chunks
  int D, H;
  int my_pos;                            // lane `lane`'s position in the chunk
  int64_t hoff[kNV];                     // head offset of each vector
  float wv[kDepth][kNV];                 // the weights of the rows in flight
  __device__ void slab(const int (&col)[kNV]) {
#pragma unroll
    for (int k = 0; k < kNV; ++k)        // a column past F takes the last head
      hoff[k] = static_cast<int64_t>(min(col[k] / D, H - 1)) * TC;
  }
  __device__ void load(int u, int j, int len) {
    const int pos = __shfl_sync(kFull, my_pos, j & 31);
    if (j < len) {                       // warp-uniform
#pragma unroll
      for (int k = 0; k < kNV; ++k) wv[u][k] = __ldg(w + hoff[k] + pos);
    }
  }
  __device__ void get(int u, int, float (&out)[kNV]) {
#pragma unroll
    for (int k = 0; k < kNV; ++k) out[k] = wv[u][k];
  }
};

// B8's Lanes policy with H > 1 heads: each lane's position in its chunk is
// staged; terms are bf16(x * w).  Three CUDA blocks an SM (80 registers):
// the weights in flight take up to 32 more a thread.  On an NVIDIA H100
// 80GB HBM3 at 700 W (scripts/time_csrc_variants.py) B8 took 23.7 ms at
// H=4, D=64 in f32 and 12.6 in bf16; with four CUDA blocks 29.1 and 18.3;
// staging each piece's H x 32 weights in shared memory instead of these L1
// reads, four rows' weights a 16-byte load, 23.2 and 14.8.
struct HeadLanes {
  static constexpr bool kAux = true, kRound = true;
  static constexpr int kMinBlocks = 3;
  const float* weight;
  int64_t TC;
  int D, H;
  __device__ int aux(int64_t, int pos, int64_t) const { return pos; }
  template <int kDepth, int kNV>
  __device__ HeadWeights<kDepth, kNV> weights(const int* aux_s, Piece pc,
                                              int lane, int64_t chunk0) const {
    HeadWeights<kDepth, kNV> wf;
    wf.w = weight + chunk0;
    wf.TC = TC;
    wf.D = D;
    wf.H = H;
    wf.my_pos = lane < pc.len ? aux_s[pc.start + lane] : 0;
    return wf;
  }
};

// ---- B9: one traversal per (row block, head), per-row running max --------
// up to D=64 three CUDA blocks share an SM (3 x 69 KB at W=256)
template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads, kCols <= 2 ? 3 : 1)
gat_flash_kernel(const void* x_rows, const float* __restrict__ alpha_src,
                 const float* __restrict__ alpha_dst, int ad_rows,
                 const int32_t* __restrict__ edge_src,
                 const int32_t* __restrict__ local_row,
                 const int32_t* __restrict__ block_start, int C, int W, int H,
                 int D, float slope, float* __restrict__ out,
                 float* __restrict__ raw_out, float* __restrict__ m_out,
                 float* __restrict__ z_out) {
  const T* __restrict__ x = static_cast<const T*>(x_rows);
  extern __shared__ float smem[];
  float* acc = smem;                     // W x D tile
  float* m = acc + W * D;                // running row max
  float* z = m + W;                      // running row sum
  float* mc = z + W;                     // the chunk's row max
  float* fac = mc + W;                   // per-row rescale factor
  float* ad = fac + W;                   // alpha_dst of this head
  const int b = blockIdx.x / H;          // the H heads of a block are adjacent
  const int hd = blockIdx.x % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t HD = static_cast<int64_t>(H) * D;

  for (int i = threadIdx.x; i < W * D; i += kThreads) acc[i] = 0.f;
  for (int r = threadIdx.x; r < W; r += kThreads) {
    const int64_t row = static_cast<int64_t>(b) * W + r;
    m[r] = -CUDART_INF_F;
    z[r] = 0.f;
    mc[r] = -CUDART_INF_F;
    ad[r] = row < ad_rows ? alpha_dst[row * H + hd] : 0.f;
  }
  __syncthreads();

  // alpha_src rides the TPU's gather in the compute dtype
  auto logit = [&](int src, int r) {
    const float a = round_to<T>(alpha_src[static_cast<int64_t>(src) * H + hd]);
    return leaky_relu(a + ad[r], slope);
  };

  const int t_end = block_start[b + 1];
  for (int t = block_start[b]; t < t_end; ++t) {
    const int64_t e0 = static_cast<int64_t>(t) * C, e1 = e0 + C;
    // sweep 1: the chunk's max logit per row
    for (int64_t e = e0 + threadIdx.x; e < e1; e += kThreads) {
      const int r = local_row[e];
      if (r < W) atomic_max_float(mc + r, logit(edge_src[e], r));
    }
    __syncthreads();
    // m_new = max(m_old, chunk max) per row; rescale rows whose max rose
    bool moved = false;
    for (int r = threadIdx.x; r < W; r += kThreads) {
      const float mo = m[r], mn = fmaxf(mo, mc[r]);
      float f = 1.f;
      if (mn > mo) {
        // a row with no edges yet has a zero tile: nothing to rescale
        if (mo != -CUDART_INF_F) f = expf(mo - mn);
        m[r] = mn;
      }
      fac[r] = f;
      moved |= f != 1.f;
      mc[r] = -CUDART_INF_F;
    }
    if (__syncthreads_or(moved)) {
      for (int i = threadIdx.x; i < W * D; i += kThreads) acc[i] *= fac[i / D];
      for (int r = threadIdx.x; r < W; r += kThreads) z[r] *= fac[r];
      __syncthreads();
    }
    // sweep 2: e = exp(s - m); z += e (f32); the tile += bf16(e) * h[src]
    for (int64_t base = e0 + warp * 32; base < e1; base += kThreads) {
      const int64_t e = base + lane;
      int my_row = W, my_src = 0;
      float my_e = 0.f;
      if (e < e1) {
        my_row = local_row[e];
        my_src = edge_src[e];
        if (my_row < W) {
          const float mr = m[my_row];
          my_e = expf(logit(my_src, my_row) - (isfinite(mr) ? mr : 0.f));
          atomicAdd(z + my_row, my_e);
        }
      }
      // pad lanes carry local_row == W (and edge_src == 0): dropped here
      unsigned live = __ballot_sync(kFull, my_row < W);
      while (live) {                     // warp-uniform loop
        int rows[kUnroll];
        float v[kUnroll][kCols];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          rows[q] = -1;
          if (live) {                    // warp-uniform branch
            const int j = __ffs(live) - 1;
            live &= live - 1;
            rows[q] = __shfl_sync(kFull, my_row, j);
            const int64_t src = __shfl_sync(kFull, my_src, j);
            const float ew = round_to<T>(__shfl_sync(kFull, my_e, j));
            const T* p = x + src * HD + hd * D;
#pragma unroll
            for (int k = 0; k < kCols; ++k) {
              const int c = lane + 32 * k;
              v[q][k] = c < D ? to_float(p[c]) * ew : 0.f;
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          if (rows[q] < 0) continue;
          float* ar = acc + rows[q] * D;
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            const int c = lane + 32 * k;
            if (c < D) atomicAdd(ar + c, v[q][k]);
          }
        }
      }
    }
    __syncthreads();
  }

  // out = acc / z where z > 0, else 0 (rows with no edges)
  for (int i = threadIdx.x; i < W * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const float zr = z[r];
    const int64_t o = (static_cast<int64_t>(b) * W + r) * HD + hd * D + c;
    out[o] = zr > 0.f ? acc[i] / fmaxf(zr, 1e-20f) : 0.f;
    if (raw_out) raw_out[o] = acc[i];
  }
  if (m_out)
    for (int r = threadIdx.x; r < W; r += kThreads) {
      const int64_t o = (static_cast<int64_t>(b) * W + r) * H + hd;
      m_out[o] = m[r];
      z_out[o] = z[r];
    }
}

// every instantiation of gat_flash_kernel has this type
using FlashKernel = void (*)(const void*, const float*, const float*, int,
                             const int32_t*, const int32_t*, const int32_t*,
                             int, int, int, int, float, float*, float*,
                             float*, float*);

// the instantiation whose kCols 32-column slices cover D
template <typename T>
FlashKernel flash_kernel(int D) {
  if (D <= 32) return gat_flash_kernel<T, 1>;
  if (D <= 64) return gat_flash_kernel<T, 2>;
  return gat_flash_kernel<T, 4>;
}

}  // namespace

extern "C" {

// Common arguments: edge_src, local_row: (num_chunks, C) int32; block_start:
// (num_blocks + 1,) int32.  Each function launches on `stream`, returns the
// cudaError_t of its launch (0 on success) and does not synchronise.

// B7: scores and att (H, num_chunks, C) f32; att is 0 on pad lanes.
int tgt_edge_softmax_multihead(const float* scores, const int32_t* local_row,
                               const int32_t* block_start, int num_blocks,
                               int num_chunks, int C, int W, int H,
                               float* att, void* stream) {
  if (num_blocks <= 0 || num_chunks <= 0 || C <= 0 || W <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(W) * H * sizeof(float);
  cudaError_t err = allow_smem(edge_softmax_mh_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_softmax_mh_kernel<<<num_blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      scores, local_row, block_start,
      static_cast<int64_t>(num_chunks) * C, C, W, H, att);
  return static_cast<int>(cudaGetLastError());
}

// B8: x (N, F) row-major, f32 (x_is_bf16 == 0) or bf16, F = H*D; weight
// (H, num_chunks, C) f32; chunk_block (num_chunks,) int32; out
// (num_blocks*W, F) f32.
int tgt_spmm_multiweighted(const void* x, int x_is_bf16,
                           const int32_t* edge_src, const int32_t* local_row,
                           const float* weight, const int32_t* chunk_block,
                           const int32_t* block_start, int num_chunks,
                           int num_blocks, int C, int W, int F, int D,
                           float* out, void* stream) {
  if (num_blocks <= 0 || num_chunks <= 0 || C <= 0 || W <= 0 || F <= 0 ||
      D <= 0 || F % D)
    return static_cast<int>(cudaErrorInvalidValue);
  const blocked::RowsArgs a{edge_src,   local_row,  chunk_block,
                            block_start, num_chunks, num_blocks,
                            C,          W,          F,
                            out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = x_is_bf16 != 0;
  // one head: a staged lane weight, as B2's, with rounded terms
  if (F == D)
    return static_cast<int>(blocked::launch_rows_vec(
        x, bf16, D, a, blocked::StagedWeight<true>{weight}, s));
  const HeadLanes lanes{weight, static_cast<int64_t>(num_chunks) * C, D,
                        F / D};
  return static_cast<int>(blocked::launch_rows_vec(x, bf16, D, a, lanes, s));
}

// B9: x (N, H*D) row-major, f32 (x_is_bf16 == 0) or bf16; alpha_src (N, H)
// f32 (rounded to the compute dtype here); alpha_dst (ad_rows, H) f32, rows
// past ad_rows read 0; out (num_blocks*W, H*D) f32, divided by z.  raw_out
// (the same shape, undivided), m_out and z_out ((num_blocks*W, H) f32 row
// stats) are written when not null.  Needs D <= 128.
int tgt_gat_flash(const void* x, int x_is_bf16, const float* alpha_src,
                  const float* alpha_dst, int ad_rows,
                  const int32_t* edge_src, const int32_t* local_row,
                  const int32_t* block_start, int num_blocks, int C, int W,
                  int H, int D, float negative_slope, float* out,
                  float* raw_out, float* m_out, float* z_out, void* stream) {
  if (num_blocks <= 0 || C <= 0 || W <= 0 || H <= 0 || D <= 0 || D > kMaxD ||
      (m_out == nullptr) != (z_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const FlashKernel kernel = x_is_bf16 ? flash_kernel<__nv_bfloat16>(D)
                                       : flash_kernel<float>(D);
  const size_t smem = (static_cast<size_t>(W) * D + 5 * W) * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = static_cast<int64_t>(num_blocks) * H;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(grid), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      x, alpha_src, alpha_dst, ad_rows, edge_src, local_row, block_start, C,
      W, H, D, negative_slope, out, raw_out, m_out, z_out);
  return static_cast<int>(cudaGetLastError());
}

const char* tgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
