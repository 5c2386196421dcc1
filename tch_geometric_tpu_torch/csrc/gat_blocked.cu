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
//   over each head's columns with a one-hot matmul.  Here, as in B1 and B2,
//   a CUDA block owns one (row block, 64-column tile) and every live lane's
//   row segment is read by the kernel itself.  A thread's columns c and c+1
//   take the weights of heads c / D and (c+1) / D: one head per tile at
//   D=64, two at D=32, and at an odd D a pair can straddle two.  They are
//   read per lane from the (H, T, C) weights; a warp's threads read at most
//   a few distinct addresses, which L1 serves.
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
//   port's B2 multiplies in f32); B9's term bf16(e) * x is exact in f32.
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
// all.  What the design does about it: pad lanes are dropped by a warp
// ballot before any row read; a warp reads a lane's columns as consecutive
// loads across its 32 threads; eight lanes' loads are in flight before
// their shared-memory adds; the tiles (B8) or heads (B9) of a row block are
// adjacent in the grid, so its lane metadata and hub rows come from L2
// after the first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "blocked_common.cuh"

namespace {

using blocked::atomic_max_float;
using blocked::kFull;
using blocked::kTileF;
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

// ---- B8: per-head weighted SpMM, one CUDA block per (row block, 64-column
// tile) ------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
spmm_multiweighted_kernel(const T* __restrict__ x,
                          const int32_t* __restrict__ edge_src,
                          const int32_t* __restrict__ local_row,
                          const float* __restrict__ weight,
                          const int32_t* __restrict__ block_start, int64_t TC,
                          int C, int W, int F, int D, int num_tiles,
                          float* __restrict__ out) {
  extern __shared__ float acc[];         // W x kTileF f32 tile
  const int b = blockIdx.x / num_tiles;  // tiles of a block are adjacent
  const int f0 = (blockIdx.x % num_tiles) * kTileF;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = f0 + 2 * lane;
  // the weights of this thread's two columns' heads (a column past F takes
  // the last head; its term is never added)
  const int last = F / D - 1;
  const float* w0 = weight + static_cast<int64_t>(min(c0 / D, last)) * TC;
  const float* w1 = weight + static_cast<int64_t>(min((c0 + 1) / D, last)) * TC;

  for (int i = threadIdx.x; i < W * kTileF; i += kThreads) acc[i] = 0.f;
  __syncthreads();
  const int64_t e_begin = static_cast<int64_t>(block_start[b]) * C;
  const int64_t e_end = static_cast<int64_t>(block_start[b + 1]) * C;
  for (int64_t base = e_begin + warp * 32; base < e_end; base += kThreads) {
    const int64_t e = base + lane;
    int my_row = W, my_src = 0;
    if (e < e_end) {
      my_row = local_row[e];
      my_src = edge_src[e];
    }
    blocked::warp_accumulate_by<T, true, kUnroll>(
        x, F, c0, my_row, my_src, W, lane, acc, [=](int j) {
          return make_float2(w0[base + j], w1[base + j]);
        });
  }
  __syncthreads();
  blocked::store_tile(acc, out, static_cast<int64_t>(b) * W, W, F, f0);
}

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

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t launch_multiweighted(const void* x, const int32_t* edge_src,
                                 const int32_t* local_row,
                                 const float* weight,
                                 const int32_t* block_start, int num_blocks,
                                 int64_t TC, int C, int W, int F, int D,
                                 float* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(W) * kTileF * sizeof(float);
  auto kernel = spmm_multiweighted_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int num_tiles = (F + kTileF - 1) / kTileF;
  const int64_t grid = static_cast<int64_t>(num_blocks) * num_tiles;
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      static_cast<const T*>(x), edge_src, local_row, weight, block_start, TC,
      C, W, F, D, num_tiles, out);
  return cudaGetLastError();
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
// (H, num_chunks, C) f32; out (num_blocks*W, F) f32.
int tgt_spmm_multiweighted(const void* x, int x_is_bf16,
                           const int32_t* edge_src, const int32_t* local_row,
                           const float* weight, const int32_t* block_start,
                           int num_blocks, int num_chunks, int C, int W,
                           int F, int D, float* out, void* stream) {
  if (num_blocks <= 0 || num_chunks <= 0 || C <= 0 || W <= 0 || F <= 0 ||
      D <= 0 || F % D)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t TC = static_cast<int64_t>(num_chunks) * C;
  return static_cast<int>(
      x_is_bf16 ? launch_multiweighted<__nv_bfloat16>(
                      x, edge_src, local_row, weight, block_start, num_blocks,
                      TC, C, W, F, D, out, s)
                : launch_multiweighted<float>(x, edge_src, local_row, weight,
                                              block_start, num_blocks, TC, C,
                                              W, F, D, out, s));
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
