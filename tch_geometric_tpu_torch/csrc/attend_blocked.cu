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
//   B4  _flash_kernel_row / _flash_kernel_scalar (attend_blocked_flash): one
//       traversal with a rescaled output accumulator, out / z at the end.
//
// What the TPU kernels did and what changes here.
// - The Pallas kernels consume a pre-gathered (T, C, F) tensor: 32.7 GB at
//   ogbn-products size in bf16.  Here a warp reads each live lane's row
//   itself, so nothing of that size exists; x_dst rows past dst_rows read
//   as zeros (the TPU padded x_dst to B*W rows with a copy).
// - The TPU carries a block's stats and output tile across sequential grid
//   steps.  Here one CUDA block owns a row block and walks its chunks in a
//   loop.  B6 and B10 pass A keep the W rows' (m, z) in shared memory and
//   take them in two sweeps (max, then the exp-sum) instead of the online
//   recurrence: the same function up to float32 rounding.
// - A (W, F) float32 accumulator does not fit in shared memory at W=256,
//   F=256 (256 KB).  B10 pass B is parallel over (row block, 64-column
//   tile), as B1 is.  B4 needs each lane's whole-row score before any column
//   is added, so one CUDA block walks the 64-column tiles of its row block
//   in turn: the first tile computes the chunk's scores and keeps them in a
//   (T, C) float32 scratch, the later tiles read them back (4 bytes a lane
//   instead of the row again) and repeat the same stats recurrence.
// - B4 follows the TPU's recurrences exactly: per row (row_stats) the
//   running max is updated per chunk and each lane's weight is
//   e = exp(s - m_running); per chunk (scalar) every weight is
//   exp(s - M_chunk) and chunks combine with exp(M - m) factors.  A row
//   whose scores sit about 87 below its chunk's max underflows in the
//   scalar variant, as on the TPU.
// - Rounding follows the TPU kernels: rows in the compute dtype, every sum
//   in float32; B10 rounds each term bf16(x * w); B4 rounds the weight,
//   bf16(e) * x, and sums z from the float32 e.  No fast math: the z > 0
//   guards rely on IEEE exp and subnormals.
//
// Bound on an H100 (3.35 TB/s), at products size, F=256 bf16, x_dst = x_src
// as the example calls it: x once, the lane metadata once and the output
// once are about 2.0 GB for B5, 0.77 GB for B6 and 4.3 GB for B4 and B10
// (0.60, 0.23 and 1.28 ms; a distinct x_dst adds 1.25 GB); the operations
// (two per lane and column, one exp per lane) are far below the float32
// rate, so every kernel is bound by bytes.  A gather cannot reach that bound: each lane reads its
// row (64M lanes x 512 B = 32.8 GB, about 9.8 ms).  What the design does
// about it: pad lanes are dropped by a warp ballot before any row read;
// lane metadata is read coalesced, one lane per thread; a row is read as
// 4- or 8-byte column pairs, 32 threads on consecutive addresses; the
// accumulation loads four lanes' columns before their shared-memory adds.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "blocked_common.cuh"

namespace {

using blocked::atomic_max_float;
using blocked::kFull;
using blocked::kTileF;
using blocked::load_cols;
using blocked::round_to;
using blocked::softmax_weight;
using blocked::tile_slot;

constexpr int kThreads = 512;            // 16 warps per CUDA block
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;               // lanes loaded before their adds
                                         // (8 spills at 40 registers)
constexpr int64_t kMaxGrid = 132 * 16;   // CUDA blocks of the lane-parallel B5

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

// The scores of a warp's 32 lanes: each thread brings one lane's local row,
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

// Max of v over the CUDA block, returned to every thread.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                       // red may still be read
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : -CUDART_INF_F;
#pragma unroll
    for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
    if (lane == 0) red[kWarps] = v;
  }
  __syncthreads();
  return red[kWarps];
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

// ---- B5: per-lane scores, one warp per 32 lanes, grid-stride -------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
sddmm_kernel(const T* __restrict__ xd, int64_t nd, const T* __restrict__ xs,
             const int32_t* __restrict__ edge_src,
             const int32_t* __restrict__ local_row,
             const int32_t* __restrict__ chunk_block, int64_t lanes, int C,
             int W, int F, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const bool even = F % 2 == 0;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t base = warp * 32; base < lanes; base += stride) {
    const int64_t e = base + lane;
    int row = W, src = 0;
    int64_t dst = 0;
    if (e < lanes) {
      row = local_row[e];
      src = edge_src[e];
      dst = static_cast<int64_t>(chunk_block[e / C]) * W + row;
    }
    const float s = warp_scores(xd, nd, xs, F, even, row, src, dst, W, lane);
    if (e < lanes) out[e] = s;
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

// ---- B4: one traversal, rescaled accumulator; one CUDA block per row block,
// its 64-column tiles in turn ------------------------------------------------
template <typename T, bool kRowStats>
__global__ void __launch_bounds__(kThreads, 3)
flash_kernel(const T* __restrict__ xd, int64_t nd, const T* __restrict__ xs,
             const int32_t* __restrict__ edge_src,
             const int32_t* __restrict__ local_row,
             const int32_t* __restrict__ block_start, int C, int W, int F,
             int num_tiles, float* s, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* acc = smem;                     // W x kTileF tile
  float* m = acc + W * kTileF;           // running row max (row stats)
  float* z = m + W;                      // running row sum
  float* mc = z + W;                     // the chunk's row max (row stats)
  float* fac = mc + W;                   // per-row rescale factor
  __shared__ float red[kWarps + 1];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool even = F % 2 == 0;
  const int t_begin = block_start[b], t_end = block_start[b + 1];

  for (int tile = 0; tile < num_tiles; ++tile) {
    const int f0 = tile * kTileF;
    for (int i = threadIdx.x; i < W * kTileF; i += kThreads) acc[i] = 0.f;
    for (int r = threadIdx.x; r < W; r += kThreads) {
      m[r] = -CUDART_INF_F;
      z[r] = 0.f;
      mc[r] = -CUDART_INF_F;
    }
    __syncthreads();
    float ms = -CUDART_INF_F;            // scalar variant: running max
    for (int t = t_begin; t < t_end; ++t) {
      const int64_t e0 = static_cast<int64_t>(t) * C, e1 = e0 + C;
      if (tile == 0) {                   // the chunk's scores, kept in s
        for (int64_t base = e0 + warp * 32; base < e1; base += kThreads) {
          const int64_t e = base + lane;
          int row = W, src = 0;
          if (e < e1) {
            row = local_row[e];
            src = edge_src[e];
          }
          const float sc = warp_scores(
              xd, nd, xs, F, even, row, src,
              static_cast<int64_t>(b) * W + row, W, lane);
          if (e < e1) s[e] = sc;
        }
        __syncthreads();                 // publishes s to the block
      }
      float M = 0.f, rc = 1.f;
      if (kRowStats) {
        // m_new = max(m_old, chunk max) per row; rescale rows whose max rose
        for (int64_t e = e0 + threadIdx.x; e < e1; e += kThreads) {
          const int r = local_row[e];
          if (r < W) atomic_max_float(mc + r, s[e]);
        }
        __syncthreads();
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
          for (int i = threadIdx.x; i < W * kTileF; i += kThreads)
            acc[i] *= fac[i / kTileF];
          for (int r = threadIdx.x; r < W; r += kThreads) z[r] *= fac[r];
          __syncthreads();
        }
      } else {
        // one max M per chunk over its valid lanes (0 for a pad-only chunk,
        // which still enters the running max, as on the TPU)
        float mx = -CUDART_INF_F;
        for (int64_t e = e0 + threadIdx.x; e < e1; e += kThreads)
          if (local_row[e] < W) mx = fmaxf(mx, s[e]);
        mx = block_max(mx, red);
        M = isfinite(mx) ? mx : 0.f;
        const float mn = fmaxf(ms, M);
        if (mn > ms && ms != -CUDART_INF_F) {   // rescale to the new max
          const float f = expf(ms - mn);
          for (int i = threadIdx.x; i < W * kTileF; i += kThreads) acc[i] *= f;
          for (int r = threadIdx.x; r < W; r += kThreads) z[r] *= f;
          __syncthreads();
        }
        rc = expf(M - mn);
        ms = mn;
      }
      // e = exp(s - max); z += e (f32); the tile += bf16(e) * x[src]
      for (int64_t base = e0 + warp * 32; base < e1; base += kThreads) {
        const int64_t e = base + lane;
        int row = W, src = 0;
        float w = 0.f;
        if (e < e1) {
          row = local_row[e];
          src = edge_src[e];
          if (row < W) {
            const float x = expf(s[e] - (kRowStats ? m[row] : M));
            atomicAdd(z + row, x * rc);
            w = round_to<T>(x) * rc;
          }
        }
        blocked::warp_accumulate<T, true, false, kUnroll>(
            xs, F, f0 + 2 * lane, row, src, w, W, lane, acc);
      }
      __syncthreads();
    }
    // out = acc / z where z > 0, else 0 (rows with no edges)
    const int fw = min(kTileF, F - f0);
    for (int i = threadIdx.x; i < W * kTileF; i += kThreads) {
      const int r = i / kTileF, j = i % kTileF;
      if (j < fw) {
        const float zr = z[r];
        out[(static_cast<int64_t>(b) * W + r) * F + f0 + j] =
            zr > 0.f ? acc[r * kTileF + tile_slot(j)] / fmaxf(zr, 1e-20f)
                     : 0.f;
      }
    }
    __syncthreads();
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t launch_sddmm(const void* xd, int64_t nd, const void* xs,
                         const int32_t* edge_src, const int32_t* local_row,
                         const int32_t* chunk_block, int num_chunks, int C,
                         int W, int F, float* out, cudaStream_t stream) {
  const int64_t lanes = static_cast<int64_t>(num_chunks) * C;
  int64_t grid = (lanes + kThreads - 1) / kThreads;
  if (grid > kMaxGrid) grid = kMaxGrid;
  sddmm_kernel<T><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const T*>(xd), nd, static_cast<const T*>(xs), edge_src,
      local_row, chunk_block, lanes, C, W, F, out);
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

template <typename T, bool kRowStats>
cudaError_t launch_flash(const void* xd, int64_t nd, const void* xs,
                         const int32_t* edge_src, const int32_t* local_row,
                         const int32_t* block_start, int num_blocks, int C,
                         int W, int F, float* s, float* out,
                         cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(W) * kTileF + 4 * W) * sizeof(float);
  auto kernel = flash_kernel<T, kRowStats>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int num_tiles = (F + kTileF - 1) / kTileF;
  kernel<<<num_blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(xd), nd, static_cast<const T*>(xs), edge_src,
      local_row, block_start, C, W, F, num_tiles, s, out);
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
  return static_cast<int>(
      x_is_bf16 ? launch_sddmm<__nv_bfloat16>(x_dst, dst_rows, x_src,
                                              edge_src, local_row,
                                              chunk_block, num_chunks, C, W,
                                              F, out, st)
                : launch_sddmm<float>(x_dst, dst_rows, x_src, edge_src,
                                      local_row, chunk_block, num_chunks, C,
                                      W, F, out, st));
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

// B4: s (T, C) f32 scratch for the scores; out (B*W, F) f32, already
// divided by z.  x_dst carries the scale already.  row_stats != 0: running
// max per row; 0: one max per chunk.
int tgt_attend_flash(const void* x_dst, int64_t dst_rows, const void* x_src,
                     int x_is_bf16, int row_stats, const int32_t* edge_src,
                     const int32_t* local_row, const int32_t* block_start,
                     int num_blocks, int C, int W, int F, float* s,
                     float* out, void* stream) {
  if (num_blocks <= 0 || C <= 0 || W <= 0 || F <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_is_bf16)
    err = row_stats
              ? launch_flash<__nv_bfloat16, true>(
                    x_dst, dst_rows, x_src, edge_src, local_row, block_start,
                    num_blocks, C, W, F, s, out, st)
              : launch_flash<__nv_bfloat16, false>(
                    x_dst, dst_rows, x_src, edge_src, local_row, block_start,
                    num_blocks, C, W, F, s, out, st);
  else
    err = row_stats
              ? launch_flash<float, true>(x_dst, dst_rows, x_src, edge_src,
                                          local_row, block_start, num_blocks,
                                          C, W, F, s, out, st)
              : launch_flash<float, false>(x_dst, dst_rows, x_src, edge_src,
                                           local_row, block_start,
                                           num_blocks, C, W, F, s, out, st);
  return static_cast<int>(err);
}

const char* tgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
