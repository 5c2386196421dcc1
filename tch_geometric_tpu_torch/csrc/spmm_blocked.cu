// Blocked-ELL SpMM for Hopper (sm_90a): kernels B1, B2 and B11.
//
// B1 replaces tch_geometric_tpu/ops/spmm_pallas.py::_kernel (wrapper
// spmm_blocked_pallas); B2 replaces
// tch_geometric_tpu/ops/attention_blocked.py::_spmm_w_kernel (wrapper
// spmm_blocked_weighted_pallas); B11 replaces
// tch_geometric_tpu/ops/spmm_pallas.py::_kernel_q8 (wrapper
// spmm_blocked_pallas_q8).  All compute, for every row block b of W rows and
// every lane of its chunks [block_start[b], block_start[b+1]),
//
//     out[b*W + local_row] += w * x[edge_src]        (w = 1 for B1)
//
// with f32 accumulation and pad lanes (local_row == W) contributing nothing.
// B1 and B2 take x in f32 or bf16; B2 multiplies the f32 lane weight w into
// each row in f32.  B11 takes int8 rows q (quantize_rows) and w =
// bf16(row_scale[edge_src]), the scale rounded as the TPU kernel's bf16
// one-hot rounds it; q * bf16(scale) is exact in f32, so only the summation
// order differs from the plain version.  The output has B*W rows; every row
// is written, rows with no edges as zeros.
//
// What the TPU kernel did and what changes here.  The Pallas kernel takes a
// pre-gathered (T, C, F) tensor (XLA did the gather) and carries a block's
// tile across sequential grid steps.  On this card the kernel gathers the
// x[edge_src] rows itself, so no (T, C, F) intermediate reaches device
// memory, and a CUDA block owns one (row block, 64-column feature tile):
// the chunks of a block are contiguous, so the carry becomes a loop inside
// the CUDA block.  The one-hot matmul becomes a shared-memory atomic add
// into a W x 64 f32 tile (lanes of a chunk are sorted by source, not by
// row, so rows collide across warps).
//
// Bound on an H100 (3.35 TB/s).  Reading each input once and writing the
// output once moves N*F*bytes (x) + lanes*8 (B1) or *12 (B2) metadata +
// B*W*F*4 (out) bytes.  A gather cannot reach that: each lane reads its
// row, so the lane-gather bound is padded lanes x F x bytes per element,
// plus the metadata, plus the output, over the memory rate.  The adds
// (lanes x F) are far below the f32 rate: the kernel is bound by bytes.
// For B11, x is N*F bytes of int8 plus N*4 of scales: 3.66 GB at
// ogbn-products size and F=256 (1.09 ms), half of B1's row bytes.
// What the design does about it: pad lanes are dropped before any feature
// read; each lane reads its row segment with one 2-byte (int8x2), 4-byte
// (bf16x2) or 8-byte (f32x2) load per thread, 64-256 contiguous bytes per
// warp (scalar loads for an odd F); eight independent row loads per warp
// are in flight before their atomics; the F tiles of one row block are
// adjacent in the grid, so its metadata and the hub rows are read from L2
// after the first tile.  Nothing needs W % 128 (the TPU's tests run B11 at
// W=64, C=256).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "blocked_common.cuh"

namespace {

using blocked::kTileF;

constexpr int kThreads = 512;            // 16 warps per CUDA block
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;            // 3 x 64 KB tiles per SM at W=256
constexpr int kUnroll = 8;               // edges loaded before their adds

// What weighs a lane: nothing (B1), its own weight (B2) or its source row's
// scale rounded to bf16 (B11).
enum Weight { kNone, kLane, kRowScale };

template <typename T, int kWeight>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
spmm_blocked_kernel(const T* __restrict__ x,
                    const int32_t* __restrict__ edge_src,
                    const int32_t* __restrict__ local_row,
                    const float* __restrict__ weight,
                    const int32_t* __restrict__ block_start,
                    int C, int W, int F, int num_tiles,
                    float* __restrict__ out) {
  extern __shared__ float acc[];         // W x kTileF f32 tile
  const int b = blockIdx.x / num_tiles;  // tiles of a block are adjacent
  const int f0 = (blockIdx.x % num_tiles) * kTileF;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < W * kTileF; i += kThreads) acc[i] = 0.f;
  __syncthreads();

  const int64_t e_begin = static_cast<int64_t>(block_start[b]) * C;
  const int64_t e_end = static_cast<int64_t>(block_start[b + 1]) * C;
  for (int64_t base = e_begin + static_cast<int64_t>(warp) * 32;
       base < e_end; base += static_cast<int64_t>(kWarps) * 32) {
    // each lane of the warp loads one edge's metadata
    const int64_t e = base + lane;
    int my_row = W, my_src = 0;
    float my_w = 0.f;
    if (e < e_end) {
      my_row = local_row[e];
      my_src = edge_src[e];
      if (kWeight == kLane) my_w = weight[e];
      if (kWeight == kRowScale && my_row < W)
        my_w = blocked::round_to<__nv_bfloat16>(weight[my_src]);
    }
    blocked::warp_accumulate<T, kWeight != kNone, false, kUnroll>(
        x, F, f0 + 2 * lane, my_row, my_src, my_w, W, lane, acc);
  }
  __syncthreads();
  blocked::store_tile(acc, out, static_cast<int64_t>(b) * W, W, F, f0);
}

template <typename T, int kWeight>
cudaError_t launch(const void* x, const int32_t* edge_src,
                   const int32_t* local_row, const float* weight,
                   const int32_t* block_start, int num_blocks, int C, int W,
                   int F, float* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(W) * kTileF * sizeof(float);
  auto kernel = spmm_blocked_kernel<T, kWeight>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int num_tiles = (F + kTileF - 1) / kTileF;
  const int64_t grid = static_cast<int64_t>(num_blocks) * num_tiles;
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      static_cast<const T*>(x), edge_src, local_row, weight, block_start, C,
      W, F, num_tiles, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (N, F) row-major, f32 (x_is_bf16 == 0) or bf16; edge_src, local_row:
// (T, C) int32; weight: (T, C) f32 or null (B1); block_start: (B+1,) int32;
// out: (B*W, F) f32.  Launches on `stream`; returns the cudaError_t of the
// launch (0 on success).  Does not synchronise.
int tgt_spmm_blocked(const void* x, int x_is_bf16, const int32_t* edge_src,
                     const int32_t* local_row, const float* weight,
                     const int32_t* block_start, int num_blocks, int C, int W,
                     int F, float* out, void* stream) {
  if (num_blocks <= 0 || C <= 0 || W <= 0 || F <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_is_bf16) {
    err = weight ? launch<__nv_bfloat16, kLane>(x, edge_src, local_row,
                                                weight, block_start,
                                                num_blocks, C, W, F, out, s)
                 : launch<__nv_bfloat16, kNone>(x, edge_src, local_row,
                                                weight, block_start,
                                                num_blocks, C, W, F, out, s);
  } else {
    err = weight ? launch<float, kLane>(x, edge_src, local_row, weight,
                                        block_start, num_blocks, C, W, F, out,
                                        s)
                 : launch<float, kNone>(x, edge_src, local_row, weight,
                                        block_start, num_blocks, C, W, F, out,
                                        s);
  }
  return static_cast<int>(err);
}

// B11.  q: (N, F) int8 row-major; row_scale: (N,) f32; the rest as
// tgt_spmm_blocked.
int tgt_spmm_blocked_q8(const int8_t* q, const float* row_scale,
                        const int32_t* edge_src, const int32_t* local_row,
                        const int32_t* block_start, int num_blocks, int C,
                        int W, int F, float* out, void* stream) {
  if (num_blocks <= 0 || C <= 0 || W <= 0 || F <= 0 || !row_scale)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<int8_t, kRowScale>(
      q, edge_src, local_row, row_scale, block_start, num_blocks, C, W, F,
      out, static_cast<cudaStream_t>(stream)));
}

const char* tgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
