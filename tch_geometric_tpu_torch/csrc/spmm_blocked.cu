// Blocked-ELL SpMM for Hopper (sm_90a): kernels B1 and B2.
//
// B1 replaces tch_geometric_tpu/ops/spmm_pallas.py::_kernel (wrapper
// spmm_blocked_pallas); B2 replaces
// tch_geometric_tpu/ops/attention_blocked.py::_spmm_w_kernel (wrapper
// spmm_blocked_weighted_pallas).  Both compute, for every row block b of W
// rows and every lane of its chunks [block_start[b], block_start[b+1]),
//
//     out[b*W + local_row] += w * x[edge_src]        (w = 1 for B1)
//
// with f32 accumulation, x in f32 or bf16, and pad lanes (local_row == W)
// contributing nothing.  The output has B*W rows; every row is written,
// rows with no edges as zeros.
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
// What the design does about it: pad lanes are dropped before any feature
// read; each lane reads its row segment with one 4-byte (bf16x2) or 8-byte
// (f32x2) load per thread, 128/256 contiguous bytes per warp; eight
// independent row loads per warp are in flight before their atomics; the
// F tiles of one row block are adjacent in the grid, so its metadata and
// the hub rows are read from L2 after the first tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;            // 16 warps per CUDA block
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;            // 3 x 64 KB tiles per SM at W=256
constexpr int kTileF = 64;               // feature columns per CUDA block
constexpr int kUnroll = 8;               // edges loaded before their adds
constexpr unsigned kFull = 0xffffffffu;

// Each lane owns columns 2*lane and 2*lane+1 of the tile.  In shared memory
// column j of a row sits at (j & 1) * 32 + (j >> 1), so a warp's two atomic
// adds each touch 32 distinct banks.
__device__ __forceinline__ int tile_slot(int j) { return (j & 1) * 32 + (j >> 1); }

// Columns c and c+1 of a row as floats (0 where a column does not exist):
// one vector load when `pair` (both exist, address aligned), else scalars.
__device__ __forceinline__ float2 load2(const float* p, bool pair, bool has0,
                                        bool has1) {
  if (pair) return *reinterpret_cast<const float2*>(p);
  return make_float2(has0 ? p[0] : 0.f, has1 ? p[1] : 0.f);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p, bool pair,
                                        bool has0, bool has1) {
  if (pair)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return make_float2(has0 ? __bfloat162float(p[0]) : 0.f,
                     has1 ? __bfloat162float(p[1]) : 0.f);
}

template <typename T, bool kWeighted>
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

  const int c0 = f0 + 2 * lane;          // this lane's first column
  const bool has0 = c0 < F, has1 = c0 + 1 < F;
  // a vector load needs both columns and aligned row starts (F even)
  const bool pair = has1 && F % 2 == 0;

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
      if (kWeighted) my_w = weight[e];
    }
    // pad lanes carry local_row == W (and edge_src == 0): drop them here
    unsigned live = __ballot_sync(kFull, my_row < W);
    while (live) {                       // warp-uniform loop
      int rows[kUnroll];
      float2 v[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        rows[q] = -1;
        if (live) {                      // warp-uniform branch
          const int j = __ffs(live) - 1;
          live &= live - 1;
          rows[q] = __shfl_sync(kFull, my_row, j);
          const int64_t src = __shfl_sync(kFull, my_src, j);
          v[q] = load2(x + src * F + c0, pair, has0, has1);
          if (kWeighted) {
            const float w = __shfl_sync(kFull, my_w, j);
            v[q].x *= w;
            v[q].y *= w;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        if (rows[q] < 0) continue;
        float* ar = acc + rows[q] * kTileF;
        if (has0) atomicAdd(ar + lane, v[q].x);
        if (has1) atomicAdd(ar + 32 + lane, v[q].y);
      }
    }
  }
  __syncthreads();

  const int fw = min(kTileF, F - f0);
  for (int i = threadIdx.x; i < W * kTileF; i += kThreads) {
    const int r = i / kTileF, j = i % kTileF;
    if (j < fw)
      out[(static_cast<int64_t>(b) * W + r) * F + f0 + j] =
          acc[r * kTileF + tile_slot(j)];
  }
}

template <typename T, bool kWeighted>
cudaError_t launch(const void* x, const int32_t* edge_src,
                   const int32_t* local_row, const float* weight,
                   const int32_t* block_start, int num_blocks, int C, int W,
                   int F, float* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(W) * kTileF * sizeof(float);
  auto kernel = spmm_blocked_kernel<T, kWeighted>;
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
    err = weight ? launch<__nv_bfloat16, true>(x, edge_src, local_row, weight,
                                               block_start, num_blocks, C, W,
                                               F, out, s)
                 : launch<__nv_bfloat16, false>(x, edge_src, local_row,
                                                weight, block_start,
                                                num_blocks, C, W, F, out, s);
  } else {
    err = weight ? launch<float, true>(x, edge_src, local_row, weight,
                                       block_start, num_blocks, C, W, F, out,
                                       s)
                 : launch<float, false>(x, edge_src, local_row, weight,
                                        block_start, num_blocks, C, W, F, out,
                                        s);
  }
  return static_cast<int>(err);
}

const char* tgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
