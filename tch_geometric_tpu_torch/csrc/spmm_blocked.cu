// Blocked-ELL SpMM for Hopper (sm_90a): kernels B1, B2 and B11.
//
// B1 replaces tch_geometric_tpu/ops/spmm_pallas.py::_kernel (wrapper
// spmm_blocked_pallas); B2 replaces
// tch_geometric_tpu/ops/attention_blocked.py::_spmm_w_kernel (wrapper
// spmm_blocked_weighted_pallas); B11 replaces
// tch_geometric_tpu/ops/spmm_pallas.py::_kernel_q8 (wrapper
// spmm_blocked_pallas_q8).  All compute, for every lane of every chunk t of
// row block b = chunk_block[t],
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
// What the TPU kernel did.  The Pallas kernel takes a pre-gathered (T, C, F)
// tensor (XLA did the gather), contracts each chunk with a one-hot (C, W)
// matrix on the matrix unit and carries a block's tile across sequential
// grid steps.  On this card the kernels gather the x[edge_src] rows
// themselves, so no (T, C, F) intermediate reaches device memory.
//
// What bounds B1 and B2 on an H100 (3.35 TB/s).  Reading each input once
// and writing the output once moves N*F*bytes (x) + lanes*8 (B1) or *12 (B2)
// metadata + T*4 (chunk_block) + B*W*F*4 (out) bytes.  A gather cannot reach
// that: each lane reads its row, so the lane-gather bound is padded lanes x
// F x bytes per element, plus the metadata, plus the output, over the memory
// rate.  The adds (lanes x F) are far below the f32 rate: bytes bound them,
// and the rows must be fetched as whole rows, many in flight.
//
// The design of B1 and B2, one CUDA block per chunk (blocked::rows_kernel
// in blocked_common.cuh, which B8 and B10 share, with the Unweighted and
// StagedWeight<false> policies):
//  * A chunk's lanes come from one contiguous CSR range of its row block
//    (the builders sort them by source afterwards), so a chunk covers a
//    contiguous range of destination rows, and only its first and last row
//    can have lanes in another chunk.  The block stages the chunk's
//    local_row, edge_src (and weight) in shared memory, each read once from
//    device memory, drops the pad lanes and counting-sorts the live lanes by
//    row (an int histogram, a scan, a scatter): each row's lanes become one
//    run.  Chunks wider than kMaxStage lanes are processed in passes.
//  * Runs are cut into pieces of at most kPiece lanes, so that a hub row is
//    spread over several warps.  A warp takes a piece and reads each lane's
//    row across all F columns with 16-, 8- or 4-byte vector loads (one load
//    per thread per row at F=256 bf16: the warp covers the row's 512
//    contiguous bytes), several rows in flight, and adds them in f32
//    registers.  The load width is chosen once per launch from F and the
//    alignment of x.
//  * A piece writes its sum once: a row that lies whole inside one piece of
//    a chunk, and is neither the chunk's first nor last row, is owned by
//    that piece and stored; every other row is added with vector atomics
//    (float4/float2, sm_90) onto a row that a small first kernel
//    (blocked::zero_split_rows_kernel) has set to zero, together with the
//    rows that no lane reaches.  With C > kMaxStage a row's lanes can fall in several
//    passes, so the output is zeroed whole (cudaMemsetAsync) and every piece
//    adds.  There is no shared-memory float atomic: the old tile kernel made
//    two per lane and column.
//  * Every row's summation order can change from run to run: the scatter
//    into row runs takes positions by shared-memory atomics on the row
//    cursors, so the order of a row's lanes within its run follows the
//    warps' schedule, and a row added from several pieces is summed by
//    global atomics.  Against the plain version the kernels differ by
//    summation order only (utils/kernel_gates.py states the limits).
//  * Direct mode relies on the builders' layout: each chunk's live lanes
//    are one contiguous CSR range of its row block (BlockedCsr), so only a
//    chunk's first and last row can be shared with another chunk.
//
// B11 still runs the first design (spmm_blocked_kernel, the tile kernel
// B1 and B2 ran before): one CUDA block per (row block, 64-column tile) walks the
// block's chunks; each lane reads its 64 int8 columns with one 2-byte load
// per thread and adds them into a W x 64 f32 tile in shared memory with
// atomics.  Its x is N*F bytes of int8 plus N*4 of scales (3.66 GB at
// ogbn-products size and F=256, 1.09 ms), half of B1's row bytes.  It keeps
// that design because kernels are redesigned at most two at a time, so
// that each move is measured alone; its time on the same layout also shows
// the old design beside the new one.  Nothing needs W % 128 (the TPU's
// tests run B11 at W=64, C=256).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "blocked_common.cuh"

namespace {

using blocked::kTileF;

// ---- B11: the tile kernel -------------------------------------------------

constexpr int kThreads = 512;            // 16 warps per CUDA block
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;            // 3 x 64 KB tiles per SM at W=256
constexpr int kUnroll = 8;               // edges loaded before their adds

// Each lane is weighted by its source row's scale rounded to bf16.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
spmm_blocked_kernel(const int8_t* __restrict__ x,
                    const int32_t* __restrict__ edge_src,
                    const int32_t* __restrict__ local_row,
                    const float* __restrict__ row_scale,
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
      if (my_row < W)
        my_w = blocked::round_to<__nv_bfloat16>(row_scale[my_src]);
    }
    blocked::warp_accumulate<kUnroll>(x, F, f0 + 2 * lane, my_row, my_src,
                                      my_w, W, lane, acc);
  }
  __syncthreads();
  blocked::store_tile(acc, out, static_cast<int64_t>(b) * W, W, F, f0);
}

cudaError_t launch_q8(const int8_t* q, const int32_t* edge_src,
                      const int32_t* local_row, const float* row_scale,
                      const int32_t* block_start, int num_blocks, int C,
                      int W, int F, float* out, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(W) * kTileF * sizeof(float);
  cudaError_t err = blocked::allow_smem(spmm_blocked_kernel, smem);
  if (err != cudaSuccess) return err;
  const int num_tiles = (F + kTileF - 1) / kTileF;
  const int64_t grid = static_cast<int64_t>(num_blocks) * num_tiles;
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  spmm_blocked_kernel<<<static_cast<unsigned>(grid), kThreads, smem,
                        stream>>>(q, edge_src, local_row, row_scale,
                                  block_start, C, W, F, num_tiles, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B1 (weight null) and B2.  x: (N, F) row-major, f32 (x_is_bf16 == 0) or
// bf16; edge_src, local_row: (T, C) int32; weight: (T, C) f32 or null;
// chunk_block: (T,) int32; block_start: (B+1,) int32; out: (B*W, F) f32.
// Launches on `stream`; returns the cudaError_t of the launches (0 on
// success).  Does not synchronise.
int tgt_spmm_blocked(const void* x, int x_is_bf16, const int32_t* edge_src,
                     const int32_t* local_row, const float* weight,
                     const int32_t* chunk_block, const int32_t* block_start,
                     int num_chunks, int num_blocks, int C, int W, int F,
                     float* out, void* stream) {
  if (num_chunks < 0 || num_blocks <= 0 || C <= 0 || W <= 0 || F <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const blocked::RowsArgs a{edge_src,   local_row,  chunk_block,
                            block_start, num_chunks, num_blocks,
                            C,          W,          F,
                            out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // B1 and B2 sum f32 products (B2 multiplies its f32 weight in f32)
  const cudaError_t err =
      weight ? blocked::launch_rows_vec(x, x_is_bf16 != 0, F, a,
                                        blocked::StagedWeight<false>{weight}, s)
             : blocked::launch_rows_vec(x, x_is_bf16 != 0, F, a,
                                        blocked::Unweighted{}, s);
  return static_cast<int>(err);
}

// B11.  q: (N, F) int8 row-major; row_scale: (N,) f32; edge_src, local_row:
// (T, C) int32; block_start: (B+1,) int32; out: (B*W, F) f32.
int tgt_spmm_blocked_q8(const int8_t* q, const float* row_scale,
                        const int32_t* edge_src, const int32_t* local_row,
                        const int32_t* block_start, int num_blocks, int C,
                        int W, int F, float* out, void* stream) {
  if (num_blocks <= 0 || C <= 0 || W <= 0 || F <= 0 || !row_scale)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_q8(q, edge_src, local_row, row_scale,
                                    block_start, num_blocks, C, W, F, out,
                                    static_cast<cudaStream_t>(stream)));
}

const char* tgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
