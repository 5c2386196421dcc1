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
// The design of B1, B2 and B11, one CUDA block per chunk
// (blocked::rows_kernel in blocked_common.cuh, which B8 and B10 share,
// with the Unweighted, StagedWeight<false> and RowScale policies):
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
//    rows that no lane reaches.  With C > kMaxStage a row's lanes can fall
//    in several passes, so the output is zeroed whole (cudaMemsetAsync) and
//    every piece adds.  There is no shared-memory float atomic: the tile
//    kernels these replace made two per lane and column.
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
// B11 is the same kernel with the RowScale policy: each lane's weight
// bf16(row_scale[src]) is gathered and rounded when the chunk is staged,
// and each int8 row is read whole with 8-, 4-, 2- or 1-byte loads (one
// 8-byte load a thread at F=256: the warp covers the row's 256 bytes;
// F=100 takes 4-byte loads, since src*100 is 4-aligned; an odd F single
// bytes), the width chosen once per launch from F and the alignment of q,
// and unpacked to f32 in registers.  The product q * bf16(scale) is a plain
// f32 multiply: exact, so its contraction into the add changes nothing.
// Its bound is N*F bytes of int8 plus N*4 of scales, the lane metadata and
// the f32 output (3.66 GB at ogbn-products size and F=256, 1.09 ms): half
// of B1's row bytes at bf16.  Nothing needs W % 128 (the TPU's tests run
// B11 at W=64, C=256).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "blocked_common.cuh"

namespace {

// B11's lanes: weight bf16(row_scale[edge_src]), the scale rounded as the
// TPU kernel's bf16 one-hot rounds it, gathered when the chunk is staged.
// Terms w * q are exact in f32 and are not rounded.
struct RowScale {
  static constexpr bool kAux = true, kRound = false;
  static constexpr int kMinBlocks = 4;
  const float* row_scale;
  const int32_t* edge_src;
  __device__ int aux(int64_t e, int, int64_t) const {
    return __float_as_int(blocked::round_to<__nv_bfloat16>(
        __ldg(row_scale + __ldg(edge_src + e))));
  }
  template <int kDepth, int kNV>
  __device__ blocked::LaneWeight weights(const int* aux_s, blocked::Piece pc,
                                         int lane, int64_t) const {
    return blocked::lane_weight(aux_s, pc, lane);
  }
};

// B11 with the widest load of 8, 4, 2 or 1 bytes that divides F and the
// address of q.
cudaError_t launch_q8(const int8_t* q, const float* row_scale,
                      const blocked::RowsArgs& a, cudaStream_t s) {
  const RowScale lanes{row_scale, a.edge_src};
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q);
  int v = 8;
  while (v > 1 && (a.F % v || addr % v)) v /= 2;
  switch (v) {
    case 8: return blocked::launch_rows<int8_t, 8>(q, a, lanes, s);
    case 4: return blocked::launch_rows<int8_t, 4>(q, a, lanes, s);
    case 2: return blocked::launch_rows<int8_t, 2>(q, a, lanes, s);
    default: return blocked::launch_rows<int8_t, 1>(q, a, lanes, s);
  }
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
// (T, C) int32; chunk_block: (T,) int32; block_start: (B+1,) int32; out:
// (B*W, F) f32.
int tgt_spmm_blocked_q8(const int8_t* q, const float* row_scale,
                        const int32_t* edge_src, const int32_t* local_row,
                        const int32_t* chunk_block, const int32_t* block_start,
                        int num_chunks, int num_blocks, int C, int W, int F,
                        float* out, void* stream) {
  if (num_chunks < 0 || num_blocks <= 0 || C <= 0 || W <= 0 || F <= 0 ||
      !row_scale)
    return static_cast<int>(cudaErrorInvalidValue);
  const blocked::RowsArgs a{edge_src,   local_row,  chunk_block,
                            block_start, num_chunks, num_blocks,
                            C,          W,          F,
                            out};
  return static_cast<int>(
      launch_q8(q, row_scale, a, static_cast<cudaStream_t>(stream)));
}

const char* tgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
