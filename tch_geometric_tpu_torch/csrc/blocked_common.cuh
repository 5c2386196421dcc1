// Device helpers shared by the blocked-layout kernels (spmm_blocked.cu: B1,
// B2, B11; attend_blocked.cu: B4, B5, B6, B10; gat_blocked.cu: B7, B8).
//
// The blocked layout: row block b owns W destination rows and the chunks
// [block_start[b], block_start[b+1]) of C lanes each; a lane carries its
// source row (edge_src) and its row within the block (local_row), pad lanes
// local_row == W and edge_src == 0.  An output tile is W rows x kTileF
// columns of float32 in shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace blocked {

constexpr int kTileF = 64;               // output columns per tile
constexpr unsigned kFull = 0xffffffffu;

// Each thread owns columns 2*lane and 2*lane+1 of a tile.  In shared memory
// column j of a row sits at (j & 1) * 32 + (j >> 1), so a warp's two atomic
// adds each touch 32 distinct banks.
__device__ __forceinline__ int tile_slot(int j) {
  return (j & 1) * 32 + (j >> 1);
}

// v rounded to the compute dtype T, as a float.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

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
__device__ __forceinline__ float2 load2(const int8_t* p, bool pair, bool has0,
                                        bool has1) {
  if (pair) {
    const char2 v = *reinterpret_cast<const char2*>(p);
    return make_float2(v.x, v.y);
  }
  return make_float2(has0 ? p[0] : 0.f, has1 ? p[1] : 0.f);
}

// Columns c and c+1 of a row of F columns, for an even c < F: one vector
// load when `even` (F even, so both columns exist and the pair is aligned),
// else scalars.  `even` is the caller's loop-invariant flag: a loop over c
// is then unswitched into a branch-free vector loop (a per-column test
// made the scores of attend_blocked.cu 1.7x slower on an H100).
template <typename T>
__device__ __forceinline__ float2 load_cols(const T* row, int c, int F,
                                            bool even) {
  return load2(row + c, even, true, c + 1 < F);
}

// Marks an unweighted accumulation for warp_accumulate_by.
struct NoWeight {};

// Adds x[src] (times the weights weight_of(j) returns for columns c0 and
// c0+1 of lane j, unless WeightFn is NoWeight; each term rounded to T,
// bf16(x * w), when kRound) of the warp's live lanes into the tile `acc`,
// columns c0 and c0+1 of this thread.  Every thread of the warp brings one
// lane's row and source.  Pad lanes (row == W) are dropped by a ballot
// before any row read; kUnroll lanes' loads are in flight before their adds.
// weight_of is called by the whole warp (it may shuffle).
template <typename T, bool kRound, int kUnroll, typename WeightFn>
__device__ __forceinline__ void warp_accumulate_by(const T* __restrict__ x,
                                                   int F, int c0, int my_row,
                                                   int my_src, int W, int lane,
                                                   float* acc,
                                                   WeightFn weight_of) {
  const bool has0 = c0 < F, has1 = c0 + 1 < F;
  const bool pair = has1 && F % 2 == 0;
  unsigned live = __ballot_sync(kFull, my_row < W);
  while (live) {                         // warp-uniform loop
    int rows[kUnroll];
    float2 v[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      rows[q] = -1;
      if (live) {                        // warp-uniform branch
        const int j = __ffs(live) - 1;
        live &= live - 1;
        rows[q] = __shfl_sync(kFull, my_row, j);
        const int64_t src = __shfl_sync(kFull, my_src, j);
        v[q] = load2(x + src * F + c0, pair, has0, has1);
        if constexpr (!std::is_same<WeightFn, NoWeight>::value) {
          const float2 w = weight_of(j);
          v[q].x *= w.x;
          v[q].y *= w.y;
          if (kRound) {
            v[q].x = round_to<T>(v[q].x);
            v[q].y = round_to<T>(v[q].y);
          }
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

// warp_accumulate_by with one weight per lane, my_w of the lane's thread
// (when kWeighted), for both columns.
template <typename T, bool kWeighted, bool kRound, int kUnroll>
__device__ __forceinline__ void warp_accumulate(const T* __restrict__ x,
                                                int F, int c0, int my_row,
                                                int my_src, float my_w, int W,
                                                int lane, float* acc) {
  if constexpr (kWeighted) {
    warp_accumulate_by<T, kRound, kUnroll>(
        x, F, c0, my_row, my_src, W, lane, acc, [my_w](int j) {
          const float w = __shfl_sync(kFull, my_w, j);
          return make_float2(w, w);
        });
  } else {
    warp_accumulate_by<T, kRound, kUnroll>(x, F, c0, my_row, my_src, W, lane,
                                           acc, NoWeight{});
  }
}

// Writes the tile's W rows into out rows row0.. (F columns), columns
// f0 .. min(f0 + kTileF, F); every row, rows with no edges as zeros.
__device__ __forceinline__ void store_tile(const float* acc,
                                           float* __restrict__ out,
                                           int64_t row0, int W, int F,
                                           int f0) {
  const int fw = min(kTileF, F - f0);
  for (int i = threadIdx.x; i < W * kTileF; i += blockDim.x) {
    const int r = i / kTileF, j = i % kTileF;
    if (j < fw) out[(row0 + r) * F + f0 + j] = acc[r * kTileF + tile_slot(j)];
  }
}

// Float max in shared memory: integer order matches float order for
// non-negative floats (as int) and reverses it for negative ones (as
// unsigned); -0.0 goes to the second branch.
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

// A lane's softmax weight from its row's final stats (0 where the row max
// is not finite or the sum is not positive).
__device__ __forceinline__ float softmax_weight(float s, float m, float z) {
  return isfinite(m) && z > 0.f ? expf(s - m) / fmaxf(z, 1e-38f) : 0.f;
}

}  // namespace blocked
