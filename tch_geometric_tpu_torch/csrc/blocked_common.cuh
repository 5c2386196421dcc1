// Device helpers shared by the blocked-layout kernels (spmm_blocked.cu: B1,
// B2, B11; attend_blocked.cu: B4, B5, B6, B10; gat_blocked.cu: B7, B8).
//
// The blocked layout: row block b owns W destination rows and the chunks
// [block_start[b], block_start[b+1]) of C lanes each; a lane carries its
// source row (edge_src) and its row within the block (local_row), pad lanes
// local_row == W and edge_src == 0.  An output tile is W rows x kTileF
// columns of float32 in shared memory (the tile kernels).  The row-grouped
// kernels (B1, B2, B4, B5) stage a chunk in shared memory instead and
// counting-sort its live lanes by row (stage_pass): each row's lanes become
// one run, cut into pieces of at most kPiece lanes that one warp takes,
// reading each lane's source row whole with Vec loads.
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

// ---- row-grouped chunks (B1, B2, B4, B5) ---------------------------------

constexpr int kRowThreads = 256;         // 8 warps per CUDA block
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kPiece = 32;               // lanes of one row a warp takes
constexpr int kMaxStage = 4096;          // lanes staged per pass
constexpr int kAcc = 8;                  // f32 sums a thread holds
constexpr int kSlab = 32 * kAcc;         // columns a warp covers at once

// kVec elements of T as one load.
template <typename T, int kVec> struct Vec;
template <> struct Vec<float, 4> { using Raw = float4; };
template <> struct Vec<float, 2> { using Raw = float2; };
template <> struct Vec<float, 1> { using Raw = float; };
template <> struct Vec<__nv_bfloat16, 8> { using Raw = uint4; };
template <> struct Vec<__nv_bfloat16, 4> { using Raw = uint2; };
template <> struct Vec<__nv_bfloat16, 2> { using Raw = unsigned; };
template <> struct Vec<__nv_bfloat16, 1> { using Raw = unsigned short; };

// Rows a warp loads before it uses them: 32 registers of loads a thread
// (kAcc / kVec vectors of a row each), at most 8.
template <typename T, int kVec>
__host__ __device__ constexpr int load_depth() {
  using Raw = typename Vec<T, kVec>::Raw;
  constexpr int kRegs = (kAcc / kVec) * ((sizeof(Raw) + 3) / 4);
  return 32 / kRegs < 8 ? 32 / kRegs : 8;
}

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32 ones.
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void unpack(float4 v, float* f) {
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void unpack(float2 v, float* f) {
  f[0] = v.x; f[1] = v.y;
}
__device__ __forceinline__ void unpack(float v, float* f) { f[0] = v; }
__device__ __forceinline__ void unpack(uint4 v, float* f) {
  f[0] = bf16_lo(v.x); f[1] = bf16_hi(v.x); f[2] = bf16_lo(v.y);
  f[3] = bf16_hi(v.y); f[4] = bf16_lo(v.z); f[5] = bf16_hi(v.z);
  f[6] = bf16_lo(v.w); f[7] = bf16_hi(v.w);
}
__device__ __forceinline__ void unpack(uint2 v, float* f) {
  f[0] = bf16_lo(v.x); f[1] = bf16_hi(v.x); f[2] = bf16_lo(v.y);
  f[3] = bf16_hi(v.y);
}
__device__ __forceinline__ void unpack(unsigned v, float* f) {
  f[0] = bf16_lo(v); f[1] = bf16_hi(v);
}
__device__ __forceinline__ void unpack(unsigned short v, float* f) {
  f[0] = bf16_lo(v);
}

// Stores (add == false) or atomically adds kVec f32 values at o, as float4,
// float2 or float accesses (o is aligned to min(kVec, 4) floats).
template <int kVec>
__device__ __forceinline__ void put(float* o, const float* f, bool add) {
  if constexpr (kVec >= 4) {
#pragma unroll
    for (int i = 0; i < kVec; i += 4) {
      const float4 v = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
      if (add) atomicAdd(reinterpret_cast<float4*>(o + i), v);
      else *reinterpret_cast<float4*>(o + i) = v;
    }
  } else if constexpr (kVec == 2) {
    const float2 v = make_float2(f[0], f[1]);
    if (add) atomicAdd(reinterpret_cast<float2*>(o), v);
    else *reinterpret_cast<float2*>(o) = v;
  } else {
    if (add) atomicAdd(o, f[0]);
    else *o = f[0];
  }
}

// One piece of a row run: lanes [start, start + len) of the sorted chunk,
// len <= kPiece, all of destination row `row`; `own`: the row lies whole in
// this piece and is neither the chunk's first nor its last row, so no other
// piece or chunk has lanes of it.
struct Piece {
  int start, row, len, own;
};

// scan[0..W) holds each row's live-lane count.  Rewrites scan[r] to (the
// row's first lane, its first piece) in the sorted chunk — exclusive sums
// of the counts and of ceil(count / kPiece) — and scan[W] to the totals.
// Called by the whole block; ends with a barrier.
__device__ inline void scan_rows(int2* scan, int W) {
  __shared__ int2 warp_sum[kRowWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (W + kRowThreads - 1) / kRowThreads;
  const int r0 = min(static_cast<int>(threadIdx.x) * per, W);
  const int r1 = min(r0 + per, W);
  int2 mine = make_int2(0, 0);
  for (int r = r0; r < r1; ++r) {
    mine.x += scan[r].x;
    mine.y += (scan[r].x + kPiece - 1) / kPiece;
  }
  int2 inc = mine;                       // inclusive sums over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int ax = __shfl_up_sync(kFull, inc.x, d);
    const int ay = __shfl_up_sync(kFull, inc.y, d);
    if (lane >= d) {
      inc.x += ax;
      inc.y += ay;
    }
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  int2 run = make_int2(inc.x - mine.x, inc.y - mine.y);
  for (int w = 0; w < warp; ++w) {
    run.x += warp_sum[w].x;
    run.y += warp_sum[w].y;
  }
  for (int r = r0; r < r1; ++r) {
    const int c = scan[r].x;
    scan[r] = run;
    run.x += c;
    run.y += (c + kPiece - 1) / kPiece;
  }
  if (threadIdx.x == kRowThreads - 1) scan[W] = run;
  __syncthreads();
}

// Shared memory of a row-grouped kernel that stages `stage` lanes a pass:
// the pieces, the scan, the row cursors, the staged rows, and `arrays`
// more int or float arrays of one entry a lane.
__host__ __device__ inline int max_pieces(int stage, int W) {
  return stage / kPiece + W + 1;
}
inline size_t stage_smem_bytes(int stage, int W, int arrays) {
  return static_cast<size_t>(max_pieces(stage, W)) * sizeof(Piece) +
         static_cast<size_t>(W + 1) * sizeof(int2) +
         static_cast<size_t>(W) * sizeof(int) +
         static_cast<size_t>(stage) * sizeof(int) * (1 + arrays);
}

// The stage in shared memory (stage_smem_bytes): piece, scan, cursor and
// row_s, then the kernel's own per-lane arrays from `lanes` on.
struct Stage {
  Piece* piece;
  int2* scan;
  int* cursor;
  int* row_s;
  int* lanes;
  __device__ Stage(void* smem, int stage, int W) {
    piece = static_cast<Piece*>(smem);
    scan = reinterpret_cast<int2*>(piece + max_pieces(stage, W));
    cursor = reinterpret_cast<int*>(scan + W + 1);
    row_s = cursor + W;
    lanes = row_s + stage;
  }
};

// Stages lanes [e0, e0 + n) of a chunk: reads local_row once, counts the
// live lanes of each row, scans, cuts each row's run into pieces (own as
// Piece says, only when `whole`: the pass is the whole chunk), and calls
// place(i, pos) for each live lane i with its position pos in the sorted
// order, pad(i) for each pad lane (by the thread that read row_s[i]).  The
// order of a row's lanes follows the shared atomics on its cursor, so it
// can change from run to run.  Called by the whole block; returns the
// number of pieces, after a barrier.
template <typename Place, typename Pad>
__device__ __forceinline__ int stage_pass(const int32_t* __restrict__ local_row,
                                          int64_t e0, int n, int W, bool whole,
                                          const Stage& st, Place place,
                                          Pad pad) {
  for (int r = threadIdx.x; r <= W; r += kRowThreads)
    st.scan[r] = make_int2(0, 0);
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kRowThreads) {
    const int r = local_row[e0 + i];
    st.row_s[i] = r;
    if (r < W) atomicAdd(&st.scan[r].x, 1);
  }
  __syncthreads();
  scan_rows(st.scan, W);
  const int live = st.scan[W].x;
  for (int r = threadIdx.x; r < W; r += kRowThreads) {
    const int first = st.scan[r].x, cnt = st.scan[r + 1].x - first;
    st.cursor[r] = first;
    const int own = whole && cnt <= kPiece && first > 0 && first + cnt < live;
    for (int q = 0; q * kPiece < cnt; ++q)
      st.piece[st.scan[r].y + q] = Piece{first + q * kPiece, r,
                                         min(kPiece, cnt - q * kPiece), own};
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kRowThreads) {
    const int r = st.row_s[i];
    if (r < W) place(i, atomicAdd(&st.cursor[r], 1));
    else pad(i);
  }
  __syncthreads();
  return st.scan[W].y;
}

// Elements per load: the widest of 16, 8 and 4 bytes that divides the row
// (F elements) and the address of x, else one element.
inline int vec_elems(const void* x, int F, int elem_bytes) {
  const int64_t row = static_cast<int64_t>(F) * elem_bytes;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x);
  for (int bytes = 16; bytes >= 4; bytes /= 2)
    if (row % bytes == 0 && addr % bytes == 0) return bytes / elem_bytes;
  return 1;
}

}  // namespace blocked
