// Device and host helpers shared by the blocked-layout kernels
// (spmm_blocked.cu: B1, B2, B11; attend_blocked.cu: B4, B5, B6, B10;
// gat_blocked.cu: B7, B8).
//
// The blocked layout: row block b owns W destination rows and the chunks
// [block_start[b], block_start[b+1]) of C lanes each; a lane carries its
// source row (edge_src) and its row within the block (local_row), pad lanes
// local_row == W and edge_src == 0.  B11 still runs the tile design: an
// output tile of W rows x kTileF columns of float32 in shared memory.  The
// row-grouped kernels (B1, B2, B4, B5, B8, B10) stage a chunk in shared
// memory instead and counting-sort its live lanes by row (stage_pass): each
// row's lanes become one run, cut into pieces of at most kPiece lanes that
// one warp takes, reading each lane's source row whole with Vec loads.  The
// weighted sums among them (B1, B2, B8, B10's last step) are one kernel,
// rows_kernel, instantiated per source file with a Lanes policy that stages
// each lane's weight data and gives add_piece each piece's weights.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace blocked {

constexpr unsigned kFull = 0xffffffffu;

// v rounded to the compute dtype T, as a float.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// ---- the tile design (B11) ------------------------------------------------

constexpr int kTileF = 64;               // output columns per tile

// Each thread owns columns 2*lane and 2*lane+1 of a tile.  In shared memory
// column j of a row sits at (j & 1) * 32 + (j >> 1), so a warp's two atomic
// adds each touch 32 distinct banks.
__device__ __forceinline__ int tile_slot(int j) {
  return (j & 1) * 32 + (j >> 1);
}

// Columns c and c+1 of an int8 row as floats (0 where a column does not
// exist): one 2-byte load when `pair` (both exist, address aligned), else
// scalars.
__device__ __forceinline__ float2 load2(const int8_t* p, bool pair, bool has0,
                                        bool has1) {
  if (pair) {
    const char2 v = *reinterpret_cast<const char2*>(p);
    return make_float2(v.x, v.y);
  }
  return make_float2(has0 ? p[0] : 0.f, has1 ? p[1] : 0.f);
}

// Adds my_w * x[src] of the warp's live lanes into the tile `acc`, columns
// c0 and c0+1 of this thread.  Every thread of the warp brings one lane's
// row, source and weight.  Pad lanes (row == W) are dropped by a ballot
// before any row read; kUnroll lanes' loads are in flight before their adds.
template <int kUnroll>
__device__ __forceinline__ void warp_accumulate(const int8_t* __restrict__ x,
                                                int F, int c0, int my_row,
                                                int my_src, float my_w, int W,
                                                int lane, float* acc) {
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
        const float w = __shfl_sync(kFull, my_w, j);
        v[q].x *= w;
        v[q].y *= w;
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

// ---- row-grouped chunks (B1, B2, B4, B5, B8, B10) ------------------------

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

template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---- the row-grouped weighted sum (B1, B2, B8, B10) ----------------------
//
// out[b*W + local_row] += w * x[edge_src] over the lanes of the chunks of
// row block b, with f32 sums; one CUDA block per chunk (rows_kernel).  The
// weight of a term can differ per lane and per column (B8's heads), and each
// term can be rounded to the compute dtype first (B8, B10).

// The weights add_piece gives the terms.  A weight functor wf is told each
// slab's columns (wf.slab(col)); in the load phase the whole warp calls
// wf.load(u, j, len) for lane j of the piece as row u of the batch in flight
// (nothing to load where j >= len); in the add phase the whole warp calls
// wf.get(u, j, w) before row u is added, and w[k] is then the weight of this
// thread's vector k of that row.  kWeighted false: no weight at all.
struct NoWeight {
  static constexpr bool kWeighted = false;
  template <int kNV>
  __device__ void slab(const int (&)[kNV]) {}
  __device__ void load(int, int, int) {}
  template <int kNV>
  __device__ void get(int, int, float (&)[kNV]) {}
};

// One weight a lane for all its columns: my_w of the lane's thread, shuffled
// to the warp as its row is added.
struct LaneWeight {
  static constexpr bool kWeighted = true;
  float my_w;
  template <int kNV>
  __device__ void slab(const int (&)[kNV]) {}
  __device__ void load(int, int, int) {}
  template <int kNV>
  __device__ void get(int, int j, float (&w)[kNV]) {
    const float v = __shfl_sync(kFull, my_w, j & 31);
#pragma unroll
    for (int k = 0; k < kNV; ++k) w[k] = v;
  }
};

// One warp adds the rows x[src_s[pc.start + j]], j < pc.len, of a piece,
// each column weighted as wf says and, when kRound, each term rounded to T
// (round_to<T>(w * x): the product rounded on its own, never fused into the
// add), and writes the f32 sums to out_row: stored when the piece owns the
// row, else added by vector atomics.  Thread `lane` holds columns
// c0 + (k*32 + lane)*kVec .. +kVec of each 32*kAcc-column slab,
// k < kAcc / kVec, so each row load of the warp is contiguous.
template <typename T, int kVec, bool kRound, typename WeightFn>
__device__ __forceinline__ void add_piece(const T* __restrict__ x, int F,
                                          const int* src_s, Piece pc,
                                          float* __restrict__ out_row,
                                          int lane, WeightFn& wf) {
  using Raw = typename Vec<T, kVec>::Raw;
  constexpr int kNV = kAcc / kVec;       // vectors a thread holds
  // rows in flight before their adds
  constexpr int kDepth = load_depth<T, kVec>();
  const int my_src = lane < pc.len ? src_s[pc.start + lane] : 0;
  for (int c0 = 0; c0 < F; c0 += kSlab) {
    int col[kNV];
    bool has[kNV];
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      col[k] = c0 + (k * 32 + lane) * kVec;
      has[k] = col[k] < F;               // F % kVec == 0: all kVec or none
    }
    wf.slab(col);
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    for (int j = 0; j < pc.len; j += kDepth) {
      Raw v[kDepth][kNV];
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        const int64_t src = __shfl_sync(kFull, my_src, (j + u) & 31);
        wf.load(u, j + u, pc.len);
        if (j + u < pc.len) {            // warp-uniform
          const T* row = x + src * F;
#pragma unroll
          for (int k = 0; k < kNV; ++k)
            if (has[k])
              v[u][k] = __ldg(reinterpret_cast<const Raw*>(row + col[k]));
        }
      }
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        float w[kNV];
        wf.get(u, j + u, w);
        if (j + u < pc.len) {
#pragma unroll
          for (int k = 0; k < kNV; ++k) {
            if (!has[k]) continue;
            float f[kVec];
            unpack(v[u][k], f);
#pragma unroll
            for (int e = 0; e < kVec; ++e) {
              float& a = acc[k * kVec + e];
              if constexpr (!WeightFn::kWeighted) a += f[e];
              else if constexpr (kRound) a += round_to<T>(__fmul_rn(w[k], f[e]));
              else a += w[k] * f[e];
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kNV; ++k)
      if (has[k]) put<kVec>(out_row + col[k], acc + k * kVec, !pc.own);
  }
}

// The Lanes policies of rows_kernel.  A policy says whether it stages one
// 32-bit value a lane (kAux: aux(e, pos, row) of lane e, the pos-th lane of
// its chunk, destination row `row` of out), whether terms are rounded to the
// compute dtype (kRound), how many CUDA blocks share an SM (kMinBlocks, for
// __launch_bounds__), and makes each piece's weight functor
// (weights<kDepth, kNV>(aux_s, pc, lane, chunk0), aux_s the staged values
// in sorted order, chunk0 the chunk's first lane).

// B1: no weight.
struct Unweighted {
  static constexpr bool kAux = false, kRound = false;
  static constexpr int kMinBlocks = 4;   // at most 64 registers a thread
  template <int kDepth, int kNV>
  __device__ NoWeight weights(const int*, Piece, int, int64_t) const {
    return {};
  }
};

// The staged value of lane `lane` of a piece as its float weight.
__device__ __forceinline__ LaneWeight lane_weight(const int* aux_s, Piece pc,
                                                  int lane) {
  return {lane < pc.len ? __int_as_float(aux_s[pc.start + lane]) : 0.f};
}

// A float32 weight a lane, weight[e] (B2; B8 with one head, kRound).  With
// rounded terms three CUDA blocks an SM (80 registers): on an NVIDIA H100
// 80GB HBM3 at 700 W (scripts/time_csrc_variants.py) B8 with one head took
// 11.7 ms at F=256 bf16 and 7.3 at F=47 f32, against 14.6 and 14.3 with
// four.  B1 and B2 keep four: at three, B1 read 11.1 against 10.7 ms at
// F=256 bf16 and 5.7 against 5.1 at F=100 (B2 2.1 against 3.9 on the hot
// half).
template <bool kRoundTerms>
struct StagedWeight {
  static constexpr bool kAux = true, kRound = kRoundTerms;
  static constexpr int kMinBlocks = kRoundTerms ? 3 : 4;
  const float* weight;
  __device__ int aux(int64_t e, int, int64_t) const {
    return __float_as_int(weight[e]);
  }
  template <int kDepth, int kNV>
  __device__ LaneWeight weights(const int* aux_s, Piece pc, int lane,
                                int64_t) const {
    return lane_weight(aux_s, pc, lane);
  }
};

// One CUDA block per chunk: stage it (stage_pass), then each warp adds its
// pieces (add_piece).  A row whose lanes all lie in this pass, in one piece,
// and that is neither the chunk's first row nor its last is stored; every
// other row is added onto a row zeroed before (launch_rows).
template <typename T, int kVec, typename Lanes>
__global__ void __launch_bounds__(kRowThreads, Lanes::kMinBlocks)
rows_kernel(const T* __restrict__ x, const int32_t* __restrict__ edge_src,
            const int32_t* __restrict__ local_row,
            const int32_t* __restrict__ chunk_block, int C, int W, int F,
            int stage, int direct, float* __restrict__ out, Lanes lanes) {
  extern __shared__ int4 smem[];
  const Stage st(smem, stage, W);
  int* src_s = st.lanes;
  int* aux_s = src_s + stage;            // the policy's value a lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t chunk0 = static_cast<int64_t>(blockIdx.x) * C;
  const int64_t row0 = static_cast<int64_t>(chunk_block[blockIdx.x]) * W;

  for (int s0 = 0; s0 < C; s0 += stage) {
    const int n = min(stage, C - s0);
    const int64_t e0 = chunk0 + s0;
    const int num_pieces = stage_pass(
        local_row, e0, n, W, direct && n == C, st,
        [&](int i, int pos) {
          src_s[pos] = edge_src[e0 + i];
          if constexpr (Lanes::kAux)
            aux_s[pos] = lanes.aux(e0 + i, s0 + i, row0 + st.row_s[i]);
        },
        [](int) {});
    for (int p = warp; p < num_pieces; p += kRowWarps) {
      const Piece pc = st.piece[p];
      auto wf = lanes.template weights<load_depth<T, kVec>(), kAcc / kVec>(
          aux_s, pc, lane, chunk0);
      add_piece<T, kVec, Lanes::kRound>(x, F, src_s, pc,
                                        out + (row0 + pc.row) * F, lane, wf);
    }
    __syncthreads();                     // the next pass reuses the stage
  }
}

// Before rows_kernel in direct mode, one CUDA block per row block b zeroes
// every row of b that the kernel will not store whole: rows no lane reaches
// (a block of pad chunks: all of them), rows of more than kPiece lanes
// (several pieces), and each chunk's first and last row (a neighbouring
// chunk may add to them).  Reads local_row of b's chunks.
static __global__ void __launch_bounds__(kRowThreads)
zero_split_rows_kernel(const int32_t* __restrict__ local_row,
                       const int32_t* __restrict__ block_start, int C, int W,
                       int F, float* __restrict__ out) {
  extern __shared__ int cnt[];           // W lane counts, then W marks
  int* mark = cnt + W;
  __shared__ int lo, hi;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  for (int r = threadIdx.x; r < W; r += kRowThreads) cnt[r] = mark[r] = 0;
  if (threadIdx.x == 0) {
    lo = W;
    hi = -1;
  }
  __syncthreads();
  for (int t = block_start[b]; t < block_start[b + 1]; ++t) {
    int my_lo = W, my_hi = -1;
    for (int i = threadIdx.x; i < C; i += kRowThreads) {
      const int r = local_row[static_cast<int64_t>(t) * C + i];
      if (r < W) {
        atomicAdd(&cnt[r], 1);
        my_lo = min(my_lo, r);
        my_hi = max(my_hi, r);
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      my_lo = min(my_lo, __shfl_xor_sync(kFull, my_lo, d));
      my_hi = max(my_hi, __shfl_xor_sync(kFull, my_hi, d));
    }
    if (lane == 0) {
      atomicMin(&lo, my_lo);
      atomicMax(&hi, my_hi);
    }
    __syncthreads();
    if (threadIdx.x == 0 && hi >= 0) {
      mark[lo] = mark[hi] = 1;
      lo = W;
      hi = -1;
    }
    __syncthreads();
  }
  float* out_block = out + static_cast<int64_t>(b) * W * F;
  for (int r = warp; r < W; r += kRowWarps) {
    if (cnt[r] == 0 || cnt[r] > kPiece || mark[r]) {
      float* o = out_block + static_cast<int64_t>(r) * F;
      for (int c = lane; c < F; c += 32) o[c] = 0.f;
    }
  }
}

// A row-grouped weighted sum's layout and output: edge_src, local_row
// (num_chunks, C) int32; chunk_block (num_chunks,) and block_start
// (num_blocks + 1,) int32; out (num_blocks * W, F) f32.
struct RowsArgs {
  const int32_t* edge_src;
  const int32_t* local_row;
  const int32_t* chunk_block;
  const int32_t* block_start;
  int num_chunks, num_blocks, C, W, F;
  float* out;
};

// Zeroes what rows_kernel will add to (one pass per chunk: the split rows
// and the rows no lane reaches, zero_split_rows_kernel; chunks wider than
// kMaxStage lanes, staged in passes: all of out, a memset), then launches
// rows_kernel over the chunks.
template <typename T, int kVec, typename Lanes>
cudaError_t launch_rows(const void* x, const RowsArgs& a, const Lanes& lanes,
                        cudaStream_t stream) {
  const int stage = std::min(a.C, kMaxStage);
  const bool direct = stage == a.C;
  cudaError_t err;
  if (direct) {
    const size_t zsmem = 2 * static_cast<size_t>(a.W) * sizeof(int);
    err = allow_smem(zero_split_rows_kernel, zsmem);
    if (err != cudaSuccess) return err;
    zero_split_rows_kernel<<<a.num_blocks, kRowThreads, zsmem, stream>>>(
        a.local_row, a.block_start, a.C, a.W, a.F, a.out);
    err = cudaGetLastError();
  } else {
    err = cudaMemsetAsync(
        a.out, 0, static_cast<size_t>(a.num_blocks) * a.W * a.F * sizeof(float),
        stream);
  }
  if (err != cudaSuccess || a.num_chunks == 0) return err;
  const size_t smem = stage_smem_bytes(stage, a.W, Lanes::kAux ? 2 : 1);
  auto kernel = rows_kernel<T, kVec, Lanes>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.num_chunks, kRowThreads, smem, stream>>>(
      static_cast<const T*>(x), a.edge_src, a.local_row, a.chunk_block, a.C,
      a.W, a.F, stage, direct ? 1 : 0, a.out, lanes);
  return cudaGetLastError();
}

// launch_rows with the widest load that divides F, D and the address of x
// (f32 rows, or bf16 when x_is_bf16), so that a vector never straddles two
// of x's D-column heads (B8; D = F elsewhere).
template <typename Lanes>
cudaError_t launch_rows_vec(const void* x, bool x_is_bf16, int D,
                            const RowsArgs& a, const Lanes& lanes,
                            cudaStream_t s) {
  int v = vec_elems(x, a.F, x_is_bf16 ? 2 : 4);
  while (D % v) v /= 2;
  if (x_is_bf16) {
    switch (v) {
      case 8: return launch_rows<__nv_bfloat16, 8>(x, a, lanes, s);
      case 4: return launch_rows<__nv_bfloat16, 4>(x, a, lanes, s);
      case 2: return launch_rows<__nv_bfloat16, 2>(x, a, lanes, s);
      default: return launch_rows<__nv_bfloat16, 1>(x, a, lanes, s);
    }
  }
  switch (v) {
    case 4: return launch_rows<float, 4>(x, a, lanes, s);
    case 2: return launch_rows<float, 2>(x, a, lanes, s);
    default: return launch_rows<float, 1>(x, a, lanes, s);
  }
}

}  // namespace blocked
