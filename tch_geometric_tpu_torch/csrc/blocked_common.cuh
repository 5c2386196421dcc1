// Device and host helpers shared by the blocked-layout kernels
// (spmm_blocked.cu: B1, B2, B11; attend_blocked.cu: B4, B5, B6, B10;
// gat_blocked.cu: B3, B7, B8, B9).
//
// The blocked layout: row block b owns W destination rows and the chunks
// [block_start[b], block_start[b+1]) of C lanes each; a lane carries its
// source row (edge_src) and its row within the block (local_row), pad lanes
// local_row == W and edge_src == 0.  The row-grouped kernels (all but B6)
// stage a chunk in shared memory and counting-sort its live lanes by row
// (stage_pass, or stage_sort after a kernel's own read of the chunk): each
// row's lanes become one run, cut into pieces of at most kPiece lanes that
// one warp takes.  The weighted sums among them (B1, B2, B8, B10's last
// step, B11) are one kernel, rows_kernel, instantiated per source file with
// a Lanes policy that stages each lane's weight data and gives add_piece
// each piece's weights; add_piece reads each lane's source row whole with
// Vec loads (f32, bf16 or int8 elements).  The softmax-weighted ones (B4;
// B3 and B9 in gat_blocked.cu) store owned rows and leave each split
// piece's partial sums in a slot: count_split_pieces sizes the slots,
// flash_merge_kernel combines them.  B7 (gat_blocked.cu) reduces each
// piece's (max, sum) with one thread and takes the rows that span chunks
// from a pre-pass.
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

// Float max in shared memory: integer order matches float order for
// non-negative floats (as int) and reverses it for negative ones (as
// unsigned); -0.0 goes to the second branch.
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

// A lane's softmax weight from e = exp(s - m) and its row's final stats
// (0 where the row max is not finite or the sum is not positive), and from
// its score s.
__device__ __forceinline__ float weight_of(float e, float m, float z) {
  return isfinite(m) && z > 0.f ? e / fmaxf(z, 1e-38f) : 0.f;
}
__device__ __forceinline__ float softmax_weight(float s, float m, float z) {
  return weight_of(expf(s - m), m, z);
}

__device__ __forceinline__ float leaky_relu(float s, float slope) {
  return s > 0.f ? s : slope * s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// ---- row-grouped chunks (B1-B5, B7-B11) ----------------------------------

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
// int8 rows (B11): at most kAcc elements a load, so 8 bytes.  Packed in
// 32- or 16-bit words (a char4 or char2 load would take a register a byte).
template <> struct Vec<int8_t, 8> { using Raw = int2; };
template <> struct Vec<int8_t, 4> { using Raw = int; };
template <> struct Vec<int8_t, 2> { using Raw = short; };
template <> struct Vec<int8_t, 1> { using Raw = signed char; };

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
// int8 -> f32 is exact; byte k of a word is element k (little-endian)
__device__ __forceinline__ void unpack_i8x4(int w, float* f) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    f[k] = static_cast<int8_t>(static_cast<unsigned>(w) >> (8 * k));
}
__device__ __forceinline__ void unpack(int2 v, float* f) {
  unpack_i8x4(v.x, f);
  unpack_i8x4(v.y, f + 4);
}
__device__ __forceinline__ void unpack(int v, float* f) { unpack_i8x4(v, f); }
__device__ __forceinline__ void unpack(short v, float* f) {
  f[0] = static_cast<int8_t>(v);
  f[1] = static_cast<int8_t>(static_cast<unsigned short>(v) >> 8);
}
__device__ __forceinline__ void unpack(signed char v, float* f) { f[0] = v; }

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

__host__ __device__ inline size_t align16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// Shared memory of a row-grouped kernel that stages `stage` lanes a pass:
// the pieces, the scan, the row cursors, the staged rows, and `arrays`
// more int or float arrays of one entry a lane.
__host__ __device__ inline int max_pieces(int stage, int W) {
  return stage / kPiece + W + 1;
}
__host__ __device__ inline size_t stage_smem_bytes(int stage, int W,
                                                    int arrays) {
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

// The second half of stage_pass, after row_s[0..n) holds the pass's local
// rows and scan[r].x each row's live-lane count (with a barrier since):
// scans, cuts each row's run into pieces (own as Piece says, only when
// `whole`: the pass is the whole chunk), and calls place(i, pos) for each
// live lane i with its position pos in the sorted order, pad(i) for each
// pad lane.  The order of a row's lanes follows the shared atomics on its
// cursor, so it can change from run to run.  Called by the whole block;
// returns the number of pieces, after a barrier.
template <typename Place, typename Pad>
__device__ __forceinline__ int stage_sort(int n, int W, bool whole,
                                          const Stage& st, Place place,
                                          Pad pad) {
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

// Stages lanes [e0, e0 + n) of a chunk: reads local_row once into row_s,
// counts the live lanes of each row, then stage_sort (place(i, pos) and
// pad(i) as it says; pad(i) by the thread that read row_s[i]).
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
  return stage_sort(n, W, whole, st, place, pad);
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

// ---- the row-grouped weighted sum (B1, B2, B8, B10, B11) -----------------
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

// Where add_piece puts a piece's f32 sums: sink.store<kVec>(col, v) takes
// the kVec sums of columns col .. col+kVec.  RowSink: into the output row,
// stored when the piece owns the row, else added by vector atomics.
struct RowSink {
  float* out_row;
  bool add;
  template <int kVec>
  __device__ void store(int col, const float* v) const {
    put<kVec>(out_row + col, v, add);
  }
};

// One warp adds the rows x[src_s[pc.start + j]], j < pc.len, of a piece,
// each column weighted as wf says and, when kRound, each term rounded to T
// (round_to<T>(w * x): the product rounded on its own, never fused into the
// add), and hands the f32 sums to sink.  Thread `lane` holds columns
// c0 + (k*32 + lane)*kVec .. +kVec of each 32*kAcc-column slab,
// k < kAcc / kVec, so each row load of the warp is contiguous.
template <typename T, int kVec, bool kRound, typename WeightFn,
          typename Sink>
__device__ __forceinline__ void add_piece(const T* __restrict__ x, int F,
                                          const int* src_s, Piece pc,
                                          int lane, WeightFn& wf,
                                          const Sink& sink) {
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
      if (has[k]) sink.template store<kVec>(col[k], acc + k * kVec);
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

// A float32 weight a lane, weight[e] (B2; B8 with one head, kRound).  Three
// CUDA blocks an SM (80 registers): on an NVIDIA H100 80GB HBM3 at 700 W
// (scripts/time_csrc_variants.py) B8 with one head took 11.7 ms at F=256
// bf16 and 7.3 at F=47 f32, against 14.6 and 14.3 with four; B2 on the hot
// half 2.13 ms at F=256 bf16 against 3.90 with four, and 1.79 against
// 1.80 at F=100.  B1 keeps four: at three it read 11.1 against 10.7 ms at
// F=256 bf16 and 5.7 against 5.1 at F=100.
template <bool kRoundTerms>
struct StagedWeight {
  static constexpr bool kAux = true, kRound = kRoundTerms;
  static constexpr int kMinBlocks = 3;
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
      add_piece<T, kVec, Lanes::kRound>(
          x, F, src_s, pc, lane, wf,
          RowSink{out + (row0 + pc.row) * F, !pc.own});
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

// ---- split rows of the softmax-weighted kernels (B3, B4, B9) -------------
//
// Their main kernels store an owned row (Piece::own) as acc / z and leave
// every other piece's partial sums in a slot: its row, per head its
// reference max and sum z, and its F = H*D f32 sums acc.  Chunk t's split
// pieces take slots [slot_off[t], slot_off[t+1]): count_split_pieces counts
// them in a kernel before, the wrapper scans the counts and reads the total
// to size the slots, and flash_merge_kernel combines them.

// The split pieces of the chunk at chunk0 — every piece that a row-grouped
// kernel staging `stage` lanes a pass will not own — and the chunk's lowest
// and highest live row (W and -1 when it has none), returned to every
// thread.  cnt: W ints of shared memory.  Called by the whole block.
struct SplitCount {
  int pieces, lo, hi;
};
__device__ inline SplitCount count_split_pieces(
    const int32_t* __restrict__ local_row, int64_t chunk0, int C, int W,
    int stage, int* cnt) {
  __shared__ int lo, hi, total, chunk_lo, chunk_hi;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    total = 0;
    chunk_lo = W;
    chunk_hi = -1;
  }
  for (int s0 = 0; s0 < C; s0 += stage) {
    const int n = min(stage, C - s0);
    const int64_t e0 = chunk0 + s0;
    for (int r = threadIdx.x; r < W; r += kRowThreads) cnt[r] = 0;
    if (threadIdx.x == 0) {
      lo = W;
      hi = -1;
    }
    __syncthreads();
    int my_lo = W, my_hi = -1;
    for (int i = threadIdx.x; i < n; i += kRowThreads) {
      const int r = local_row[e0 + i];
      if (r < W) {
        atomicAdd(&cnt[r], 1);
        my_lo = min(my_lo, r);
        my_hi = max(my_hi, r);
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      my_lo = min(my_lo, __shfl_xor_sync(kFull, my_lo, o));
      my_hi = max(my_hi, __shfl_xor_sync(kFull, my_hi, o));
    }
    if (lane == 0) {
      atomicMin(&lo, my_lo);
      atomicMax(&hi, my_hi);
    }
    __syncthreads();
    // Piece::own: whole chunk in one pass, at most kPiece lanes, neither
    // first nor last
    const bool whole = n == C;
    int mine = 0;
    for (int r = threadIdx.x; r < W; r += kRowThreads) {
      const int c = cnt[r];
      if (c > 0 && (!whole || c > kPiece || r == lo || r == hi))
        mine += (c + kPiece - 1) / kPiece;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) mine += __shfl_xor_sync(kFull, mine, o);
    if (lane == 0) atomicAdd(&total, mine);
    if (threadIdx.x == 0) {
      chunk_lo = min(chunk_lo, lo);
      chunk_hi = max(chunk_hi, hi);
    }
    __syncthreads();                     // the next pass resets cnt
  }
  return SplitCount{total, chunk_lo, chunk_hi};
}

// After the main kernel, one CUDA block per row block b, for H heads of D
// columns (row_m, row_z (B*W, H): an owned row's reference and sum, a
// row no lane reaches (-inf, 0); slot_m, slot_z (S, H); slot_acc and out
// (., H*D)).  Per row and head the reference `ref` is the row's largest
// slot max (kRowStats) or the row block's largest max M_block (the chunk-max
// recurrence, where a lane weighs exp(s - M_chunk) and chunks combine by
// exp(M_chunk - M_block)).  Merges each split row's slots into it, Z =
// sum z_p exp(m_p - ref) and out = sum acc_p exp(m_p - ref) / max(Z, 1e-20)
// where Z > 0 (added by vector atomics onto the row zeroed here); without
// kRowStats rescales an owned row whose z exp(m - M_block) is below 1e-20
// as the division by max(z, 1e-20) would, or zeroes it where that is 0;
// zeroes the rows no lane reaches.  With kRowStats a split row's (ref, Z)
// go to row_m, row_z, and raw (when not null, the shape of out) gets the
// undivided sums of the split rows and zeroes where out is zeroed (an owned
// row's raw sums are the main kernel's).  kOut floats per access; kOut
// divides D.
//
// Self (chunk-max stats only): B3's self-loop mode, in which each row i
// below Self::rows takes one more term, its own row x[i] under the logit
// s_i = self.logits(i, ...).  The s_i join M_block, and per row and head
// the term e_i = exp(s_i - M_block) joins the sum: Z = z exp(m - M_block)
// + e_i (an owned row), the slots' sum + e_i (a split row) or e_i (a row no
// lane reaches), and out = (acc exp(m - M_block) + e_i x[i]) / max(Z,
// 1e-20), the term f32 e_i times the compute-dtype row.  NoSelfLoops
// leaves the kernel as it was.
struct NoSelfLoops {
  static constexpr bool kOn = false;
  static constexpr int kHeads = 1;
  int64_t rows = 0;
  __device__ void logits(int64_t, int, float (&)[1]) const {}
  __device__ float value(int64_t, int) const { return 0.f; }
};

template <int kOut, bool kRowStats, typename Self = NoSelfLoops>
__global__ void __launch_bounds__(kRowThreads)
flash_merge_kernel(const int32_t* __restrict__ block_start,
                   const int32_t* __restrict__ slot_off, int W, int H, int D,
                   const int32_t* __restrict__ slot_row,
                   const float* __restrict__ slot_m,
                   const float* __restrict__ slot_z,
                   const float* __restrict__ slot_acc,
                   float* __restrict__ row_m, float* __restrict__ row_z,
                   float* __restrict__ out, float* __restrict__ raw,
                   Self self) {
  static_assert(!(kRowStats && Self::kOn), "self loops: chunk-max stats");
  extern __shared__ float mz[];
  float* mr = mz;                        // W x H maxima over the slots
  float* zr = mr + W * H;                // W x H merged sums
  float* mb = zr + W * H;                // H: M_block (chunk-max stats)
  int* ns = reinterpret_cast<int*>(mb + H);   // W slot counts
  // Self: W x H self-loop logits, then their weights e_i
  float* es = reinterpret_cast<float*>(ns + W);
  __shared__ float red[kRowWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x, F = H * D;
  const int s0 = slot_off[block_start[b]], s1 = slot_off[block_start[b + 1]];
  const int64_t row0 = static_cast<int64_t>(b) * W;
  for (int i = threadIdx.x; i < W * H; i += kRowThreads) {
    mr[i] = -CUDART_INF_F;
    zr[i] = 0.f;
  }
  for (int r = threadIdx.x; r < W; r += kRowThreads) ns[r] = 0;
  __syncthreads();
  for (int s = s0 + threadIdx.x; s < s1; s += kRowThreads) {
    const int r = slot_row[s];
    for (int h = 0; h < H; ++h)
      atomic_max_float(mr + r * H + h, slot_m[static_cast<int64_t>(s) * H + h]);
    atomicAdd(ns + r, 1);
  }
  if constexpr (Self::kOn) {
    for (int r = threadIdx.x; r < W; r += kRowThreads) {
      const int64_t row = row0 + r;
      for (int h0 = 0; h0 < H; h0 += Self::kHeads) {
        float s[Self::kHeads];
        if (row < self.rows) self.logits(row, h0, s);
#pragma unroll
        for (int q = 0; q < Self::kHeads; ++q)
          if (h0 + q < H)
            es[r * H + h0 + q] = row < self.rows ? s[q] : -CUDART_INF_F;
      }
    }
  }
  __syncthreads();
  if (!kRowStats) {
    for (int h = 0; h < H; ++h) {
      float v = -CUDART_INF_F;
      for (int r = threadIdx.x; r < W; r += kRowThreads) {
        v = fmaxf(v, fmaxf(mr[r * H + h], row_m[(row0 + r) * H + h]));
        if constexpr (Self::kOn) v = fmaxf(v, es[r * H + h]);
      }
      v = warp_max(v);
      if (lane == 0) red[warp] = v;
      __syncthreads();
      if (threadIdx.x == 0) {
        v = -CUDART_INF_F;
#pragma unroll
        for (int w = 0; w < kRowWarps; ++w) v = fmaxf(v, red[w]);
        // a block of pad chunks has no score; its rows are zeroed below
        mb[h] = isfinite(v) ? v : 0.f;
      }
      __syncthreads();
    }
  }
  if constexpr (Self::kOn) {
    // exp(-inf) = 0 past the rows with a self loop
    for (int i = threadIdx.x; i < W * H; i += kRowThreads) {
      const float e = expf(es[i] - mb[i % H]);
      es[i] = e;
      zr[i] = e;                         // the slots' sums add to it
    }
    __syncthreads();
  }
  auto ref = [&](int r, int h) { return kRowStats ? mr[r * H + h] : mb[h]; };
  for (int s = s0 + threadIdx.x; s < s1; s += kRowThreads) {
    const int r = slot_row[s];
    for (int h = 0; h < H; ++h) {
      const int64_t i = static_cast<int64_t>(s) * H + h;
      atomicAdd(zr + r * H + h, slot_z[i] * expf(slot_m[i] - ref(r, h)));
    }
  }
  __syncthreads();
  if constexpr (Self::kOn) {
    // an owned row's acc / z becomes (acc / z) zf / Z + e_i x[i] / Z; a
    // split row starts from e_i x[i] / Z (its slots are added below).  The
    // two weights of each row and head first (ca over the spent slot
    // maxima, cb over e_i), then one pass over the block's rows, all
    // threads streaming kOut columns each
    float* ca = mr;
    for (int i = threadIdx.x; i < W * H; i += kRowThreads) {
      const int r = i / H;
      const int64_t ri = row0 * H + i;
      const float zo = row_z[ri];
      const float zf = ns[r] == 0 && zo > 0.f
                           ? zo * expf(row_m[ri] - mb[i - r * H])
                           : 0.f;
      const float zt = ns[r] > 0 ? zr[i] : zf + es[i];
      const float inv = zt > 0.f ? 1.f / fmaxf(zt, 1e-20f) : 0.f;
      ca[i] = zf * inv;
      es[i] *= inv;
    }
    __syncthreads();
    const int per_row = F / kOut;
    for (int k = threadIdx.x; k < W * per_row; k += kRowThreads) {
      const int r = k / per_row, c = (k - r * per_row) * kOut;
      const int i = r * H + c / D;
      const float a = ca[i], w = es[i];
      float* o = out + (row0 + r) * F + c;
      float v[kOut];
      if constexpr (kOut == 4) {
        const float4 t = *reinterpret_cast<const float4*>(o);
        v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
      } else if constexpr (kOut == 2) {
        const float2 t = *reinterpret_cast<const float2*>(o);
        v[0] = t.x; v[1] = t.y;
      } else {
        v[0] = *o;
      }
#pragma unroll
      for (int e = 0; e < kOut; ++e) {
        v[e] = a > 0.f ? v[e] * a : 0.f;
        if (w > 0.f) v[e] += w * self.value(row0 + r, c + e);
      }
      put<kOut>(o, v, false);
    }
  }
  for (int r = warp; r < W && !Self::kOn; r += kRowWarps) {
    const int64_t row = row0 + r;
    for (int h = 0; h < H; ++h) {
      const float zo = row_z[row * H + h];
      float scale = 1.f;                 // of an owned row, stored acc / z
      if (ns[r] > 0 || !(zo > 0.f)) {
        scale = 0.f;                     // split (added below) or no lanes
      } else if (!kRowStats) {
        const float zf = zo * expf(row_m[row * H + h] - mb[h]);
        scale = !(zf > 0.f) ? 0.f : zf < 1e-20f ? zf / 1e-20f : 1.f;
      }
      if (scale != 1.f) {                // warp-uniform
        float* o = out + row * F + h * D;
        for (int c = lane; c < D; c += 32)
          o[c] = scale == 0.f ? 0.f : o[c] * scale;
        if (raw != nullptr && scale == 0.f)
          for (int c = lane; c < D; c += 32) raw[row * F + h * D + c] = 0.f;
      }
      if (kRowStats && ns[r] > 0 && lane == 0) {
        row_m[row * H + h] = mr[r * H + h];
        row_z[row * H + h] = zr[r * H + h];
      }
    }
  }
  __syncthreads();                       // the zeroed rows, before the adds
  for (int s = s0 + warp; s < s1; s += kRowWarps) {
    const int r = slot_row[s];
    const float* a = slot_acc + static_cast<int64_t>(s) * F;
    const int64_t o = (row0 + r) * F;
    for (int c = lane * kOut; c < F; c += 32 * kOut) {
      const int h = c / D;
      const float zs = zr[r * H + h];
      const float f = expf(slot_m[static_cast<int64_t>(s) * H + h] - ref(r, h));
      float v[kOut];
      if (zs > 0.f) {                    // else the row's head stays 0
        const float coef = f / fmaxf(zs, 1e-20f);
#pragma unroll
        for (int e = 0; e < kOut; ++e) v[e] = a[c + e] * coef;
        put<kOut>(out + o + c, v, true);
      }
      if (raw != nullptr) {
#pragma unroll
        for (int e = 0; e < kOut; ++e) v[e] = a[c + e] * f;
        put<kOut>(raw + o + c, v, true);
      }
    }
  }
}

// The merge kernel of kOut floats an access (row stats, or chunk-max stats
// with or without self loops).
template <int kOut, typename Self>
auto merge_kernel(bool row_stats) {
  if constexpr (Self::kOn) {
    return &flash_merge_kernel<kOut, false, Self>;
  } else {
    return row_stats ? &flash_merge_kernel<kOut, true, Self>
                     : &flash_merge_kernel<kOut, false, Self>;
  }
}

// flash_merge_kernel with the widest access (4, 2 or 1 floats) that divides
// D, over num_blocks row blocks.
template <typename Self = NoSelfLoops>
inline cudaError_t launch_merge(bool row_stats, const int32_t* block_start,
                                const int32_t* slot_off, int num_blocks,
                                int W, int H, int D, const int32_t* slot_row,
                                const float* slot_m, const float* slot_z,
                                const float* slot_acc, float* row_m,
                                float* row_z, float* out, float* raw,
                                cudaStream_t stream, Self self = Self()) {
  const size_t smem =
      (2 * static_cast<size_t>(W) * H + H +
       (Self::kOn ? static_cast<size_t>(W) * H : 0)) * sizeof(float) +
      static_cast<size_t>(W) * sizeof(int);
  auto merge = D % 4 == 0 ? merge_kernel<4, Self>(row_stats)
               : D % 2 == 0 ? merge_kernel<2, Self>(row_stats)
                            : merge_kernel<1, Self>(row_stats);
  cudaError_t err = allow_smem(merge, smem);
  if (err != cudaSuccess) return err;
  merge<<<num_blocks, kRowThreads, smem, stream>>>(
      block_start, slot_off, W, H, D, slot_row, slot_m, slot_z, slot_acc,
      row_m, row_z, out, raw, self);
  return cudaGetLastError();
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
