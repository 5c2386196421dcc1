// Multi-head blocked GAT for Hopper (sm_90a): kernels B3, B7, B8 and B9.
//
// Replaces, in tch_geometric_tpu/ops/attention_blocked.py:
//   B3  _gat_packed_kernel, _gat_packed_vec_kernel and _gat_packed_core
//       (gat_attend_blocked_packed): multi-head GATv1, for every dst row i
//       and head h over the valid lanes e of i's row block,
//           s_e = leaky_relu(alpha_src[src(e), h] + alpha_dst[i, h]),
//           out[i, h, :] = sum_e exp(s_e) h[src(e), h, :] / sum_e exp(s_e),
//       rows with no edges 0; alpha_src a given (N, H) table or the GATv1
//       projection sum_d h[n, h, d] * a[h, d] (the mode GATConv uses);
//   B7  _mz_mh_kernel + _att_mh_kernel (edge_softmax_blocked_multihead): the
//       per-dst-row softmax of (H, T, C) f32 scores for H heads, 0 on pad
//       lanes; a second entry computes the scores, the GAT logits
//       leaky_relu(alpha_src[src, h] + alpha_dst[row, h]), from the (N, H)
//       tables (the XLA fusion before the TPU kernel);
//   B8  _spmm_mw_kernel (spmm_blocked_multiweighted_pallas): over (N, H*D)
//       head-concatenated rows x and (H, T, C) f32 weights w,
//           out[i, c] = sum_e bf16(x[src(e), c] * w[c / D, e])
//       with f32 sums (each term rounded to the compute dtype);
//   B9  _gat_flash_kernel (gat_attend_blocked_flash): B3's function in one
//       traversal with a per-row running max.
// B7's second entry and B8 make gat_attend_blocked (the composed route); B9
// is gat_attend_blocked_flash.  B3, the composed route and B9 compute one
// function with other rounding points.
//
// What the TPU kernels did and what changes here.
// - B7: the TPU carries a (W, H) online (max, expsum) tile across a block's
//   chunks and sweeps them twice.  Here, on B1's row-grouped chunks, two
//   kernels, one CUDA block per chunk each.  A pre-pass finds the chunk's
//   lowest and highest live row, the only rows that can have lanes in
//   another chunk, and takes their (max, sum) over this chunk by an online
//   update per lane, reading only their scores.  The main kernel copies the
//   chunk's local_row and H scores into shared memory with cp.async (the
//   whole pass in flight at once, the scores in lane order) and
//   counting-sorts the live lanes by row (stage_sort); a thread reduces a
//   piece of at most 32 lanes of one row to its (max, sum) per head, in two
//   sweeps over the staged scores, and one thread per row and head merges
//   the row's pieces in order.  The lowest and highest row take the merge of
//   their run's pre-pass partials, in chunk order from the run's first
//   chunk, so that every chunk of a run sees the same (m, z).  Each weight
//   exp(s - m) * (1 / z) is written in lane order, so the (H, T, C) stores
//   are coalesced.  A chunk wider than one pass of shared memory keeps
//   per-row stats across its passes and reads its scores a second time to
//   write the weights (its first read skips the lowest and highest row), so
//   every score is read from device memory at most twice.  No float atomic
//   is left (the first design made one in shared memory per lane and head
//   in each of two sweeps); the function is the plain version's up to the
//   order of the sums in z and the reciprocal of z.  The second entry
//   computes each lane's H logits in both kernels from the tables
//   (GatLogitLanes: one float4 load from each at H=4, the row clamped to
//   alpha_dst's last row, the add before the slope, as
//   gat_edge_logits_blocked does: bit for bit its f32 logits), so the
//   (H, T, C) logits never reach device memory.
// - B8: the TPU gathers a (T, C, H*D) tensor and expands the (C, H) weights
//   over each head's columns with a one-hot matmul.  Here B8 is B1's
//   row-grouped weighted sum (blocked::rows_kernel, blocked_common.cuh;
//   spmm_blocked.cu describes it): one CUDA block per chunk counting-sorts
//   its live lanes by row, a warp takes a piece of at most 32 lanes of one
//   row and reads each source row whole with the widest vector load that
//   divides F, D and x's address (so that no vector straddles two heads:
//   D=36 in bf16 takes 4-element loads), load_depth rows in flight, f32
//   sums in registers; an owned row is stored, a split row added by vector
//   atomics onto a row that a zero pass cleared (chunks wider than
//   kMaxStage lanes: onto a memset output).  With one head (the attend
//   routes, GAT's last layer) each lane's weight is staged in shared memory
//   and shuffled to the warp, as B2's.  With H > 1 heads each lane's
//   position in its chunk is staged instead (H weights a lane would take
//   53 KB more a CUDA block at C=3,328, H=4), and each thread reads the
//   weight of its vectors' heads for every row in flight from the (H, T, C)
//   weights (HeadWeights): a warp touches at most H addresses a row, which
//   L1 serves.  No shared-memory float atomic is left.
// - B3 and B9: the TPU gathers a (T, C, H*D) tensor (B9: H more columns,
//   alpha_src in the compute dtype) and carries a block's (W, H*D) f32
//   accumulator across its chunks.  Here the two are one kernel template
//   on B1's row-grouped chunks, all H heads in one CUDA block per chunk,
//   in three steps (at most four kernels, two C calls):
//   1. A pre-pass, one CUDA block per chunk, that reads no row: it counts
//      the chunk's split pieces (blocked::count_split_pieces) and takes the
//      references the plain versions round against.  A GAT logit needs
//      only alpha_src[src, h] and alpha_dst[row, h] (16 bytes a lane at
//      H=4), so the exact reference is known before any row is read.  B3
//      shifts each chunk's logits by the chunk's max M_chunk over its valid
//      lanes (the TPU takes it over the pad lanes too; the shift cancels in
//      out / z) and combines chunks by exp(M_chunk - M_block): the pre-pass
//      writes M_chunk.  B9 weighs a lane by exp(s - m), m the row's running
//      max after the lane's chunk; only a chunk's lowest and highest row can
//      span chunks, so the pre-pass writes their maxima, and the main kernel
//      takes the prefix max over the lowest row's earlier chunks.  For B3's
//      vec mode a kernel before it projects alpha_src once per node
//      (reading h once, N rows, not 62M lanes): the same values as the
//      TPU's per-lane projection on rows it had gathered.
//   2. The main kernel stages the chunk (stage_pass); a warp takes a piece
//      of at most 32 lanes of one row.  Per head each thread computes its
//      lane's logit and e = exp(s - ref) (B9: for a row of several pieces
//      the row's max in the chunk is taken first by one warp max and shared
//      atomic max per piece and head), writes round_to<T>(e) into its
//      warp's 32 x H tile in shared memory and sums e into z by a warp
//      reduction (heads four at a time, their alpha loads issued
//      together; with one head the staging threads compute each lane's
//      logit).  Then add_piece reads each source row whole, all H*D
//      columns once, with the widest vector load that divides H*D, D and
//      the address (no vector straddles two heads), several rows in
//      flight, and adds each vector times its head's weight, read from the
//      tile (TileWeight), into f32 sums in registers.  Of the three ways to
//      get lane j's weight for a vector's head (a shared tile, a shuffle
//      from per-lane registers, L1 as B8 does) the tile takes one
//      conflict-free shared load a row and vector for any H.  Shuffles
//      need H known at compile time and all H of a row (then a select);
//      for H <= 4 they read 20.2 ms against the tile's 17.0 for B3 at H=4,
//      D=64 in bf16, 16.8 against 14.6 for B9, and the same within 1.5%
//      in f32 and at one head (NVIDIA H100 80GB HBM3, 700 W,
//      scripts/time_csrc_variants.py).  There is no weight array in device
//      memory to read through L1.
//   3. Owned and split rows as in B4: an owned row is stored as acc / z
//      with its (ref, z) per head in row_m, row_z; every other piece
//      writes a slot (row, per head ref and z, acc[H*D]); a merge kernel
//      (blocked::flash_merge_kernel, one CUDA block per row block) combines
//      the slots by exp(ref_p - ref_final), ref_final B9's row max over its
//      slots (the plain version's product of rescales, in exact
//      arithmetic) or B3's M_block, and rescales an owned B3 row by
//      z exp(M_chunk - M_block) under B4's chunk-max rule (0 on underflow,
//      the max(z, 1e-20) division below 1e-20).  B9's debug outputs come
//      out of the main kernel (owned rows) and the merge (split rows).
//   No shared-memory float atomic per lane and column is left, and each
//   chunk is traversed once for all heads.
// - Rounding: B8 rounds each term bf16(x * w), as the TPU kernel does (the
//   port's B2 multiplies in f32): the product is rounded on its own
//   (__fmul_rn, never fused into the add), then to the compute dtype.  B3
//   rounds bf16(x * bf16(e)) likewise, e against M_chunk; B9's term
//   bf16(e) * x is exact in f32, e against the running row max: the same
//   f32 arguments of exp as the plain versions, so bf16(e) matches them.
//   A table alpha_src (B3) and B9's alpha_src are rounded to the compute
//   dtype; every sum is f32.  No fast math: the z > 0 guards rely on IEEE
//   exp.  The counting sort orders a row's lanes by shared atomics and the
//   merge adds slots by global atomics, so the summation order changes from
//   run to run.
//
// Bound on an H100 (3.35 TB/s) at ogbn-products size (W=256, T=19,222,
// C=3,328, N=2,449,029, B*W=2,449,152), each input read once and the output
// written once: B7 at H=4 moves the scores, local_row, chunk_block and the
// weights, 2.30 GB (0.69 ms), or on the logit tables the two (N, H) tables,
// edge_src and local_row and the weights, 1.62 GB (0.48 ms); B8 at H*D=256 in bf16 moves x, the lane metadata, the
// weights and the f32 output, 5.30 GB (1.58 ms); B3 and B9 at H=4, D=64
// move h, the lane metadata, both alpha tables and the f32 output, 4.35 GB
// in bf16 and 5.61 GB in f32 (1.30 and 1.67 ms).  The operations are far
// below the f32 rate: all four are bound by bytes.  A gather cannot reach
// that for B3, B8 and B9: every live lane reads its source row, lanes x
// H*D x bytes in all; they read it whole and once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "blocked_common.cuh"

namespace {

using blocked::add_piece;
using blocked::allow_smem;
using blocked::atomic_max_float;
using blocked::count_split_pieces;
using blocked::kAcc;
using blocked::kFull;
using blocked::kMaxStage;
using blocked::kRowThreads;
using blocked::kRowWarps;
using blocked::Piece;
using blocked::put;
using blocked::round_to;
using blocked::SplitCount;
using blocked::Stage;
using blocked::stage_pass;
using blocked::warp_max;
using blocked::warp_sum;

constexpr int kMaxD = 128;               // B3, B9: columns per head

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float leaky_relu(float s, float slope) {
  return s > 0.f ? s : slope * s;
}

// ---- B8: per-head weighted SpMM on row-grouped chunks -------------------

// The weights of a piece's lanes per column: column c of lane e takes
// w[head(c) * TC + e], head(c) = c / D.  kVec divides D, so each of a
// thread's vectors lies in one head: its kNV head offsets are set per slab,
// and in the load phase it reads its kNV weights of each row in flight from
// device memory (a warp reads at most H addresses a row, which L1 serves).
template <int kDepth, int kNV>
struct HeadWeights {
  static constexpr bool kWeighted = true;
  const float* w;                        // the chunk's first lane, head 0
  int64_t TC;                            // lanes of all chunks
  int D, H;
  int my_pos;                            // lane `lane`'s position in the chunk
  int64_t hoff[kNV];                     // head offset of each vector
  float wv[kDepth][kNV];                 // the weights of the rows in flight
  __device__ void slab(const int (&col)[kNV]) {
#pragma unroll
    for (int k = 0; k < kNV; ++k)        // a column past F takes the last head
      hoff[k] = static_cast<int64_t>(min(col[k] / D, H - 1)) * TC;
  }
  __device__ void load(int u, int j, int len) {
    const int pos = __shfl_sync(kFull, my_pos, j & 31);
    if (j < len) {                       // warp-uniform
#pragma unroll
      for (int k = 0; k < kNV; ++k) wv[u][k] = __ldg(w + hoff[k] + pos);
    }
  }
  __device__ void get(int u, int, float (&out)[kNV]) {
#pragma unroll
    for (int k = 0; k < kNV; ++k) out[k] = wv[u][k];
  }
};

// B8's Lanes policy with H > 1 heads: each lane's position in its chunk is
// staged; terms are bf16(x * w).  Three CUDA blocks an SM (80 registers):
// the weights in flight take up to 32 more a thread.  On an NVIDIA H100
// 80GB HBM3 at 700 W (scripts/time_csrc_variants.py) B8 took 23.7 ms at
// H=4, D=64 in f32 and 12.6 in bf16; with four CUDA blocks 29.1 and 18.3;
// staging each piece's H x 32 weights in shared memory instead of these L1
// reads, four rows' weights a 16-byte load, 23.2 and 14.8.
struct HeadLanes {
  static constexpr bool kAux = true, kRound = true;
  static constexpr int kMinBlocks = 3;
  const float* weight;
  int64_t TC;
  int D, H;
  __device__ int aux(int64_t, int pos, int64_t) const { return pos; }
  template <int kDepth, int kNV>
  __device__ HeadWeights<kDepth, kNV> weights(const int* aux_s, Piece pc,
                                              int lane, int64_t chunk0) const {
    HeadWeights<kDepth, kNV> wf;
    wf.w = weight + chunk0;
    wf.TC = TC;
    wf.D = D;
    wf.H = H;
    wf.my_pos = lane < pc.len ? aux_s[pc.start + lane] : 0;
    return wf;
  }
};

// ---- B3 and B9: one kernel template, all heads of a chunk per CUDA block --

// alpha_src[n, h] = sum_d h[n, h, d] * round(a[h, d]), f32 sum; one warp
// per (node, head): B3's GATv1 projection, once per node.
template <typename T>
__global__ void __launch_bounds__(256)
gat_alpha_src_kernel(const T* __restrict__ x, const float* __restrict__ avec,
                     int64_t rows, int H, int D,
                     float* __restrict__ alpha_src) {
  const int64_t w =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= rows * H) return;             // whole warps leave together
  const int hd = static_cast<int>(w % H);
  const T* row = x + w * D;              // (n*H + hd) * D
  const float* a = avec + hd * D;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc += to_float(row[d]) * round_to<T>(a[d]);
  acc = warp_sum(acc);
  if (lane == 0) alpha_src[w] = acc;
}

// Heads are taken kHeads at a time: a lane's kHeads logits are loaded
// together, then used.
constexpr int kHeads = 4;

// A lane's logits, leaky_relu(alpha_src[src, h] + alpha_dst[row, h]):
// alpha_src rounded to the compute dtype T where round_alpha (B3's table
// and B9: it rides the TPU's row gather), alpha_dst 0 past ad_rows.  vec4:
// H % 4 == 0 and both tables 16-byte aligned, so kHeads of a row are one
// float4 load.
struct Logits {
  const float* alpha_src;
  const float* alpha_dst;
  int64_t ad_rows;
  int H;
  float slope;
  int round_alpha;
  int vec4;
  // heads h0 .. h0+kHeads of lane (src, row) into s (-inf past H)
  template <typename T>
  __device__ void at(int src, int64_t row, int h0, float (&s)[kHeads]) const {
    const float* a = alpha_src + static_cast<int64_t>(src) * H + h0;
    const float* d = alpha_dst + row * H + h0;
    const bool has_d = row < ad_rows;
    float av[kHeads], dv[kHeads];
    if (vec4) {
      const float4 a4 = __ldg(reinterpret_cast<const float4*>(a));
      const float4 d4 = has_d ? __ldg(reinterpret_cast<const float4*>(d))
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      av[0] = a4.x; av[1] = a4.y; av[2] = a4.z; av[3] = a4.w;
      dv[0] = d4.x; dv[1] = d4.y; dv[2] = d4.z; dv[3] = d4.w;
    } else {
#pragma unroll
      for (int q = 0; q < kHeads; ++q) {
        const bool ok = h0 + q < H;
        av[q] = ok ? __ldg(a + q) : 0.f;
        dv[q] = ok && has_d ? __ldg(d + q) : 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < kHeads; ++q) {
      const float x = round_alpha ? round_to<T>(av[q]) : av[q];
      s[q] = h0 + q < H ? leaky_relu(x + dv[q], slope) : -CUDART_INF_F;
    }
  }
};

// ---- B7: per-(row, head) softmax on row-grouped chunks -----------------

// Softmax statistics (max, sum of exp(s - max)) of a set of lanes as a
// float2.  mz_merge combines two sets (a max of -inf: no finite lane, sum
// 0), symmetric in its arguments; mz_add adds one lane, rescaling the sum
// when the max moves (a lane of -inf adds nothing).
__device__ __forceinline__ float2 mz_merge(float2 a, float2 b) {
  if (a.x == -CUDART_INF_F) return b;
  if (b.x == -CUDART_INF_F) return a;
  const float m = fmaxf(a.x, b.x);
  return make_float2(m, a.y * expf(a.x - m) + b.y * expf(b.x - m));
}
__device__ __forceinline__ void mz_add(float2& mz, float s) {
  if (s > mz.x) {
    mz.y = mz.y * expf(mz.x - s) + 1.f;
    mz.x = s;
  } else if (s > -CUDART_INF_F) {
    mz.y += expf(s - mz.x);
  }
}

// Where B7 takes a lane's scores, heads h0 .. h0+kHeads at a time (-inf
// past H): at(e, src, row, h0, s) for lane e of source src and destination
// row `row` of the output.  kCopy: the main kernel copies the scores of a
// pass into shared memory as they are (cp.async from `scores`); else it
// copies edge_src and computes each live lane's scores with at().
// ScoreLanes, entry (a): the (H, T, C) f32 scores.
struct ScoreLanes {
  static constexpr bool kCopy = true;
  const float* scores;
  int64_t TC;
  int H;
  __device__ void at(int64_t e, int, int64_t, int h0,
                     float (&s)[kHeads]) const {
#pragma unroll
    for (int q = 0; q < kHeads; ++q)
      s[q] = h0 + q < H ? __ldg(scores + (h0 + q) * TC + e) : -CUDART_INF_F;
  }
};

// GatLogitLanes, entry (b): the GAT logits of gat_edge_logits_blocked,
// leaky_relu(alpha_src[src, h] + alpha_dst[row, h], slope), the add first,
// row clamped to alpha_dst's last row: bit for bit the plain version's f32
// logits.  vec4: kHeads of a row are one float4 load (H % 4 == 0, both
// tables 16-byte aligned).
struct GatLogitLanes {
  static constexpr bool kCopy = false;
  const int32_t* edge_src;
  const float* alpha_src;
  const float* alpha_dst;
  int64_t ad_last;
  int H;
  float slope;
  int vec4;
  __device__ void at(int64_t, int src, int64_t row, int h0,
                     float (&s)[kHeads]) const {
    const float* a = alpha_src + static_cast<int64_t>(src) * H + h0;
    const float* d = alpha_dst + (row < ad_last ? row : ad_last) * H + h0;
    float av[kHeads], dv[kHeads];
    if (vec4) {
      const float4 a4 = __ldg(reinterpret_cast<const float4*>(a));
      const float4 d4 = __ldg(reinterpret_cast<const float4*>(d));
      av[0] = a4.x; av[1] = a4.y; av[2] = a4.z; av[3] = a4.w;
      dv[0] = d4.x; dv[1] = d4.y; dv[2] = d4.z; dv[3] = d4.w;
    } else {
#pragma unroll
      for (int q = 0; q < kHeads; ++q) {
        const bool ok = h0 + q < H;
        av[q] = ok ? __ldg(a + q) : 0.f;
        dv[q] = ok ? __ldg(d + q) : 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < kHeads; ++q)
      s[q] = h0 + q < H ? leaky_relu(av[q] + dv[q], slope) : -CUDART_INF_F;
  }
};

// A lane's source for at(): none for ScoreLanes.
__device__ __forceinline__ int lane_src(const ScoreLanes&, int64_t) {
  return 0;
}
__device__ __forceinline__ int lane_src(const GatLogitLanes& l, int64_t e) {
  return __ldg(l.edge_src + e);
}

// Asynchronous 4-byte copies from device to shared memory (cp.async): each
// thread issues its copies and goes on; cp_async_wait waits for its own,
// and a barrier after it publishes every thread's.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

constexpr int kSoftmaxBatch = 4;         // logits in: lanes a thread takes at once

// B7 step 1, one CUDA block per chunk: its lowest and highest live row,
// the only rows that can have lanes in another chunk, into chunk_rows[t]
// ((W, -1) for a chunk of pads), and each one's statistics over this
// chunk's lanes, per head, into chunk_mz (T, 2, H): an online update per
// lane, reading only those rows' scores.  The chunk's first `cap` local
// rows are copied into shared memory (cp.async) and read from there.
template <typename Lanes>
__global__ void __launch_bounds__(kRowThreads)
softmax_prepass_kernel(Lanes lanes, const int32_t* __restrict__ local_row,
                       const int32_t* __restrict__ chunk_block, int C, int W,
                       int H, int cap, int2* __restrict__ chunk_rows,
                       float2* __restrict__ chunk_mz) {
  extern __shared__ int lr_s[];          // cap local rows
  __shared__ int lo, hi;
  __shared__ float2 red[kRowWarps][2][kHeads];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x;
  const int64_t chunk0 = static_cast<int64_t>(t) * C;
  const int64_t row0 = static_cast<int64_t>(chunk_block[t]) * W;
  for (int i = threadIdx.x; i < cap; i += kRowThreads)
    cp_async4(lr_s + i, local_row + chunk0 + i);
  if (threadIdx.x == 0) {
    lo = W;
    hi = -1;
  }
  cp_async_wait();
  __syncthreads();
  auto row_of = [&](int i) {
    return i < cap ? lr_s[i] : local_row[chunk0 + i];
  };
  int my_lo = W, my_hi = -1;
  for (int i = threadIdx.x; i < C; i += kRowThreads) {
    const int r = row_of(i);
    if (r < W) {
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
  const int r_lo = lo, r_hi = hi;
  if (threadIdx.x == 0) chunk_rows[t] = make_int2(r_lo, r_hi);
  for (int h0 = 0; h0 < H; h0 += kHeads) {
    float2 mz[2][kHeads];
#pragma unroll
    for (int q = 0; q < kHeads; ++q)
      mz[0][q] = mz[1][q] = make_float2(-CUDART_INF_F, 0.f);
    for (int i = threadIdx.x; r_hi >= 0 && i < C; i += kRowThreads) {
      const int r = row_of(i);
      if (r != r_lo && r != r_hi) continue;
      const int64_t e = chunk0 + i;
      float s[kHeads];
      lanes.at(e, lane_src(lanes, e), row0 + r, h0, s);
#pragma unroll
      for (int q = 0; q < kHeads; ++q) {
        if (r == r_lo) mz_add(mz[0][q], s[q]);
        if (r == r_hi) mz_add(mz[1][q], s[q]);
      }
    }
    // the warp's statistics: its max, each thread's sum rescaled to it,
    // their sum (one exp a thread and value)
#pragma unroll
    for (int k = 0; k < 2; ++k) {
#pragma unroll
      for (int q = 0; q < kHeads; ++q) {
        const float m = warp_max(mz[k][q].x);
        const float z = warp_sum(mz[k][q].x == -CUDART_INF_F
                                     ? 0.f
                                     : mz[k][q].y * expf(mz[k][q].x - m));
        if (lane == 0) red[warp][k][q] = make_float2(m, z);
      }
    }
    __syncthreads();
    if (threadIdx.x < 2 * kHeads) {
      const int k = threadIdx.x / kHeads, q = threadIdx.x % kHeads;
      if (h0 + q < H) {
        float2 v = red[0][k][q];
#pragma unroll
        for (int w = 1; w < kRowWarps; ++w) v = mz_merge(v, red[w][k][q]);
        chunk_mz[(static_cast<int64_t>(t) * 2 + k) * H + h0 + q] = v;
      }
    }
    __syncthreads();                     // red is reused by the next heads
  }
}

// The final statistics of head h of row r, chunk t's lowest or highest row:
// the merge of the partials of the row's chunks (chunk_mz: slot 1 of a
// chunk where r is the highest row, else slot 0) in chunk order from the
// first chunk of the row's run in its block ([tb0, tb1)), so that every
// chunk of the run computes the same values.
__device__ float2 split_row_stats(int r, int t, int tb0, int tb1,
                                  const int2* __restrict__ chunk_rows,
                                  const float2* __restrict__ chunk_mz, int H,
                                  int h) {
  int u0 = t;
  for (int u = t - 1; u >= tb0; --u) {
    const int2 ru = chunk_rows[u];
    if (ru.y < 0) continue;              // a chunk of pads
    if (ru.y != r) break;
    u0 = u;
    if (ru.x != r) break;
  }
  float2 mz = make_float2(-CUDART_INF_F, 0.f);
  for (int u = u0; u < tb1; ++u) {
    const int2 ru = chunk_rows[u];
    if (ru.y < 0) continue;
    if (u > u0 && ru.x != r) break;
    mz = mz_merge(mz, chunk_mz[(static_cast<int64_t>(u) * 2 + (ru.y == r)) * H
                               + h]);
    if (ru.y != r) break;
  }
  return mz;
}


// B7 step 2, one CUDA block per chunk.  Each pass of `stage` lanes: the
// lanes' local rows and H scores are copied into shared memory with
// cp.async (a chunk's whole pass in flight at once), the scores in lane
// order (logits in: edge_src is copied, then each live lane's logits
// computed, kSoftmaxBatch lanes a thread at once), and the live lanes
// counting-sorted by row (stage_sort; perm maps a sorted position to its
// lane).  A thread takes a piece of at most 32 lanes of one row and
// reduces its (max, sum) per head in registers, in two sweeps over the
// piece's staged scores (the max, then the sum of exp(s - max)); one
// thread per row and head merges the row's pieces in piece order into its
// statistics row_mz (W x H).  The chunk's lowest and highest row take the
// statistics of their whole run (split_row_stats over the pre-pass's
// partials) instead.  Once final, row_mz holds each row's max and 1 / z
// (0 where the max is not finite or z not positive).  Then each lane's
// weight exp(s - m) / z is written in lane order, from the staged scores
// (one pass) or from a second read of the chunk (a chunk of several
// passes, whose first read skips the lowest and highest row).  mz_off: the
// byte offset of the float2 arrays in shared memory, after the scores.
// kMinBlocks: two CUDA blocks an SM at H > 1 (106 KB of shared memory at
// H=4), three at one head.
template <typename Lanes, int kMinBlocks>
__global__ void __launch_bounds__(kRowThreads, kMinBlocks)
softmax_rows_kernel(Lanes lanes, const int32_t* __restrict__ local_row,
                    const int32_t* __restrict__ chunk_block,
                    const int32_t* __restrict__ block_start,
                    const int2* __restrict__ chunk_rows,
                    const float2* __restrict__ chunk_mz, int C, int W, int H,
                    int stage, int mz_off, int64_t TC,
                    float* __restrict__ att) {
  extern __shared__ int4 smem[];
  const Stage st(smem, stage, W);
  int* perm = st.lanes;                  // sorted position -> lane
  char* base = reinterpret_cast<char*>(smem);
  float* s_s = reinterpret_cast<float*>(
      base + blocked::align16(blocked::stage_smem_bytes(stage, W, 1)));
  float2* piece_mz = reinterpret_cast<float2*>(base + mz_off);  // pieces x H
  float2* row_mz = piece_mz + blocked::max_pieces(stage, W) * H;  // W x H
  float2* bnd = row_mz + W * H;          // 2 x H: lowest, highest row
  const int t = blockIdx.x;
  const int64_t chunk0 = static_cast<int64_t>(t) * C;
  const int b = chunk_block[t];
  const int64_t row0 = static_cast<int64_t>(b) * W;
  const int2 rows = chunk_rows[t];
  const bool one_pass = stage >= C;
  for (int i = threadIdx.x; i < W * H; i += kRowThreads)
    row_mz[i] = make_float2(-CUDART_INF_F, 0.f);
  if (rows.y >= 0)
    for (int j = threadIdx.x; j < 2 * H; j += kRowThreads)
      bnd[j] = split_row_stats(j < H ? rows.x : rows.y, t, block_start[b],
                               block_start[b + 1], chunk_rows, chunk_mz, H,
                               j % H);
  // several passes: the lowest and highest row are not read in the first
  // sweep (their statistics are bnd's)
  auto staged = [&](int r) {
    return r < W && (one_pass || (r != rows.x && r != rows.y));
  };
  // exp(s - m) / z from row_mz's final (m, 1 / z)
  auto weight = [&](float s, int r, int h) {
    const float2 mi = row_mz[r * H + h];
    return mi.y > 0.f ? expf(s - mi.x) * mi.y : 0.f;
  };

  for (int s0 = 0; s0 < C; s0 += stage) {
    const int n = min(stage, C - s0);
    const int64_t e0 = chunk0 + s0;
    for (int r = threadIdx.x; r <= W; r += kRowThreads)
      st.scan[r] = make_int2(0, 0);
    for (int i = threadIdx.x; i < n; i += kRowThreads)
      cp_async4(st.row_s + i, local_row + e0 + i);
    if constexpr (Lanes::kCopy) {
      if (one_pass) {                    // every lane's scores, pads too
        for (int h = 0; h < H; ++h)
          for (int i = threadIdx.x; i < n; i += kRowThreads)
            cp_async4(s_s + h * stage + i, lanes.scores + h * TC + e0 + i);
      }
    } else {                             // perm holds edge_src until sorted
      for (int i = threadIdx.x; i < n; i += kRowThreads)
        cp_async4(perm + i, lanes.edge_src + e0 + i);
    }
    cp_async_wait();
    __syncthreads();                     // also publishes row_mz and bnd
    if constexpr (Lanes::kCopy) {
      if (!one_pass) {
        for (int h = 0; h < H; ++h)
          for (int i = threadIdx.x; i < n; i += kRowThreads)
            if (staged(st.row_s[i]))
              cp_async4(s_s + h * stage + i, lanes.scores + h * TC + e0 + i);
        cp_async_wait();
      }
    } else {
      for (int i0 = threadIdx.x; i0 < n; i0 += kRowThreads * kSoftmaxBatch) {
        int r[kSoftmaxBatch], src[kSoftmaxBatch];
#pragma unroll
        for (int u = 0; u < kSoftmaxBatch; ++u) {
          const int i = i0 + u * kRowThreads;
          r[u] = i < n ? st.row_s[i] : W;
          src[u] = i < n ? perm[i] : 0;
        }
        for (int h0 = 0; h0 < H; h0 += kHeads) {
          float s[kSoftmaxBatch][kHeads];
#pragma unroll
          for (int u = 0; u < kSoftmaxBatch; ++u)
            if (staged(r[u]))
              lanes.at(0, src[u], row0 + r[u], h0, s[u]);
#pragma unroll
          for (int u = 0; u < kSoftmaxBatch; ++u) {
            if (!staged(r[u])) continue;
#pragma unroll
            for (int q = 0; q < kHeads; ++q)
              if (h0 + q < H)
                s_s[(h0 + q) * stage + i0 + u * kRowThreads] = s[u][q];
          }
        }
      }
    }
    for (int i = threadIdx.x; i < n; i += kRowThreads) {
      const int r = st.row_s[i];
      if (r < W) atomicAdd(&st.scan[r].x, 1);
    }
    __syncthreads();
    const int num_pieces = blocked::stage_sort(
        n, W, false, st, [&](int i, int pos) { perm[pos] = i; },
        [](int) {});
    for (int p = threadIdx.x; p < num_pieces; p += kRowThreads) {
      const Piece pc = st.piece[p];
      if (!staged(pc.row)) continue;
      const int* pos = perm + pc.start;
      for (int h0 = 0; h0 < H; h0 += kHeads) {
        float m[kHeads], z[kHeads];
#pragma unroll
        for (int q = 0; q < kHeads; ++q) {
          m[q] = -CUDART_INF_F;
          z[q] = 0.f;
        }
        for (int j = 0; j < pc.len; ++j) {
          const float* sj = s_s + pos[j];
#pragma unroll
          for (int q = 0; q < kHeads; ++q)
            if (h0 + q < H) m[q] = fmaxf(m[q], sj[(h0 + q) * stage]);
        }
        for (int j = 0; j < pc.len; ++j) {
          const float* sj = s_s + pos[j];
#pragma unroll
          for (int q = 0; q < kHeads; ++q)
            if (h0 + q < H && m[q] > -CUDART_INF_F)
              z[q] += expf(sj[(h0 + q) * stage] - m[q]);
        }
#pragma unroll
        for (int q = 0; q < kHeads; ++q)
          if (h0 + q < H) piece_mz[p * H + h0 + q] = make_float2(m[q], z[q]);
      }
    }
    __syncthreads();
    // each row's pieces of the pass merged in order; after the last pass
    // the lowest and highest row take their run's statistics, and every
    // row's become (m, 1 / z)
    const bool last = s0 + stage >= C;
    for (int j = threadIdx.x; j < W * H; j += kRowThreads) {
      const int r = j / H, h = j - r * H;
      float2 mz = row_mz[j];
      if (staged(r)) {
        const int q1 = st.scan[r + 1].y;
        for (int q = st.scan[r].y; q < q1; ++q)
          mz = mz_merge(mz, piece_mz[q * H + h]);
      }
      if (last) {
        if (rows.y >= 0 && (r == rows.x || r == rows.y))
          mz = bnd[(r == rows.x ? 0 : H) + h];
        const bool ok = isfinite(mz.x) && mz.y > 0.f;
        mz = make_float2(ok ? mz.x : 0.f, ok ? 1.f / fmaxf(mz.y, 1e-38f) : 0.f);
      }
      row_mz[j] = mz;
    }
    if (one_pass) {
      __syncthreads();
#pragma unroll 4
      for (int i = threadIdx.x; i < n; i += kRowThreads) {
        const int r = st.row_s[i];
        for (int h = 0; h < H; ++h)
          att[h * TC + e0 + i] = r < W ? weight(s_s[h * stage + i], r, h)
                                       : 0.f;
      }
    }
    __syncthreads();                     // the next pass reuses the stage
  }
  if (one_pass) return;
  for (int i = threadIdx.x; i < C; i += kRowThreads) {
    const int64_t e = chunk0 + i;
    const int r = local_row[e];
    const int src = r < W ? lane_src(lanes, e) : 0;
    for (int h0 = 0; h0 < H; h0 += kHeads) {
      float s[kHeads];
      if (r < W) lanes.at(e, src, row0 + r, h0, s);
#pragma unroll
      for (int q = 0; q < kHeads; ++q)
        if (h0 + q < H)
          att[(h0 + q) * TC + e] = r < W ? weight(s[q], r, h0 + q) : 0.f;
    }
  }
}

// Shared memory of softmax_rows_kernel staging `stage` lanes a pass (the
// stage, H x stage scores, then the float2 arrays), and (mz_off) the
// offset of the float2 arrays.
inline size_t softmax_smem(int stage, int W, int H, size_t* mz_off) {
  *mz_off = blocked::align16(blocked::stage_smem_bytes(stage, W, 1)) +
            blocked::align16(static_cast<size_t>(H) * stage * sizeof(float));
  return *mz_off +
         (static_cast<size_t>(blocked::max_pieces(stage, W)) * H +
          static_cast<size_t>(W) * H + 2 * H) * sizeof(float2);
}

// Both kernels of B7: the pre-pass, then the main kernel with the widest
// pass (a multiple of kPiece lanes, at most kMaxStage) whose shared memory
// fits a CUDA block.
template <typename Lanes>
cudaError_t launch_softmax(const Lanes& lanes, const int32_t* local_row,
                           const int32_t* chunk_block,
                           const int32_t* block_start, int num_chunks, int C,
                           int W, int H, int2* chunk_rows, float2* chunk_mz,
                           float* att, cudaStream_t s) {
  constexpr size_t kMaxSmem = 232448;    // a CUDA block's most on sm_90
  int stage = std::min(C, kMaxStage);
  size_t mz_off;
  size_t smem = softmax_smem(stage, W, H, &mz_off);
  while (smem > kMaxSmem && stage > blocked::kPiece) {
    stage = std::max(blocked::kPiece, stage / 2 / blocked::kPiece *
                                          blocked::kPiece);
    smem = softmax_smem(stage, W, H, &mz_off);
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int cap = std::min(C, kMaxStage);  // the pre-pass's staged rows
  softmax_prepass_kernel<Lanes>
      <<<num_chunks, kRowThreads, cap * sizeof(int), s>>>(
          lanes, local_row, chunk_block, C, W, H, cap, chunk_rows, chunk_mz);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = H == 1 ? softmax_rows_kernel<Lanes, 3>
                       : softmax_rows_kernel<Lanes, 2>;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<num_chunks, kRowThreads, smem, s>>>(
      lanes, local_row, chunk_block, block_start, chunk_rows, chunk_mz, C, W,
      H, stage, static_cast<int>(mz_off),
      static_cast<int64_t>(num_chunks) * C, att);
  return cudaGetLastError();
}

// Step 1, one CUDA block per chunk, no row read: the chunk's split pieces
// (count_split_pieces) into split[t]; B3 (!kFlash): the chunk's max logit
// per head over its valid lanes, M_chunk, into chunk_ref (T, H); B9: the
// max logit per head of the chunk's lowest and of its highest live row, the
// only rows that can span chunks, into chunk_ref (T, 2, H), and those rows
// into chunk_rows (T,) (W, -1 for a chunk of pads).  The block's first
// chunk resets its row stats to (-inf, 0).
template <typename T, bool kFlash>
__global__ void __launch_bounds__(kRowThreads)
gat_prepass_kernel(Logits lg, const int32_t* __restrict__ edge_src,
                   const int32_t* __restrict__ local_row,
                   const int32_t* __restrict__ chunk_block, int C, int W,
                   int stage, int32_t* __restrict__ split,
                   float* __restrict__ chunk_ref, int2* __restrict__ chunk_rows,
                   float* __restrict__ row_m, float* __restrict__ row_z) {
  extern __shared__ int cnt[];           // W lane counts of a pass
  __shared__ float red[kRowWarps][2][kHeads];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x, H = lg.H;
  const int b = chunk_block[t];
  const int64_t chunk0 = static_cast<int64_t>(t) * C;
  const int64_t row0 = static_cast<int64_t>(b) * W;
  if (t == 0 || chunk_block[t - 1] != b) {
    for (int i = threadIdx.x; i < W * H; i += kRowThreads) {
      row_m[row0 * H + i] = -CUDART_INF_F;
      row_z[row0 * H + i] = 0.f;
    }
  }
  const SplitCount sc =
      count_split_pieces(local_row, chunk0, C, W, stage, cnt);
  if (threadIdx.x == 0) {
    split[t] = sc.pieces;
    if (kFlash) chunk_rows[t] = make_int2(sc.lo, sc.hi);
  }
  for (int h0 = 0; h0 < H; h0 += kHeads) {
    float m0[kHeads], m1[kHeads];
#pragma unroll
    for (int q = 0; q < kHeads; ++q) m0[q] = m1[q] = -CUDART_INF_F;
    for (int i = threadIdx.x; i < C; i += kRowThreads) {
      const int r = local_row[chunk0 + i];
      if (r >= W || (kFlash && r != sc.lo && r != sc.hi)) continue;
      float s[kHeads];
      lg.at<T>(edge_src[chunk0 + i], row0 + r, h0, s);
#pragma unroll
      for (int q = 0; q < kHeads; ++q) {
        if (!kFlash || r == sc.lo) m0[q] = fmaxf(m0[q], s[q]);
        if (kFlash && r == sc.hi) m1[q] = fmaxf(m1[q], s[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kHeads; ++q) {
      m0[q] = warp_max(m0[q]);
      if (kFlash) m1[q] = warp_max(m1[q]);
      if (lane == 0) {
        red[warp][0][q] = m0[q];
        red[warp][1][q] = m1[q];
      }
    }
    __syncthreads();
    const int q = threadIdx.x;
    if (q < kHeads && h0 + q < H) {
      float v0 = -CUDART_INF_F, v1 = -CUDART_INF_F;
#pragma unroll
      for (int w = 0; w < kRowWarps; ++w) {
        v0 = fmaxf(v0, red[w][0][q]);
        v1 = fmaxf(v1, red[w][1][q]);
      }
      if (kFlash) {
        chunk_ref[(static_cast<int64_t>(t) * 2) * H + h0 + q] = v0;
        chunk_ref[(static_cast<int64_t>(t) * 2 + 1) * H + h0 + q] = v1;
      } else {
        chunk_ref[static_cast<int64_t>(t) * H + h0 + q] = v0;
      }
    }
    __syncthreads();                     // red is reused by the next heads
  }
}

// The weights of a piece's lanes per column, from the warp's 32 x H tile
// in shared memory (w[j*H + h]: lane j's rounded weight for head h).  kVec
// divides D, so each of a thread's vectors lies in one head: its kNV heads
// are set per slab, and each row's weights are shared-memory reads (the
// warp reads at most H consecutive words a row: no bank conflict).  With
// one head (kOneHead) a row's weight is one read for all the vectors.
template <int kNV, bool kOneHead>
struct TileWeight {
  static constexpr bool kWeighted = true;
  const float* w;
  int H, D;
  int head[kNV];
  __device__ void slab(const int (&col)[kNV]) {
    if constexpr (!kOneHead) {
#pragma unroll
      for (int k = 0; k < kNV; ++k)      // a column past F takes the last head
        head[k] = min(col[k] / D, H - 1);
    }
  }
  __device__ void load(int, int, int) {}
  __device__ void get(int, int j, float (&out)[kNV]) {
    if constexpr (kOneHead) {
      const float v = w[j & 31];
#pragma unroll
      for (int k = 0; k < kNV; ++k) out[k] = v;
    } else {
#pragma unroll
      for (int k = 0; k < kNV; ++k) out[k] = w[(j & 31) * H + head[k]];
    }
  }
};

// Where a warp's piece puts its sums (GatSink): o, an owned row's output
// row or a split piece's slot; raw, an owned row's undivided sums (B9's
// debug output) or null; zinv, the piece's 1 / max(z, 1e-20) per head (0
// where z is not positive); own.  Kept in shared memory and read at each
// slab's end, not held in registers through add_piece's row loop, which
// needs them all: B3 at H=1, D=47 read 11.45 ms with these fields in
// registers, 10.97 with them here, and 10.57 with the piece's stats also
// written before its sums (NVIDIA H100 80GB HBM3, 700 W,
// scripts/time_csrc_variants.py; 3-4% less at H=4, D=64 too).
struct PieceOut {
  float* o;
  float* raw;
  const float* zinv;
  int D, own;
};
__shared__ PieceOut piece_out[kRowWarps];

// An owned row is stored as acc times its head's 1 / z (the plain version
// divides: the two differ by an ulp), a split piece's slot as it is.
template <bool kOneHead>
struct GatSink {
  template <int kVec>
  __device__ void store(int col, const float* v) const {
    const PieceOut& p = piece_out[threadIdx.x >> 5];
    if (!p.own) {
      put<kVec>(p.o + col, v, false);
      return;
    }
    const float zi = p.zinv[kOneHead ? 0 : col / p.D];
    float q[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) q[e] = v[e] * zi;
    put<kVec>(p.o + col, q, false);
    if (p.raw != nullptr) put<kVec>(p.raw + col, v, false);
  }
};

// Three CUDA blocks an SM (80 registers), as B8's rounded-term policies.
// On an NVIDIA H100 80GB HBM3 at 700 W (scripts/time_csrc_variants.py), B3
// at H=4, D=64 read 25.0 ms in f32 and 18.9 in bf16, against 24.9 and 19.6
// with two CUDA blocks and 27.4 and 24.3 with four; B9 20.5 and 16.1
// against 21.2 and 16.6 (two) and 23.0 and 20.0 (four).
constexpr int kGatMinBlocks = 3;

// Step 2, one CUDA block per chunk: stage it (stage_pass), then each warp
// takes a piece of at most kPiece lanes of one row.  Per head, each thread
// computes its lane's logit and e = exp(s - ref) against the reference the
// plain version rounds against — B3: the chunk's max M_chunk; B9: the row's
// running max after this chunk, i.e. the row's max in the chunk (a warp max
// for a row of one piece, else the row maxima taken over the whole chunk
// first) and, for the chunk's lowest row, the prefix max over the earlier
// chunks of its run (chunk_ref, chunk_rows) — writes round_to<T>(e) into
// the warp's tile and sums e into z.  Then add_piece reads each source row
// whole, all H*D columns once, and adds round_to<T>(bf16(e) * x) (B3) or
// bf16(e) * x (B9, exact in f32) per column.  An owned row is stored as
// acc / z with its (ref, z) in row_m, row_z; a split piece takes a slot.
// kOneHead: H == 1.
template <typename T, int kVec, bool kFlash, bool kOneHead>
__global__ void __launch_bounds__(kRowThreads, kGatMinBlocks)
gat_rows_kernel(const T* __restrict__ x, Logits lg,
                const int32_t* __restrict__ edge_src,
                const int32_t* __restrict__ local_row,
                const int32_t* __restrict__ chunk_block,
                const int32_t* __restrict__ block_start,
                const int32_t* __restrict__ slot_off,
                const float* __restrict__ chunk_ref,
                const int2* __restrict__ chunk_rows, int C, int W, int D,
                int stage, float* __restrict__ out, float* __restrict__ raw,
                float* __restrict__ row_m, float* __restrict__ row_z,
                int32_t* __restrict__ slot_row, float* __restrict__ slot_m,
                float* __restrict__ slot_z, float* __restrict__ slot_acc) {
  extern __shared__ int4 smem[];
  const Stage st(smem, stage, W);
  int* src_s = st.lanes;
  const int H = lg.H, F = H * D;
  float* tile = reinterpret_cast<float*>(src_s + stage);  // per warp 32 x H
  float* piece_z = tile + kRowWarps * 32 * H;             // per warp H
  float* piece_ref = piece_z + kRowWarps * H;             // per warp H
  float* piece_zinv = piece_ref + kRowWarps * H;          // per warp H
  float* chunk_h = piece_zinv + kRowWarps * H;  // H: B3 M_chunk; B9 prefix
  float* row_max = chunk_h + H;                // B9: W x H
  // one head: each lane's logit, staged in sorted order
  float* lane_s = row_max + (kFlash ? W * H : 0);
  __shared__ int next_slot;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x;
  const int64_t chunk0 = static_cast<int64_t>(t) * C;
  const int b = chunk_block[t];
  const int64_t row0 = static_cast<int64_t>(b) * W;
  const int slot_end = slot_off[t + 1];
  const int lo = kFlash ? chunk_rows[t].x : 0;
  // stage_pass's first barrier publishes next_slot, chunk_h and row_max
  if (threadIdx.x == 0) next_slot = slot_off[t];
  for (int h = threadIdx.x; h < H; h += kRowThreads) {
    if (!kFlash) {
      chunk_h[h] = chunk_ref[static_cast<int64_t>(t) * H + h];
    } else {
      // the lowest row's max over the earlier chunks of its run (a chunk of
      // pads carries the running max on)
      float p = -CUDART_INF_F;
      for (int u = t - 1; u >= block_start[b]; --u) {
        const int2 rows = chunk_rows[u];
        if (rows.y < 0) continue;
        if (rows.y != lo) break;
        p = fmaxf(p, chunk_ref[(static_cast<int64_t>(u) * 2 + 1) * H + h]);
        if (rows.x != lo) break;
      }
      chunk_h[h] = p;
    }
  }
  if (kFlash)
    for (int i = threadIdx.x; i < W * H; i += kRowThreads)
      row_max[i] = -CUDART_INF_F;
  const bool one_pass = stage >= C;

  // with one head the staging threads also compute each lane's logit, so
  // that a piece starts without a dependent gather of alpha_src
  auto place = [&](int64_t e0) {
    return [=](int i, int pos) {
      const int src = edge_src[e0 + i];
      src_s[pos] = src;
      if constexpr (kOneHead) {
        float s[kHeads];
        lg.at<T>(src, row0 + st.row_s[i], 0, s);
        lane_s[pos] = s[0];
      }
    };
  };
  // the logits of heads h0 .. h0+kHeads of lane `lane` of a piece
  auto piece_logits = [&](const Piece& pc, int my_src, int h0,
                          float (&s)[kHeads]) {
    if constexpr (kOneHead) {
#pragma unroll
      for (int q = 0; q < kHeads; ++q) s[q] = -CUDART_INF_F;
      if (lane < pc.len) s[0] = lane_s[pc.start + lane];
    } else {
      lg.at<T>(my_src, row0 + pc.row, h0, s);
    }
  };
  // B9: the piece's max logit per head into its row's row_max
  auto piece_max = [&](const Piece& pc) {
    const bool live = lane < pc.len;
    const int my_src = live ? src_s[pc.start + lane] : 0;
    for (int h0 = 0; h0 < H; h0 += kHeads) {
      float s[kHeads];
      piece_logits(pc, my_src, h0, s);
#pragma unroll
      for (int q = 0; q < kHeads; ++q) {
        if (h0 + q >= H) break;
        const float m = warp_max(live ? s[q] : -CUDART_INF_F);
        if (lane == 0) atomic_max_float(row_max + pc.row * H + h0 + q, m);
      }
    }
  };
  if (kFlash && !one_pass) {             // the row maxima over every pass
    for (int s0 = 0; s0 < C; s0 += stage) {
      const int n = min(stage, C - s0);
      const int num_pieces = stage_pass(local_row, chunk0 + s0, n, W, false,
                                        st, place(chunk0 + s0), [](int) {});
      for (int p = warp; p < num_pieces; p += kRowWarps)
        piece_max(st.piece[p]);
      __syncthreads();
    }
  }

  float* tw = tile + warp * 32 * H;
  float* zw = piece_z + warp * H;
  float* rw = piece_ref + warp * H;
  float* zi = piece_zinv + warp * H;
  // the number of pieces of row r in the pass (scan[r].y is its first)
  auto pieces_of = [&](int r) { return st.scan[r + 1].y - st.scan[r].y; };
  for (int s0 = 0; s0 < C; s0 += stage) {
    const int n = min(stage, C - s0);
    const int64_t e0 = chunk0 + s0;
    const int num_pieces = stage_pass(local_row, e0, n, W, one_pass, st,
                                      place(e0), [](int) {});
    if (kFlash && one_pass) {            // rows of several pieces
      for (int p = warp; p < num_pieces; p += kRowWarps)
        if (pieces_of(st.piece[p].row) > 1) piece_max(st.piece[p]);
      __syncthreads();
    }
    for (int p = warp; p < num_pieces; p += kRowWarps) {
      const Piece pc = st.piece[p];
      const int64_t row = row0 + pc.row;
      const bool live = lane < pc.len;
      const int my_src = live ? src_s[pc.start + lane] : 0;
      const bool single = one_pass && pieces_of(pc.row) == 1;
      for (int h0 = 0; h0 < H; h0 += kHeads) {
        float s[kHeads];
        piece_logits(pc, my_src, h0, s);
#pragma unroll
        for (int q = 0; q < kHeads; ++q) {
          const int h = h0 + q;
          if (h >= H) break;
          float ref;
          if (!kFlash) {
            ref = chunk_h[h];
          } else {
            ref = single ? warp_max(live ? s[q] : -CUDART_INF_F)
                         : row_max[pc.row * H + h];
            if (pc.row == lo) ref = fmaxf(ref, chunk_h[h]);
          }
          const float e = live ? expf(s[q] - ref) : 0.f;
          tw[lane * H + h] = round_to<T>(e);
          const float z = warp_sum(e);
          if (lane == 0) {
            zw[h] = z;
            rw[h] = ref;
            zi[h] = z > 0.f ? 1.f / fmaxf(z, 1e-20f) : 0.f;
          }
        }
      }
      int slot = 0;
      if (!pc.own) {
        if (lane == 0) slot = atomicAdd(&next_slot, 1);
        slot = __shfl_sync(kFull, slot, 0);
        if (slot >= slot_end) __trap();  // the count disagrees: fail loudly
      }
      if (lane == 0)
        piece_out[warp] = PieceOut{
            pc.own ? out + row * F : slot_acc + static_cast<int64_t>(slot) * F,
            pc.own && raw != nullptr ? raw + row * F : nullptr, zi, D, pc.own};
      __syncwarp();                      // the tile, zw, rw, zi, piece_out
      // the piece's stats before its sums, so that row and slot are not
      // held through add_piece
      for (int h = lane; h < H; h += 32) {
        if (pc.own) {
          row_m[row * H + h] = rw[h];
          row_z[row * H + h] = zw[h];
        } else {
          slot_m[static_cast<int64_t>(slot) * H + h] = rw[h];
          slot_z[static_cast<int64_t>(slot) * H + h] = zw[h];
        }
      }
      if (!pc.own && lane == 0) slot_row[slot] = pc.row;
      TileWeight<kAcc / kVec, kOneHead> wf{tw, H, D};
      add_piece<T, kVec, !kFlash>(x, F, src_s, pc, lane, wf,
                                  GatSink<kOneHead>{});
      __syncwarp();                      // the next piece rewrites them
    }
    __syncthreads();                     // the next pass reuses the stage
  }
}

inline Logits logits(const float* alpha_src, const float* alpha_dst,
                     int ad_rows, int H, float slope, int round_alpha) {
  const bool vec4 = H % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(alpha_src) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(alpha_dst) % 16 == 0;
  return Logits{alpha_src, alpha_dst, ad_rows, H, slope, round_alpha,
                vec4 ? 1 : 0};
}

// The arguments of B3 and B9 (gat_prepass_kernel, gat_rows_kernel).
struct GatArgs {
  Logits lg;
  const int32_t* edge_src;
  const int32_t* local_row;
  const int32_t* chunk_block;
  const int32_t* block_start;
  int num_chunks, num_blocks, C, W, D;
};

// Lanes staged per pass: a chunk in one pass when it fits kMaxStage.
inline int gat_stage(int C) { return std::min(C, kMaxStage); }

template <typename T>
cudaError_t launch_prepass(const GatArgs& a, bool flash, int32_t* split,
                           float* chunk_ref, int2* chunk_rows, float* row_m,
                           float* row_z, cudaStream_t stream) {
  auto kernel = flash ? gat_prepass_kernel<T, true>
                      : gat_prepass_kernel<T, false>;
  const size_t smem = static_cast<size_t>(a.W) * sizeof(int);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.num_chunks, kRowThreads, smem, stream>>>(
      a.lg, a.edge_src, a.local_row, a.chunk_block, a.C, a.W, gat_stage(a.C),
      split, chunk_ref, chunk_rows, row_m, row_z);
  return cudaGetLastError();
}

template <typename T, int kVec>
cudaError_t launch_gat_rows(const void* x, const GatArgs& a, bool flash,
                            const int32_t* slot_off, const float* chunk_ref,
                            const int2* chunk_rows, float* out, float* raw,
                            float* row_m, float* row_z, int32_t* slot_row,
                            float* slot_m, float* slot_z, float* slot_acc,
                            cudaStream_t stream) {
  const int stage = gat_stage(a.C), H = a.lg.H;
  const size_t smem =
      blocked::stage_smem_bytes(stage, a.W, 1) +
      (static_cast<size_t>(kRowWarps) * (32 + 3) * H + H +
       (flash ? static_cast<size_t>(a.W) * H : 0) + (H == 1 ? stage : 0)) *
          sizeof(float);
  auto kernel = H == 1 ? (flash ? gat_rows_kernel<T, kVec, true, true>
                                : gat_rows_kernel<T, kVec, false, true>)
                       : (flash ? gat_rows_kernel<T, kVec, true, false>
                                : gat_rows_kernel<T, kVec, false, false>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<a.num_chunks, kRowThreads, smem, stream>>>(
      static_cast<const T*>(x), a.lg, a.edge_src, a.local_row, a.chunk_block,
      a.block_start, slot_off, chunk_ref, chunk_rows, a.C, a.W, a.D, stage,
      out, raw, row_m, row_z, slot_row, slot_m, slot_z, slot_acc);
  return cudaGetLastError();
}

// gat_rows_kernel with the widest load that divides H*D, D and the address
// of x (so that no vector straddles two heads), then the merge.
cudaError_t launch_gat(const void* x, bool bf16, const GatArgs& a, bool flash,
                       const int32_t* slot_off, const float* chunk_ref,
                       const int2* chunk_rows, float* out, float* raw,
                       float* row_m, float* row_z, int32_t* slot_row,
                       float* slot_m, float* slot_z, float* slot_acc,
                       cudaStream_t s) {
  const int F = a.lg.H * a.D;
  int v = blocked::vec_elems(x, F, bf16 ? 2 : 4);
  while (a.D % v) v /= 2;
#define TGT_GAT(T, V)                                                       \
  launch_gat_rows<T, V>(x, a, flash, slot_off, chunk_ref, chunk_rows, out,  \
                        raw, row_m, row_z, slot_row, slot_m, slot_z,        \
                        slot_acc, s)
  cudaError_t err;
  if (bf16) {
    switch (v) {
      case 8: err = TGT_GAT(__nv_bfloat16, 8); break;
      case 4: err = TGT_GAT(__nv_bfloat16, 4); break;
      case 2: err = TGT_GAT(__nv_bfloat16, 2); break;
      default: err = TGT_GAT(__nv_bfloat16, 1);
    }
  } else {
    switch (v) {
      case 4: err = TGT_GAT(float, 4); break;
      case 2: err = TGT_GAT(float, 2); break;
      default: err = TGT_GAT(float, 1);
    }
  }
#undef TGT_GAT
  if (err != cudaSuccess) return err;
  return blocked::launch_merge(flash, a.block_start, slot_off, a.num_blocks,
                               a.W, a.lg.H, a.D, slot_row, slot_m, slot_z,
                               slot_acc, row_m, row_z, out, raw, s);
}

}  // namespace

extern "C" {

// Common arguments: edge_src, local_row: (num_chunks, C) int32; block_start:
// (num_blocks + 1,) int32.  Each function launches on `stream`, returns the
// cudaError_t of its launch (0 on success) and does not synchronise.

// B7's two entries share: chunk_block (num_chunks,) int32; chunk_rows
// (num_chunks, 2) int32 and chunk_mz (num_chunks, 2, H, 2) f32 scratch;
// att (H, num_chunks, C) f32, the per-(row, head) softmax, 0 on pad lanes.
// Entry (a): scores (H, num_chunks, C) f32.
int tgt_edge_softmax_multihead(const float* scores, const int32_t* local_row,
                               const int32_t* chunk_block,
                               const int32_t* block_start, int num_chunks,
                               int C, int W, int H, int32_t* chunk_rows,
                               float* chunk_mz, float* att, void* stream) {
  if (num_chunks <= 0 || C <= 0 || W <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const ScoreLanes lanes{scores, static_cast<int64_t>(num_chunks) * C, H};
  return static_cast<int>(launch_softmax(
      lanes, local_row, chunk_block, block_start, num_chunks, C, W, H,
      reinterpret_cast<int2*>(chunk_rows),
      reinterpret_cast<float2*>(chunk_mz), att,
      static_cast<cudaStream_t>(stream)));
}

// Entry (b): the scores are the GAT logits leaky_relu(alpha_src[src, h] +
// alpha_dst[min(row, ad_rows - 1), h], negative_slope) of alpha_src (N, H)
// and alpha_dst (ad_rows, H) f32, computed in the kernels.
int tgt_gat_edge_softmax(const float* alpha_src, const float* alpha_dst,
                         int ad_rows, float negative_slope,
                         const int32_t* edge_src, const int32_t* local_row,
                         const int32_t* chunk_block,
                         const int32_t* block_start, int num_chunks, int C,
                         int W, int H, int32_t* chunk_rows, float* chunk_mz,
                         float* att, void* stream) {
  if (num_chunks <= 0 || C <= 0 || W <= 0 || H <= 0 || ad_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = H % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(alpha_src) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(alpha_dst) % 16 == 0;
  const GatLogitLanes lanes{edge_src, alpha_src, alpha_dst, ad_rows - 1, H,
                            negative_slope, vec4 ? 1 : 0};
  return static_cast<int>(launch_softmax(
      lanes, local_row, chunk_block, block_start, num_chunks, C, W, H,
      reinterpret_cast<int2*>(chunk_rows),
      reinterpret_cast<float2*>(chunk_mz), att,
      static_cast<cudaStream_t>(stream)));
}

// B8: x (N, F) row-major, f32 (x_is_bf16 == 0) or bf16, F = H*D; weight
// (H, num_chunks, C) f32; chunk_block (num_chunks,) int32; out
// (num_blocks*W, F) f32.
int tgt_spmm_multiweighted(const void* x, int x_is_bf16,
                           const int32_t* edge_src, const int32_t* local_row,
                           const float* weight, const int32_t* chunk_block,
                           const int32_t* block_start, int num_chunks,
                           int num_blocks, int C, int W, int F, int D,
                           float* out, void* stream) {
  if (num_blocks <= 0 || num_chunks <= 0 || C <= 0 || W <= 0 || F <= 0 ||
      D <= 0 || F % D)
    return static_cast<int>(cudaErrorInvalidValue);
  const blocked::RowsArgs a{edge_src,   local_row,  chunk_block,
                            block_start, num_chunks, num_blocks,
                            C,          W,          F,
                            out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool bf16 = x_is_bf16 != 0;
  // one head: a staged lane weight, as B2's, with rounded terms
  if (F == D)
    return static_cast<int>(blocked::launch_rows_vec(
        x, bf16, D, a, blocked::StagedWeight<true>{weight}, s));
  const HeadLanes lanes{weight, static_cast<int64_t>(num_chunks) * C, D,
                        F / D};
  return static_cast<int>(blocked::launch_rows_vec(x, bf16, D, a, lanes, s));
}

// B3 and B9 share the next two functions (flash == 0: B3, 1: B9).  x (N,
// H*D) row-major, f32 (x_is_bf16 == 0) or bf16; alpha_src (N, H) f32, the
// given table, or for B3 with alpha_src_vec (H, D) f32 not null written
// here with the GATv1 projection; round_alpha != 0: alpha_src rounded to the
// compute dtype in the logits (B3's table, B9); alpha_dst (ad_rows, H) f32,
// rows past ad_rows read 0; chunk_block (num_chunks,) int32; row_m, row_z
// (num_blocks*W, H) f32.  Needs D <= 128.

// Step 1 (and B3's projection): split (num_chunks,) int32, each chunk's
// split pieces; chunk_ref f32, B3 (num_chunks, H) the chunk max, B9
// (num_chunks, 2, H) the max of the chunk's lowest and highest row;
// chunk_rows (num_chunks, 2) int32 those rows (B9 only, else null); row_m,
// row_z reset to (-inf, 0).  The caller scans split into the slot offsets
// and sizes the slots for tgt_gat_attend.
int tgt_gat_count(const void* x, int x_is_bf16, int flash, int round_alpha,
                  float* alpha_src, const float* alpha_src_vec,
                  const float* alpha_dst, int ad_rows,
                  const int32_t* edge_src, const int32_t* local_row,
                  const int32_t* chunk_block, int N, int num_chunks, int C,
                  int W, int H, int D, float negative_slope, int32_t* split,
                  float* chunk_ref, int32_t* chunk_rows, float* row_m,
                  float* row_z, void* stream) {
  if (N <= 0 || num_chunks <= 0 || C <= 0 || W <= 0 || H <= 0 || D <= 0 ||
      D > kMaxD || (flash != 0) != (chunk_rows != nullptr) ||
      (flash && alpha_src_vec))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (alpha_src_vec) {                   // the projection, once per node
    const int64_t threads = static_cast<int64_t>(N) * H * 32;
    const int64_t grid = (threads + 255) / 256;
    if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
    if (x_is_bf16)
      gat_alpha_src_kernel<__nv_bfloat16><<<static_cast<unsigned>(grid), 256,
                                            0, s>>>(
          static_cast<const __nv_bfloat16*>(x), alpha_src_vec, N, H, D,
          alpha_src);
    else
      gat_alpha_src_kernel<float><<<static_cast<unsigned>(grid), 256, 0, s>>>(
          static_cast<const float*>(x), alpha_src_vec, N, H, D, alpha_src);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const GatArgs a{logits(alpha_src, alpha_dst, ad_rows, H, negative_slope,
                         round_alpha),
                  edge_src, local_row, chunk_block, nullptr, num_chunks, 0, C,
                  W, D};
  int2* rows = reinterpret_cast<int2*>(chunk_rows);
  return static_cast<int>(
      x_is_bf16 ? launch_prepass<__nv_bfloat16>(a, flash != 0, split,
                                                chunk_ref, rows, row_m, row_z,
                                                s)
                : launch_prepass<float>(a, flash != 0, split, chunk_ref, rows,
                                        row_m, row_z, s));
}

// Step 2, the main and merge kernels.  block_start (num_blocks + 1,)
// int32; slot_off (num_chunks + 1,) int32: chunk t's split pieces take
// slots [slot_off[t], slot_off[t+1]); slot_row (S,) int32, slot_m, slot_z
// (S, H) and slot_acc (S, H*D) f32 scratch; chunk_ref, chunk_rows, row_m,
// row_z as tgt_gat_count left them; out (num_blocks*W, H*D) f32, divided
// by z.  B9 only: raw_out (the shape of out, undivided) when not null, and
// row_m, row_z then hold each row's final (m, z).
int tgt_gat_attend(const void* x, int x_is_bf16, int flash, int round_alpha,
                   const float* alpha_src, const float* alpha_dst,
                   int ad_rows, const int32_t* edge_src,
                   const int32_t* local_row, const int32_t* chunk_block,
                   const int32_t* block_start, const int32_t* slot_off,
                   const float* chunk_ref, const int32_t* chunk_rows,
                   int num_chunks, int num_blocks, int C, int W, int H, int D,
                   float negative_slope, float* row_m, float* row_z,
                   int32_t* slot_row, float* slot_m, float* slot_z,
                   float* slot_acc, float* out, float* raw_out,
                   void* stream) {
  if (num_chunks <= 0 || num_blocks <= 0 || C <= 0 || W <= 0 || H <= 0 ||
      D <= 0 || D > kMaxD || (flash != 0) != (chunk_rows != nullptr) ||
      (!flash && raw_out))
    return static_cast<int>(cudaErrorInvalidValue);
  const GatArgs a{logits(alpha_src, alpha_dst, ad_rows, H, negative_slope,
                         round_alpha),
                  edge_src, local_row, chunk_block, block_start, num_chunks,
                  num_blocks, C, W, D};
  return static_cast<int>(launch_gat(
      x, x_is_bf16 != 0, a, flash != 0, slot_off, chunk_ref,
      reinterpret_cast<const int2*>(chunk_rows), out, raw_out, row_m, row_z,
      slot_row, slot_m, slot_z, slot_acc, static_cast<cudaStream_t>(stream)));
}

const char* tgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
