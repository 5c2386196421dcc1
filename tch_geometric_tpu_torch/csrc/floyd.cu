// One hop of uniform neighbor sampling without replacement on a graph with
// no ELL table, for Hopper (sm_90a): F1.
//
// This kernel replaces no Pallas kernel: the JAX package's Floyd loop
// (sampling/primitives.py::floyd_sample) is a fori_loop that XLA fuses.
// The port's plain version runs it as k iterations of host key hashes, two
// threefry draws and ~20 int64 torch ops each, with a blocking copy of the
// randint bounds; at fanouts [15, 10, 5] that was ~1,500 launches and ~30
// host waits a train step.  Here one launch does a whole hop.
//
// What it computes, row b of a frontier of B rows, bit for bit what
// sampling/primitives.py::floyd_hop_plain computes:
//   node = clamp(frontier[b], 0, N - 1), start/end from indptr,
//   deg = valid[b] ? end - start : 0;
//   if deg > k, Floyd: for i in [0, k), j = deg - k + i, t = jax's randint
//   in [0, j + 1) from the two 32-bit draws at the partitionable counter
//   row0 + b under the words of split(fold_in(hop key, i)) (out0 ^ out1
//   each, the 2**16 mod span multiplier wrapping in uint32), chosen[i] =
//   t already chosen ? j : t;
//   else every position below deg is taken: pos[i] = i < deg ? i : 0;
//   eptr = clamp(start + pos, 0, E - 1), neighbor = indices[eptr] (or, given
//   the graph's aligned-window table, the value its gather reads: lane
//   (start mod lanes) + pos of the rows from start / lanes, the row clamped
//   to the table; it differs from indices[eptr] on invalid slots only).
// The keys of draw i are the same for every row: a block derives them once
// (three hashes a draw) into shared memory, for kChunk draws at a time.
//
// What bounds it at the sampled train step's shapes (1,024 seeds, fanouts
// [15, 10, 5]): 15,360 + 153,600 + 768,000 = 937k row-draws, two hashes
// each at most (rows with deg <= k draw nothing), ~0.08 G ALU operations,
// and ~25 bytes written a slot (pos, valid, eptr, neighbor), ~24 MB with
// the reads of the frontier, indptr and indices.  At 3.35 TB/s and 132 SMs
// x 64 ALU lanes x 1.98 GHz that is 2-8 us a hop: a hop is bound by the
// latency of its chain (frontier -> indptr -> the draws -> Floyd's serial
// insertions -> indices) and by its launch, and the first hop has only
// 1,024 rows.  So a block takes R = max(1, 128 / k) rows and spreads their
// R x k draws over its 128 threads: 128 blocks at the first hop (one an SM),
// 1,280 at the second, 6,144 at the third.  The draws (the work) run one a
// thread; the insertions, k(k-1)/2 compares a row in shared memory, run one
// thread a row.  A block whose rows all have deg <= k skips the draws.
//
// Where Floyd's state lives: the chosen positions are staged in shared
// memory (R x k <= kStage 32-bit words), Floyd inserting in place over the
// draws; past kStage (k > 1,024) in the pos output itself, which the
// wrapper allocates, so the kernel allocates nothing for any k.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 128;   // draws whose keys a block holds at once
constexpr int kStage = 1024;  // staged draws a block holds in shared memory

struct Args {
  const int64_t* indptr;    // (N + 1,)
  const int64_t* indices;   // (E,)
  const int32_t* win;       // (win_rows, win_lanes), or null
  const int64_t* frontier;  // (B,)
  const bool* valid_in;     // (B,)
  int64_t num_nodes, num_edges, win_rows, win_lanes, rows, k;
  int rows_per_block;
  uint64_t row0;
  uint32_t k0, k1;          // the hop key
  int64_t* deg;             // (B,)
  int64_t* pos;             // (B, k)
  bool* valid;              // (B, k)
  int64_t* eptr;            // (B, k)
  int64_t* neighbor;        // (B, k)
};

// jax.random.randint's fold of two 32-bit draws into [0, span), span >= 1.
__device__ __forceinline__ uint32_t randint_fold(uint32_t higher,
                                                 uint32_t lower,
                                                 uint32_t span) {
  uint32_t mult = 65536u % span;
  mult = (mult * mult) % span;
  uint32_t off = (higher % span) * mult;
  off += lower % span;
  return off % span;
}

// The bits out0 ^ out1 of counter c under key (k0, k1).
__device__ __forceinline__ uint32_t bits(uint32_t k0, uint32_t k1,
                                         uint64_t c) {
  uint32_t x0 = static_cast<uint32_t>(c >> 32);
  uint32_t x1 = static_cast<uint32_t>(c);
  tgt_rng::threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// The neighbor id of slot position p of a row starting at edge `start`.
__device__ __forceinline__ int64_t neighbor_of(const Args& a, int64_t start,
                                               int64_t ep, int64_t p) {
  if (a.num_edges == 0) return 0;
  if (a.win == nullptr) return __ldg(a.indices + ep);
  // the window table's gather: lane (start mod lanes) + p of the rows from
  // start / lanes, the row clamped to the table
  const int64_t lane = (start % a.win_lanes) + p;
  int64_t row = start / a.win_lanes + lane / a.win_lanes;
  row = row < a.win_rows - 1 ? row : a.win_rows - 1;
  return __ldg(a.win + row * a.win_lanes + lane % a.win_lanes);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads) floyd_kernel(const Args a) {
  __shared__ uint32_t s_key[kChunk][4];  // split(fold_in(hop, i)) words
  __shared__ int64_t s_start[kThreads];
  __shared__ int64_t s_deg[kThreads];
  __shared__ uint32_t s_stage[kShared ? kStage : 1];
  const int tid = threadIdx.x;
  const int R = a.rows_per_block;
  const int64_t k = a.k;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * R;
  const int64_t nrows = a.rows - b0 < R ? a.rows - b0 : R;

  bool draws = false;
  if (tid < nrows) {
    const int64_t b = b0 + tid;
    int64_t node = __ldg(a.frontier + b);
    node = node < 0 ? 0 : node;
    node = node > a.num_nodes - 1 ? a.num_nodes - 1 : node;
    int64_t start = __ldg(a.indptr + (node < 0 ? 0 : node));
    int64_t end = __ldg(a.indptr + node + 1);
    const int64_t d = a.valid_in[b] ? end - start : 0;
    s_start[tid] = start;
    s_deg[tid] = d;
    a.deg[b] = d;
    draws = d > k;
  }
  if (__syncthreads_or(draws)) {
    // each draw t of a row with deg > k, staged
    for (int64_t c0 = 0; c0 < k; c0 += kChunk) {
      const int64_t cw = k - c0 < kChunk ? k - c0 : kChunk;
      if (tid < cw) {
        uint32_t f0 = 0, f1 = static_cast<uint32_t>(c0 + tid);
        tgt_rng::threefry2x32(a.k0, a.k1, f0, f1);       // fold_in(hop, i)
        uint32_t h0 = 0, h1 = 0, l0 = 0, l1 = 1;
        tgt_rng::threefry2x32(f0, f1, h0, h1);           // split: key 0
        tgt_rng::threefry2x32(f0, f1, l0, l1);           // split: key 1
        s_key[tid][0] = h0; s_key[tid][1] = h1;
        s_key[tid][2] = l0; s_key[tid][3] = l1;
      }
      __syncthreads();
      for (int64_t e = tid; e < nrows * cw; e += kThreads) {
        const int64_t r = e / cw, q = e - r * cw, i = c0 + q;
        const int64_t d = s_deg[r];
        if (d <= k) continue;
        const uint64_t c = a.row0 + static_cast<uint64_t>(b0 + r);
        const uint32_t higher = bits(s_key[q][0], s_key[q][1], c);
        const uint32_t lower = bits(s_key[q][2], s_key[q][3], c);
        const uint32_t span = static_cast<uint32_t>(d - k + i + 1);
        const uint32_t t = randint_fold(higher, lower, span);
        if constexpr (kShared) s_stage[r * k + i] = t;
        else a.pos[(b0 + r) * k + i] = t;
      }
      __syncthreads();
    }
    // Floyd's insertions, in place, one thread a row
    if (tid < nrows && s_deg[tid] > k) {
      const int64_t j0 = s_deg[tid] - k;
      if constexpr (kShared) {
        uint32_t* ch = s_stage + tid * k;
        for (int64_t i = 1; i < k; ++i) {
          const uint32_t t = ch[i];
          bool hit = false;
          for (int64_t q = 0; q < i; ++q) hit |= ch[q] == t;
          if (hit) ch[i] = static_cast<uint32_t>(j0 + i);
        }
      } else {
        int64_t* ch = a.pos + (b0 + tid) * k;
        for (int64_t i = 1; i < k; ++i) {
          const int64_t t = ch[i];
          bool hit = false;
          for (int64_t q = 0; q < i; ++q) hit |= ch[q] == t;
          if (hit) ch[i] = j0 + i;
        }
      }
    }
    __syncthreads();
  }
  // the slots, in the block's contiguous (rows, k) range
  const int64_t last = a.num_edges > 0 ? a.num_edges - 1 : 0;
  for (int64_t e = tid; e < nrows * k; e += kThreads) {
    const int64_t r = e / k, i = e - r * k, g = b0 * k + e;
    const int64_t d = s_deg[r], start = s_start[r];
    int64_t p;
    bool v;
    if (d > k) {
      if constexpr (kShared) p = s_stage[r * k + i];
      else p = a.pos[g];
      v = true;
    } else {
      v = i < d;
      p = v ? i : 0;
    }
    int64_t ep = start + p;
    ep = ep < 0 ? 0 : (ep > last ? last : ep);
    a.pos[g] = p;
    a.valid[g] = v;
    a.eptr[g] = ep;
    a.neighbor[g] = neighbor_of(a, start, ep, p);
  }
}

}  // namespace

extern "C" {

// indptr (N + 1) and indices (E) int64; win (win_rows, win_lanes) int32,
// the graph's aligned-window table whose gather the neighbor ids follow,
// or null for indices[eptr]; frontier (rows) int64 and valid_in (rows)
// bool; (k0, k1) the hop key's words; row0 the frontier's first row in the
// draw.  Writes deg (rows) and pos, valid, eptr, neighbor (rows, k),
// contiguous.  Launches on `stream`; returns the cudaError_t of the launch
// (0 on success).  Does not synchronise.
int tgt_floyd_hop(const int64_t* indptr, const int64_t* indices,
                  const int32_t* win, const int64_t* frontier,
                  const bool* valid_in, int64_t num_nodes, int64_t num_edges,
                  int64_t win_rows, int64_t win_lanes, int64_t rows,
                  int64_t k, uint64_t row0, int64_t k0, int64_t k1,
                  int64_t* deg, int64_t* pos, bool* valid,
                  int64_t* eptr, int64_t* neighbor, void* stream) {
  if (rows < 0 || k < 0 || num_nodes < 0 || num_edges < 0 ||
      (win != nullptr && (win_rows < 1 || win_lanes < 1)) ||
      k >= (int64_t{1} << 32) || (rows > 0 && k > (int64_t{1} << 48) / rows))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const int rpb = k > 0 && k < kThreads ? static_cast<int>(kThreads / k)
                                        : (k == 0 ? kThreads : 1);
  const int64_t blocks = (rows + rpb - 1) / rpb;
  if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{indptr, indices, win, frontier, valid_in, num_nodes,
               num_edges, win_rows, win_lanes, rows, k, rpb, row0,
               static_cast<uint32_t>(k0), static_cast<uint32_t>(k1), deg,
               pos, valid, eptr, neighbor};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (static_cast<int64_t>(rpb) * k <= kStage)
    floyd_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  else
    floyd_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* tgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
