// Threefry-2x32 for Hopper (sm_90a): every random draw of the port on the
// card.
//
// This kernel replaces no Pallas kernel: the JAX package's threefry is
// XLA's own lowering (jax/_src/prng.py::_threefry2x32_lowering), fused into
// whatever consumes the bits.  The port's plain version
// (sampling/rng.py::threefry2x32) runs the same hash as ~176 int64 torch
// ops a draw, each one launch over the whole draw; on the card that was
// most of a sampled train step (the dropout masks and the sampler's draws).
// Here one launch computes a whole draw.
//
// The hash is jax's with jax_threefry_partitionable=True (threefry.cuh,
// shared with floyd.cu).  Element e of a draw of rows x n elements hashes
// the counter c = offset + (data ? data[e] mod 2**32 : e mod n), a uint64
// split into the words (c >> 32, c mod 2**32), under the key of its row
// (row e / n of a (rows, 2) key table) or under the one key (k0, k1).  The
// output is either the 32 bits out0 ^ out1 as an int64 in [0, 2**32) (the
// values sampling/rng.py::random_bits returns) or the two words as an int64
// pair (the device-side key derivations: fold_in_many, fold_in_each,
// split_each).  Counters from data exist only for keys, so data implies the
// two-word output: three modes, bits, words and words of data.
//
// What bounds it on an H100.  An element takes 20 funnel shifts and 21 xors
// (the rounds' and the output's), which only the ALU pipe issues (64 lanes
// an SM), 32 adds, which the FMA pipe can take as IMAD, and writes 8 bytes
// (16 in the two-word mode); nothing is read but a key table or a data
// array.  At the dropout masks' 47.7M elements a sampled train step, the
// ALU pipe needs 0.117 ms at 1.98 GHz and the bits' 0.38 GB need 0.114 ms
// at 3.35 TB/s: the two bounds meet, so the design keeps every SM's ALU
// pipe issuing and stores wide.  A grid-stride loop over groups of 4
// consecutive elements, at most 16 blocks of 256 threads an SM; each thread
// hashes its 4 counters in registers (4 independent chains for the
// scheduler to interleave) and writes them with 16-byte stores.  One launch
// a draw: a draw's cost on the host is then one launch, and the card needs
// no more to fill its SMs from 1,024 elements up.
#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;  // consecutive elements a thread hashes at once
constexpr int kBlocksPerSm = 16;

struct Args {
  const int64_t* keys;  // (rows, 2) uint32 words held in int64, or null
  uint32_t k0, k1;      // the one key when keys is null
  const int64_t* data;  // (rows * n) counters, taken mod 2**32, or null
  uint64_t offset;      // added to every counter
  int64_t n;            // elements a row
  int64_t total;        // rows * n
  int64_t* out;         // (total,) bits or (total, 2) words
};

// The hash of element e: its key, its counter, the two output words.
template <bool kTable, bool kData>
__device__ __forceinline__ void element(const Args& a, int64_t e,
                                        uint32_t& x0, uint32_t& x1) {
  uint32_t k0 = a.k0, k1 = a.k1;
  int64_t i = e;
  if (kTable) {
    const int64_t b = e / a.n;
    i = e - b * a.n;
    k0 = static_cast<uint32_t>(__ldg(a.keys + 2 * b));
    k1 = static_cast<uint32_t>(__ldg(a.keys + 2 * b + 1));
  }
  const uint64_t c =
      a.offset + (kData ? static_cast<uint64_t>(
                              static_cast<uint32_t>(__ldg(a.data + e)))
                        : static_cast<uint64_t>(i));
  x0 = static_cast<uint32_t>(c >> 32);
  x1 = static_cast<uint32_t>(c);
  tgt_rng::threefry2x32(k0, k1, x0, x1);
}

template <bool kTable, bool kData, bool kWords>
__global__ void __launch_bounds__(kThreads) threefry_kernel(const Args a) {
  const int64_t groups = (a.total + kGroup - 1) / kGroup;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       g < groups; g += stride) {
    const int64_t e0 = g * kGroup;
    uint32_t x0[kGroup], x1[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j)  // past the end: recompute the last
      element<kTable, kData>(a, e0 + j < a.total ? e0 + j : a.total - 1,
                             x0[j], x1[j]);
    if (e0 + kGroup <= a.total) {  // 16-byte stores (the base is aligned)
      if (kWords) {
        longlong2* o = reinterpret_cast<longlong2*>(a.out + 2 * e0);
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          o[j] = make_longlong2(x0[j], x1[j]);
      } else {
        longlong2* o = reinterpret_cast<longlong2*>(a.out + e0);
        o[0] = make_longlong2(x0[0] ^ x1[0], x0[1] ^ x1[1]);
        o[1] = make_longlong2(x0[2] ^ x1[2], x0[3] ^ x1[3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (e0 + j >= a.total) break;
        if (kWords) {
          a.out[2 * (e0 + j)] = x0[j];
          a.out[2 * (e0 + j) + 1] = x1[j];
        } else {
          a.out[e0 + j] = x0[j] ^ x1[j];
        }
      }
    }
  }
}

template <bool kTable>
void launch(const Args& a, bool words, int blocks, cudaStream_t s) {
  if (a.data)
    threefry_kernel<kTable, true, true><<<blocks, kThreads, 0, s>>>(a);
  else if (words)
    threefry_kernel<kTable, false, true><<<blocks, kThreads, 0, s>>>(a);
  else
    threefry_kernel<kTable, false, false><<<blocks, kThreads, 0, s>>>(a);
}

}  // namespace

extern "C" {

// keys: (rows, 2) int64 key table, or null for the one key (k0, k1); data:
// (rows * n) int64 counters, or null for the counters 0..n-1 of each row;
// offset: added to every counter; out: (rows * n) int64 bits (words == 0)
// or (rows * n, 2) int64 words, 16-byte aligned; data needs words.  Launches on `stream`;
// returns the cudaError_t of the launch (0 on success).  Does not
// synchronise.
int tgt_threefry(const int64_t* keys, int64_t k0, int64_t k1,
                 const int64_t* data, uint64_t offset, int64_t rows, int64_t n,
                 int words, int64_t* out, void* stream) {
  if (rows < 0 || n < 0 || (rows > 0 && n > (int64_t{1} << 61) / rows) ||
      (data && !words) || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = rows * n;
  if (total == 0) return static_cast<int>(cudaSuccess);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t groups = (total + kGroup - 1) / kGroup;
  const int64_t need = (groups + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(
      need < static_cast<int64_t>(sms) * kBlocksPerSm
          ? need : static_cast<int64_t>(sms) * kBlocksPerSm);
  const Args a{keys,   static_cast<uint32_t>(k0), static_cast<uint32_t>(k1),
               data,   offset, n, total, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool w = words != 0;
  if (keys) launch<true>(a, w, blocks, s);
  else launch<false>(a, w, blocks, s);
  return static_cast<int>(cudaGetLastError());
}

const char* tgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
