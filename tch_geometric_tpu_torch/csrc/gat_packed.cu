// Head-packed multi-head GAT aggregation for Hopper (sm_90a): kernel B3.
//
// Replaces tch_geometric_tpu/ops/attention_blocked.py::_gat_packed_kernel,
// _gat_packed_vec_kernel and _gat_packed_core (wrapper
// gat_attend_blocked_packed).  For every dst row i of the blocked layout and
// every head h, over the valid lanes e of i's row block (local_row < W):
//
//     s_e   = leaky_relu(alpha_src[src(e), h] + alpha_dst[i, h])
//     out[i, h, :] = sum_e exp(s_e) h[src(e), h, :] / sum_e exp(s_e)
//
// written for all B*W rows, rows with no edges as zeros.  alpha_src is a
// given (N, H) table, or the GATv1 projection sum_d h[n, h, d] * a[h, d] of
// the (H, D) vector a (the mode GATConv uses).
//
// What the TPU kernel did and what changes here.
// - The Pallas kernel consumes a pre-gathered (T, C, H*D) tensor (XLA did
//   the gather).  At ogbn-products size that is 64M lanes x 256 columns,
//   65 GB in f32.  Here every lane reads its own h[src] row segment, so
//   nothing of that size exists.
// - The TPU carries a block's (W, H*D) tile across sequential grid steps.
//   Here one CUDA block owns one (row block, head) pair: a W x D f32 tile in
//   shared memory (64 KB at W=256, D=64; the full 256-column f32 tile would
//   not fit), and the chunks of its row block become a loop inside it.
//   Only the head's D columns of each row are read.
// - Stabilisation is the TPU kernel's: each chunk's logits are shifted by
//   the chunk's max M over its valid lanes (the TPU takes it over the pad
//   lanes too; the shift cancels in out/z), and the block keeps one running
//   max m in a register, rescaling its tile only when M > m.  Each chunk
//   is therefore traversed twice: the max pass reads 12 bytes per lane
//   (local_row, edge_src, alpha_src[src, h]), the accumulation pass reads
//   the rows.
// - The TPU's vec kernel projects alpha_src per lane, (C, H*D) @ (H*D, H),
//   on rows it has gathered anyway.  Here the max pass needs alpha_src
//   before any row is read, and projecting per lane would read every row
//   twice; so the projection runs once per node in gat_alpha_src_kernel,
//   reading h once (N rows, not 62M lanes), and gives the same values.
// - Rounding follows the TPU kernel: in bf16 the projection multiplies bf16
//   h by bf16-rounded a with f32 accumulation, a table alpha_src is rounded
//   to bf16, and each lane's term is bf16(h * bf16(e)); every sum is f32.
//   In f32 everything is true f32 (no tensor cores, no TF32).
//
// Bound on an H100 (3.35 TB/s).  Inputs read once: h (N*H*D in the compute
// dtype), lane metadata (T*C*8), alpha_dst (N*H*4), output (B*W*H*D*4):
// 5.6 GB at products size in f32, 1.65 ms.  The operations (about 2 per
// lane and column, plus one exp per lane and head) are far below the f32
// rate: the kernel is bound by bytes.  A gather cannot reach that: each lane
// reads its row, lanes x H*D x bytes in all.  What the design does about
// it: pad lanes are dropped by a warp ballot before any row read; each warp
// reads a lane's D columns as consecutive 4- or 2-byte loads across its 32
// threads; eight lanes' loads are in flight before their adds; the H heads
// of a row block are adjacent in the grid, so the lane metadata and hub rows
// come from L2 after the first head.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;            // 16 warps per CUDA block
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;               // lanes loaded before their adds
constexpr int kMaxD = 128;               // columns per head: 4 per thread
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// v rounded to the compute dtype T, as a float.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float leaky_relu(float s, float slope) {
  return s > 0.f ? s : slope * s;
}

// alpha_src[n, h] = sum_d h[n, h, d] * round(a[h, d]), f32 sum; one warp
// per (node, head).
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
#pragma unroll
  for (int o = 16; o; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
  if (lane == 0) alpha_src[w] = acc;
}

// Max of v over the CUDA block, returned to every thread.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : -CUDART_INF_F;
#pragma unroll
    for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
    if (lane == 0) red[kWarps] = v;
  }
  __syncthreads();
  return red[kWarps];
}

// up to D=64 three CUDA blocks share an SM (3 x 66 KB tiles at W=256)
template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads, kCols <= 2 ? 3 : 1)
gat_packed_kernel(const T* __restrict__ x, const float* __restrict__ alpha_src,
                  int round_alpha, const float* __restrict__ alpha_dst,
                  int ad_rows, const int32_t* __restrict__ edge_src,
                  const int32_t* __restrict__ local_row,
                  const int32_t* __restrict__ block_start, int C, int W,
                  int H, int D, float slope, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* acc = smem;                     // W x D tile
  float* z = acc + W * D;                // W row sums
  float* ad = z + W;                     // W alpha_dst of this head
  __shared__ float red[kWarps + 1];
  const int b = blockIdx.x / H;          // the H heads of a block are adjacent
  const int hd = blockIdx.x % H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t HD = static_cast<int64_t>(H) * D;

  for (int i = threadIdx.x; i < W * D; i += kThreads) acc[i] = 0.f;
  for (int r = threadIdx.x; r < W; r += kThreads) {
    const int64_t row = static_cast<int64_t>(b) * W + r;
    z[r] = 0.f;
    ad[r] = row < ad_rows ? alpha_dst[row * H + hd] : 0.f;
  }
  __syncthreads();

  auto logit = [&](int src, int r) {
    float a = alpha_src[static_cast<int64_t>(src) * H + hd];
    if (round_alpha) a = round_to<__nv_bfloat16>(a);
    return leaky_relu(a + ad[r], slope);
  };

  float m = -CUDART_INF_F;               // running max, the same in every thread
  const int t_end = block_start[b + 1];
  for (int t = block_start[b]; t < t_end; ++t) {
    const int64_t e0 = static_cast<int64_t>(t) * C;
    // pass 1: the chunk's max logit over its valid lanes
    float mx = -CUDART_INF_F;
    for (int i = threadIdx.x; i < C; i += kThreads) {
      const int r = local_row[e0 + i];
      if (r < W) mx = fmaxf(mx, logit(edge_src[e0 + i], r));
    }
    mx = block_max(mx, red);
    if (mx == -CUDART_INF_F) continue;   // pad lanes only
    if (mx > m) {                        // rescale the tile to the new max
      const float scale = expf(m - mx);  // 0 while the tile is empty
      for (int i = threadIdx.x; i < W * D; i += kThreads) acc[i] *= scale;
      for (int r = threadIdx.x; r < W; r += kThreads) z[r] *= scale;
      m = mx;
      __syncthreads();
    }
    const float rc = expf(mx - m);

    // pass 2: add e * h[src] into the tile, e = exp(s - M); C % 32 == 0
    for (int64_t base = e0 + warp * 32; base < e0 + C;
         base += kThreads) {
      const int my_row = local_row[base + lane];
      const int my_src = edge_src[base + lane];
      float my_e = 0.f;
      if (my_row < W) {
        my_e = expf(logit(my_src, my_row) - mx);
        atomicAdd(z + my_row, my_e * rc);
      }
      // pad lanes carry local_row == W (and edge_src == 0): dropped here
      unsigned live = __ballot_sync(kFull, my_row < W);
      while (live) {                     // warp-uniform loop
        int rows[kUnroll];
        float v[kUnroll][kCols];
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          rows[q] = -1;
          if (live) {                    // warp-uniform branch
            const int j = __ffs(live) - 1;
            live &= live - 1;
            rows[q] = __shfl_sync(kFull, my_row, j);
            const int64_t src = __shfl_sync(kFull, my_src, j);
            const float ew = round_to<T>(__shfl_sync(kFull, my_e, j));
            const T* p = x + src * HD + hd * D;
#pragma unroll
            for (int k = 0; k < kCols; ++k) {
              const int c = lane + 32 * k;
              v[q][k] = c < D ? round_to<T>(to_float(p[c]) * ew) * rc : 0.f;
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kUnroll; ++q) {
          if (rows[q] < 0) continue;
          float* ar = acc + rows[q] * D;
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            const int c = lane + 32 * k;
            if (c < D) atomicAdd(ar + c, v[q][k]);
          }
        }
      }
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < W * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const float zr = z[r];
    out[(static_cast<int64_t>(b) * W + r) * HD + hd * D + c] =
        zr > 0.f ? acc[i] / fmaxf(zr, 1e-20f) : 0.f;
  }
}

template <typename T, int kCols>
cudaError_t launch_main(const void* x, const float* alpha_src, int round_alpha,
                        const float* alpha_dst, int ad_rows,
                        const int32_t* edge_src, const int32_t* local_row,
                        const int32_t* block_start, int num_blocks, int C,
                        int W, int H, int D, float slope, float* out,
                        cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(W) * D + 2 * W) * sizeof(float);
  auto kernel = gat_packed_kernel<T, kCols>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int64_t grid = static_cast<int64_t>(num_blocks) * H;
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
      static_cast<const T*>(x), alpha_src, round_alpha, alpha_dst, ad_rows,
      edge_src, local_row, block_start, C, W, H, D, slope, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, float* alpha_src, const float* avec,
                   const float* alpha_dst, int ad_rows,
                   const int32_t* edge_src, const int32_t* local_row,
                   const int32_t* block_start, int N, int num_blocks, int C,
                   int W, int H, int D, float slope, float* out,
                   cudaStream_t stream) {
  if (avec) {                            // the projection, once per node
    const int64_t threads = static_cast<int64_t>(N) * H * 32;
    const int64_t grid = (threads + 255) / 256;
    if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
    gat_alpha_src_kernel<T><<<static_cast<unsigned>(grid), 256, 0, stream>>>(
        static_cast<const T*>(x), avec, N, H, D, alpha_src);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  // a given table rides the gather in the compute dtype on the TPU
  const int round_alpha = avec == nullptr && sizeof(T) == 2;
  if (D <= 32)
    return launch_main<T, 1>(x, alpha_src, round_alpha, alpha_dst, ad_rows,
                             edge_src, local_row, block_start, num_blocks, C,
                             W, H, D, slope, out, stream);
  if (D <= 64)
    return launch_main<T, 2>(x, alpha_src, round_alpha, alpha_dst, ad_rows,
                             edge_src, local_row, block_start, num_blocks, C,
                             W, H, D, slope, out, stream);
  return launch_main<T, 4>(x, alpha_src, round_alpha, alpha_dst, ad_rows,
                           edge_src, local_row, block_start, num_blocks, C,
                           W, H, D, slope, out, stream);
}

}  // namespace

extern "C" {

// x: (N, H*D) row-major, f32 (x_is_bf16 == 0) or bf16; alpha_src: (N, H)
// f32, the given table when alpha_src_vec is null, else written with the
// projection of alpha_src_vec (H, D) f32; alpha_dst: (ad_rows, H) f32 (rows
// past ad_rows read 0); edge_src, local_row: (T, C) int32; block_start:
// (B+1,) int32; out: (B*W, H*D) f32.  Needs C % 32 == 0 and D <= 128.
// Launches on `stream`; returns the cudaError_t of the launches (0 on
// success).  Does not synchronise.
int tgt_gat_packed(const void* x, int x_is_bf16, float* alpha_src,
                   const float* alpha_src_vec, const float* alpha_dst,
                   int ad_rows, const int32_t* edge_src,
                   const int32_t* local_row, const int32_t* block_start,
                   int N, int num_blocks, int C, int W, int H, int D,
                   float negative_slope, float* out, void* stream) {
  if (N <= 0 || num_blocks <= 0 || C <= 0 || C % 32 || W <= 0 || H <= 0 ||
      D <= 0 || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      x_is_bf16
          ? launch<__nv_bfloat16>(x, alpha_src, alpha_src_vec, alpha_dst,
                                  ad_rows, edge_src, local_row, block_start, N,
                                  num_blocks, C, W, H, D, negative_slope, out,
                                  s)
          : launch<float>(x, alpha_src, alpha_src_vec, alpha_dst, ad_rows,
                          edge_src, local_row, block_start, N, num_blocks, C,
                          W, H, D, negative_slope, out, s);
  return static_cast<int>(err);
}

const char* tgt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
