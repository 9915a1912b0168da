// Fused exit-confidence kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `exit_confidence` in
// src/repro/kernels/exit_confidence/kernel.py (`_exit_conf_kernel`): for each
// row of h (N, d) it computes
//     logits = RMSNorm(h) * (1 + scale) @ W_out / temperature      (W_out: d x V)
// and returns only conf = 1 / sum(exp(logits - max)), pred = argmax (the first
// index of the maximum), max_logit and lse = max + log(sum).  The V-wide
// logits row never reaches device memory.
//
// What bounds it on an H100: every element of W_out is read once (4 d V
// bytes) for 2 N d V flops.  With N <= 8 rows that is at most 4 flops per byte,
// far below the ~20 fp32 flops per byte where the card's CUDA cores (67
// TFLOP/s fp32) rather than its memory (3.35 TB/s) would limit, so the kernel
// is bound by the bytes of W_out.  At the serving path's shapes (d = 128,
// V = 10) W_out is 5 KB and the kernel is bound by its launch.
//
// Design.  The TPU kernel walks vocab blocks in sequence on one core and
// carries (max, sum, argmax) in scratch between grid steps.  Hopper blocks run
// in parallel in no order, so the fold is split in two passes:
//   pass 1, grid (vocab slab, row block): a block normalises its (up to 8)
//     rows once into shared memory, transposed so one k gives all rows in two
//     float4 loads, then each thread takes one column of its 256-column slab
//     and streams that column of W_out down k (neighbouring threads on
//     neighbouring columns, so every load of a warp is one 128-byte line).
//     W_out is read once for all the rows of the block.  The block reduces
//     its columns' (max, sum, argmax) to one partial per (row, slab).
//   pass 2, one thread per row: folds the row's partials in slab order, then
//     clamps the sum at 1e-30 and writes conf, pred, max_logit and lse.
// Tie rule: whenever two partials merge, the greater max wins and on equal
// maxima the lower column index wins, so the result is the first index of
// the maximum, as in the TPU kernel (strictly greater block max wins, first
// index within a block) and in argmax.  No wgmma or TMA yet: at these row
// counts the product is a matrix-vector stream, and TMA tiling is later work.
//
// Plain C interface (loaded with ctypes): the caller allocates outputs and the
// partial buffers, the launch goes on the caller's stream, nothing
// synchronises, and the return value is cudaGetLastError() after the launches.

#include <cfloat>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;             // threads per block = columns per slab
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                  // rows per block (padded with zeros)
constexpr int kUnroll = 8;                // loads of W_out in flight per thread
constexpr int kMaxSmem = 227 * 1024;      // shared memory a block may use
constexpr int kStaticSmem = 2048;         // room kept for the static arrays
constexpr float kEmpty = -FLT_MAX;        // max of a partial that saw no column

// Merge partial (m2, l2, a2) into (m, l, a): max, sum of exp(x - max), argmax.
__device__ __forceinline__ void merge(float& m, float& l, int& a,
                                      float m2, float l2, int a2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  if (m2 > m || (m2 == m && a2 < a)) a = a2;
  m = mn;
}

__global__ void __launch_bounds__(kThreads)
exit_conf_partial(const float* __restrict__ h, const float* __restrict__ scale,
                  const float* __restrict__ w, float* __restrict__ part_m,
                  float* __restrict__ part_l, int* __restrict__ part_a,
                  int N, int d, int V, int n_slabs, float eps,
                  float temperature) {
  extern __shared__ float4 hn4[];         // [d][kRows] as 2 float4 per k
  float* hn = reinterpret_cast<float*>(hn4);
  __shared__ float red[kWarps][kRows];
  __shared__ float inv_rms[kRows];
  __shared__ float wm[kWarps][kRows];
  __shared__ float wl[kWarps][kRows];
  __shared__ int wa[kWarps][kRows];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slab = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int rows = min(kRows, N - row0);

  // ---- RMSNorm of the block's rows: sum of squares, block reduction -------
  float ss[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) ss[r] = 0.f;
  for (int k = tid; k < d; k += kThreads) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < rows) {
        const float x = h[(size_t)(row0 + r) * d + k];
        ss[r] = fmaf(x, x, ss[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float s = ss[r];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp][r] = s;
  }
  __syncthreads();
  if (tid < kRows) {
    float s = 0.f;
    for (int i = 0; i < kWarps; ++i) s += red[i][tid];
    inv_rms[tid] = 1.0f / sqrtf(s / (float)d + eps);
  }
  __syncthreads();
  for (int k = tid; k < d; k += kThreads) {
    const float g = 1.0f + scale[k];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      hn[k * kRows + r] =
          (r < rows) ? h[(size_t)(row0 + r) * d + k] * inv_rms[r] * g : 0.f;
    }
  }
  __syncthreads();

  // ---- this thread's column of the slab: logits for every row ------------
  float m[kRows], l[kRows];
  int a[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) { m[r] = kEmpty; l[r] = 0.f; a[r] = INT_MAX; }
  const int c = slab * kThreads + tid;
  if (c < V) {
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    const float* wc = w + c;
    int k = 0;
    for (; k + kUnroll <= d; k += kUnroll) {
      float wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) wv[u] = __ldg(wc + (size_t)(k + u) * V);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4 lo = hn4[(k + u) * 2], hi = hn4[(k + u) * 2 + 1];
        acc[0] = fmaf(lo.x, wv[u], acc[0]);
        acc[1] = fmaf(lo.y, wv[u], acc[1]);
        acc[2] = fmaf(lo.z, wv[u], acc[2]);
        acc[3] = fmaf(lo.w, wv[u], acc[3]);
        acc[4] = fmaf(hi.x, wv[u], acc[4]);
        acc[5] = fmaf(hi.y, wv[u], acc[5]);
        acc[6] = fmaf(hi.z, wv[u], acc[6]);
        acc[7] = fmaf(hi.w, wv[u], acc[7]);
      }
    }
    for (; k < d; ++k) {
      const float wk = __ldg(wc + (size_t)k * V);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(hn[k * kRows + r], wk, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) { m[r] = acc[r] / temperature; l[r] = 1.f; a[r] = c; }
  }

  // ---- block reduction to one partial per (row, slab) ---------------------
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float mr = m[r], lr = l[r];
    int ar = a[r];
    for (int off = 16; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, mr, off);
      const float l2 = __shfl_xor_sync(0xffffffffu, lr, off);
      const int a2 = __shfl_xor_sync(0xffffffffu, ar, off);
      merge(mr, lr, ar, m2, l2, a2);
    }
    if (lane == 0) { wm[warp][r] = mr; wl[warp][r] = lr; wa[warp][r] = ar; }
  }
  __syncthreads();
  if (tid < rows) {
    float mr = wm[0][tid], lr = wl[0][tid];
    int ar = wa[0][tid];
    for (int i = 1; i < kWarps; ++i) merge(mr, lr, ar, wm[i][tid], wl[i][tid], wa[i][tid]);
    const size_t o = (size_t)(row0 + tid) * n_slabs + slab;
    part_m[o] = mr;
    part_l[o] = lr;
    part_a[o] = ar;
  }
}

__global__ void exit_conf_finish(const float* __restrict__ part_m,
                                 const float* __restrict__ part_l,
                                 const int* __restrict__ part_a,
                                 float* __restrict__ conf, int* __restrict__ pred,
                                 float* __restrict__ max_logit,
                                 float* __restrict__ lse, int N, int n_slabs) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  const size_t base = (size_t)row * n_slabs;
  float m = part_m[base], l = part_l[base];
  int a = part_a[base];
  for (int s = 1; s < n_slabs; ++s) {
    // slabs in order: a strictly greater max moves the argmax, an equal one
    // keeps the earlier (lower) index
    const float ms = part_m[base + s], ls = part_l[base + s];
    const float mn = fmaxf(m, ms);
    l = l * expf(m - mn) + ls * expf(ms - mn);
    if (ms > m) a = part_a[base + s];
    m = mn;
  }
  l = fmaxf(l, 1e-30f);
  conf[row] = 1.0f / l;
  pred[row] = a;
  max_logit[row] = m;
  lse[row] = m + logf(l);
}

}  // namespace

extern "C" {

// Columns per slab: the partial buffers hold ceil(V / slab_width) per row.
int exit_confidence_slab_width() { return kThreads; }

// Largest hidden width d whose normalised rows fit in one block's shared memory.
int exit_confidence_max_dim() { return (kMaxSmem - kStaticSmem) / (kRows * (int)sizeof(float)); }

const char* exit_confidence_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int exit_confidence_launch(const float* h, const float* scale, const float* w,
                           float* part_m, float* part_l, int* part_a,
                           float* conf, int* pred, float* max_logit, float* lse,
                           int N, int d, int V, float eps, float temperature,
                           void* stream) {
  if (N < 1 || d < 1 || V < 1 || d > exit_confidence_max_dim()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_slabs = (V + kThreads - 1) / kThreads;
  const int smem = d * kRows * static_cast<int>(sizeof(float));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        exit_conf_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n_slabs, (N + kRows - 1) / kRows);
  exit_conf_partial<<<grid, kThreads, smem, s>>>(h, scale, w, part_m, part_l,
                                                 part_a, N, d, V, n_slabs, eps,
                                                 temperature);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  exit_conf_finish<<<(N + 127) / 128, 128, 0, s>>>(part_m, part_l, part_a, conf,
                                                   pred, max_logit, lse, N,
                                                   n_slabs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
