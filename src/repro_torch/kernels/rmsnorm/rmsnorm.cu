// RMSNorm kernel for Hopper (sm_90a): per row of x (N, d),
//     out = x * rsqrt(mean(x^2) + eps) * (1 + scale),
// the sum of squares and the arithmetic in fp32, the result written in x's
// storage type (fp32 or bf16); scale is fp32 or x's type.
//
// Replaces the Pallas TPU kernel `rmsnorm` in
// src/repro/kernels/rmsnorm/kernel.py (`_rmsnorm_kernel`).  The TPU kernel
// pads N up to a multiple of its row block and keeps a block of rows in
// VMEM; here rows are walked with a stride and nothing is padded.
//
// What bounds it on an H100: each element is read once and written once
// for 4 flops, far below the ~20 fp32 flops per byte where the CUDA cores
// would limit, so the kernel is bound by the bytes of x and out.  The
// design is about moving each byte once with enough bytes in flight.
//
// Design (the path and K come from `ops.plan`, in Python; the grid from
// `ops.resident`, the occupancy calculator below):
//   - warp path: one warp a row, 4 warps a block.  A lane holds K 16-byte
//     chunks of its row (4 fp32 or 8 bf16 values each; chunk c of the row
//     at lane c % 32), all K loads issued before the sum of squares, so a
//     warp has 512 K bytes in flight.  The output is computed from the
//     same registers: x is read once.  K is a template parameter.
//   - block path: rows wider than the warp path's K take one block of 8
//     warps a row, still in registers (chunk c at thread c % 256); the
//     warps' sums meet in shared memory and every thread adds them in the
//     same fixed order.
//   - loop path: widths that are not a multiple of the 16-byte vector, and
//     rows wider than the block path holds, take the two-pass loop (one
//     warp a row, the row read again for the output).
// In every path the grid is at most the blocks that fit the card at once
// (rmsnorm_blocks_per_sm); a warp (or block) walks rows with a stride and
// keeps 1 + scale for its chunks in registers across rows, so scale is
// read once per warp.  x is loaded and out stored with the streaming hint
// (evict first): each byte is touched once.  K stops where ptxas would
// spill (bf16 warp path: K 11; at K 12 it keeps a thread under 168
// registers and spills).  Sums go across the warp with shuffles in a fixed
// order, so a result repeats exactly.
//
// Plain C interface (loaded with ctypes): the caller allocates the output,
// the launch goes on the caller's stream, nothing synchronises, and the
// return value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace {

constexpr int kWarpThreads = 128;    // warp path: 4 rows a block
constexpr int kBlockThreads = 256;   // block path: 8 warps on one row
constexpr int kLoopThreads = 256;    // loop path: 8 rows a block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(uint16_t x) {
  return __uint_as_float(static_cast<unsigned>(x) << 16);   // exact
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(uint16_t* p, float x) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo)))
         | (static_cast<unsigned>(
                __bfloat16_as_ushort(__float2bfloat16_rn(hi)))
            << 16);
}

// A 16-byte chunk of a row: its values as fp32, and back.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void unpack(const uint4& c,
                                                float (&f)[4]) {
    f[0] = __uint_as_float(c.x);
    f[1] = __uint_as_float(c.y);
    f[2] = __uint_as_float(c.z);
    f[3] = __uint_as_float(c.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Chunk<uint16_t> {
  static constexpr int n = 8;
  static __device__ __forceinline__ void unpack(const uint4& c,
                                                float (&f)[8]) {
    const unsigned w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[2 * j] = __uint_as_float(w[j] << 16);
      f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&f)[8]) {
    return make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]),
                      bf16x2(f[4], f[5]), bf16x2(f[6], f[7]));
  }
};

// N values from 16-byte aligned p, as fp32.
template <int N>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float (&f)[N]) {
  static_assert(N % 4 == 0, "fp32 values load in float4");
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p + i));
    f[i] = x.x;
    f[i + 1] = x.y;
    f[i + 2] = x.z;
    f[i + 3] = x.w;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const uint16_t* __restrict__ p,
                                         float (&f)[N]) {
  static_assert(N % 8 == 0, "bf16 values load 8 in 16 bytes");
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    float g[8];
    Chunk<uint16_t>::unpack(__ldg(reinterpret_cast<const uint4*>(p + i)), g);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[i + j] = g[j];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Warp path (WARPS == 1: a warp a row, THREADS / 32 rows a block) and
// block path (WARPS == THREADS / 32: the block on one row).  T: storage
// type of x and out; S: storage type of scale; K: 16-byte chunks a thread
// holds.  Requires d a multiple of the vector width and d / vector <=
// K * 32 * WARPS.
template <typename T, typename S, int K, int WARPS, int THREADS>
__global__ void __launch_bounds__(THREADS)
rmsnorm_rows(const T* __restrict__ x, const S* __restrict__ scale,
             T* __restrict__ out, int N, int d, float eps) {
  constexpr int V = Chunk<T>::n;
  constexpr int kTeam = 32 * WARPS;               // threads on one row
  constexpr int kTeams = THREADS / kTeam;         // rows a block at a time
  static_assert(THREADS % kTeam == 0, "whole teams a block");
  __shared__ float partial[2][WARPS];             // block path only

  const int t = threadIdx.x % kTeam;
  const int first = blockIdx.x * kTeams + threadIdx.x / kTeam;
  const int stride = gridDim.x * kTeams;
  if (first >= N) return;                         // the whole team leaves
  const int chunks = d / V;

  // 1 + scale for this thread's chunks, once for all its rows
  float s1[K][V];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = t + kTeam * j;
    if (c < chunks) {
      load_vec(scale + static_cast<size_t>(c) * V, s1[j]);
#pragma unroll
      for (int i = 0; i < V; ++i) s1[j][i] = 1.f + s1[j][i];
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) s1[j][i] = 0.f;
    }
  }

  int parity = 0;
  for (int row = first; row < N; row += stride) {
    const uint4* xr = reinterpret_cast<const uint4*>(
        x + static_cast<size_t>(row) * d);
    uint4 r[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = t + kTeam * j;
      // x is read once: streaming loads (evict first)
      r[j] = c < chunks ? __ldcs(xr + c) : make_uint4(0u, 0u, 0u, 0u);
    }
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float f[V];
      Chunk<T>::unpack(r[j], f);
#pragma unroll
      for (int i = 0; i < V; ++i) ss = fmaf(f[i], f[i], ss);
    }
    ss = warp_sum(ss);
    if constexpr (WARPS > 1) {
      // a buffer a row, alternating: a warp writes row i + 2's buffer only
      // after every warp passed row i + 1's barrier, i.e. read row i's
      if ((t & 31) == 0) partial[parity][t >> 5] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) ss += partial[parity][w];
      parity ^= 1;
    }
    const float rs = rsqrtf(ss / static_cast<float>(d) + eps);
    uint4* orow = reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * d);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int c = t + kTeam * j;
      if (c < chunks) {
        float f[V];
        Chunk<T>::unpack(r[j], f);
#pragma unroll
        for (int i = 0; i < V; ++i) f[i] = f[i] * rs * s1[j][i];
        __stcs(orow + c, Chunk<T>::pack(f));
      }
    }
  }
}

// Loop path: one warp a row, the row read twice; VEC: 16-byte loads (d a
// multiple of the vector width), else one value a lane at a time.
template <typename T, typename S, bool VEC>
__global__ void __launch_bounds__(kLoopThreads)
rmsnorm_loop(const T* __restrict__ x, const S* __restrict__ scale,
             T* __restrict__ out, int N, int d, float eps) {
  constexpr int kVec = Chunk<T>::n;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * (kLoopThreads / 32);
  for (int row = blockIdx.x * (kLoopThreads / 32) + (threadIdx.x >> 5);
       row < N; row += stride) {
    const T* xr = x + static_cast<size_t>(row) * d;
    T* orow = out + static_cast<size_t>(row) * d;
    float ss = 0.f;
    if (VEC) {
      for (int c = lane * kVec; c < d; c += 32 * kVec) {
        float f[kVec];
        load_vec(xr + c, f);
#pragma unroll
        for (int i = 0; i < kVec; ++i) ss = fmaf(f[i], f[i], ss);
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        const float f = to_float(xr[c]);
        ss = fmaf(f, f, ss);
      }
    }
    ss = warp_sum(ss);
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    if (VEC) {
      for (int c = lane * kVec; c < d; c += 32 * kVec) {
        float f[kVec], s[kVec];
        load_vec(xr + c, f);
        load_vec(scale + c, s);
#pragma unroll
        for (int i = 0; i < kVec; ++i) f[i] = f[i] * r * (1.f + s[i]);
        *reinterpret_cast<uint4*>(orow + c) = Chunk<T>::pack(f);
      }
    } else {
      for (int c = lane; c < d; c += 32)
        store(orow + c, to_float(xr[c]) * r * (1.f + to_float(scale[c])));
    }
  }
}

// K values each path is built for (ops.WARP_K_MAX, ops.BLOCK_KS).
template <typename T>
struct Ks;
template <>
struct Ks<float> {
  using warp = std::integer_sequence<int, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11,
                                     12, 13, 14, 15, 16>;
  using block = std::integer_sequence<int, 4, 8, 16>;
};
template <>
struct Ks<uint16_t> {
  using warp = std::integer_sequence<int, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10,
                                     11>;
  using block = std::integer_sequence<int, 2, 4, 8, 12>;
};

enum Path { kWarp = 0, kBlock = 1, kLoop = 2 };

// The kernel of (path, K) as a function pointer and its block size, or
// nullptr for a K the library is not built for.
template <typename T, typename S, int WARPS, int THREADS, int... K>
void* pick_rows(int k, int* threads, std::integer_sequence<int, K...>) {
  void* fn = nullptr;
  ((k == K ? (fn = reinterpret_cast<void*>(
                  rmsnorm_rows<T, S, K, WARPS, THREADS>),
              *threads = THREADS, 0)
           : 0),
   ...);
  return fn;
}

template <typename T, typename S>
void* pick(int path, int k, int d, int* threads) {
  if (path == kWarp)
    return pick_rows<T, S, 1, kWarpThreads>(k, threads,
                                             typename Ks<T>::warp{});
  if (path == kBlock)
    return pick_rows<T, S, kBlockThreads / 32, kBlockThreads>(
        k, threads, typename Ks<T>::block{});
  if (path == kLoop) {
    *threads = kLoopThreads;
    return d % Chunk<T>::n == 0
               ? reinterpret_cast<void*>(rmsnorm_loop<T, S, true>)
               : reinterpret_cast<void*>(rmsnorm_loop<T, S, false>);
  }
  return nullptr;
}

void* pick_kernel(int x_bf16, int scale_bf16, int path, int k, int d,
                  int* threads) {
  if (!x_bf16) return scale_bf16 ? nullptr : pick<float, float>(path, k, d,
                                                                threads);
  return scale_bf16 ? pick<uint16_t, uint16_t>(path, k, d, threads)
                    : pick<uint16_t, float>(path, k, d, threads);
}

}  // namespace

extern "C" {

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x and out (N, d), scale (d,): contiguous, 16-byte aligned.  x_bf16: x and
// out are bf16 (else fp32); scale_bf16: scale is bf16 (else fp32; a bf16
// scale needs bf16 x).  path (0 warp, 1 block, 2 loop) and k as ops.plan
// chooses them, grid as ops.rmsnorm sizes it; the warp and block paths need d a multiple of the
// vector width (4 fp32, 8 bf16) with d / vector <= k * 32 (warp) or
// k * 256 (block).
int rmsnorm_launch(const void* x, const void* scale, void* out, int N, int d,
                   float eps, int x_bf16, int scale_bf16, int path, int k,
                   int grid, void* stream) {
  int threads = 0;
  void* fn = pick_kernel(x_bf16, scale_bf16, path, k, d, &threads);
  const int vec = x_bf16 ? 8 : 4;
  const long long team = path == kWarp ? 32 : kBlockThreads;
  if (fn == nullptr || N < 1 || d < 1 || grid < 1 ||
      (path != kLoop &&
       (d % vec != 0 || static_cast<long long>(d / vec) > team * k))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* args[] = {&x, &scale, &out, &N, &d, &eps};
  cudaError_t e = cudaLaunchKernel(fn, dim3(grid), dim3(threads), args, 0,
                                   static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the kernel of (path, k) for rows of width d (d picks the loop
// path's kernel) that fit one SM at once (the occupancy calculator), or -1
// for a (path, k) the library is not built for; ops.resident sizes the
// grid with it.
int rmsnorm_blocks_per_sm(int x_bf16, int scale_bf16, int path, int k,
                          int d) {
  int threads = 0, blocks = 0;
  void* fn = pick_kernel(x_bf16, scale_bf16, path, k, d, &threads);
  if (fn == nullptr) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, 0)
      != cudaSuccess)
    return -1;
  return blocks;
}

}  // extern "C"
