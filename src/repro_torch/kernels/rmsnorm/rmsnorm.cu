// RMSNorm kernel for Hopper (sm_90a): per row of x (N, d),
//     out = x * rsqrt(mean(x^2) + eps) * (1 + scale),
// the sum of squares and the arithmetic in fp32, the result written in x's
// storage type (fp32 or bf16); scale is fp32 or x's type.
//
// Replaces the Pallas TPU kernel `rmsnorm` in
// src/repro/kernels/rmsnorm/kernel.py (`_rmsnorm_kernel`).  The TPU kernel
// pads N up to a multiple of its row block and keeps a block of rows in
// VMEM; here the ragged last block is masked instead (a warp whose row is
// past N returns), so nothing is padded or copied.
//
// What bounds it on an H100: each element is read once and written once
// for 4 flops, far below the ~20 fp32 flops per byte where the CUDA cores
// would limit, so the kernel is bound by the bytes of x and out.
//
// Design.  One warp per row, 8 rows per block of 256 threads.  Each lane
// reads 16 bytes at a time (4 fp32 or 8 bf16 values), neighbouring lanes
// neighbouring addresses, when d is a multiple of that vector width; a
// scalar path takes any other d.  Pass 1 sums the squares in fp32 per
// lane, then across the warp with shuffles in a fixed order (the result
// repeats exactly); pass 2 reads the row again, mostly from L1 or L2 (a
// row is 10 KB at d 2560 in fp32), and writes the scaled values.  Keeping the row in
// registers, and a block per row with more warps when N is small, are
// later work.
//
// Plain C interface (loaded with ctypes): the caller allocates the output,
// the launch goes on the caller's stream, nothing synchronises, and the
// return value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(uint16_t x) {
  return __uint_as_float(static_cast<unsigned>(x) << 16);   // exact
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(uint16_t* p, float x) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

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
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p + i));
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[i + 2 * j] = __uint_as_float(w[j] << 16);
      f[i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

// N values to 16-byte aligned p.
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&f)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
}

template <int N>
__device__ __forceinline__ void store_vec(uint16_t* p, const float (&f)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = static_cast<unsigned>(
                 __bfloat16_as_ushort(__float2bfloat16_rn(f[i + 2 * j]))) |
             (static_cast<unsigned>(__bfloat16_as_ushort(
                  __float2bfloat16_rn(f[i + 2 * j + 1])))
              << 16);
    *reinterpret_cast<uint4*>(p + i) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// T: storage type of x and out; S: storage type of scale.  VEC: the
// 16-byte path (d a multiple of 16 / sizeof(T)); otherwise scalar.
template <typename T, typename S, bool VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, int N, int d, float eps) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= N) return;                       // the whole warp leaves
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
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  if (VEC) {
    for (int c = lane * kVec; c < d; c += 32 * kVec) {
      float f[kVec], s[kVec];
      load_vec(xr + c, f);
      load_vec(scale + c, s);
#pragma unroll
      for (int i = 0; i < kVec; ++i) f[i] = f[i] * r * (1.f + s[i]);
      store_vec(orow + c, f);
    }
  } else {
    for (int c = lane; c < d; c += 32)
      store(orow + c, to_float(xr[c]) * r * (1.f + to_float(scale[c])));
  }
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, void* out, int N, int d,
                   float eps, cudaStream_t stream) {
  const dim3 grid((N + kRowsPerBlock - 1) / kRowsPerBlock);
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  if (d % kVec == 0) {
    rmsnorm_kernel<T, S, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale),
        static_cast<T*>(out), N, d, eps);
  } else {
    rmsnorm_kernel<T, S, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale),
        static_cast<T*>(out), N, d, eps);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x and out (N, d), scale (d,): contiguous, 16-byte aligned.  x_bf16: x and
// out are bf16 (else fp32); scale_bf16: scale is bf16 (else fp32; a bf16
// scale needs bf16 x).
int rmsnorm_launch(const void* x, const void* scale, void* out, int N, int d,
                   float eps, int x_bf16, int scale_bf16, void* stream) {
  if (N < 1 || d < 1 || (scale_bf16 && !x_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (!x_bf16) {
    e = launch<float, float>(x, scale, out, N, d, eps, s);
  } else if (scale_bf16) {
    e = launch<uint16_t, uint16_t>(x, scale, out, N, d, eps, s);
  } else {
    e = launch<uint16_t, float>(x, scale, out, N, d, eps, s);
  }
  return static_cast<int>(e);
}

}  // extern "C"
