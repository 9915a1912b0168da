// Flash-attention (prefill) kernel for Hopper (sm_90a): blocked
// online-softmax attention over a whole sequence, with GQA.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// src/repro/kernels/flash_attention/kernel.py (`_attn_kernel`).  For batch
// row b, query head h (KV head h / G, G = H / KV, the KV heads never
// repeated) and query position i:
//     s_ij = scale * q[b,h,i] . k[b,h/G,j],
//     valid_ij = j < S && (!causal || i >= j) && (window < 0 || i - j < window),
//     out[b,h,i] = sum_j p_ij v[b,h/G,j] / max(sum_j p_ij, 1e-30),
//     p_ij = valid_ij ? exp(s_ij - m_i) : 0,  m_i = max(-1e30, max valid s_ij).
// The window has no lower bound when causal is off (future keys inside it
// stay visible), and a row with no valid key (window 0) gives zeros, as the
// Pallas kernel does.  Arithmetic is fp32 whatever the storage type (fp32
// or bf16); the output is written in the storage type.
//
// What bounds it on an H100: a kept (query, key) pair costs 4 dh flops,
// and every K and V row is read once for all the queries that see it, so
// at prefill lengths the operations bound it (at the kernel benchmark's
// shape, 33.7 MFLOP against 0.79 MB: 0.50 us of fp32 flops, 0.23 us of
// bytes); in bf16 the bound is the tensor cores' rate.  This kernel does
// its products on the CUDA cores in fp32, so it cannot reach a bf16 bound:
// it is the simple, exact version, and tensor-core tiles (mma / wgmma),
// TMA and pipelining are later work.
//
// Design.  The TPU kernel runs a grid of (B*H, q blocks, kv blocks) in
// order on one core and carries (m, l, acc) in scratch across kv blocks.
// Here one block of 256 threads owns one (batch row, KV head, q tile) and
// GB of the query heads that share the KV head (GB = 1, 2, 4 or 8, the
// smallest that holds G, with ceil(G / 8) blocks per KV head above 8), so
// each K and V tile is read once for the whole GQA group.  The block
// holds 64 query rows (GB heads x 64 / GB positions) in shared memory and
// walks the K/V tiles (64 keys, 32 at dh 128) in a loop:
//   1. K and V tiles into shared memory (16-byte loads, rows past S zero);
//   2. scores: each thread a 4 x (BK / 16) patch of the 64 x BK tile, fp32
//      dot products, masked entries -inf;
//   3. online softmax: four threads per row raise the running max, turn
//      scores into p and rescale the running sum;
//   4. each thread rescales its 4 x (dh / 16) patch of the accumulator and
//      adds p . V.
// A tile wholly above the diagonal, or wholly outside the window, is
// skipped, as the Pallas kernel's pl.when skips it.  The running max
// starts at -1e30, not -inf, so exp(m_prev - m_new) is never NaN.  Rows are
// padded by one float in shared memory so that the threads of a warp read
// different banks.  Shared memory exceeds 48 KB (67 KB at dh 64, 75 KB at
// dh 128), so the launch raises the kernel's dynamic shared-memory limit.
//
// Plain C interface (loaded with ctypes): the caller allocates the output,
// the launch goes on the caller's stream, nothing synchronises, and the
// return value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;       // 16 x 16 threads
constexpr int kRows = 64;           // query rows of a block (heads x positions)
constexpr float kNegInf = -1e30f;   // running max before any valid key

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

// N bf16 values from 16-byte aligned p, as fp32 (the 16 bits are the high
// half of the fp32 value, so the conversion is exact).
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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(uint16_t* p, float x) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

template <int DH, int BK>
constexpr int smem_floats() {
  // Q (64 x dh+1), K (BK x dh+1), V (BK x dh), scores (64 x BK+1),
  // running max, running sum and rescale factor (64 each)
  return kRows * (DH + 1) + BK * (DH + 1) + BK * DH + kRows * (BK + 1) +
         3 * kRows;
}

template <typename T, int DH, int BK, int GB>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int KV, int S, int causal, int window, float scale) {
  constexpr int BQ = kRows / GB;                      // positions per block
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = DH / kVec;                  // 16-byte loads a row
  constexpr int QS = DH + 1, KS = DH + 1, SS = BK + 1;  // padded strides
  constexpr int TN = BK / 16;                         // score columns a thread
  constexpr int DN = DH / 16;                         // output columns a thread
  static_assert(DH % kVec == 0 && BK % 16 == 0 && DH % 16 == 0,
                "unsupported tile");

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kRows * QS;
  float* Vs = Ks + BK * KS;
  float* Ss = Vs + BK * DH;
  float* m_run = Ss + kRows * SS;
  float* l_run = m_run + kRows;
  float* alpha = l_run + kRows;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int G = H / KV;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int g0 = blockIdx.z * GB;
  const size_t kv0 = (static_cast<size_t>(b) * KV + kvh) * S * DH;

  // the block's query rows: row r is head g0 + r / BQ at position
  // q0 + r % BQ (zeros past S or past the group's last head)
  for (int c = tid; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks, d0 = (c % kChunks) * kVec;
    const int g = g0 + r / BQ, pos = q0 + r % BQ;
    float f[kVec];
    if (g < G && pos < S) {
      load_vec(q + ((static_cast<size_t>(b) * H + kvh * G + g) * S + pos) *
                       DH + d0, f);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) Qs[r * QS + d0 + i] = f[i];
  }
  if (tid < kRows) {
    m_run[tid] = kNegInf;
    l_run[tid] = 0.f;
  }
  float acc[4][DN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;

  const int q_last = q0 + BQ - 1;
  for (int k0 = 0; k0 < S; k0 += BK) {
    if (causal && k0 > q_last) break;            // the rest lies above
    if (window >= 0 && q0 - (k0 + BK - 1) >= window) continue;
    __syncthreads();    // the last tile's readers are done with Ks, Vs, Ss

    // ---- 1. K and V tiles ------------------------------------------------
    for (int c = tid; c < BK * kChunks; c += kThreads) {
      const int r = c / kChunks, d0 = (c % kChunks) * kVec;
      float fk[kVec], fv[kVec];
      if (k0 + r < S) {
        const size_t off = kv0 + static_cast<size_t>(k0 + r) * DH + d0;
        load_vec(k + off, fk);
        load_vec(v + off, fv);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) fk[i] = fv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        Ks[r * KS + d0 + i] = fk[i];
        Vs[r * DH + d0 + i] = fv[i];
      }
    }
    __syncthreads();

    // ---- 2. scores, masked -----------------------------------------------
    float s[4][TN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qa[4], kb[TN];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < TN; ++j) kb[j] = Ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r % BQ;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = tx + 16 * j, kpos = k0 + c;
        const bool valid = kpos < S && (!causal || qpos >= kpos) &&
                           (window < 0 || qpos - kpos < window);
        Ss[r * SS + c] = valid ? s[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // ---- 3. online softmax, four threads a row ---------------------------
    {
      constexpr int CP = BK / 4;
      const int r = tid >> 2, part = tid & 3;
      float* srow = Ss + r * SS + part * CP;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < CP; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_run[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CP; ++c) {
        const float sv = srow[c];
        const float p = sv == -INFINITY ? 0.f : expf(sv - m_new);
        srow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();     // every thread of the row has read m_run[r]
      if (part == 0) {
        const float a = expf(m_prev - m_new);
        alpha[r] = a;
        l_run[r] = l_run[r] * a + sum;
        m_run[r] = m_new;
      }
    }
    __syncthreads();

    // ---- 4. acc = acc * alpha + p . V ------------------------------------
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vb[DN];
#pragma unroll
      for (int j = 0; j < DN; ++j) vb[j] = Vs[c * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ss[(ty + 16 * i) * SS + c];
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(p, vb[j], acc[i][j]);
      }
    }
  }
  __syncthreads();      // the final l_run (and its first values) visible

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int g = g0 + r / BQ, pos = q0 + r % BQ;
    if (g < G && pos < S) {
      const float l = fmaxf(l_run[r], 1e-30f);
      T* o = out + ((static_cast<size_t>(b) * H + kvh * G + g) * S + pos) *
                       DH;
#pragma unroll
      for (int j = 0; j < DN; ++j) store(o + tx + 16 * j, acc[i][j] / l);
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, H, KV, S, causal, window;
  float scale;
};

template <typename T, int DH, int BK, int GB>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int kSmem = smem_floats<DH, BK>() * static_cast<int>(sizeof(float));
  auto kernel = flash_attention_kernel<T, DH, BK, GB>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  const int G = a.H / a.KV;
  constexpr int BQ = kRows / GB;
  const dim3 grid((a.S + BQ - 1) / BQ, a.B * a.KV, (G + GB - 1) / GB);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.H, a.KV, a.S,
      a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// heads per block: the smallest of 1, 2, 4, 8 that holds G (8 above that)
template <typename T, int DH, int BK>
cudaError_t launch_heads(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.KV;
  if (G <= 1) return launch<T, DH, BK, 1>(a, stream);
  if (G <= 2) return launch<T, DH, BK, 2>(a, stream);
  if (G <= 4) return launch<T, DH, BK, 4>(a, stream);
  return launch<T, DH, BK, 8>(a, stream);
}

template <typename T>
cudaError_t launch_dim(const Args& a, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch_heads<T, 16, 64>(a, stream);
    case 32: return launch_heads<T, 32, 64>(a, stream);
    case 64: return launch_heads<T, 64, 64>(a, stream);
    case 128: return launch_heads<T, 128, 32>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q and out (B, H, S, dh), k and v (B, KV, S, dh): contiguous, 16-byte
// aligned, all fp32 (is_bf16 = 0) or all bf16 (is_bf16 = 1); dh 16, 32, 64
// or 128.  window < 0: no window.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int H, int KV, int S, int dh,
                           int causal, int window, float scale, int is_bf16,
                           void* stream) {
  if (B < 1 || H < 1 || KV < 1 || S < 1 || H % KV != 0 ||
      B * KV > 65535 || (dh != 16 && dh != 32 && dh != 64 && dh != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, out, B, H, KV, S, causal, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = is_bf16 ? launch_dim<uint16_t>(a, dh, s)
                                : launch_dim<float>(a, dh, s);
  return static_cast<int>(e);
}

}  // extern "C"
