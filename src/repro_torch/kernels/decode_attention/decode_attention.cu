// Decode-attention kernel for Hopper (sm_90a): one new query token per
// (batch row, query head) against that row's KV cache.
//
// Replaces the Pallas TPU kernel `decode_attention` in
// src/repro/kernels/decode_attention/kernel.py (`_decode_kernel`).  For row b
// and query head h (KV head h / G, G = H / KV, the KV heads never repeated):
//     s_j = scale * q[b,h] . k[b,h/G,j]           over the cache slots j,
//     valid_j = slot_pos[b,j] >= 0 && slot_pos[b,j] <= cur_pos[b]
//               && (window < 0 || cur_pos[b] - slot_pos[b,j] < window),
//     out[b,h] = sum_j p_j v[b,h/G,j] / max(sum_j p_j, 1e-30),
//     p_j = valid_j ? exp(s_j - m) : 0,  m = max(-1e30, max over valid s_j).
// The mask is per row (each row has its own slot_pos and cur_pos), so
// requests at different positions in one batch are exact, ring caches with
// non-monotonic slot_pos mask exactly, and a row with no valid slot gives
// zeros, as the Pallas kernel does.  Arithmetic is fp32 whatever the
// storage type (fp32 or bf16); the output is written in the storage type.
//
// What bounds it on an H100: each (row, KV head) reads its 2 S dh cache
// values once and does 4 G S dh flops on them, G flops per byte in bf16
// (4 at qwen3-4b), far below the ~20 fp32 flops per byte where the CUDA
// cores would limit, so the kernel is bound by the bytes of the cache.
//
// Design.  The TPU kernel runs a grid of (B*H, kv blocks) in order on one
// core and carries (m, l, acc) in scratch from one kv block to the next.
// Here one block of 256 threads owns one (row, KV head) and up to 8 of the
// query heads that share it, so K and V are read once for all of them, and
// walks the slots in chunks of 512 inside the block:
//   1. scores: a group of lanes takes one slot (each lane 16 bytes of the
//      K row, so neighbouring lanes read neighbouring addresses), the lanes
//      reduce their partial dot products with shuffles, and the chunk's
//      scores go to shared memory (-inf for a masked slot);
//   2. the block's running max per head is raised to the chunk's max, and
//      the running sum and the partial outputs are rescaled once per chunk;
//   3. probabilities p = exp(s - m) replace the scores, and their sum is
//      added to the running sum;
//   4. each lane group accumulates p * v over its slots of the chunk, in
//      registers.
// At the end the lane groups' partial outputs are summed in a fixed order
// (shuffles within a warp, then the warps through shared memory), so the
// result does not change from run to run.  With few rows the grid is small
// (B * KV blocks: 64 at B 8 on qwen3-4b, on 132 SMs); splitting the slots
// across blocks (flash-decoding) and TMA loads are later work.
//
// Plain C interface (loaded with ctypes): the caller allocates the output,
// the launch goes on the caller's stream, nothing synchronises, and the
// return value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;           // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 512;             // slots whose scores a block holds at once
constexpr int kUnroll = 4;              // cache rows a lane loads before using them
constexpr float kNegInf = -1e30f;       // running max before any valid slot

// n elements from 16-byte aligned p, as fp32 (fp32 storage).
template <int N>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&f)[N]) {
  static_assert(N % 4 == 0, "fp32 rows load in float4");
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p + i));
    f[i] = x.x;
    f[i + 1] = x.y;
    f[i + 2] = x.z;
    f[i + 3] = x.w;
  }
}

// n elements from 16-byte aligned p, as fp32 (bf16 storage: the raw 16 bits
// are the high half of the fp32 value, so the conversion is exact).
template <int N>
__device__ __forceinline__ void load_row(const uint16_t* __restrict__ p,
                                         float (&f)[N]) {
  static_assert(N % 8 == 0, "bf16 rows load 8 values in 16 bytes");
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

template <typename T, int DH, int GB>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ slot_pos,
                        const int* __restrict__ cur_pos, T* __restrict__ out,
                        int H, int KV, int S, int window, float scale) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // values per 16 B
  constexpr int kEpl = DH / 32 > kVec ? DH / 32 : kVec;   // values per lane
  constexpr int kLps = DH / kEpl;                          // lanes per slot
  constexpr int kSpw = 32 / kLps;                          // slots per warp
  constexpr int kPass = kWarps * kSpw;                     // slots per pass
  constexpr int kBuf = GB * kChunk > kWarps * GB * DH ? GB * kChunk
                                                      : kWarps * GB * DH;
  static_assert(DH % kEpl == 0 && 32 % kLps == 0, "unsupported head dim");

  // a chunk's scores, then its probabilities; at the end the warps'
  // partial outputs
  __shared__ float buf[kBuf];
  __shared__ float red[kWarps][GB];
  __shared__ float m_run[GB], l_run[GB], alpha[GB];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / kLps, li = lane % kLps;
  const int slot_lane = warp * kSpw + sub;       // this lane group's slot
  const int G = H / KV;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int g0 = blockIdx.y * GB;
  const int ng = min(GB, G - g0);                // heads of this block
  const int h0 = kvh * G + g0;
  const int cur = cur_pos[b];
  const size_t row0 = (static_cast<size_t>(b) * KV + kvh) * S;
  const T* kb = k + row0 * DH + li * kEpl;
  const T* vb = v + row0 * DH + li * kEpl;
  const int* sp = slot_pos + static_cast<size_t>(b) * S;

  float qr[GB][kEpl];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g < ng) {
      load_row(q + (static_cast<size_t>(b) * H + h0 + g) * DH + li * kEpl,
               qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < kEpl; ++e) qr[g][e] = 0.f;
    }
  }
  float acc[GB][kEpl];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < kEpl; ++e) acc[g][e] = 0.f;
  if (tid < GB) {
    m_run[tid] = kNegInf;
    l_run[tid] = 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += kChunk) {
    const int n = min(kChunk, S - c0);

    // ---- 1. scores of the chunk (-inf where the slot is masked) ----------
    // every lane runs every pass (the shuffles need the whole warp); lanes
    // past the chunk's end load nothing and store nothing
    for (int j0 = 0; j0 < n; j0 += kPass * kUnroll) {
      float kf[kUnroll][kEpl];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kPass + slot_lane;
        if (j < n) {
          load_row(kb + static_cast<size_t>(c0 + j) * DH, kf[u]);
        } else {
#pragma unroll
          for (int e = 0; e < kEpl; ++e) kf[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kPass + slot_lane;
        float s[GB];
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < kEpl; ++e) d = fmaf(qr[g][e], kf[u][e], d);
          s[g] = d;
        }
#pragma unroll
        for (int off = kLps / 2; off > 0; off >>= 1)
#pragma unroll
          for (int g = 0; g < GB; ++g)
            s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
        if (j < n && li == 0) {
          const int p = sp[c0 + j];
          const bool valid = p >= 0 && p <= cur &&
                             (window < 0 || cur - p < window);
#pragma unroll
          for (int g = 0; g < GB; ++g)
            buf[g * kChunk + j] = valid ? s[g] * scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // ---- 2. running max per head, and the factor that rescales ----------
    float mx[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) mx[g] = -INFINITY;
    for (int j = tid; j < n; j += kThreads)
#pragma unroll
      for (int g = 0; g < GB; ++g) mx[g] = fmaxf(mx[g], buf[g * kChunk + j]);
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      for (int off = 16; off > 0; off >>= 1)
        mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], off));
      if (lane == 0) red[warp][g] = mx[g];
    }
    __syncthreads();
    if (tid < GB) {
      float cm = red[0][tid];
      for (int w = 1; w < kWarps; ++w) cm = fmaxf(cm, red[w][tid]);
      const float mn = fmaxf(m_run[tid], cm);
      alpha[tid] = expf(m_run[tid] - mn);
      m_run[tid] = mn;
    }
    __syncthreads();

    // ---- 3. probabilities and their sum ----------------------------------
    float sum[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) sum[g] = 0.f;
    for (int j = tid; j < n; j += kThreads) {
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float s = buf[g * kChunk + j];
        const float p = s == -INFINITY ? 0.f : expf(s - m_run[g]);
        buf[g * kChunk + j] = p;
        sum[g] += p;
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      for (int off = 16; off > 0; off >>= 1)
        sum[g] += __shfl_xor_sync(0xffffffffu, sum[g], off);
      if (lane == 0) red[warp][g] = sum[g];
    }
    __syncthreads();
    if (tid < GB) {
      float t = red[0][tid];
      for (int w = 1; w < kWarps; ++w) t += red[w][tid];
      l_run[tid] = l_run[tid] * alpha[tid] + t;
    }

    // ---- 4. partial outputs: acc * alpha + sum over this lane's slots ----
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float a = alpha[g];
#pragma unroll
      for (int e = 0; e < kEpl; ++e) acc[g][e] *= a;
    }
    for (int j0 = 0; j0 < n; j0 += kPass * kUnroll) {
      float vf[kUnroll][kEpl];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kPass + slot_lane;
        if (j < n) {
          load_row(vb + static_cast<size_t>(c0 + j) * DH, vf[u]);
        } else {
#pragma unroll
          for (int e = 0; e < kEpl; ++e) vf[u][e] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u * kPass + slot_lane;
        if (j < n) {
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            const float p = buf[g * kChunk + j];
#pragma unroll
            for (int e = 0; e < kEpl; ++e)
              acc[g][e] = fmaf(p, vf[u][e], acc[g][e]);
          }
        }
      }
    }
    __syncthreads();    // the next chunk (or the combine) overwrites buf
  }

  // ---- combine the lane groups in a fixed order, normalise, store --------
#pragma unroll
  for (int off = kLps; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int e = 0; e < kEpl; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int e = 0; e < kEpl; ++e)
        buf[(warp * GB + g) * DH + li * kEpl + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = tid; i < ng * DH; i += kThreads) {
    const int g = i / DH, d = i % DH;
    float o = 0.f;
    for (int w = 0; w < kWarps; ++w) o += buf[(w * GB + g) * DH + d];
    store(out + (static_cast<size_t>(b) * H + h0 + g) * DH + d,
          o / fmaxf(l_run[g], 1e-30f));
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* slot_pos;
  const int* cur_pos;
  void* out;
  int B, H, KV, S, window;
  float scale;
};

template <typename T, int DH, int GB>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.KV;
  const dim3 grid(a.B * a.KV, (G + GB - 1) / GB);
  decode_attention_kernel<T, DH, GB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.slot_pos, a.cur_pos,
      static_cast<T*>(a.out), a.H, a.KV, a.S, a.window, a.scale);
  return cudaGetLastError();
}

// heads per block: the smallest of 1, 2, 4, 8 that holds G (8 above that,
// with ceil(G / 8) blocks per (row, KV head))
template <typename T, int DH>
cudaError_t launch_heads(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.KV;
  if (G <= 1) return launch<T, DH, 1>(a, stream);
  if (G <= 2) return launch<T, DH, 2>(a, stream);
  if (G <= 4) return launch<T, DH, 4>(a, stream);
  return launch<T, DH, 8>(a, stream);
}

template <typename T>
cudaError_t launch_dim(const Args& a, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch_heads<T, 16>(a, stream);
    case 32: return launch_heads<T, 32>(a, stream);
    case 64: return launch_heads<T, 64>(a, stream);
    case 128: return launch_heads<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Head dims the kernel is built for.
int decode_attention_supports_dim(int dh) {
  return dh == 16 || dh == 32 || dh == 64 || dh == 128;
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, H, dh), k and v (B, KV, S, dh), out (B, H, dh): contiguous, 16-byte
// aligned, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1); slot_pos (B, S) and
// cur_pos (B,) int32.  window < 0: no window.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const int* slot_pos, const int* cur_pos, void* out,
                            int B, int H, int KV, int S, int dh, int window,
                            float scale, int is_bf16, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || S < 1 || H % KV != 0 ||
      !decode_attention_supports_dim(dh)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, slot_pos, cur_pos, out, B, H, KV, S, window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = is_bf16 ? launch_dim<uint16_t>(a, dh, s)
                                : launch_dim<float>(a, dh, s);
  return static_cast<int>(e);
}

}  // extern "C"
