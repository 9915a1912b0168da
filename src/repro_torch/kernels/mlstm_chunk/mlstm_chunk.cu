// mLSTM chunk kernel for Hopper (sm_90a): one chunk of the chunk-parallel
// stabilised mLSTM for every (batch, head), with its state update.
//
// Replaces the Pallas TPU kernel `mlstm_chunk` in
// src/repro/kernels/mlstm_chunk/kernel.py (`_mlstm_chunk_kernel`).  For one
// (batch, head) with q, k, v (L, dh), gates i, f (L) and the stabilised
// state C0 (dh, dh), n0 (dh), m0:
//     lf = log sigmoid(f),  b = cumsum lf,  u = i - b,
//     g_t = max(m0, max_{s<=t} u_s),  m_t = b_t + g_t,
//     W_ts = (q_t . k_s) exp(u_s - g_t) for s <= t, else 0,
//     h_t = (sum_s W_ts v_s + exp(m0 - g_t) q_t C0)
//           / max(|sum_s W_ts + exp(m0 - g_t) q_t . n0|, exp(-m_t)),
//     C1 = exp(m0 - g_L) C0 + sum_s exp(u_s - g_L) k_s v_s^T,
//     n1 = exp(m0 - g_L) n0 + sum_s exp(u_s - g_L) k_s,  m1 = b_L + g_L.
// A fresh state (m0 = -1e30) gives exp(m0 - g) = 0 exactly.  Arithmetic is
// fp32 whatever the storage type of q, k, v (fp32 or bf16); h is written
// in that type, the gates and the state are fp32.
//
// What bounds it on an H100: per (batch, head) 4 dh flops for each of the
// L (L + 1) / 2 causal (t, s) pairs and 4 L dh^2 for q C0 and the k v^T
// update, on inputs of 3 L dh values: at L 128, dh 64 the operations bound
// it (about 4.2 MFLOP against 0.17 MB per head).  The kernel does them on
// the CUDA cores in fp32; tensor-core tiles are later work.
//
// Design.  The TPU kernel runs one grid step per (batch, head) with the
// q/k/v tiles, the L x L decay matrix and the state in VMEM.  Here one
// block of 256 threads owns one (batch, head) and keeps the same in shared
// memory (q, k, v as fp32 with k and q rows padded by one float, W, C0,
// n0 and the gate scans: 184 KB at L 128, dh 64, over the 48 KB static
// limit, so the launch raises the kernel's dynamic shared-memory limit):
//   1. one thread scans the gates in a fixed order (log sigmoid computed
//      as min(f, 0) - log1p(exp(-|f|)), which never overflows): b, u, g;
//   2. W, one (t, s) entry a thread at a time, zeros above the diagonal;
//   3. the normaliser of each row, one warp a row;
//   4. h, one (t, d) entry a thread at a time;
//   5. C1 and n1, one entry a thread at a time, and m1.
// Nothing is summed with atomics, so the result repeats exactly.  One
// block per (batch, head) is few blocks for 132 SMs at small B * H;
// splitting a head's rows across blocks is later work, and so is a state
// tiled over dh for heads wider than 64.
//
// Plain C interface (loaded with ctypes): the caller allocates the
// outputs, the launch goes on the caller's stream, nothing synchronises,
// and the return value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 128;

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

// bf16 -> fp32 is exact: the 16 bits are the high half of the fp32 value
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

template <int DH>
int smem_bytes(int L) {
  // q, k (L x dh+1), v (L x dh), W (L x L), C0 (dh x dh), n0 (dh),
  // b, u, g, the normaliser, exp(u - g_L) and exp(m0 - g) (L each)
  return static_cast<int>(sizeof(float)) *
         (2 * L * (DH + 1) + L * DH + L * L + DH * DH + DH + 6 * L);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
mlstm_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ i_pre,
                   const float* __restrict__ f_pre,
                   const float* __restrict__ C0, const float* __restrict__ n0,
                   const float* __restrict__ m0, T* __restrict__ h,
                   float* __restrict__ C1, float* __restrict__ n1,
                   float* __restrict__ m1, int L) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kChunks = DH / kVec;      // 16-byte loads a row
  constexpr int QS = DH + 1;              // padded stride of q and k rows
  static_assert(DH % kVec == 0, "unsupported head dim");

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + L * QS;
  float* vs = ks + L * QS;
  float* W = vs + L * DH;
  float* Cs = W + L * L;
  float* ns = Cs + DH * DH;
  float* bs = ns + DH;
  float* us = bs + L;
  float* gs = us + L;
  float* nq = gs + L;
  float* ws = nq + L;                     // exp(u_s - g_L)
  float* inter = ws + L;                  // exp(m0 - g_t)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = blockIdx.x;
  const size_t x0 = bh * L * DH;
  const float m0v = m0[bh];

  for (int c = tid; c < L * kChunks; c += kThreads) {
    const int r = c / kChunks, d0 = (c % kChunks) * kVec;
    float fq[kVec], fk[kVec], fv[kVec];
    const size_t off = x0 + static_cast<size_t>(r) * DH + d0;
    load_vec(q + off, fq);
    load_vec(k + off, fk);
    load_vec(v + off, fv);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      qs[r * QS + d0 + i] = fq[i];
      ks[r * QS + d0 + i] = fk[i];
      vs[r * DH + d0 + i] = fv[i];
    }
  }
  for (int e = tid; e < DH * DH; e += kThreads) Cs[e] = C0[bh * DH * DH + e];
  for (int e = tid; e < DH; e += kThreads) ns[e] = n0[bh * DH + e];

  // ---- 1. gate scans, in order -------------------------------------------
  if (tid == 0) {
    float b = 0.f, cm = -INFINITY;
    for (int t = 0; t < L; ++t) {
      const float f = f_pre[bh * L + t];
      b += fminf(f, 0.f) - log1pf(expf(-fabsf(f)));
      const float u = i_pre[bh * L + t] - b;
      cm = fmaxf(cm, u);
      bs[t] = b;
      us[t] = u;
      gs[t] = fmaxf(m0v, cm);
    }
  }
  __syncthreads();
  const float gL = gs[L - 1], bL = bs[L - 1];
  for (int t = tid; t < L; t += kThreads) {
    ws[t] = expf(us[t] - gL);
    inter[t] = expf(m0v - gs[t]);
  }

  // ---- 2. W -------------------------------------------------------------
  for (int e = tid; e < L * L; e += kThreads) {
    const int t = e / L, s = e % L;
    float w = 0.f;
    if (s <= t) {
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) dot = fmaf(qs[t * QS + d], ks[s * QS + d], dot);
      w = dot * expf(us[s] - gs[t]);
    }
    W[e] = w;
  }
  __syncthreads();

  // ---- 3. normalisers: sum_s W_ts + exp(m0 - g_t) q_t . n0 ----------------
  for (int t = warp; t < L; t += kThreads / 32) {
    float sw = 0.f, qn = 0.f;
    for (int s = lane; s <= t; s += 32) sw += W[t * L + s];
    for (int d = lane; d < DH; d += 32) qn = fmaf(qs[t * QS + d], ns[d], qn);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sw += __shfl_xor_sync(0xffffffffu, sw, off);
      qn += __shfl_xor_sync(0xffffffffu, qn, off);
    }
    if (lane == 0) nq[t] = sw + inter[t] * qn;
  }
  __syncthreads();

  // ---- 4. h ---------------------------------------------------------------
  for (int e = tid; e < L * DH; e += kThreads) {
    const int t = e / DH, d = e % DH;
    float hn = 0.f, qc = 0.f;
    for (int s = 0; s <= t; ++s) hn = fmaf(W[t * L + s], vs[s * DH + d], hn);
#pragma unroll 8
    for (int j = 0; j < DH; ++j) qc = fmaf(qs[t * QS + j], Cs[j * DH + d], qc);
    const float num = hn + inter[t] * qc;
    const float den = fmaxf(fabsf(nq[t]), expf(-(bs[t] + gs[t])));
    store(h + x0 + e, num / den);
  }

  // ---- 5. the state at the end of the chunk ------------------------------
  const float decay = expf(m0v - gL);
  for (int e = tid; e < DH * DH; e += kThreads) {
    const int dd = e / DH, ee = e % DH;
    float acc = 0.f;
    for (int s = 0; s < L; ++s)
      acc = fmaf(ks[s * QS + dd] * ws[s], vs[s * DH + ee], acc);
    C1[bh * DH * DH + e] = decay * Cs[e] + acc;
  }
  for (int d = tid; d < DH; d += kThreads) {
    float acc = 0.f;
    for (int s = 0; s < L; ++s) acc = fmaf(ks[s * QS + d], ws[s], acc);
    n1[bh * DH + d] = decay * ns[d] + acc;
  }
  if (tid == 0) m1[bh] = bL + gL;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* i_pre;
  const float* f_pre;
  const float* C0;
  const float* n0;
  const float* m0;
  void* h;
  float* C1;
  float* n1;
  float* m1;
  int BH, L;
};

template <typename T, int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int smem = smem_bytes<DH>(a.L);
  auto kernel = mlstm_chunk_kernel<T, DH>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<DH>(kMaxL));
  if (e != cudaSuccess) return e;
  kernel<<<a.BH, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.i_pre, a.f_pre, a.C0, a.n0, a.m0,
      static_cast<T*>(a.h), a.C1, a.n1, a.m1, a.L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const Args& a, int dh, cudaStream_t stream) {
  switch (dh) {
    case 8: return launch<T, 8>(a, stream);
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* mlstm_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, k, v and h (B*H, L, dh): contiguous, 16-byte aligned, fp32
// (is_bf16 = 0) or bf16 (is_bf16 = 1); i_pre, f_pre (B*H, L), C0 and C1
// (B*H, dh, dh), n0 and n1 (B*H, dh), m0 and m1 (B*H,): contiguous fp32.
// 1 <= L <= 128; dh 8, 16, 32 or 64.
int mlstm_chunk_launch(const void* q, const void* k, const void* v,
                       const float* i_pre, const float* f_pre,
                       const float* C0, const float* n0, const float* m0,
                       void* h, float* C1, float* n1, float* m1, int BH,
                       int L, int dh, int is_bf16, void* stream) {
  if (BH < 1 || L < 1 || L > kMaxL ||
      (dh != 8 && dh != 16 && dh != 32 && dh != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, i_pre, f_pre, C0, n0, m0, h, C1, n1, m1, BH, L};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = is_bf16 ? launch_dim<uint16_t>(a, dh, s)
                                : launch_dim<float>(a, dh, s);
  return static_cast<int>(e);
}

}  // extern "C"
