// Decode-attention kernels for Hopper (sm_90a): one new query token per
// (batch row, query head) against that row's KV cache, with the cache's
// slots split across blocks (flash-decoding).
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
// cores would limit, so the kernel is bound by the bytes of the cache.  To
// reach the HBM rate the card needs many bytes in flight on every SM, at
// B 1 as at B 8.
//
// Design.  The TPU kernel runs a grid of (B*H, kv blocks) in order on one
// core and carries (m, l, acc) in scratch from one kv block to the next.
// Here two launches:
//   1. `decode_partial`: grid (B * KV, ceil(G / GB), ceil(S / SPLIT)).  A
//      block of 128 threads owns SPLIT consecutive slots (SPLIT 128 or
//      256, chosen by the caller from S alone, never from B) of one
//      (row, KV head) for up to GB = 8 of the query heads that share it, so
//      K and V are read once for all of them.  It first reads its slots'
//      slot_pos (4 bytes a slot) and marks the sub-tiles (16 KB of K or V
//      each) that hold a valid slot; a split with none writes m = -1e30,
//      l = 0, acc = 0 and reads no K or V, so the unwritten tail of a cache
//      costs nothing.  Thread 0 brings the live sub-tiles of K, then of V,
//      into a 3-stage shared-memory ring with cp.async.bulk (1-D TMA, no
//      tensor map: a sub-tile's rows are contiguous in the (B, KV, S, dh)
//      cache), each completion counted on an mbarrier, so the loads of the
//      next sub-tiles overlap the work on this one.  Scores: a group of
//      lanes takes one slot (each lane 16 bytes of the row), the lanes
//      reduce their partial dot products with shuffles, and the split's
//      scores go to shared memory (-inf where masked).  Then the split's
//      max and sum per head (block reductions in a fixed order), and each
//      lane group accumulates p * v over its slots in registers.  The lane
//      groups' partial outputs are summed in a fixed order (shuffles, then
//      the warps through shared memory), and the block writes its
//      unnormalised acc (fp32, dh per head) and (m, l) to scratch.
//   2. `decode_combine`: one block per (row, query head) combines the
//      splits in index order: m = max m_i, out = sum e^{m_i - m} acc_i /
//      max(sum e^{m_i - m} l_i, 1e-30).  An all-empty row gives zeros.
// Blocks of 128 threads (about 52 KB of shared memory, under 120 registers
// a thread at qwen3-4b's heads) let four share an SM, so that while one
// reads its slot_pos or reduces its scores, the others' copies are in
// flight.  Every block's work depends on its own row's data only, and SPLIT
// does not depend on B, so row b of a batched launch is bitwise the row
// launched alone.
//
// Plain C interface (loaded with ctypes): the caller allocates the output
// and the scratch, both launches go on the caller's stream, nothing
// synchronises, and the return value is cudaGetLastError() after the
// launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 128;           // threads of a partial block
constexpr int kWarps = kThreads / 32;
constexpr int kSubBytes = 16384;        // bytes of K or V a ring stage holds
constexpr int kStages = 3;              // ring stages
constexpr float kNegInf = -1e30f;       // max of a split with no valid slot

// N values from 16-byte aligned p (global or shared memory), as fp32.
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&f)[N]) {
  static_assert(N % 4 == 0, "fp32 rows load in float4");
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + i);
    f[i] = x.x;
    f[i + 1] = x.y;
    f[i + 2] = x.z;
    f[i + 3] = x.w;
  }
}

// N bf16 values from 16-byte aligned p, as fp32 (the raw 16 bits are the
// high half of the fp32 value, so the conversion is exact).
template <int N>
__device__ __forceinline__ void load_row(const uint16_t* p, float (&f)[N]) {
  static_assert(N % 8 == 0, "bf16 rows load 8 values in 16 bytes");
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(p + i);
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (a multiple of 16) from global src to shared dst with the
// bulk-copy engine; completion is counted on the mbarrier bar, which is
// told to expect the bytes first.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Wait until the phase of `bar` with parity `phase` has completed.  A wait
// that does not end within 2^26 tries is a fault: trap (the launch fails
// with an error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int phase) {
  for (int tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
    if (done) return;
    if (tries == (1 << 26)) __trap();
  }
}

// Index of the n-th set bit of m (n < popcount(m)).
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  for (int i = 0; i < n; ++i) m &= m - 1;
  return __ffs(m) - 1;
}

template <typename T, int DH, int SPLIT>
struct Partial {
  static constexpr int kRowBytes = DH * static_cast<int>(sizeof(T));
  // cache rows a ring stage holds, and sub-tiles a split has
  static constexpr int kSub =
      SPLIT < kSubBytes / kRowBytes ? SPLIT : kSubBytes / kRowBytes;
  static constexpr int kNSub = SPLIT / kSub;
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kEpl = DH / 32 > kVec ? DH / 32 : kVec;  // per lane
  static constexpr int kLps = DH / kEpl;                         // lanes a slot
  static constexpr int kSpw = 32 / kLps;                         // slots a warp
  static constexpr int kPass = kWarps * kSpw;                    // slots a pass
  static constexpr int kRing = kStages * kSub * kRowBytes;
  static_assert(kNSub <= 32, "the live sub-tiles are a 32-bit mask");
  static_assert(SPLIT % kSub == 0 && kSub % kPass == 0, "unsupported tile");
  static_assert(DH % kEpl == 0 && 32 % kLps == 0, "unsupported head dim");
};

template <typename T, int DH, int GB, int SPLIT>
__host__ __device__ constexpr int partial_smem() {
  using P = Partial<T, DH, SPLIT>;
  // the ring (reused for the warps' partial outputs at the end), the
  // split's scores, then 8-byte barriers
  constexpr int ring = P::kRing > kWarps * GB * DH * 4 ? P::kRing
                                                       : kWarps * GB * DH * 4;
  return ring + GB * SPLIT * 4 + 8 * kStages;
}

template <typename T, int DH, int GB, int SPLIT>
__global__ void __launch_bounds__(kThreads)
decode_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ slot_pos,
               const int* __restrict__ cur_pos, float* __restrict__ part_acc,
               float* __restrict__ part_ml, int H, int KV, int S, int window,
               float scale) {
  using P = Partial<T, DH, SPLIT>;
  constexpr int kEpl = P::kEpl, kLps = P::kLps, kSpw = P::kSpw;
  constexpr int kSub = P::kSub, kPass = P::kPass;

  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* scores = reinterpret_cast<float*>(
      smem + partial_smem<T, DH, GB, SPLIT>() - GB * SPLIT * 4 - 8 * kStages);
  uint64_t* bars = reinterpret_cast<uint64_t*>(scores + GB * SPLIT);
  __shared__ float red[kWarps][GB];
  __shared__ float m_split[GB], l_split[GB];
  __shared__ bool valid_s[SPLIT];
  __shared__ unsigned live_mask;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / kLps, li = lane % kLps;
  const int slot_lane = warp * kSpw + sub;       // this lane group's slot
  const int G = H / KV;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int g0 = blockIdx.y * GB;
  const int ng = min(GB, G - g0);                // heads of this block
  const int h0 = kvh * G + g0;
  const int n_splits = gridDim.z, split = blockIdx.z;
  const int s0 = split * SPLIT, n = min(SPLIT, S - s0);
  const int cur = cur_pos[b];
  const int* sp = slot_pos + static_cast<size_t>(b) * S + s0;
  const size_t row0 = (static_cast<size_t>(b) * KV + kvh) * S + s0;

  // ---- which slots of the split are valid, and which sub-tiles hold one --
  if (tid == 0) {
    live_mask = 0u;
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
          smem_addr(bars + s)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  for (int j = tid; j < SPLIT; j += kThreads) {
    bool valid = false;
    if (j < n) {
      const int p = sp[j];
      valid = p >= 0 && p <= cur && (window < 0 || cur - p < window);
    }
    valid_s[j] = valid;
    // a masked slot (or one past S) keeps the score -inf
#pragma unroll
    for (int g = 0; g < GB; ++g) scores[g * SPLIT + j] = -INFINITY;
    if (valid) atomicOr(&live_mask, 1u << (j / kSub));
  }
  __syncthreads();
  const unsigned mask = live_mask;
  const int n_live = __popc(mask);
  float* pacc = part_acc +
                (static_cast<size_t>(b) * H + h0) * n_splits * DH +
                static_cast<size_t>(split) * DH;
  float* pml = part_ml + ((static_cast<size_t>(b) * H + h0) * n_splits +
                          split) * 2;
  if (n_live == 0) {          // nothing valid here: read no K or V
    for (int i = tid; i < ng * DH; i += kThreads)
      pacc[static_cast<size_t>(i / DH) * n_splits * DH + i % DH] = 0.f;
    if (tid < ng) {
      pml[static_cast<size_t>(tid) * n_splits * 2] = kNegInf;
      pml[static_cast<size_t>(tid) * n_splits * 2 + 1] = 0.f;
    }
    return;
  }

  // copy i of the 2 n_live: the (i mod n_live)-th live sub-tile, of K for
  // i < n_live, else of V, into ring stage i mod kStages
  const int n_copies = 2 * n_live;
  auto issue = [&](int i) {
    const int s = i % kStages;
    const int t = nth_bit(mask, i % n_live);
    const int rows = min(kSub, n - t * kSub);
    const T* src = (i < n_live ? k : v) + (row0 + t * kSub) * DH;
    bulk_load(smem_addr(ring + s * kSub * DH), src, rows * P::kRowBytes,
              smem_addr(bars + s));
  };
  if (tid == 0)
    for (int i = 0; i < min(kStages, n_copies); ++i) issue(i);

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

  for (int i = 0; i < n_copies; ++i) {
    const int s = i % kStages;
    const int t = nth_bit(mask, i % n_live);
    const int rows = min(kSub, n - t * kSub);
    const T* tile = ring + s * kSub * DH + li * kEpl;

    if (i == n_live) {
      // ---- every score is in: the split's max and sum per head ----------
      float mx[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) mx[g] = -INFINITY;
      for (int j = tid; j < SPLIT; j += kThreads)
#pragma unroll
        for (int g = 0; g < GB; ++g) mx[g] = fmaxf(mx[g], scores[g * SPLIT + j]);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        for (int off = 16; off > 0; off >>= 1)
          mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], off));
        if (lane == 0) red[warp][g] = mx[g];
      }
      __syncthreads();
      if (tid < GB) {
        float m = kNegInf;
        for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red[w][tid]);
        m_split[tid] = m;
      }
      __syncthreads();
      float sum[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) sum[g] = 0.f;
      for (int j = tid; j < SPLIT; j += kThreads) {
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float x = scores[g * SPLIT + j];
          const float p = x == -INFINITY ? 0.f : expf(x - m_split[g]);
          scores[g * SPLIT + j] = p;
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
        float l = 0.f;
        for (int w = 0; w < kWarps; ++w) l += red[w][tid];
        l_split[tid] = l;
      }
    }

    mbar_wait(smem_addr(bars + s), (i / kStages) & 1);
    if (i < n_live) {
      // ---- scores of the sub-tile's valid slots ---------------------------
      // every lane runs every pass (the shuffles need the whole warp);
      // lanes past the sub-tile's rows read nothing and store nothing
      for (int r0 = 0; r0 < kSub; r0 += kPass) {
        const int r = r0 + slot_lane;
        float kf[kEpl];
        if (r < rows) {
          load_row(tile + r * DH, kf);
        } else {
#pragma unroll
          for (int e = 0; e < kEpl; ++e) kf[e] = 0.f;
        }
        float d[GB];
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < kEpl; ++e) x = fmaf(qr[g][e], kf[e], x);
          d[g] = x;
        }
#pragma unroll
        for (int off = kLps / 2; off > 0; off >>= 1)
#pragma unroll
          for (int g = 0; g < GB; ++g)
            d[g] += __shfl_xor_sync(0xffffffffu, d[g], off);
        const int j = t * kSub + r;
        if (r < rows && li == 0 && valid_s[j]) {
#pragma unroll
          for (int g = 0; g < GB; ++g) scores[g * SPLIT + j] = d[g] * scale;
        }
      }
    } else {
      // ---- partial outputs: acc + p * v over this lane group's slots -----
      for (int r0 = 0; r0 < kSub; r0 += kPass) {
        const int r = r0 + slot_lane, j = t * kSub + r;
        if (r < rows && valid_s[j]) {
          float vf[kEpl];
          load_row(tile + r * DH, vf);
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            const float p = scores[g * SPLIT + j];
#pragma unroll
            for (int e = 0; e < kEpl; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
          }
        }
      }
    }
    __syncthreads();    // every thread is done with stage s
    if (tid == 0 && i + kStages < n_copies) {
      // order this stage's generic reads before the async copy's writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(i + kStages);
    }
  }

  // ---- combine the lane groups in a fixed order, write the partials -----
#pragma unroll
  for (int off = kLps; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int e = 0; e < kEpl; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
  float* buf = reinterpret_cast<float*>(smem);   // the ring is free now
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
    pacc[static_cast<size_t>(g) * n_splits * DH + d] = o;
  }
  if (tid < ng) {
    pml[static_cast<size_t>(tid) * n_splits * 2] = m_split[tid];
    pml[static_cast<size_t>(tid) * n_splits * 2 + 1] = l_split[tid];
  }
}

// One block per (row, query head), one thread per output element.
template <typename T>
__global__ void decode_combine(const float* __restrict__ part_acc,
                               const float* __restrict__ part_ml,
                               T* __restrict__ out, int DH, int n_splits) {
  const int bh = blockIdx.x, d = threadIdx.x;
  if (d >= DH) return;
  const float* ml = part_ml + static_cast<size_t>(bh) * n_splits * 2;
  const float* acc = part_acc + static_cast<size_t>(bh) * n_splits * DH + d;
  float m = kNegInf;
  for (int i = 0; i < n_splits; ++i) m = fmaxf(m, ml[2 * i]);
  float l = 0.f, o = 0.f;
  for (int i = 0; i < n_splits; ++i) {
    const float w = expf(ml[2 * i] - m);
    l = fmaf(w, ml[2 * i + 1], l);
    o = fmaf(w, acc[static_cast<size_t>(i) * DH], o);
  }
  store(out + static_cast<size_t>(bh) * DH + d, o / fmaxf(l, 1e-30f));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* slot_pos;
  const int* cur_pos;
  void* out;
  float* part_acc;
  float* part_ml;
  int B, H, KV, S, window;
  float scale;
};

template <typename T, int DH, int GB, int SPLIT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int kSmem = partial_smem<T, DH, GB, SPLIT>();
  auto kernel = decode_partial<T, DH, GB, SPLIT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  const int G = a.H / a.KV;
  const int n_splits = (a.S + SPLIT - 1) / SPLIT;
  const dim3 grid(a.B * a.KV, (G + GB - 1) / GB, n_splits);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.slot_pos, a.cur_pos, a.part_acc,
      a.part_ml, a.H, a.KV, a.S, a.window, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int threads = DH < 32 ? 32 : DH;
  decode_combine<T><<<a.B * a.H, threads, 0, stream>>>(
      a.part_acc, a.part_ml, static_cast<T*>(a.out), DH, n_splits);
  return cudaGetLastError();
}

// heads per block: the smallest of 1, 2, 4, 8 that holds G (8 above that,
// with ceil(G / 8) blocks per (row, KV head, split))
template <typename T, int DH, int SPLIT>
cudaError_t launch_heads(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.KV;
  if (G <= 1) return launch<T, DH, 1, SPLIT>(a, stream);
  if (G <= 2) return launch<T, DH, 2, SPLIT>(a, stream);
  if (G <= 4) return launch<T, DH, 4, SPLIT>(a, stream);
  return launch<T, DH, 8, SPLIT>(a, stream);
}

template <typename T, int SPLIT>
cudaError_t launch_dim(const Args& a, int dh, cudaStream_t stream) {
  switch (dh) {
    case 16: return launch_heads<T, 16, SPLIT>(a, stream);
    case 32: return launch_heads<T, 32, SPLIT>(a, stream);
    case 64: return launch_heads<T, 64, SPLIT>(a, stream);
    case 128: return launch_heads<T, 128, SPLIT>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_split(const Args& a, int dh, int split,
                         cudaStream_t stream) {
  switch (split) {
    case 128: return launch_dim<T, 128>(a, dh, stream);
    case 256: return launch_dim<T, 256>(a, dh, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Head dims the kernel is built for.
int decode_attention_supports_dim(int dh) {
  return dh == 16 || dh == 32 || dh == 64 || dh == 128;
}

// Split lengths (slots a partial block owns) the kernel is built for.
int decode_attention_supports_split(int split) {
  return split == 128 || split == 256;
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, H, dh), k and v (B, KV, S, dh), out (B, H, dh): contiguous, 16-byte
// aligned, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1); slot_pos (B, S) and
// cur_pos (B,) int32; part_acc (B, H, ceil(S / split), dh) and part_ml
// (B, H, ceil(S / split), 2) fp32 scratch.  window < 0: no window.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const int* slot_pos, const int* cur_pos, void* out,
                            float* part_acc, float* part_ml, int B, int H,
                            int KV, int S, int dh, int window, float scale,
                            int is_bf16, int split, void* stream) {
  if (B < 1 || H < 1 || KV < 1 || S < 1 || H % KV != 0 ||
      !decode_attention_supports_dim(dh) ||
      !decode_attention_supports_split(split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,  k,  v, slot_pos, cur_pos, out,    part_acc,
               part_ml, B, H, KV,       S,       window, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = is_bf16 ? launch_split<uint16_t>(a, dh, split, s)
                                : launch_split<float>(a, dh, split, s);
  return static_cast<int>(e);
}

}  // extern "C"
