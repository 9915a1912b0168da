// Fused exit-confidence kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `exit_confidence` in
// src/repro/kernels/exit_confidence/kernel.py (`_exit_conf_kernel`): for each
// row of h (N, d) it computes
//     logits = RMSNorm(h) * (1 + scale) @ W_out / temperature   (W_out: d x V)
// and returns only conf = 1 / max(sum(exp(logits - max)), 1e-30), pred =
// argmax (the first index of the maximum), max_logit and lse = max + log(sum).
// The V-wide logits row never reaches device memory.
//
// h, scale and W_out are all fp32 or all bf16; the arithmetic is fp32 either
// way, as in the TPU kernel, and the outputs are fp32 (pred int32).
//
// What bounds it on an H100: every element of W_out is read once (4 d V
// bytes in fp32, 2 d V in bf16) for 2 N d V flops.  With N <= 8 rows that is
// at most 8 flops a byte, far below the card's operations-per-byte line, so
// the kernel is bound by the bytes of W_out: at qwen3-4b's head (d 2560,
// V 151936) 0.23 ms in bf16 and 0.46 ms in fp32 at 3.35 TB/s.  Only moving
// those bytes faster helps, which needs about 25 KB or more in flight on
// every SM.  At the classifier's shapes (d 128, V 10) W_out is 5 KB and a
// call is bound by its launch.
//
// Design.  The TPU kernel walks vocab blocks in sequence on one core and
// carries (max, sum, argmax) in scratch between grid steps.  Here
// `ops.plan` chooses one of three paths and owns every number of the launch
// (tile counts, ring stages, k chunk, grid, the scratch's regions):
//   "one"   (V <= one tile of kTile columns, the classifier): one launch of
//           `exit_small`, a block per 8 rows, which normalises its rows into
//           shared memory (in k chunks, so any d fits), multiplies, reduces
//           and writes the four outputs.  No partials.
//   "bulk"  (W_out's rows on 16-byte boundaries: V % 8 == 0 in bf16, V % 4
//           == 0 in fp32, and an aligned pointer): two launches.
//           `exit_norm` normalises the rows once for the whole launch into
//           the scratch (hn, zero-padded to whole k chunks and to 8 rows; in
//           bf16 split into bf16 hi + lo, laid out as the tensor cores' B
//           fragments), where it stays in L2; a block for each 256 k, so
//           it takes a few microseconds rather than one block's
//           latency-bound walk over the rows.  `exit_stream` then runs a
//           grid sized to the card (SMs x resident blocks): each block takes
//           a contiguous run of 128-column tiles (runs differ by at most one
//           tile) and streams W_out's (k chunk x 128) tiles through a ring
//           of stages in shared memory, filled by TMA tensor copies (2-D
//           boxes of 128 bytes x kc rows; OOB rows and columns arrive as
//           zeros) beside a 1-D bulk copy of hn's matching chunk, each stage
//           counted on an mbarrier.  Thread 0 refills a stage as soon as
//           every warp is past it, so the other stages stay in flight:
//           the plan's ring is 2 stages, of 64 KB of W_out at a full chunk
//           (kc 256 rows in bf16, 128 in fp32; one block an SM), so 64 KB
//           is in flight while a stage is read.  Where d cuts the chunk
//           short, the occupancy calculator fits more blocks an SM, which
//           beat more stages on an H100.
//   "plain" (other V): the same `exit_stream`, its stages filled by the
//           block's threads with plain loads, without overlap.
// Products: in bf16 on the tensor cores, mma.sync.m16n8k16 with W_out's
// tile as the A operand (ldmatrix.trans from the ring, which TMA lays out
// with the 128-byte swizzle, so the reads are free of bank conflicts) and hn
// as the 8-wide B operand (the rows), twice: hi then lo.  The tensor cores'
// fp32 accumulation is not rounded to nearest and its error grows with the
// chain of mmas (1e-3 off at d 32768 on an H100), so each stage sums into
// fresh accumulators that are added to the running sums with rounded fp32
// adds.
// W_out is exact in bf16 and never rounded; hi + lo holds hn to about
// 2^-17, and N 1-8 costs what N 8 costs.  A warp owns 32 columns
// of the tile.  In fp32 on the CUDA cores: a thread takes 4 neighbouring
// columns as one 16-byte read from the ring and the 8 rows' hn as two
// broadcast 16-byte reads, 32 FFMA for its 3 LDS.128; the 4 warps split
// the chunk's k rows and their sums meet in shared memory at the tile's end.
// At a tile's end the block folds its 8 x 128 logits into one running
// (max, sum, argmax) per (row, thread); at the run's end it writes one
// partial per row, and the last block to arrive (a ticket in the scratch,
// reset by `exit_norm`) folds every block's partials in a fixed order
// (lane j takes blocks j, j + 32, ... in order, then the lanes merge) and
// writes the outputs.  Results repeat exactly, and every row depends on its
// own data only, so a row of a batched launch is bitwise the row launched
// alone.  Tie rule: whenever two partials merge, the greater max wins and on
// equal maxima the lower column index wins, so the result is the first index
// of the maximum, as in the TPU kernel and in argmax.
//
// Plain C interface (loaded with ctypes): the caller allocates one scratch
// for the outputs and the partials and passes ops.plan's numbers in one
// packed struct (`Launch`); the launches go on the caller's stream, nothing
// synchronises, and the return value is cudaGetLastError() after them.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>
#include <cstdint>
#include <type_traits>

// The launch, as ops.pack packs it (ops._LAUNCH): the tensors' addresses,
// the scratch's regions, then ops.plan's numbers.
struct Launch {
  const void* h;        // (N, d)
  const void* scale;    // (d,)
  const void* w;        // (d, V)
  float* out;           // (4, N): conf, pred (int32 bits), max_logit, lse
  void* hn;             // (groups, chunks * kc * 8) 4-byte words, aligned
  float* part_m;        // (groups, blocks, 8)
  float* part_l;        // (groups, blocks, 8)
  int* part_a;          // (groups, blocks, 8)
  int* ticket;          // (groups,)
  int N, d, V, path, groups, tiles, kc, chunks, stages, blocks, run, extra,
      smem;             // ops.Plan.numbers
  int is_bf16;
  float eps, temperature;
};

namespace {

constexpr int kRows = 8;              // rows a block takes (ops.ROWS)
constexpr int kTile = 128;            // columns a tile (ops.TILE)
constexpr int kRedPitch = kTile + 4;  // padded row of the block's logits
constexpr int kStreamThreads = 128;   // exit_stream: 4 warps
constexpr int kSmallThreads = 256;    // exit_small: 8 warps
constexpr int kNormThreads = 256;     // exit_norm: 8 warps
constexpr int kNormK = 256;           // k of hn an exit_norm block writes
constexpr int kSmallChunk = 256;      // k rows of hn exit_small holds
constexpr int kMaxDim = 32768;        // ops.MAX_DIM
constexpr int kMaxStages = 8;         // ops.MAX_STAGES: most ring stages
constexpr int kMaxSmem = 227 * 1024;  // shared memory a block may use
constexpr float kEmpty = -FLT_MAX;    // max of a partial that saw no column
enum { kOne = 0, kBulk = 1, kPlain = 2 };   // ops.PATHS

__device__ __forceinline__ float to_float(float x) { return x; }
// bf16 bits as fp32: the raw 16 bits are the high half, so this is exact.
__device__ __forceinline__ float to_float(unsigned short x) {
  return __uint_as_float(static_cast<unsigned>(x) << 16);
}

template <bool BF16>
using Elem = std::conditional_t<BF16, unsigned short, float>;

// Merge partial (m2, l2, a2) into (m, l, a): max, sum of exp(x - max), argmax.
__device__ __forceinline__ void merge(float& m, float& l, int& a, float m2,
                                      float l2, int a2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  if (m2 > m || (m2 == m && a2 < a)) a = a2;
  m = mn;
}

// Fold logit x of column c into (m, l, a); columns come in increasing order,
// so an equal maximum keeps the earlier column.
__device__ __forceinline__ void update(float& m, float& l, int& a, float x,
                                       int c) {
  if (x > m) {
    l = l * expf(m - x) + 1.f;
    m = x;
    a = c;
  } else {
    l += expf(x - m);
  }
}

__device__ __forceinline__ void merge_lanes(float& m, float& l, int& a,
                                            int from) {
  for (int off = from; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    const int a2 = __shfl_xor_sync(0xffffffffu, a, off);
    merge(m, l, a, m2, l2, a2);
  }
}

__device__ __forceinline__ void write_row(const Launch& a, int row, float m,
                                          float l, int arg) {
  l = fmaxf(l, 1e-30f);
  a.out[row] = 1.0f / l;
  reinterpret_cast<int*>(a.out)[a.N + row] = arg;
  a.out[2 * a.N + row] = m;
  a.out[3 * a.N + row] = m + logf(l);
}

// 1 / rms of the block's rows into inv (a block of kNormThreads threads,
// kSmallThreads for exit_small: the same).  A thread takes 16-byte chunks
// c, c + 256, ... of every row (all loads of a round in flight at once;
// one element at a time where the rows are not on 16-byte boundaries); the
// sums meet across the warp with shuffles and across the warps in warp
// order, so a row's sum depends on that row alone.
template <bool BF16>
__device__ __forceinline__ void block_inv_rms(const Launch& a, int row0,
                                              int rows, float* inv) {
  constexpr int kVec = BF16 ? 8 : 4;            // values in 16 bytes
  constexpr int kWarps = kNormThreads / 32;
  __shared__ float part[kWarps][kRows];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Elem<BF16>* h = static_cast<const Elem<BF16>*>(a.h) +
                        static_cast<size_t>(row0) * a.d;
  float ss[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) ss[r] = 0.f;
  if (a.d % kVec == 0 && reinterpret_cast<uintptr_t>(a.h) % 16 == 0) {
    const int chunks = a.d / kVec;
#pragma unroll 2
    for (int c = tid; c < chunks; c += kNormThreads) {
      uint4 x[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows)
          x[r] = __ldg(reinterpret_cast<const uint4*>(
                           h + static_cast<size_t>(r) * a.d) + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= rows) continue;
        const unsigned u[4] = {x[r].x, x[r].y, x[r].z, x[r].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (BF16) {
            const float lo = __uint_as_float(u[q] << 16);
            const float hi = __uint_as_float(u[q] & 0xffff0000u);
            ss[r] = fmaf(hi, hi, fmaf(lo, lo, ss[r]));
          } else {
            const float v = __uint_as_float(u[q]);
            ss[r] = fmaf(v, v, ss[r]);
          }
        }
      }
    }
  } else {
#pragma unroll 2
    for (int k = tid; k < a.d; k += kNormThreads) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          const float v = to_float(__ldg(h + static_cast<size_t>(r) * a.d + k));
          ss[r] = fmaf(v, v, ss[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float s = ss[r];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) part[warp][r] = s;
  }
  __syncthreads();
  if (tid < kRows) {
    float s = part[0][tid];
    for (int w = 1; w < kWarps; ++w) s += part[w][tid];
    inv[tid] = 1.0f / sqrtf(s / static_cast<float>(a.d) + a.eps);
  }
  __syncthreads();
}

// hn[r][k] of the block's rows: 0 past the rows and past d.
template <bool BF16>
__device__ __forceinline__ float hn_value(const Launch& a, const float* inv,
                                          int row0, int rows, int r, int k) {
  if (r >= rows || k >= a.d) return 0.f;
  const Elem<BF16>* h = static_cast<const Elem<BF16>*>(a.h);
  const Elem<BF16>* scale = static_cast<const Elem<BF16>*>(a.scale);
  return to_float(__ldg(h + static_cast<size_t>(row0 + r) * a.d + k)) *
         inv[r] * (1.0f + to_float(__ldg(scale + k)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
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

// One TMA box of W_out's (V, d) tensor map, at column x and row y, into
// shared memory at dst; completion is counted on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst with the
// bulk-copy engine, counted on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_trans(uint32_t (&r)[4],
                                               uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, bf16) . b (16 x 8, bf16), fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned short to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------------------------
// "one": the whole function for 8 rows in one block (V <= kTile).
template <bool BF16>
__global__ void __launch_bounds__(kSmallThreads)
exit_small(const Launch a) {
  static_assert(kSmallThreads == kNormThreads, "block_inv_rms's block");
  constexpr int kWarps = kSmallThreads / 32, kCols = kTile / 32;
  constexpr int kAhead = 16;            // rows of W a warp loads at once
  constexpr int kFill = kSmallChunk * kRows / kSmallThreads;   // hn a thread
  __shared__ __align__(16) float hs[kSmallChunk * kRows];      // [k][row]
  __shared__ __align__(16) float red[kWarps][kRows][kTile];
  __shared__ float inv[kRows];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kRows, rows = min(kRows, a.N - row0);
  const Elem<BF16>* h = static_cast<const Elem<BF16>*>(a.h);
  const Elem<BF16>* scale = static_cast<const Elem<BF16>*>(a.scale);
  const Elem<BF16>* w = static_cast<const Elem<BF16>*>(a.w);
  const int cols = (a.V + 31) / 32;     // column groups that hold a column

  // warp `warp` takes rows k = warp, warp + 8, ... of each chunk, kAhead
  // of them loaded at once; lane the columns lane + 32 j (j < cols).
  // Every load of a chunk's first round (W's rows, h and 1 + scale for
  // hn) is issued before anything waits, the first chunk's before the sum
  // of squares.
  float acc[kCols][kRows];
#pragma unroll
  for (int j = 0; j < kCols; ++j)
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[j][r] = 0.f;
  float wv[kAhead][kCols];
  auto load_w = [&](int k0, int kn, int kb) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int k = kb + kWarps * u;
      const Elem<BF16>* wk = w + static_cast<size_t>(k0 + k) * a.V;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = lane + 32 * j;
        wv[u][j] = k < kn && c < a.V ? to_float(__ldg(wk + c)) : 0.f;
      }
    }
  };
  for (int k0 = 0; k0 < a.d; k0 += kSmallChunk) {
    const int kn = min(kSmallChunk, a.d - k0);
    // item i = tid + 256 u: (k i / 8, row i % 8)
    float xr[kFill], gr[kFill];
#pragma unroll
    for (int u = 0; u < kFill; ++u) {
      const int i = tid + kSmallThreads * u, k = i >> 3, r = i & 7;
      const bool live = k < kn && r < rows;
      xr[u] = live ? to_float(__ldg(h + static_cast<size_t>(row0 + r) * a.d +
                                    k0 + k))
                   : 0.f;
      gr[u] = live ? 1.0f + to_float(__ldg(scale + k0 + k)) : 0.f;
    }
    load_w(k0, kn, warp);
    if (k0 == 0) block_inv_rms<BF16>(a, row0, rows, inv);
#pragma unroll
    for (int u = 0; u < kFill; ++u) {
      const int i = tid + kSmallThreads * u, r = i & 7;
      if ((i >> 3) < kn) hs[i] = r < rows ? xr[u] * inv[r] * gr[u] : 0.f;
    }
    __syncthreads();
    for (int kb = warp; kb < kn; kb += kWarps * kAhead) {
      if (kb != warp) load_w(k0, kn, kb);
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const int k = kb + kWarps * u;
        if (k >= kn) break;
        const float4 lo = reinterpret_cast<const float4*>(hs)[2 * k];
        const float4 hi = reinterpret_cast<const float4*>(hs)[2 * k + 1];
        const float hr[kRows] = {lo.x, lo.y, lo.z, lo.w,
                                 hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (j < cols)
#pragma unroll
            for (int r = 0; r < kRows; ++r)
              acc[j][r] = fmaf(hr[r], wv[u][j], acc[j][r]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    if (j < cols)
#pragma unroll
      for (int r = 0; r < kRows; ++r) red[warp][r][lane + 32 * j] = acc[j][r];
  __syncthreads();
  // the warps' parts, summed in warp order
  for (int i = tid; i < kRows * 32 * cols; i += kSmallThreads) {
    const int r = i / (32 * cols), c = i % (32 * cols);
    float s = red[0][r][c];
    for (int p = 1; p < kWarps; ++p) s += red[p][r][c];
    red[0][r][c] = s;
  }
  __syncthreads();
  if (warp < rows) {                    // a warp a row
    float m = kEmpty, l = 0.f;
    int arg = INT_MAX;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = lane + 32 * j;
      if (c < a.V) update(m, l, arg, red[0][warp][c] / a.temperature, c);
    }
    merge_lanes(m, l, arg, 16);
    if (lane == 0) write_row(a, row0 + warp, m, l, arg);
  }
}

// ---------------------------------------------------------------------------
// "bulk" and "plain", first launch, grid (ceil(chunks * kc / kNormK),
// groups): hn for the whole launch, kNormK k a block, and the tickets
// reset.  fp32: hn[g][k][8].  bf16: for each 16 k, the 32 lanes' B
// fragments of mma.m16n8k16, {hi(k, k+1), hi(k+8, k+9), lo(k, k+1),
// lo(k+8, k+9)} with k = 16 j + 2 (lane % 4) of row lane / 4, 16 bytes a
// lane.  Both are chunks * kc * 8 words a group, zero past d and the rows.
// Every block sums the squares of the whole rows itself (from L2).
template <bool BF16>
__global__ void __launch_bounds__(kNormThreads)
exit_norm(const Launch a) {
  __shared__ float inv[kRows];
  const int tid = threadIdx.x, g = blockIdx.y;
  const int row0 = g * kRows, rows = min(kRows, a.N - row0);
  const int d_pad = a.chunks * a.kc;
  const int k0 = blockIdx.x * kNormK, k1 = min(d_pad, k0 + kNormK);
  if (blockIdx.x == 0 && tid == 0) a.ticket[g] = 0;
  block_inv_rms<BF16>(a, row0, rows, inv);
  if (BF16) {
    uint4* hn = static_cast<uint4*>(a.hn) + static_cast<size_t>(g) * d_pad * 2;
#pragma unroll 2
    for (int i = k0 * 2 + tid; i < k1 * 2; i += kNormThreads) {
      const int l = i & 31, n = l >> 2, kq = 16 * (i >> 5) + 2 * (l & 3);
      const int ks[4] = {kq, kq + 1, kq + 8, kq + 9};
      unsigned hi[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = hn_value<BF16>(a, inv, row0, rows, n, ks[q]);
        const unsigned short vh = to_bf16(v);
        hi[q] = vh;
        lo[q] = to_bf16(v - to_float(vh));
      }
      hn[i] = make_uint4(hi[0] | (hi[1] << 16), hi[2] | (hi[3] << 16),
                         lo[0] | (lo[1] << 16), lo[2] | (lo[3] << 16));
    }
  } else {
    float* hn =
        static_cast<float*>(a.hn) + static_cast<size_t>(g) * d_pad * kRows;
#pragma unroll 8
    for (int i = k0 * kRows + tid; i < k1 * kRows; i += kNormThreads)
      hn[i] = hn_value<BF16>(a, inv, row0, rows, i & 7, i >> 3);
  }
}

// Bytes of W_out's tile a stage holds, and boxes of 128 bytes x kc a stage.
template <bool BF16>
__host__ __device__ constexpr int tile_row_bytes() {
  return kTile * (BF16 ? 2 : 4);
}

// fp32: 4 warps' sums of the tile's logits; bf16: one (the warps own
// columns).
template <bool BF16>
__host__ __device__ constexpr int red_parts() {
  return BF16 ? 1 : 4;
}

// exit_stream's dynamic shared memory: alignment slack, the W ring, the hn
// ring, the logits, the barriers (ops.stream_smem).
template <bool BF16>
__host__ __device__ constexpr int stream_smem(int kc, int stages) {
  return 1024 + stages * (kc * tile_row_bytes<BF16>() + kc * 32) +
         red_parts<BF16>() * kRows * kRedPitch * 4 + 8 * stages;
}

// Byte offset in a stage of W_out's (k, column v) value: boxes of 128-byte
// rows, kc rows a box; in bf16 the 16-byte chunks of each row are swizzled
// as TMA's 128-byte swizzle lays them out (chunk ^ (k % 8)).
template <bool BF16>
__device__ __forceinline__ int w_offset(int kc, int k, int v) {
  if (BF16) {
    return (v >> 6) * kc * 128 + k * 128 + ((((v & 63) >> 3) ^ (k & 7)) << 4) +
           (v & 7) * 2;
  }
  return (v >> 5) * kc * 128 + k * 128 + (v & 31) * 4;
}

// ---------------------------------------------------------------------------
// "bulk" and "plain", second launch: grid (blocks, groups).
template <bool BF16, bool BULK>
__global__ void __launch_bounds__(kStreamThreads, 1)
exit_stream(const __grid_constant__ CUtensorMap tw, const Launch a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kc = a.kc, S = a.stages, chunks = a.chunks;
  const int w_stage = kc * tile_row_bytes<BF16>(), h_stage = kc * 32;
  unsigned char* ring_w =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring_h = ring_w + S * w_stage;
  float* red = reinterpret_cast<float*>(ring_h + S * h_stage);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      red + red_parts<BF16>() * kRows * kRedPitch);

  const int b = blockIdx.x, g = blockIdx.y;
  const int first = b * a.run + min(b, a.extra);
  const int total = (a.run + (b < a.extra ? 1 : 0)) * chunks;
  const int row0 = g * kRows, rows = min(kRows, a.N - row0);
  const unsigned char* hn_g = static_cast<const unsigned char*>(a.hn) +
                              static_cast<size_t>(g) * chunks * h_stage;

  auto issue = [&](int it) {              // thread 0: stage `it` into its slot
    const int s = it % S, t = first + it / chunks, c = it % chunks;
    const uint32_t bar = smem_addr(&full[s]);
    const uint32_t dst = smem_addr(ring_w + s * w_stage);
    mbar_expect_tx(bar, w_stage + h_stage);
#pragma unroll
    for (int box = 0; box < tile_row_bytes<BF16>() / 128; ++box)
      tma_load(dst + box * kc * 128, &tw, bar,
               t * kTile + box * (BF16 ? 64 : 32), c * kc);
    bulk_load(smem_addr(ring_h + s * h_stage), hn_g + c * h_stage, h_stage,
              bar);
  };
  auto fill = [&](int it) {               // every thread: plain loads
    const int s = it % S, t = first + it / chunks, c = it % chunks;
    const Elem<BF16>* w = static_cast<const Elem<BF16>*>(a.w);
    unsigned char* dst = ring_w + s * w_stage;
    const int k0 = c * kc, col0 = t * kTile;
#pragma unroll 4
    for (int i = tid; i < kc * kTile; i += kStreamThreads) {
      const int k = i / kTile, v = i % kTile;
      const int gk = k0 + k, gv = col0 + v;
      const Elem<BF16> x = gk < a.d && gv < a.V
                               ? w[static_cast<size_t>(gk) * a.V + gv]
                               : Elem<BF16>(0);
      *reinterpret_cast<Elem<BF16>*>(dst + w_offset<BF16>(kc, k, v)) = x;
    }
    const uint4* src = reinterpret_cast<const uint4*>(hn_g + c * h_stage);
    uint4* hd = reinterpret_cast<uint4*>(ring_h + s * h_stage);
    for (int i = tid; i < h_stage / 16; i += kStreamThreads) hd[i] = src[i];
  };

  if (BULK) {
    if (tid == 0) {
      for (int s = 0; s < S; ++s) mbar_init(smem_addr(&full[s]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0)
      for (int it = 0; it < min(S, total); ++it) issue(it);
  }

  // bf16: mma accumulators of the warp's 32 columns (2 tiles of 16);
  // fp32: the thread's 4 columns x 8 rows over its warp's quarter of k
  constexpr int kAcc = BF16 ? 2 * 4 : kRows * 4;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  // the thread's running (max, sum, argmax) of row tid / 16 over columns
  // 8 (tid % 16) .. + 7 of each tile
  float m_run = kEmpty, l_run = 0.f;
  int a_run = INT_MAX;
  const int fr = tid >> 4, fq = tid & 15;

  for (int it = 0; it < total; ++it) {
    const int s = it % S;
    if (BULK) {
      mbar_wait(smem_addr(&full[s]), (it / S) & 1);
    } else {
      fill(it);
      __syncthreads();
    }
    const unsigned char* wt = ring_w + s * w_stage;
    const unsigned char* ht = ring_h + s * h_stage;
    if (BF16) {
      // lane's row of the four 8x8 matrices ldmatrix.x4.trans reads: matrix
      // i = lane / 8 is (k + 8 (i / 2), columns + 8 (i % 2))
      // The tensor cores' fp32 accumulation is not rounded to nearest, and
      // its error grows with the chain of mmas: each stage sums into fresh
      // accumulators, added to acc with rounded fp32 adds.
      const int mi = lane >> 3, mr = lane & 7;
      float cf[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int j = 0; j < kc / 16; ++j) {
        const uint4 bf = reinterpret_cast<const uint4*>(ht)[j * 32 + lane];
        const int k = 16 * j + (mi >> 1) * 8 + mr;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int v = 32 * warp + 16 * mt + (mi & 1) * 8;
          uint32_t af[4];
          ldmatrix_trans(af, smem_addr(wt) + (v >> 6) * kc * 128 + k * 128 +
                                 ((((v & 63) >> 3) ^ mr) << 4));
          mma_bf16(cf[mt], af, bf.x, bf.y);       // hi
          mma_bf16(cf[mt], af, bf.z, bf.w);       // lo
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[4 * mt + q] += cf[mt][q];
    } else {
      const int kq = kc / 4;                      // the warp's rows of k
      const float* wrow = reinterpret_cast<const float*>(
          wt + (lane >> 3) * kc * 128 + (lane & 7) * 16);
      const float4* hrow = reinterpret_cast<const float4*>(ht);
#pragma unroll 4
      for (int kk = 0; kk < kq; ++kk) {
        const int k = warp * kq + kk;
        const float4 wv = *reinterpret_cast<const float4*>(wrow + k * 32);
        const float4 lo = hrow[2 * k], hi = hrow[2 * k + 1];
        const float hr[kRows] = {lo.x, lo.y, lo.z, lo.w,
                                 hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[4 * r] = fmaf(hr[r], wv.x, acc[4 * r]);
          acc[4 * r + 1] = fmaf(hr[r], wv.y, acc[4 * r + 1]);
          acc[4 * r + 2] = fmaf(hr[r], wv.z, acc[4 * r + 2]);
          acc[4 * r + 3] = fmaf(hr[r], wv.w, acc[4 * r + 3]);
        }
      }
    }
    __syncthreads();                    // every warp is past stage s
    if (BULK && tid == 0 && it + S < total) issue(it + S);
    if (it % chunks == chunks - 1) {    // the tile's last chunk
      if (BF16) {
        // c0, c1: (column lane / 4, rows 2 (lane % 4) + 0, 1); c2, c3:
        // column + 8
        const int n = 2 * (lane & 3);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int v = 32 * warp + 16 * mt + (lane >> 2);
          red[n * kRedPitch + v] = acc[4 * mt];
          red[(n + 1) * kRedPitch + v] = acc[4 * mt + 1];
          red[n * kRedPitch + v + 8] = acc[4 * mt + 2];
          red[(n + 1) * kRedPitch + v + 8] = acc[4 * mt + 3];
        }
      } else {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          *reinterpret_cast<float4*>(red + (warp * kRows + r) * kRedPitch +
                                     4 * lane) =
              make_float4(acc[4 * r], acc[4 * r + 1], acc[4 * r + 2],
                          acc[4 * r + 3]);
      }
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
      __syncthreads();
      const int col0 = (first + it / chunks) * kTile;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * fq + j;
        float x = red[fr * kRedPitch + c];
#pragma unroll
        for (int p = 1; p < red_parts<BF16>(); ++p)
          x += red[(p * kRows + fr) * kRedPitch + c];
        if (col0 + c < a.V) update(m_run, l_run, a_run, x / a.temperature,
                                   col0 + c);
      }
      __syncthreads();
    }
  }

  // the block's partial of each row: its 16 threads merged
  merge_lanes(m_run, l_run, a_run, 8);
  if (fq == 0) {
    const size_t o = (static_cast<size_t>(g) * a.blocks + b) * kRows + fr;
    a.part_m[o] = m_run;
    a.part_l[o] = l_run;
    a.part_a[o] = a_run;
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(&a.ticket[g], 1) == a.blocks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: every block's partials, lane j taking blocks j, j + 32,
  // ... in order, then the lanes merged; warp w takes rows w and w + 4
  for (int r = warp; r < rows; r += kStreamThreads / 32) {
    float m = kEmpty, l = 0.f;
    int arg = INT_MAX;
    for (int p = lane; p < a.blocks; p += 32) {
      const size_t o = (static_cast<size_t>(g) * a.blocks + p) * kRows + r;
      merge(m, l, arg, __ldcg(a.part_m + o), __ldcg(a.part_l + o),
            __ldcg(a.part_a + o));
    }
    merge_lanes(m, l, arg, 16);
    if (lane == 0) write_row(a, row0 + r, m, l, arg);
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// W_out (d, V) as a 2-D map (V, d) with boxes of 128 bytes x kc rows: bf16
// 64 columns with the 128-byte swizzle, fp32 32 columns unswizzled.
bool make_map(CUtensorMap* map, const Launch& a) {
  const int item = a.is_bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a.V),
                              static_cast<cuuint64_t>(a.d)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(a.V) * item};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / item),
                             static_cast<cuuint32_t>(a.kc)};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled()(
             map,
             a.is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             2, const_cast<void*>(a.w), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             a.is_bf16 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

const void* stream_kernel(int is_bf16, int bulk) {
  if (is_bf16) {
    return bulk ? reinterpret_cast<const void*>(exit_stream<true, true>)
                : reinterpret_cast<const void*>(exit_stream<true, false>);
  }
  return bulk ? reinterpret_cast<const void*>(exit_stream<false, true>)
              : reinterpret_cast<const void*>(exit_stream<false, false>);
}

// Let the stream kernel take `smem` bytes of dynamic shared memory (once a
// kernel for the most asked so far: the attribute costs host time).
cudaError_t allow_smem(int is_bf16, int bulk, int smem) {
  static int allowed[2][2] = {{0, 0}, {0, 0}};
  if (smem <= allowed[is_bf16][bulk]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      stream_kernel(is_bf16, bulk), cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e == cudaSuccess) allowed[is_bf16][bulk] = smem;
  return e;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

const char* exit_confidence_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Blocks of the path's streaming kernel ("bulk" or "plain") an SM of the
// current device holds at `smem` bytes of dynamic shared memory; -1 on an
// error.
int exit_confidence_blocks_per_sm(int is_bf16, int path, int smem) {
  int blocks = 0;
  if (path != kBulk && path != kPlain) return -1;
  const int bulk = path == kBulk;
  if (allow_smem(is_bf16 != 0, bulk, smem) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, stream_kernel(is_bf16 != 0, bulk), kStreamThreads, smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}

// One call: the launches of ops.plan's path for the packed `a`.
int exit_confidence_launch(const Launch* a, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bf16 = a->is_bf16 != 0;
  if (a->N < 1 || a->d < 1 || a->V < 1 || a->d > kMaxDim ||
      a->groups != cdiv(a->N, kRows) || a->groups > 65535 ||
      a->out == nullptr || !(a->temperature == a->temperature)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a->path == kOne) {
    if (a->V > kTile) return static_cast<int>(cudaErrorInvalidValue);
    if (bf16) {
      exit_small<true><<<a->groups, kSmallThreads, 0, s>>>(*a);
    } else {
      exit_small<false><<<a->groups, kSmallThreads, 0, s>>>(*a);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int bulk = a->path == kBulk;
  // the plan's numbers must hold together: every tile in one run, the k
  // chunks covering d, the ring as exit_stream lays it out
  if ((a->path != kBulk && a->path != kPlain) ||
      a->tiles != cdiv(a->V, kTile) || a->blocks < 1 ||
      a->blocks > a->tiles || a->run != a->tiles / a->blocks ||
      a->extra != a->tiles % a->blocks || a->kc < 16 || a->kc > 256 ||
      a->kc % 16 || a->chunks != cdiv(a->d, a->kc) || a->stages < 1 ||
      a->stages > kMaxStages ||
      a->smem != (bf16 ? stream_smem<true>(a->kc, a->stages)
                       : stream_smem<false>(a->kc, a->stages)) ||
      a->smem > kMaxSmem || a->hn == nullptr || !aligned16(a->hn) ||
      a->part_m == nullptr || a->part_l == nullptr || a->part_a == nullptr ||
      a->ticket == nullptr ||
      (bulk && (!aligned16(a->w) ||
                (static_cast<long long>(a->V) * (bf16 ? 2 : 4)) % 16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map{};
  if (bulk) {
    if (encode_tiled() == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    if (!make_map(&map, *a)) return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e = allow_smem(bf16, bulk, a->smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 norm_grid(cdiv(a->chunks * a->kc, kNormK), a->groups);
  if (bf16) {
    exit_norm<true><<<norm_grid, kNormThreads, 0, s>>>(*a);
  } else {
    exit_norm<false><<<norm_grid, kNormThreads, 0, s>>>(*a);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(a->blocks, a->groups);
  if (bf16) {
    if (bulk) {
      exit_stream<true, true><<<grid, kStreamThreads, a->smem, s>>>(map, *a);
    } else {
      exit_stream<true, false><<<grid, kStreamThreads, a->smem, s>>>(map, *a);
    }
  } else {
    if (bulk) {
      exit_stream<false, true><<<grid, kStreamThreads, a->smem, s>>>(map, *a);
    } else {
      exit_stream<false, false><<<grid, kStreamThreads, a->smem, s>>>(map, *a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
