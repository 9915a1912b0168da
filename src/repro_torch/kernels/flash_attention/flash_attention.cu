// Flash-attention (prefill) kernels for Hopper (sm_90a): blocked
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
// Pallas kernel does.  The softmax state (m, l, acc) is fp32; the output is
// written in the storage type.  Two kernels, one per storage type:
//
// bf16: `tc::flash_attention_tc`, on the tensor cores.  What bounds it on
// an H100: a kept (query, key) pair costs 4 dh flops, and every K and V
// row is read once for all the queries that see it, so at prefill lengths
// the bf16 tensor-core rate bounds it (B 1, H 32, KV 8, S 2048, dh 128,
// causal: 34.4 GFLOP, 0.035 ms at 989 TFLOP/s, against 8.4 MB of bytes,
// 0.0025 ms).  Design (the shape of FlashAttention-3):
//   - a block owns 128 query rows of one (b, query head): two consumer
//     warpgroups of 64 rows and one producer warp; blocks are issued
//     longest first (the last query tile first under the causal mask), and
//     the G query heads of a KV head are neighbouring blocks, so that
//     head's K and V (1 MB at S 2048) are read from HBM once and from the
//     50 MB L2 by the others;
//   - the producer's one thread loads Q once and the K and V tiles (64
//     keys x dh) into a 3-stage shared-memory ring with TMA (3-D tensor
//     maps over (dh, S, heads): rows past S arrive as zeros), in the
//     swizzled layout wgmma reads (128-byte swizzle; 64 and 32 bytes at
//     dh 32 and 16), each completion counted on an mbarrier; consumers
//     hand a stage back through an "empty" mbarrier;
//   - scores S = Q K^T with wgmma.m64n64k16 (bf16 in, fp32 accumulators in
//     registers), both operands in shared memory.  128-key tiles (n128)
//     would read less shared memory per flop, but S, P and O of 64 x dh
//     then pass the 168 registers a thread that ptxas allows a block this
//     size, and it serialises the wgmmas;
//   - the online softmax on the accumulator registers (a row's four
//     threads reduce with shuffles), in log2 units with exp2; only tiles on
//     the diagonal, on the window's edge or past S pay for the mask, and a
//     tile wholly above the diagonal or outside the window is skipped, as
//     pl.when skips it;
//   - P rounded to bf16 in registers is the A operand of O += P V
//     (wgmma.m64nNk16 with A from registers, N = dh, V the MN-major B
//     operand in shared memory); O accumulates in fp32 registers,
//     and the row sums l are of the fp32 P;
//   - a software pipeline in each warpgroup: the scores of tile i + 1
//     and P V of tile i are issued together, and the softmax of tile i + 1
//     runs on the CUDA cores while the tensor cores run P V of tile i (P
//     is packed to bf16 once that P V has retired, so one set of P
//     registers serves);
//   - epilogue: O / max(l, 1e-30), stored as bf16.
// Rounding P to bf16 for the product is the one numerical difference from
// the Pallas kernel, which multiplies an fp32 P by V (tested against a
// plain model of it, `flash_attention_ref_bf16_p`).
//
// fp32: `fp32::flash_attention_kernel`, products on the CUDA cores in fp32
// (a TF32 product could not meet the fp32 tolerance; at the kernel
// benchmark's fp32 shape it is 3.9-5.1x faster than fp32 SDPA).  The TPU
// kernel runs a grid of (B*H, q blocks, kv blocks) in order on one core and
// carries (m, l, acc) in scratch across kv blocks.  Here one block of 256
// threads owns one (batch row, KV head, q tile) and GB of the query heads
// that share the KV head (GB = 1, 2, 4 or 8, the smallest that holds G,
// with ceil(G / 8) blocks per KV head above 8), so each K and V tile is
// read once for the whole GQA group.  The block holds 64 query rows (GB
// heads x 64 / GB positions) in shared memory and walks the K/V tiles (64
// keys, 32 at dh 128) in a loop:
//   1. K and V tiles into shared memory (16-byte loads, rows past S zero);
//   2. scores: each thread a 4 x (BK / 16) patch of the 64 x BK tile, fp32
//      dot products, masked entries -inf;
//   3. online softmax: four threads per row raise the running max, turn
//      scores into p and rescale the running sum;
//   4. each thread rescales its 4 x (dh / 16) patch of the accumulator and
//      adds p . V.
// Tiles wholly above the diagonal or outside the window are skipped.  Rows
// are padded by one float in shared memory so that the threads of a warp
// read different banks.
//
// In both kernels the running max starts at -1e30, not -inf, so
// exp(m_prev - m_new) is never NaN, and shared memory exceeds 48 KB, so the
// launch raises the kernel's dynamic shared-memory limit.
//
// Plain C interface (loaded with ctypes): the caller allocates the output,
// the launch goes on the caller's stream, nothing synchronises, and the
// return value is cudaGetLastError() after the launch.  The TMA tensor maps
// are encoded on the host with the driver's cuTensorMapEncodeTiled, fetched
// through the runtime's driver entry point, so the library links no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace fp32 {

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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

}  // namespace fp32

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma), TMA loads, a shared-memory ring
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBlockQ = 128;        // query rows of a block
constexpr int kBlockK = 64;         // keys of a K/V tile
constexpr int kStages = 3;          // K/V tiles in flight
constexpr int kConsumers = 256;     // two warpgroups of 64 query rows each
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr float kNegInf = -1e30f;   // running max before any valid key
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout of a tile of `rows` rows x DH bf16 columns, as the
// TMA writes it: DH / kAtom column blocks of `rows` x kSwz bytes each, every
// one swizzled with the kSwz-byte pattern that wgmma reads.
template <int DH>
struct Tile {
  static constexpr int kSwz = DH * 2 < 128 ? DH * 2 : 128;   // bytes a row
  static constexpr int kAtom = kSwz / 2;                     // columns a row
  static constexpr int kBlocks = DH / kAtom;                 // column blocks
  static constexpr int kQBytes = kBlockQ * DH * 2;
  static constexpr int kKVBytes = kBlockK * DH * 2;
  // wgmma descriptor layout code: 1 = 128 B, 2 = 64 B, 3 = 32 B swizzle
  static constexpr int kLayout = kSwz == 128 ? 1 : kSwz == 64 ? 2 : 3;
  // Q, then the K ring, then the V ring, each 1024-byte aligned; then the
  // barriers
  static constexpr int kSmem =
      kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 3 * kStages);
};

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
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

// One TMA box of a (DH, S, heads) tensor map into shared memory at dst;
// completion is counted on bar.  Rows past S arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, int lbo, int sbo,
                                              int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma uses across its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (m64nN, fp32) (+)= A . B for one k16 step.  _ss: A and B bf16 in shared
// memory, both K-major (descriptors da, db).  _rs: A bf16 in registers
// (four 32-bit registers a thread, the layout of the accumulator's rows),
// B bf16 in shared memory, MN-major.  scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                  uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (N == 16) wgmma_m64n16k16_rs(d, a, db, scale_d);
  if constexpr (N == 32) wgmma_m64n32k16_rs(d, a, db, scale_d);
  if constexpr (N == 64) wgmma_m64n64k16_rs(d, a, db, scale_d);
  if constexpr (N == 128) wgmma_m64n128k16_rs(d, a, db, scale_d);
}

// 2^x on the special-function unit (-inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Block (query head bh = b * H + h, query tile): threads 0-255 are two
// consumer warpgroups of 64 query rows each, threads 256-287 the producer
// warp, of which one thread issues the loads.  The accumulator layout of
// wgmma m64nN gives thread t of a warpgroup rows r0 = 16 (t / 32) +
// (t % 32) / 4 and r0 + 8, and in each 8-column group j the columns 8 j + 2 (t % 4) and + 1: element 4 j + e is
// (row r0 + 8 (e / 2), column 8 j + 2 (t % 4) + e % 2).
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc(__grid_constant__ const CUtensorMap tq,
                   __grid_constant__ const CUtensorMap tk,
                   __grid_constant__ const CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, int H, int KV, int S,
                   int causal, int window, float scale) {
  using L = Tile<DH>;
  constexpr int kSwz = L::kSwz, kAtom = L::kAtom, kCB = L::kBlocks;
  constexpr int kKSteps = DH / 16;          // k16 steps of Q K^T
  constexpr int kStepsPerAtom = kAtom / 16;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle patterns repeat every 1024 bytes: align the tiles to them
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = smem;
  unsigned char* Ks = Qs + L::kQBytes;
  unsigned char* Vs = Ks + kStages * L::kKVBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(Vs + kStages * L::kKVBytes);
  const uint32_t q_full = smem_addr(bars);
  const uint32_t k_full = q_full + 8;                 // + 8 stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int bkv = b * KV + h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;   // longest first
  // the key tiles any query of the block sees
  const int k_end = causal ? min(S, q0 + kBlockQ) : S;
  const int kt_hi = (k_end + kBlockK - 1) / kBlockK;
  const int kt_lo = window >= 0 ? max(0, q0 - window + 1) / kBlockK : 0;
  const int n_tiles = max(0, kt_hi - kt_lo);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);   // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: Q once, then K and V tiles, last tile first ----------
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < kCB; ++c)
        tma_load(smem_addr(Qs + c * kBlockQ * kSwz), &tq, q_full, c * kAtom,
                 q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty + 8 * s, ((it / kStages) & 1) ^ 1);
        const int k0 = (kt_hi - 1 - it) * kBlockK;
        mbar_expect_tx(k_full + 8 * s, L::kKVBytes);
        for (int c = 0; c < kCB; ++c)
          tma_load(smem_addr(Ks + s * L::kKVBytes + c * kBlockK * kSwz), &tk,
                   k_full + 8 * s, c * kAtom, k0, bkv);
        mbar_expect_tx(v_full + 8 * s, L::kKVBytes);
        for (int c = 0; c < kCB; ++c)
          tma_load(smem_addr(Vs + s * L::kKVBytes + c * kBlockK * kSwz), &tv,
                   v_full + 8 * s, c * kAtom, k0, bkv);
      }
    }
    return;
  }

  // ---- consumers ----------------------------------------------------------
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128, lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4;          // rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);
  const int qw = q0 + 64 * wg;                      // the warpgroup's first
  const float scale_log2 = scale * kLog2e;

  float m_run[2] = {kNegInf, kNegInf};   // running max, log2 units
  float l_run[2] = {0.f, 0.f};           // this thread's part of the sum
  float o[DH / 2];                        // O: 64 rows x DH, fp32
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  constexpr int kN8 = kBlockK / 8;       // 8-key column groups of a tile
  constexpr int kPSteps = kBlockK / 16;  // k16 steps of P V
  float sc[kBlockK / 2];                 // scores, then probabilities
  uint32_t pa[kPSteps][4];               // P in bf16, the A operand of P V

  // A tile wholly above this warpgroup's diagonal or outside its window is
  // skipped, as pl.when skips it.  Iterations run from the last key tile
  // down, so the live tiles are one run [it_a, it_b): the diagonal's
  // neighbours come first, the tiles below the window last.
  auto live = [&](int it) {
    const int k0 = (kt_hi - 1 - it) * kBlockK;
    return qw < S && !(causal && k0 > qw + 63) &&
           !(window >= 0 && qw - (k0 + kBlockK - 1) >= window);
  };
  int it_a = 0;
  while (it_a < n_tiles && !live(it_a)) ++it_a;
  int it_b = it_a;
  while (it_b < n_tiles && live(it_b)) ++it_b;

  // a tile this warpgroup skips: wait for it (so every barrier phase is
  // consumed in order) and hand it back
  auto skip = [&](int it) {
    const int st = it % kStages, ph = (it / kStages) & 1;
    mbar_wait(k_full + 8 * st, ph);
    mbar_wait(v_full + 8 * st, ph);
    if (lane == 0) mbar_arrive(empty + 8 * st);
  };
  // S = Q K^T of tile it, issued and committed (not waited for)
  const uint32_t q_base = smem_addr(Qs) + 64 * wg * kSwz;
  auto issue_scores = [&](int it) {
    const int st = it % kStages;
    mbar_wait(k_full + 8 * st, (it / kStages) & 1);
    const uint32_t k_base = smem_addr(Ks + st * L::kKVBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const int cb = kk / kStepsPerAtom, off = (kk % kStepsPerAtom) * 32;
      const uint64_t da = make_desc(q_base + cb * kBlockQ * kSwz + off, 16,
                                    8 * kSwz, L::kLayout);
      const uint64_t db = make_desc(k_base + cb * kBlockK * kSwz + off, 16,
                                    8 * kSwz, L::kLayout);
      wgmma_m64n64k16_ss(sc, da, db, kk > 0);
    }
    wgmma_commit();
  };
  // the online softmax of tile it's scores in sc, in place: mask (only
  // diagonal, window-edge and tail tiles), the new running max (a row's
  // four threads are one quad), P = 2^(s - max) in fp32, the running sums;
  // returns the factors that rescale O in alpha
  auto softmax = [&](int it, float (&alpha)[2]) {
    const int k0 = (kt_hi - 1 - it) * kBlockK;
    const bool masked = (causal && k0 + kBlockK - 1 > qw) ||
                        (window >= 0 && qw + 63 - k0 >= window) ||
                        k0 + kBlockK > S;
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * scale_log2;
        if (masked) {
          const int qp = qw + r0 + 8 * (e / 2);
          const int kp = k0 + 8 * j + c0 + (e % 2);
          const bool valid = kp < S && (!causal || qp >= kp) &&
                             (window < 0 || qp - kp < window);
          if (!valid) x = -INFINITY;
        }
        sc[4 * j + e] = x;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kN8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[i], mx);
      alpha[i] = ex2(m_run[i] - m_new);
      m_run[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kN8; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          const float pe = ex2(sc[4 * j + e] - m_new);   // -inf -> 0
          sc[4 * j + e] = pe;
          sum += pe;
        }
      l_run[i] = l_run[i] * alpha[i] + sum;
    }
  };
  // P (fp32 in sc) to bf16 as the A operand of P V: k16 step kk is columns
  // 16 kk .. 16 kk + 15, the accumulator's column groups 2 kk and 2 kk + 1
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kPSteps; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };
  // O += P V of tile it, issued and committed.  V (keys x DH) is the
  // MN-major B operand: 8-key groups kSwz * 8 bytes apart, its column
  // blocks (swizzle atoms along N) kBlockK * kSwz bytes apart.
  auto issue_pv = [&](int it) {
    const int st = it % kStages;
    mbar_wait(v_full + 8 * st, (it / kStages) & 1);
    const uint32_t v_base = smem_addr(Vs + st * L::kKVBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kPSteps; ++kk) {
      const uint64_t db = make_desc(v_base + kk * 16 * kSwz, kBlockK * kSwz,
                                    8 * kSwz, L::kLayout);
      wgmma_rs<DH>(o, pa[kk], db, 1);
    }
    wgmma_commit();
  };
  // wait for the P V in flight, then hand tile it's stage back
  auto retire_pv = [&](int it) {
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < kPSteps; ++kk) fence_regs(pa[kk]);
    if (lane == 0) mbar_arrive(empty + 8 * (it % kStages));
  };

  mbar_wait(q_full, 0);
  for (int it = 0; it < it_a; ++it) skip(it);
  if (it_a < it_b) {
    float alpha[2];
    issue_scores(it_a);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(it_a, alpha);                // O is 0: nothing to rescale
    pack_p();
    // Software pipeline: while the tensor cores run tile it + 1's scores
    // and tile it's P V, the warpgroup computes tile it + 1's softmax; P
    // is packed for the next P V only after this one has retired.  No
    // branch sits between an issue and its wait (a join there would copy
    // registers in flight, and ptxas would serialise the wgmmas), so the
    // last tile is peeled off the loop.
    for (int it = it_a; it + 1 < it_b; ++it) {
      issue_scores(it + 1);
      issue_pv(it);
      wgmma_wait<1>();                   // the scores (the older group)
      fence_regs(sc);
      softmax(it + 1, alpha);
      retire_pv(it);
      fence_regs(sc);                    // pack only after the retire
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] *= alpha[(i / 2) % 2];
      pack_p();
    }
    issue_pv(it_b - 1);
    retire_pv(it_b - 1);
  }
  for (int it = it_b; it < n_tiles; ++it) skip(it);

  // ---- epilogue: out = O / max(l, 1e-30), bf16 ----------------------------
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int qp = qw + r0 + 8 * i;
    if (qp < S) {
      __nv_bfloat16* row = out + (static_cast<size_t>(bh) * S + qp) * DH;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const __nv_bfloat162 v2 = __floats2bfloat162_rn(
            o[4 * j + 2 * i] / l, o[4 * j + 2 * i + 1] / l);
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + c0) = v2;
      }
    }
  }
}

}  // namespace tc

namespace {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, H, KV, S, causal, window;
  float scale;
};

template <int DH, int BK, int GB>
cudaError_t launch_fp32(const Args& a, cudaStream_t stream) {
  constexpr int kSmem =
      fp32::smem_floats<DH, BK>() * static_cast<int>(sizeof(float));
  auto kernel = fp32::flash_attention_kernel<float, DH, BK, GB>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  const int G = a.H / a.KV;
  constexpr int BQ = fp32::kRows / GB;
  const dim3 grid((a.S + BQ - 1) / BQ, a.B * a.KV, (G + GB - 1) / GB);
  kernel<<<grid, fp32::kThreads, kSmem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.H, a.KV,
      a.S, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

// heads per block: the smallest of 1, 2, 4, 8 that holds G (8 above that)
template <int DH, int BK>
cudaError_t launch_fp32_heads(const Args& a, cudaStream_t stream) {
  const int G = a.H / a.KV;
  if (G <= 1) return launch_fp32<DH, BK, 1>(a, stream);
  if (G <= 2) return launch_fp32<DH, BK, 2>(a, stream);
  if (G <= 4) return launch_fp32<DH, BK, 4>(a, stream);
  return launch_fp32<DH, BK, 8>(a, stream);
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

// Tensor map of a contiguous bf16 (heads, S, DH) tensor as (DH, S, heads),
// boxes of one swizzle atom's columns x `rows` rows x one head.
template <int DH>
bool make_map(CUtensorMap* map, const void* ptr, int S, int heads,
              int rows) {
  using L = tc::Tile<DH>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(DH),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(DH) * 2,
                                 static_cast<cuuint64_t>(S) * DH * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(L::kAtom),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz = L::kSwz == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : L::kSwz == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tq, tk, tv;
  if (!make_map<DH>(&tq, a.q, a.S, a.B * a.H, tc::kBlockQ) ||
      !make_map<DH>(&tk, a.k, a.S, a.B * a.KV, tc::kBlockK) ||
      !make_map<DH>(&tv, a.v, a.S, a.B * a.KV, tc::kBlockK)) {
    return cudaErrorInvalidValue;
  }
  constexpr int kSmem = tc::Tile<DH>::kSmem + 1024;   // + alignment slack
  auto kernel = tc::flash_attention_tc<DH>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.B * a.H, (a.S + tc::kBlockQ - 1) / tc::kBlockQ);
  kernel<<<grid, tc::kThreads, kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(a.out), a.H, a.KV, a.S,
      a.causal, a.window, a.scale);
  return cudaGetLastError();
}

cudaError_t launch_dim(const Args& a, int dh, int is_bf16,
                       cudaStream_t stream) {
  if (is_bf16) {
    switch (dh) {
      case 16: return launch_bf16<16>(a, stream);
      case 32: return launch_bf16<32>(a, stream);
      case 64: return launch_bf16<64>(a, stream);
      case 128: return launch_bf16<128>(a, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (dh) {
    case 16: return launch_fp32_heads<16, 64>(a, stream);
    case 32: return launch_fp32_heads<32, 64>(a, stream);
    case 64: return launch_fp32_heads<64, 64>(a, stream);
    case 128: return launch_fp32_heads<128, 32>(a, stream);
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
      B * KV > 65535 || (is_bf16 && (S + 127) / 128 > 65535) ||
      (dh != 16 && dh != 32 && dh != 64 && dh != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, out, B, H, KV, S, causal, window, scale};
  return static_cast<int>(
      launch_dim(a, dh, is_bf16, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
