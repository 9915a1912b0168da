// mLSTM chunk kernels for Hopper (sm_90a): one chunk of the chunk-parallel
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
// A fresh state (m0 = -1e30) gives exp(m0 - g) = 0 exactly, and a product
// with a zero factor is skipped, so it contributes exactly 0.  Products
// are fp32 whatever the storage type of q, k, v (fp32 or bf16); the gate
// scan, the decay factors and the normaliser are fp64 (see mlstm_scores);
// h is written in q's type, the gates and the state are fp32.
//
// What bounds it on an H100: per (batch, head) the q C0 and k v^T products
// are 2 L dh^2 fmas each, on an fp32 state of 4 dh^2 bytes read and
// written.  At L 128 the operations bound it on the CUDA cores (fp32
// operands: the state is carried across chunks in fp32); at small heads
// it is launch latency.
//
// Design.  The TPU kernel runs one grid step per (batch, head) with the
// whole state in VMEM.  Here the work is split across the card in two
// launches on the caller's stream (four above dh 256), with a scratch the
// wrapper allocates (ops.plan: W's row sums by column tile and the state's
// part of the normaliser in fp64; W (BH, L, LP), exp(-m), the gate factors
// in fp32):
//   1. scores, grid (BH, ceil(L / 16), ceil(L / 64)): each block scans its
//      head's gates (gate_scan), then computes its 16 x 64 tile of W for
//      s <= t, the dot products over dh in fp32 on 32-deep slices staged
//      through shared memory (four 64-thread groups a quarter of each
//      slice, a thread a 4 x 4 micro-tile), and its rows' sums of W.  The
//      scan, the dot products' sums beyond 64 d, the decay factors and the
//      row sums are fp64 (see mlstm_scores): the normaliser cancels, and an
//      fp32 one would move h by more than fp32 rounding at dh 1024.  Above
//      dh 256 a block takes 256 of dh (k_parts a tile, so no block loops
//      over more than 8 slices), writes its part of the dot products in
//      fp64, and a combine launch (mlstm_combine) adds the parts in order
//      and finishes W.
//   2. output, one grid of three kinds of 128-thread block, h tiles first
//      (the longest): h tiles (BH, ceil(L / 64), ceil(dh / 64)) computing
//      h = (W v + (exp(m0 - g) q) C0) / max(|nq|, exp(-m)), nq summed
//      from the scores pass's parts in a fixed order; state tiles (BH,
//      ceil(dh / 64), ceil(dh / 64)) computing C1 = decay C0 + (ws k)^T v;
//      and n1 blocks (BH, ceil(dh / 128)), one thread a column of k.  Above
//      dh 256 an h tile takes 256 rows of C0 (h_parts of them a tile, so
//      no block's product is longer than 64 + 256 deep), writes its part
//      of the numerator, and a third launch adds the parts in order and
//      divides by the denominator.  The tiles are register-tiled fp32
//      products, a thread an 8 x 4 micro-tile: a 128-bit shared load is
//      served a quarter-warp at a time, so a 4 x 4 micro-tile's two loads
//      a step (8 shared-memory cycles for a warp's 16 fmas) would hold the
//      fmas to half their rate; 8 x 4 needs 12 for 32, and keeps a thread
//      near 100 registers, so several blocks share an SM.
//      16-deep slices of both operands go through two shared buffers, the
//      slice after next loaded into registers (converted from bf16,
//      scaled by its gate, causally masked or transposed on the way in)
//      while the current one is multiplied.  No block holds more than its
//      tiles, so shared memory does not grow with dh or L.
// Nothing is summed with atomics, so the result repeats exactly.
//
// Plain C interface (loaded with ctypes): the caller allocates the
// outputs and the scratch, the launches go on the caller's stream, nothing
// synchronises, and the return value is cudaGetLastError() after them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

// The scratch's regions, in this order (ops.REGIONS): fp64 first (8-byte
// aligned), then fp32.  ops.plan lays them out, the one place the layout
// is worked out; the wrapper passes each region's address (nullptr for
// one the plan has not).
struct Scratch {
  double* part;     // (BH, L, t_tiles): W's row sums over a column tile
  double* nq0;      // (BH, L): exp(m0 - g_t) q_t . n0
  double* pdot;     // (BH, row_tiles, t_tiles, k_parts, 16, 64): dh parts'
  double* pqn;      // (BH, row_tiles, k_parts, 16): their q . n0
  float* W;         // (BH, L, LP)
  float* floor;     // (BH, L): exp(-m_t)
  float* inter;     // (BH, L): exp(m0 - g_t)
  float* ws;        // (BH, L): exp(u_s - g_L)
  float* decay;     // (BH,): exp(m0 - g_L)
  float* hnum;      // (h_parts, BH, L, dh): h's numerator by part of C0
};

// Everything a launch needs, packed by the wrapper in this order
// (ops._LAUNCH); at file scope, so the C entry point keeps its external
// name.
struct Launch {
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
  Scratch sc;
  // ops.plan's grid: the output pass's blocks and the third launch's
  // (0 when h comes in one part) included
  int BH, L, dh, LP, is_bf16, row_tiles, t_tiles, d_tiles, n1_blocks,
      h_parts, k_parts, out_blocks, finish_blocks;
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 512;        // ops.KERNEL_MAX_L
constexpr int kMaxDh = 1024;      // ops.KERNEL_MAX_DH
constexpr int kRows = 16;         // W rows a scores block (ops.SCORE_ROWS)
constexpr int kTile = 64;         // output tile (ops.TILE), W column tile
constexpr int kTP = kTile + 4;    // padded row of a staged tile
constexpr int kBK = 16;           // depth of a staged slice
constexpr int kN1 = 128;          // columns of k an n1 block sums
constexpr int kDs = 32;           // d slice of the scores pass
constexpr int kHPart = 256;       // rows of C0 an h tile's part takes
constexpr int kSPart = 256;       // d a scores block's part takes

// A slice pipeline of depth D: slices kt = 0 .. nk - 1 of a product's
// depth, each loaded into register set kt % D (a compile-time constant:
// Set<n>), then stored into shared buffer kt % 2 and multiplied.
// fetch(kt, set) issues the loads of slice kt; put(kt, set) converts,
// scales or masks them and stores them into buffer set & 1; mul(set)
// multiplies buffer set & 1.  A slice's loads are issued D slices before
// its products, so they have that many slices' products to arrive in; one
// barrier a slice.  `first` runs while the first D slices' loads are in
// flight.
template <int S>
using Set = std::integral_constant<int, S>;

struct Nothing {
  __device__ void operator()() const {}
};

template <int D, class Fetch, class Put, class Mul, int S>
__device__ __forceinline__ void pipeline_step(int kt, int nk, Fetch& fetch,
                                              Put& put, Mul& mul, Set<S>) {
  if (kt >= nk) return;
  if (kt + D < nk) fetch(kt + D, Set<S>{});   // set S was put
  mul(Set<S>{});
  if (kt + 1 < nk) put(kt + 1, Set<(S + 1) % D>{});
  __syncthreads();
}

template <int D, class Fetch, class Put, class Mul, class First = Nothing>
__device__ __forceinline__ void pipeline(int nk, Fetch fetch, Put put,
                                         Mul mul, First first = {}) {
  static_assert(D == 2 || D == 4, "depth 2 or 4");
  if (nk <= 0) return;
  fetch(0, Set<0>{});
  if (nk > 1) fetch(1, Set<1>{});
  if constexpr (D == 4) {
    if (nk > 2) fetch(2, Set<2 % D>{});
    if (nk > 3) fetch(3, Set<3 % D>{});
  }
  first();
  put(0, Set<0>{});
  __syncthreads();
  for (int kt = 0; kt < nk; kt += D) {
    pipeline_step<D>(kt, nk, fetch, put, mul, Set<0>{});
    pipeline_step<D>(kt + 1, nk, fetch, put, mul, Set<1>{});
    if constexpr (D == 4) {
      pipeline_step<D>(kt + 2, nk, fetch, put, mul, Set<2 % D>{});
      pipeline_step<D>(kt + 3, nk, fetch, put, mul, Set<3 % D>{});
    }
  }
}

// 4 values from 16-byte aligned p
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}

__device__ __forceinline__ float to_float(float x) { return x; }
// bf16 -> fp32 is exact: the 16 bits are the high half of the fp32 value
__device__ __forceinline__ float to_float(uint16_t x) {
  return __uint_as_float(static_cast<unsigned>(x) << 16);
}

__device__ __forceinline__ void store4(float* p, const float (&f)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo)))
         | (static_cast<unsigned>(
                __bfloat16_as_ushort(__float2bfloat16_rn(hi)))
            << 16);
}
__device__ __forceinline__ void store4(uint16_t* p, const float (&f)[4]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]));
}


// 4 values as loaded, not yet converted: a load's registers are only read
// after the slice's products (a value used right after its load would
// hold the warp until the load returns).
template <typename T>
struct Raw4;
template <>
struct Raw4<float> {
  float4 v;
  __device__ __forceinline__ void fetch(const float* p) {
    v = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ void clear() {
    v = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void get(float (&f)[4]) const {
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};
template <>
struct Raw4<uint16_t> {
  uint2 v;
  __device__ __forceinline__ void fetch(const uint16_t* p) {
    v = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ void clear() { v = make_uint2(0u, 0u); }
  __device__ __forceinline__ void get(float (&f)[4]) const {
    f[0] = __uint_as_float(v.x << 16);
    f[1] = __uint_as_float(v.x & 0xffff0000u);
    f[2] = __uint_as_float(v.y << 16);
    f[3] = __uint_as_float(v.y & 0xffff0000u);
  }
};

// ---- 1. scores ----------------------------------------------------------

// b = cumsum log sigmoid(f), u = i - b, g = max(m0, cummax u), in fp64,
// by the whole block (it ends on a barrier).  Every thread computes log
// sigmoid(f) = min(f, 0) - log1p(exp(-|f|)) (it never overflows) for its
// elements; then one warp scans: lane l owns the segment [l P, (l + 1) P)
// of the chunk, P = ceil(L / 32), sums it in order, and a shuffle scan in
// a fixed order adds the segments before it; the same for the running
// maximum (exact).
__device__ void gate_scan(const float* __restrict__ ip,
                          const float* __restrict__ fp, double m0v, int L,
                          double* sb, double* su, double* sg) {
  for (int t = threadIdx.x; t < L; t += blockDim.x) {
    const double f = fp[t];
    sb[t] = fmin(f, 0.0) - log1p(exp(-fabs(f)));
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x;
    const int per = (L + 31) / 32;
    const int lo = min(lane * per, L), hi = min(lo + per, L);
    double run = 0.0;
    for (int t = lo; t < hi; ++t) {
      run += sb[t];
      sb[t] = run;
    }
    double incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_up_sync(full, incl, off);
      if (lane >= off) incl += o;
    }
    double before = __shfl_up_sync(full, incl, 1);
    if (lane == 0) before = 0.0;
    double cm = -INFINITY;
    for (int t = lo; t < hi; ++t) {
      const double b = sb[t] + before;
      const double u = ip[t] - b;
      sb[t] = b;
      su[t] = u;
      cm = fmax(cm, u);
      sg[t] = cm;
    }
    double mx = cm;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_up_sync(full, mx, off);
      if (lane >= off) mx = fmax(mx, o);
    }
    double mbefore = __shfl_up_sync(full, mx, 1);
    if (lane == 0) mbefore = -INFINITY;
    for (int t = lo; t < hi; ++t) sg[t] = fmax(m0v, fmax(mbefore, sg[t]));
  }
  __syncthreads();
}

// The column-0 blocks' row constants of rows r0 .. r0 + 15: exp(u_s -
// g_L), exp(m0 - g_s), exp(-m_s); block (r0 0, column 0) also m1 and
// exp(m0 - g_L).  After gate_scan.
__device__ void row_constants(const Scratch& sc, float* __restrict__ m1,
                              const double* sb, const double* su,
                              const double* sg, double m0v, int bh, int r0,
                              int L) {
  const size_t row0 = static_cast<size_t>(bh) * L;
  const double gL = sg[L - 1];
  if (r0 == 0 && threadIdx.x == 0) {
    m1[bh] = static_cast<float>(sb[L - 1] + gL);
    sc.decay[bh] = static_cast<float>(exp(m0v - gL));
  }
  if (threadIdx.x < kRows && r0 + threadIdx.x < L) {
    const int s = r0 + threadIdx.x;
    sc.ws[row0 + s] = static_cast<float>(exp(su[s] - gL));
    sc.inter[row0 + s] = static_cast<float>(exp(m0v - sg[s]));
    sc.floor[row0 + s] = static_cast<float>(exp(-(sb[s] + sg[s])));
  }
}

// W of the 16 x 64 tile (rows r0 .., columns c0 ..) from its dot products
// `full` (fp64, [row][column], in shared memory), and its rows' sums: a
// thread row tid / 16, columns 4 (tid % 16) .. + 3; `qn` is the thread's
// share of its row's q_t . n0 (column-0 blocks); the row's 16 threads add
// in a fixed order.
__device__ void finish_w(const double* full, double qn, const Scratch& sc,
                         const double* su, const double* sg, double m0v,
                         int bh, int r0, int c, int L, int LP, int t_tiles) {
  const int tid = threadIdx.x, row = tid >> 4, c0 = c * kTile;
  const size_t row0 = static_cast<size_t>(bh) * L;
  const int t = r0 + row, s0 = c0 + (tid & 15) * 4;
  float w[4];
  double part = 0.0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s = s0 + j;
    const double wd = (t < L && s <= t)
                          ? full[row * kTile + s - c0] * exp(su[s] - sg[t])
                          : 0.0;
    w[j] = static_cast<float>(wd);
    part += wd;
  }
  if (t < L && s0 < LP) store4(sc.W + (row0 + t) * LP + s0, w);
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    part += __shfl_xor_sync(0xffffffffu, part, off);
    qn += __shfl_xor_sync(0xffffffffu, qn, off);
  }
  if ((tid & 15) == 0 && t < L) {
    sc.part[(row0 + t) * t_tiles + c] = part;
    if (c == 0) sc.nq0[row0 + t] = exp(m0v - sg[t]) * qn;
  }
}

// Grid (BH, ceil(L / kRows), ceil(L / kTile)): the block owns rows r0 ..
// r0 + 15 and columns c0 .. c0 + 63 of W (blocks wholly above the diagonal
// leave at once).  The dot products over dh run in fp32 on 32-deep slices
// staged through shared memory (loads four slices ahead of the products);
// each of four 64-thread groups takes 8 of a slice's 32 d, a thread a 4 x
// 4 micro-tile (rows 4 lr .., columns 4 lc ..), and every two slices' fp32
// sums are added into fp64.  At the end the groups' sums meet in a fixed
// order, (g0 + g2) + (g1 + g3), and every thread finishes 4 elements of
// W.  The normaliser cancels where a row's scores have
// both signs (its condition number reaches 10^4 at dh 1024), and then an
// fp32 rounding of its summands moves h by that factor: so the scan, the
// decay factors, W before its rounding to fp32 and the row sums are fp64.
// Each block writes its rows' sums of W over its columns (part, fp64),
// which the h tiles add in column order; the column-0 blocks write
// exp(m0 - g_t) q_t . n0 (nq0, fp64), exp(-m_t), exp(m0 - g_t) and
// exp(u_t - g_L) for their rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_scores(const T* __restrict__ q, const T* __restrict__ k,
             const float* __restrict__ i_pre,
             const float* __restrict__ f_pre, const float* __restrict__ n0,
             const float* __restrict__ m0, Scratch sc, float* __restrict__ m1,
             int L, int LP, int dh, int t_tiles, int k_parts) {
  __shared__ double sb[kMaxL], su[kMaxL], sg[kMaxL];
  __shared__ __align__(16) float qT[2][kDs][kRows];      // q^T: [d][row]
  __shared__ __align__(16) float kT[2][kDs][kTP];        // k^T: [d][s]
  __shared__ float n0s[2][kDs];                          // n0, a d slice
  static_assert(sizeof(kT) >= 2 * 16 * 64 * sizeof(double),
                "the groups' sums and the tile's dot products meet in kT");

  const int bh = blockIdx.x, r0 = blockIdx.y * kRows;
  const int c = blockIdx.z / k_parts, kp = blockIdx.z % k_parts;
  const int c0 = c * kTile;
  if (c0 > r0 + kRows - 1) return;             // above the diagonal
  const int tid = threadIdx.x, grp = tid >> 6, g = tid & 63;
  const int lr = g >> 4, lc = g & 15;
  const size_t row0 = static_cast<size_t>(bh) * L;
  const double m0v = m0[bh];
  // this block's part of dh: d0 .. d0 + dn - 1
  const int d0 = kp * kSPart, dn = k_parts == 1 ? dh : min(kSPart, dh - d0);
  const T* qb = q + row0 * dh + d0;
  const T* kb = k + row0 * dh + d0;

  // slice loads: q rows (threads 0..127, 4 values each), k rows (every
  // thread, two runs of 4 values), and for the column-0 blocks n0 (threads
  // 0..15, 2 values each), fetched raw and stored after the slice's
  // products
  const int qr = (tid & 127) >> 3, qd = (tid & 7) * 4;
  const int kr = tid >> 2, kd = (tid & 3) * 4;
  const int nrow = tid >> 4, nd = (tid & 15) * 2;   // q . n0: row, 2 d
  const int nk = (dn + kDs - 1) / kDs;
  constexpr int kDepth = 4;                    // slices in flight
  Raw4<T> qa[kDepth], ka[kDepth][2];
  float nv[kDepth][2] = {};
  auto load = [&](int kt, auto set) {
    constexpr int x = decltype(set)::value;
    const int ds = kt * kDs;
    qa[x].clear();
    if (tid < 128 && r0 + qr < L && ds + qd < dn)
      qa[x].fetch(qb + static_cast<size_t>(r0 + qr) * dh + ds + qd);
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      ka[x][y].clear();
      const int dd = ds + kd + 16 * y;
      if (c0 + kr < L && dd < dn)
        ka[x][y].fetch(kb + static_cast<size_t>(c0 + kr) * dh + dd);
    }
    if (c == 0 && tid < 16) {
#pragma unroll
      for (int y = 0; y < 2; ++y)
        nv[x][y] = ds + nd + y < dn
                       ? n0[static_cast<size_t>(bh) * dh + d0 + ds + nd + y]
                       : 0.f;
    }
  };
  auto put = [&](int, auto set) {
    constexpr int x = decltype(set)::value, buf = x & 1;
    float fq[4], fk[2][4];
    qa[x].get(fq);
    ka[x][0].get(fk[0]);
    ka[x][1].get(fk[1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (tid < 128) qT[buf][qd + i][qr] = fq[i];
      kT[buf][kd + i][kr] = fk[0][i];
      kT[buf][kd + 16 + i][kr] = fk[1][i];
    }
    if (c == 0 && tid < 16) {
      n0s[buf][nd] = nv[x][0];
      n0s[buf][nd + 1] = nv[x][1];
    }
  };
  double dot[4][4] = {};
  float run[4][4] = {};                        // fp32 sums of up to 64 d
  double qn = 0.0;                             // q_t . n0 (column-0 blocks)
  auto flush = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dot[i][j] += run[i][j];
        run[i][j] = 0.f;
      }
  };
  // the gate scan runs while the first slices load (with dh in parts,
  // mlstm_combine scans)
  auto scan = [&]() {
    if (k_parts > 1) return;
    gate_scan(i_pre + row0, f_pre + row0, m0v, L, sb, su, sg);
    if (c == 0) row_constants(sc, m1, sb, su, sg, m0v, bh, r0, L);
  };
  pipeline<kDepth>(nk, load, put, [&](auto set) {
    constexpr int x = decltype(set)::value, buf = x & 1;
    float (&acc)[4][4] = run;
#pragma unroll
    for (int dd = 0; dd < kDs / 4; ++dd) {
      const int d = grp * (kDs / 4) + dd;
      const float4 av =
          *reinterpret_cast<const float4*>(&qT[buf][d][lr * 4]);
      const float4 bv =
          *reinterpret_cast<const float4*>(&kT[buf][d][lc * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    if (x & 1) flush();                        // after every second slice
    if (c == 0) {
      qn = fma(static_cast<double>(qT[buf][nd][nrow]),
               static_cast<double>(n0s[buf][nd]), qn);
      qn = fma(static_cast<double>(qT[buf][nd + 1][nrow]),
               static_cast<double>(n0s[buf][nd + 1]), qn);
    }
  }, scan);
  flush();

  // the groups' sums, (g0 + g2) + (g1 + g3), through kT (free now)
  double* red = reinterpret_cast<double*>(&kT[0][0][0]);
  if (grp >= 2) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      red[((grp - 2) * 16 + e) * 64 + g] = dot[e / 4][e % 4];
  }
  __syncthreads();
  if (grp < 2) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      dot[e / 4][e % 4] += red[(grp * 16 + e) * 64 + g];
  }
  __syncthreads();
  if (grp == 1) {
#pragma unroll
    for (int e = 0; e < 16; ++e) red[e * 64 + g] = dot[e / 4][e % 4];
  }
  __syncthreads();
  // the whole tile's dot products, [row][column], after red's 1024
  double* full = red + 1024;
  if (grp == 0) {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      full[(lr * 4 + e / 4) * kTile + lc * 4 + e % 4] =
          dot[e / 4][e % 4] + red[e * 64 + g];
  }
  __syncthreads();
  if (k_parts == 1) {
    finish_w(full, qn, sc, su, sg, m0v, bh, r0, c, L, LP, t_tiles);
    return;
  }
  // dh in parts: this part's dot products and q . n0 for mlstm_combine
  const size_t tile = (static_cast<size_t>(bh) * gridDim.y + blockIdx.y) *
                          t_tiles + c;
  double* pd = sc.pdot + (tile * k_parts + kp) * (kRows * kTile);
#pragma unroll
  for (int i = 0; i < kRows * kTile / kThreads; ++i)
    pd[tid + kThreads * i] = full[tid + kThreads * i];
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    qn += __shfl_xor_sync(0xffffffffu, qn, off);
  if (c == 0 && (tid & 15) == 0)
    sc.pqn[((static_cast<size_t>(bh) * gridDim.y + blockIdx.y) * k_parts +
            kp) * kRows + nrow] = qn;
}

// With dh in parts: grid (BH, ceil(L / kRows), ceil(L / kTile)), a block
// a tile of W as in mlstm_scores: the gate scan, the row constants, the
// parts' dot products and q . n0 added in part order, then W.
__global__ void __launch_bounds__(kThreads)
mlstm_combine(const float* __restrict__ i_pre,
              const float* __restrict__ f_pre, const float* __restrict__ m0,
              Scratch sc, float* __restrict__ m1, int L, int LP,
              int t_tiles, int k_parts) {
  __shared__ double sb[kMaxL], su[kMaxL], sg[kMaxL];
  __shared__ double full[kRows * kTile];
  const int bh = blockIdx.x, r0 = blockIdx.y * kRows, c = blockIdx.z;
  if (c * kTile > r0 + kRows - 1) return;      // above the diagonal
  const int tid = threadIdx.x;
  const size_t row0 = static_cast<size_t>(bh) * L;
  const double m0v = m0[bh];
  const size_t tile = (static_cast<size_t>(bh) * gridDim.y + blockIdx.y) *
                          t_tiles + c;
  const double* pd = sc.pdot + tile * k_parts * (kRows * kTile);
#pragma unroll
  for (int i = 0; i < kRows * kTile / kThreads; ++i) {
    const int e = tid + kThreads * i;
    double sum = pd[e];
    for (int p = 1; p < k_parts; ++p) sum += pd[p * (kRows * kTile) + e];
    full[e] = sum;
  }
  double qn = 0.0;
  if (c == 0 && (tid & 15) == 0) {
    const double* pq = sc.pqn + (static_cast<size_t>(bh) * gridDim.y +
                                 blockIdx.y) * k_parts * kRows + (tid >> 4);
    for (int p = 0; p < k_parts; ++p) qn += pq[p * kRows];
  }
  gate_scan(i_pre + row0, f_pre + row0, m0v, L, sb, su, sg);
  if (c == 0) row_constants(sc, m1, sb, su, sg, m0v, bh, r0, L);
  finish_w(full, qn, sc, su, sg, m0v, bh, r0, c, L, LP, t_tiles);
}

// ---- 2. output ------------------------------------------------------------

constexpr int kOut = 128;         // threads of an output block
constexpr int kOutDepth = 2;      // slices in flight in an output block

struct Smem {
  float A[2][kBK][kTP];       // A^T slices: [k][m]
  float B[2][kBK][kTP];       // B slices: [k][n]
  float den[kTile];           // h tiles: their rows' denominators
};

// Thread (ty, tx) = (tid / 16, tid % 16) of an output block owns an 8 x 4
// micro-tile: rows 4 ty .. 4 ty + 3 and 32 + 4 ty .. 32 + 4 ty + 3 (i = 0
// .. 7 -> at(i, ty)) and columns 4 tx .. 4 tx + 3 of the 64 x 64 tile.  A
// 128-bit shared load is served a quarter-warp (8 lanes) at a time: the 8
// lanes of a quarter-warp share ty, so they read one float4 of A and
// eight neighbouring float4s of B, one shared-memory cycle each: 12 cycles
// for a warp's 32 fmas a step.
__device__ __forceinline__ int at(int i, int t) {
  return (i & 4) * 8 + 4 * t + (i & 3);
}

// acc += A B over nk slices of depth kBK, through pipeline(): fetch(kt,
// set) loads this thread's values of slice kt of A and B into register
// set `set`; put(kt, set) stores them into shared buffer set & 1.
template <class Fetch, class Put>
__device__ __forceinline__ void mainloop(float (&acc)[8][4], int nk,
                                         Smem& sm, int ty, int tx,
                                         Fetch fetch, Put put) {
  pipeline<kOutDepth>(nk, fetch, put, [&](auto set) {
    constexpr int buf = decltype(set)::value & 1;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&sm.A[buf][kk][4 * ty]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sm.A[buf][kk][32 + 4 * ty]);
      const float4 b0 =
          *reinterpret_cast<const float4*>(&sm.B[buf][kk][4 * tx]);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  });
}

struct OutArgs {
  const float* C0;
  const float* n0;
  float* C1;
  float* n1;
  Scratch sc;
  int BH, L, LP, dh, t_tiles, d_tiles, n1_blocks, h_parts;
};

// max(|nq_t|, exp(-m_t)): W's row sums over the column tiles at or left
// of the diagonal, in order, then the state's part, in fp64.
__device__ __forceinline__ float row_den(const OutArgs& o, size_t row,
                                         int t) {
  const double* pt = o.sc.part + row * o.t_tiles;
  double nq = 0.0;
  for (int c = 0; c * kTile <= (t / kRows) * kRows + kRows - 1; ++c)
    nq += pt[c];
  nq += o.sc.nq0[row];
  return static_cast<float>(
      fmax(fabs(nq), static_cast<double>(o.sc.floor[row])));
}

// A thread's loads of a 16 x 64 slice: kRuns runs of 4 values.  Row-major
// with 64 columns (B, and the state tiles' A): run p is row (tid + 128 p)
// / 16, columns 4 ((tid + 128 p) % 16) ..; 64 rows of 16 (the h tiles' A,
// stored transposed): run p is row (tid + 128 p) / 4, columns 4 ((tid +
// 128 p) % 4) ...
constexpr int kRuns = kBK * kTile / (4 * kOut);
__device__ __forceinline__ int run_row16(int p) {
  return (threadIdx.x + kOut * p) >> 4;
}
__device__ __forceinline__ int run_col16(int p) {
  return ((threadIdx.x + kOut * p) & 15) * 4;
}
__device__ __forceinline__ int run_row64(int p) {
  return (threadIdx.x + kOut * p) >> 2;
}
__device__ __forceinline__ int run_col64(int p) {
  return ((threadIdx.x + kOut * p) & 3) * 4;
}

// h rows t0 .. t0 + 63, columns j0 .. j0 + 63 of head bh: part 0 takes
// W v and rows 0 .. 255 of C0, part p rows 256 p .. 256 p + 255.  With one
// part the tile divides by the denominators and writes h; with more it
// writes its part of the numerator for mlstm_finish.
template <typename T>
__device__ __forceinline__ void h_tile(const T* __restrict__ q,
                                       const T* __restrict__ v,
                                       T* __restrict__ h, const OutArgs& o,
                                       Smem& sm, int bh, int t0, int j0,
                                       int part, int ty, int tx) {
  const int tid = threadIdx.x, L = o.L, dh = o.dh;
  const size_t row0 = static_cast<size_t>(bh) * L;
  const T* vb = v + row0 * dh + j0;
  // the rows' denominators, read after a barrier
  if (o.h_parts == 1 && tid < kTile && t0 + tid < L)
    sm.den[tid] = row_den(o, row0 + t0 + tid, t0 + tid);
  float acc[8][4] = {};
  Raw4<float> wa[kOutDepth][kRuns], cb[kOutDepth][kRuns];
  Raw4<T> va[kOutDepth][kRuns], qa[kOutDepth][kRuns];

  // W v over s < min(t0 + 64, L), W masked to s <= t
  const int send = part == 0 ? min(t0 + kTile, L) : 0;
  mainloop(acc, (send + kBK - 1) / kBK, sm, ty, tx,
           [&](int kt, auto set) {
             constexpr int x = decltype(set)::value;
#pragma unroll
             for (int p = 0; p < kRuns; ++p) {
               const int t = t0 + run_row64(p), s = kt * kBK + run_col64(p);
               wa[x][p].clear();
               if (t < L && s < L)
                 wa[x][p].fetch(o.sc.W + (row0 + t) * o.LP + s);
               const int sv = kt * kBK + run_row16(p), c4 = run_col16(p);
               va[x][p].clear();
               if (sv < L && j0 + c4 < dh)
                 va[x][p].fetch(vb + static_cast<size_t>(sv) * dh + c4);
             }
           },
           [&](int kt, auto set) {
             constexpr int x = decltype(set)::value;
#pragma unroll
             for (int p = 0; p < kRuns; ++p) {
               float a[4], b[4];
               wa[x][p].get(a);
               va[x][p].get(b);
               const int m = run_row64(p), k4 = run_col64(p);
               const int s = kt * kBK + k4;
#pragma unroll
               for (int i = 0; i < 4; ++i)
                 sm.A[x & 1][k4 + i][m] = s + i > t0 + m ? 0.f : a[i];
               store4(&sm.B[x & 1][run_row16(p)][run_col16(p)], b);
             }
           });

  // (exp(m0 - g_t) q_t) C0 over this part's rows of C0, skipped where
  // every row's factor is 0
  float it[kRuns];
  bool any = false;
#pragma unroll
  for (int p = 0; p < kRuns; ++p) {
    const int t = t0 + run_row64(p);
    it[p] = t < L ? o.sc.inter[row0 + t] : 0.f;
    any = any || it[p] != 0.f;
  }
  const int dlo = part * kHPart, dn = min(dh, dlo + kHPart) - dlo;
  if (__syncthreads_or(any)) {
    const float* Cb =
        o.C0 + (static_cast<size_t>(bh) * dh + dlo) * dh + j0;
    mainloop(acc, (dn + kBK - 1) / kBK, sm, ty, tx,
             [&](int kt, auto set) {
               constexpr int x = decltype(set)::value;
#pragma unroll
               for (int p = 0; p < kRuns; ++p) {
                 const int t = t0 + run_row64(p), d = kt * kBK + run_col64(p);
                 qa[x][p].clear();
                 if (t < L && d < dn)
                   qa[x][p].fetch(q + (row0 + t) * dh + dlo + d);
                 const int dc = kt * kBK + run_row16(p);
                 cb[x][p].clear();
                 if (dc < dn && j0 + run_col16(p) < dh)
                   cb[x][p].fetch(Cb + static_cast<size_t>(dc) * dh +
                                  run_col16(p));
               }
             },
             [&](int, auto set) {
               constexpr int x = decltype(set)::value;
#pragma unroll
               for (int p = 0; p < kRuns; ++p) {
                 float a[4], b[4];
                 qa[x][p].get(a);
                 cb[x][p].get(b);
                 const int m = run_row64(p), k4 = run_col64(p);
#pragma unroll
                 for (int i = 0; i < 4; ++i)
                   sm.A[x & 1][k4 + i][m] = a[i] * it[p];
                 store4(&sm.B[x & 1][run_row16(p)][run_col16(p)], b);
               }
             });
  }

  float* hn = o.sc.hnum + static_cast<size_t>(part) * o.BH * L * dh;
  const int j = j0 + 4 * tx;
  if (j >= dh) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = at(i, ty), t = t0 + r;
    if (t >= L) continue;
    if (o.h_parts > 1) {
      store4(hn + (row0 + t) * dh + j, acc[i]);
    } else {
      float f[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) f[c] = acc[i][c] / sm.den[r];
      store4(h + (row0 + t) * dh + j, f);
    }
  }
}

// C1 rows d0 .. d0 + 63, columns j0 .. j0 + 63 of head bh.
template <typename T>
__device__ __forceinline__ void state_tile(const T* __restrict__ k,
                                           const T* __restrict__ v,
                                           const OutArgs& o, Smem& sm,
                                           int bh, int d0, int j0, int ty,
                                           int tx) {
  const int L = o.L, dh = o.dh;
  const size_t row0 = static_cast<size_t>(bh) * L;
  const T* kb = k + row0 * dh + d0;
  const T* vb = v + row0 * dh + j0;
  float acc[8][4] = {};
  Raw4<T> ka[kOutDepth][kRuns], va[kOutDepth][kRuns];
  float w[kOutDepth][kRuns];
  mainloop(acc, (L + kBK - 1) / kBK, sm, ty, tx,
           [&](int kt, auto set) {
             constexpr int x = decltype(set)::value;
#pragma unroll
             for (int p = 0; p < kRuns; ++p) {
               const int s = kt * kBK + run_row16(p), c4 = run_col16(p);
               ka[x][p].clear();
               va[x][p].clear();
               w[x][p] = 0.f;
               if (s < L) {
                 if (d0 + c4 < dh) {
                   w[x][p] = o.sc.ws[row0 + s];
                   ka[x][p].fetch(kb + static_cast<size_t>(s) * dh + c4);
                 }
                 if (j0 + c4 < dh)
                   va[x][p].fetch(vb + static_cast<size_t>(s) * dh + c4);
               }
             }
           },
           [&](int, auto set) {
             constexpr int x = decltype(set)::value;
#pragma unroll
             for (int p = 0; p < kRuns; ++p) {
               float a[4], b[4];
               ka[x][p].get(a);
               va[x][p].get(b);
#pragma unroll
               for (int i = 0; i < 4; ++i) a[i] *= w[x][p];
               store4(&sm.A[x & 1][run_row16(p)][run_col16(p)], a);
               store4(&sm.B[x & 1][run_row16(p)][run_col16(p)], b);
             }
           });

  const float dec = o.sc.decay[bh];
  const size_t base = static_cast<size_t>(bh) * dh * dh;
  const int j = j0 + 4 * tx;
  if (j >= dh) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int d = d0 + at(i, ty);
    if (d >= dh) continue;
    float f[4] = {acc[i][0], acc[i][1], acc[i][2], acc[i][3]};
    if (dec != 0.f) {
      float c0[4];
      load4(o.C0 + base + static_cast<size_t>(d) * dh + j, c0);
#pragma unroll
      for (int c = 0; c < 4; ++c) f[c] = dec * c0[c] + f[c];
    }
    store4(o.C1 + base + static_cast<size_t>(d) * dh + j, f);
  }
}

// n1 for columns part * 128 .. + 127 of head bh: one thread a column, the
// sum over s in order, 16 rows of k loaded at a time.
template <typename T>
__device__ void n1_block(const T* __restrict__ k, const OutArgs& o, int bh,
                         int part) {
  constexpr int kU = 16;
  const int d = part * kN1 + threadIdx.x;
  if (d >= o.dh) return;
  const size_t row0 = static_cast<size_t>(bh) * o.L;
  const float* ws = o.sc.ws + row0;
  const T* kd = k + row0 * o.dh + d;
  float acc = 0.f;
  for (int s0 = 0; s0 < o.L; s0 += kU) {
    float kv[kU], wv[kU];
#pragma unroll
    for (int j = 0; j < kU; ++j) {
      const bool in = s0 + j < o.L;
      kv[j] = in ? to_float(kd[static_cast<size_t>(s0 + j) * o.dh]) : 0.f;
      wv[j] = in ? ws[s0 + j] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kU; ++j) acc += wv[j] * kv[j];
  }
  const float dec = o.sc.decay[bh];
  const size_t i = static_cast<size_t>(bh) * o.dh + d;
  o.n1[i] = dec != 0.f ? dec * o.n0[i] + acc : acc;
}

template <typename T>
__global__ void __launch_bounds__(kOut)
mlstm_out(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ h, OutArgs o) {
  __shared__ __align__(16) Smem sm;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  int id = blockIdx.x;
  const int per_h = o.t_tiles * o.d_tiles * o.h_parts;
  const int per_c = o.d_tiles * o.d_tiles;
  if (id < o.BH * per_h) {
    const int bh = id / per_h, r = id % per_h / o.h_parts;
    h_tile(q, v, h, o, sm, bh, (r / o.d_tiles) * kTile,
           (r % o.d_tiles) * kTile, id % o.h_parts, ty, tx);
    return;
  }
  id -= o.BH * per_h;
  if (id < o.BH * per_c) {
    const int bh = id / per_c, r = id % per_c;
    state_tile(k, v, o, sm, bh, (r / o.d_tiles) * kTile,
               (r % o.d_tiles) * kTile, ty, tx);
    return;
  }
  id -= o.BH * per_c;
  n1_block(k, o, id / o.n1_blocks, id % o.n1_blocks);
}

// h = (sum of the parts' numerators, in order) / den, 4 columns of one
// row a thread: the third launch when h's numerator came in parts.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_finish(T* __restrict__ h, OutArgs o) {
  const size_t quads = static_cast<size_t>(o.BH) * o.L * (o.dh / 4);
  const size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= quads) return;
  const size_t row = e / (o.dh / 4);
  const int j = static_cast<int>(e % (o.dh / 4)) * 4;
  const int t = static_cast<int>(row % o.L);
  const size_t plane = static_cast<size_t>(o.BH) * o.L * o.dh;
  float acc[4];
  load4(o.sc.hnum + row * o.dh + j, acc);
  for (int p = 1; p < o.h_parts; ++p) {
    float f[4];
    load4(o.sc.hnum + p * plane + row * o.dh + j, f);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] += f[c];
  }
  const float dn = row_den(o, row, t);
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] /= dn;
  store4(h + row * o.dh + j, acc);
}

template <typename T>
cudaError_t launch(const Launch& a, cudaStream_t stream) {
  const OutArgs o{a.C0, a.n0, a.C1, a.n1, a.sc, a.BH, a.L, a.LP, a.dh,
                  a.t_tiles, a.d_tiles, a.n1_blocks, a.h_parts};
  mlstm_scores<T><<<dim3(a.BH, a.row_tiles, a.t_tiles * a.k_parts),
                    kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), a.i_pre,
      a.f_pre, a.n0, a.m0, a.sc, a.m1, a.L, a.LP, a.dh, a.t_tiles,
      a.k_parts);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (a.k_parts > 1) {
    mlstm_combine<<<dim3(a.BH, a.row_tiles, a.t_tiles), kThreads, 0,
                    stream>>>(a.i_pre, a.f_pre, a.m0, a.sc, a.m1, a.L, a.LP,
                              a.t_tiles, a.k_parts);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  mlstm_out<T><<<a.out_blocks, kOut, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.h), o);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.h_parts == 1) return e;
  mlstm_finish<T><<<a.finish_blocks, kThreads, 0, stream>>>(
      static_cast<T*>(a.h), o);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mlstm_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The arguments in one Launch (ops.py packs it): q, k, v and h (B*H, L,
// dh): contiguous, 16-byte aligned, fp32 (is_bf16 = 0) or bf16 (is_bf16 =
// 1); i_pre, f_pre (B*H, L), C0 and C1 (B*H, dh, dh, 16-byte aligned), n0
// and n1 (B*H, dh), m0 and m1 (B*H,): contiguous fp32.  1 <= L <= 512; dh
// a multiple of 8 from 8 to 1024.  sc: the regions of ops.plan's scratch
// (pdot and pqn with dh in parts, hnum with h in parts; W and hnum 16-byte
// aligned); the grid: ops.plan's, which must cover L and dh exactly, with
// out_blocks the blocks mlstm_out decodes and finish_blocks covering h.
int mlstm_chunk_launch(const Launch* a, void* stream) {
  const auto covers = [](long long tiles, long long size, long long n) {
    return tiles >= 1 && tiles * size >= n && (tiles - 1) * size < n;
  };
  const auto aligned = [](const void* p) {
    return p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const Scratch& sc = a->sc;
  const long long BH = a->BH, h_values = BH * a->L * a->dh;
  if (a->BH < 1 || a->L < 1 || a->L > kMaxL || a->dh < 8 ||
      a->dh > kMaxDh || a->dh % 8 || a->LP < a->L || a->LP % 4 ||
      !covers(a->row_tiles, kRows, a->L) || !covers(a->t_tiles, kTile, a->L) ||
      !covers(a->d_tiles, kTile, a->dh) || !covers(a->n1_blocks, kN1, a->dh) ||
      !covers(a->h_parts, kHPart, a->dh) ||
      !covers(a->k_parts, kSPart, a->dh) ||
      a->out_blocks != BH * (a->t_tiles * a->d_tiles * a->h_parts +
                             a->d_tiles * a->d_tiles + a->n1_blocks) ||
      (a->h_parts > 1 ? !covers(a->finish_blocks, 4 * kThreads, h_values)
                      : a->finish_blocks != 0) ||
      !sc.part || !sc.nq0 || !aligned(sc.W) || !sc.floor || !sc.inter ||
      !sc.ws || !sc.decay || (a->k_parts > 1 && (!sc.pdot || !sc.pqn)) ||
      (a->h_parts > 1 && !aligned(sc.hnum))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = a->is_bf16 ? launch<uint16_t>(*a, s)
                                   : launch<float>(*a, s);
  return static_cast<int>(e);
}

}  // extern "C"
