// Batched thin-QR (Q factor) of tall-skinny panels for Hopper (sm_90a):
// PowerSGD's orthonormalization (repro_torch/comm/lowrank.py), one launch
// for every panel of a fire.
//
// Replaces the Pallas TPU kernel repro/kernels/batched_qr.py::batched_qr
// (body _qr_kernel) and computes its recurrence, classical Gram-Schmidt
// with reorthogonalization (CGS2), in fp32:
//
//   p [batch, a, r] fp32, a >= r; for each panel and column j = 0 .. r-1:
//     v = p[:, j]
//     twice, for j > 0:  c = Q[:, :j]^T v ;  v = v - Q[:, :j] c
//     Q[:, j] = |v|^2 > 1e-30 ? v * rsqrt(|v|^2) : 0
//
// so a rank-deficient column comes out as an exact zero column and each
// column keeps the input panel's sign.  The plain version is
// repro_torch/kernels/ref.py::batched_qr_plain (another sum order: equal
// within a tolerance); ref.py::batched_qr_blocked_plain runs this kernel's
// arithmetic operation for operation from the same plan, and the kernel
// should equal it to the bit: every sum is an explicit fmaf chain or a
// fixed tree of fp32 additions, the projection subtracts with __fsub_rn,
// and the inverse norm is __frsqrt_rn(n), the correctly rounded rsqrt.
//
// What bounds it.  Bytes: each panel is read once and Q written once
// (PowerSGD's [16, 1536, 2] bucket is 0.39 MB, 0.12 us at 3.35 TB/s).  At
// the trainer's sizes that is far below the latency of the work itself:
// the launch, one cold round trip to device memory, and a chain of
// reductions, each of which every thread waits for (4 at r = 2: the norm
// of column 0; two projections and the norm of column 1).
//
// What the design does about it.
//   * One launch a fire.  A call takes the segments (the panels of every
//     compressible leaf or of a bucket) and the piece each CTA works,
//     planned on the host (kernels/batched_qr.py::qr_plan), as its 4 KB
//     parameter block: no table goes to the device ahead of the launch,
//     and a CTA finds its work in two reads through the constant cache.
//     A panel's plan depends on its own (a, r) alone, so its Q is the
//     same bits in any group.
//   * Read once.  A thread owns units of rows (lcm(r, 4) / r rows: whole
//     16-byte vectors), units tid, tid + threads, ..., and loads them all
//     at the start, every load in flight, with 16-byte loads where the
//     slab is aligned (4-byte ones otherwise).  For r <= 8 the rows stay
//     in registers (REG_FLOATS values a thread; every loop over them stops
//     after the thread's last unit); 8 < r <= 32 keeps them in shared
//     memory (SMEM_FLOATS a CTA, odd row stride).  Q is written once at
//     the end, with 16-byte stores where aligned.
//   * Reductions.  A thread's partial is an fmaf chain over its rows; a
//     warp butterfly sums the lanes; lane 0 writes the warp's sum to one
//     of two slot buffers (used in turn, so one barrier a reduction
//     suffices); after the barrier each warp sums the 8 warp sums of the
//     CTA (or the 64 of a cluster) by halves.  Column 0 runs no
//     projection pass.
//   * Four sizes of panel, by the plan (mode):
//       warp     a <= WARP_ROWS and r <= 8: a warp a panel, 8 panels a
//                CTA, the butterfly alone (no barrier);
//       cta      one CTA holds the panel (a <= 256 * thread rows, e.g.
//                8192 rows at r = 2);
//       cluster  a thread-block cluster of CLUSTER CTAs splits the rows
//                (e.g. rwkv6's [4, 65536, 2] embedding panel in 8 x 64 KB)
//                and exchanges its warp sums through distributed shared
//                memory, one cluster barrier a reduction;
//       device   a panel no cluster holds (more than 8 x 64 KB of it on
//                chip, e.g. [65536, 8]) is worked in place in the output
//                by a cluster, each thread on its own rows; each pass
//                reads them again (from L2).
//     The launch takes clusters of CLUSTER CTAs when any panel needs one;
//     cluster panels then come first, one whole cluster each, and the
//     other CTAs never touch a cluster barrier.
//   * Host side: the shared-memory limit is set once per device, and the
//     launch follows a check of the parameter block against this file's
//     limits.
//
// Built with nvcc into a plain-C shared library and loaded with ctypes
// (repro_torch/kernels/_build.py, repro_torch/kernels/batched_qr.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <cstring>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CLUSTER = 8;
constexpr int REG_FLOATS = 64;
constexpr int SMEM_FLOATS = 16384;
constexpr int WARP_ROWS = 256;
constexpr int RMAX = 32;
constexpr float EPS = 1e-30f;
constexpr unsigned FULL = 0xffffffffu;
static_assert(WARPS * CLUSTER == 64, "a cluster reduction sums 64 warps");

// The launch's parameter block (4 KB, the kernel parameter limit; read
// through the constant cache, nothing to copy to the device first):
// pieces of segments (a segment's panels first .. first + batch, its
// pointers moved to the first), and for each CTA the piece it works
// (IDLE: padding to whole clusters).
constexpr int M_WARP = 0, M_CTA = 1, M_CLUSTER = 2, M_DEVICE = 3;
struct Seg {
  const float* p;
  float* q;
  int batch, a, r, mode, span, cta0;   // cta0: the piece's first CTA
};
constexpr int MAX_SEGS = 48;
constexpr int PARAM_BYTES = 4096;
constexpr int MAX_CTAS = PARAM_BYTES - MAX_SEGS * (int)sizeof(Seg) - 8;
constexpr unsigned char IDLE = 255;
struct Params {
  Seg seg[MAX_SEGS];
  int nseg, ncta;
  unsigned char owner[MAX_CTAS];
};
static_assert(sizeof(Seg) == 40 && sizeof(Params) == PARAM_BYTES,
              "kernels/batched_qr.py packs this layout");
// the scope of a reduction
constexpr int S_WARP = 0, S_CTA = 1, S_CLUSTER = 2;

// rows a thread loads together, the most it holds in registers (r <= 8),
// the shared-memory row stride (r > 8) and the most rows a CTA holds
__host__ __device__ constexpr int unit_rows(int r) {
  return r > 8 ? 1 : (r % 4 == 0 ? 1 : (r % 2 == 0 ? 2 : 4));
}
__host__ __device__ constexpr int thread_rows(int r) {
  return REG_FLOATS / r / unit_rows(r) * unit_rows(r);
}
__host__ __device__ constexpr int smem_stride(int r) { return r | 1; }
__host__ __device__ constexpr int cta_rows(int r) {
  return r <= 8 ? THREADS * thread_rows(r) : SMEM_FLOATS / smem_stride(r);
}

typedef float Slots[2][WARPS][RMAX];

// The cluster's barrier in two halves: arrive (releasing this thread's
// shared-memory writes to the cluster) and wait (acquiring the others').
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int SCOPE>
__device__ __forceinline__ void scope_sync() {
  if (SCOPE == S_CTA) {
    __syncthreads();
  } else if (SCOPE == S_CLUSTER) {
    cluster_arrive();
    cluster_wait();
  }
}

// Sum over the warp's lanes by halves: lane i adds lane i ^ 16, then 8,
// 4, 2, 1; every lane ends with the same bits.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// After the barrier: value k summed over the warp sums of one buffer,
// entry (rank, warp) at rank * WARPS + warp, by halves (8 entries for a
// CTA, 64 for a cluster: lane l first adds entries l and l + 32).  Every
// thread gets it.
template <int SCOPE>
__device__ __forceinline__ float gather(float (*slot)[RMAX], int k) {
  const int lane = threadIdx.x & 31;
  float x;
  if (SCOPE == S_CTA) {
    x = lane < WARPS ? slot[lane][k] : 0.0f;
#pragma unroll
    for (int o = WARPS / 2; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  } else {
    cg::cluster_group cl = cg::this_cluster();
    const int at = (lane % WARPS) * RMAX + k;
    const float lo = cl.map_shared_rank(&slot[0][0], lane / WARPS)[at];
    const float hi = cl.map_shared_rank(&slot[0][0], (lane + 32) / WARPS)[at];
    x = warp_sum(lo + hi);
  }
  return __shfl_sync(FULL, x, 0);
}

// Every thread's v[0 .. cnt-1] becomes its sum over the scope (a warp, a
// CTA or a cluster): one barrier for all cnt values; slots[buf] is
// written, then buf flips.
template <int SCOPE, int N>
__device__ __forceinline__ void reduce(float (&v)[N], int cnt, Slots& slots,
                                       int& buf) {
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k < cnt) v[k] = warp_sum(v[k]);
  if (SCOPE == S_WARP) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < cnt) slots[buf][warp][k] = v[k];
  }
  scope_sync<SCOPE>();
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k < cnt) v[k] = gather<SCOPE>(slots[buf], k);
  buf ^= 1;
}

__device__ __forceinline__ float inv_norm(float n) {
  return n > EPS ? __frsqrt_rn(n) : 0.0f;
}

// ---------------------------------------------------------------------- //
// r <= 8: the thread's rows in registers

template <int R>
struct Reg {
  static constexpr int U = unit_rows(R);     // rows a unit
  static constexpr int K = thread_rows(R);   // rows a thread at most
  static constexpr int KU = K / U;           // units a thread at most
  static constexpr int V4 = U * R / 4;       // 16-byte vectors a unit
};

// x, q: the rows [0, rows) this group of nthr threads works ([rows, R]
// row-major); the thread is tid of them.
template <int R, int SCOPE>
__device__ void reg_panel(const float* __restrict__ x, float* __restrict__ q,
                          int rows, int tid, int nthr, Slots& slots) {
  using S = Reg<R>;
  float X[S::K][R];
  // the thread's units: every loop below stops after its last (rows of a
  // unit past `rows` are zeros, and only the sums skip them)
  const int units = (rows + S::U - 1) / S::U;
  const int nu = tid < units ? (units - tid + nthr - 1) / nthr : 0;
  // every load issued before any is used: one round trip
  const bool vin = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
#pragma unroll
  for (int u = 0; u < S::KU; ++u) {
    if (u >= nu) break;
    const int row0 = (tid + nthr * u) * S::U;
    if (vin && row0 + S::U <= rows) {
      const float4* src = reinterpret_cast<const float4*>(x + (size_t)row0 * R);
#pragma unroll
      for (int m = 0; m < S::V4; ++m) {
        const float4 t = __ldg(src + m);
        const float e[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          X[u * S::U + (4 * m + c) / R][(4 * m + c) % R] = e[c];
      }
    } else {
#pragma unroll
      for (int i = 0; i < S::U; ++i)
#pragma unroll
        for (int c = 0; c < R; ++c)
          X[u * S::U + i][c] =
              row0 + i < rows ? __ldg(x + (size_t)(row0 + i) * R + c) : 0.0f;
    }
  }

  int buf = 0;
#pragma unroll
  for (int j = 0; j < R; ++j) {
#pragma unroll
    for (int pass = 0; pass < (j > 0 ? 2 : 0); ++pass) {
      float c[R];
#pragma unroll
      for (int k = 0; k < R; ++k) c[k] = 0.0f;
#pragma unroll
      for (int u = 0; u < S::KU; ++u) {
        if (u >= nu) break;
#pragma unroll
        for (int i = 0; i < S::U; ++i)
          if ((tid + nthr * u) * S::U + i < rows) {
#pragma unroll
            for (int k = 0; k < j; ++k)
              c[k] = fmaf(X[u * S::U + i][k], X[u * S::U + i][j], c[k]);
          }
      }
      reduce<SCOPE, R>(c, j, slots, buf);
#pragma unroll
      for (int kk = 0; kk < S::K; ++kk) {
        if (kk >= nu * S::U) break;
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < j; ++k) s = fmaf(X[kk][k], c[k], s);
        X[kk][j] = __fsub_rn(X[kk][j], s);
      }
    }
    float n[1] = {0.0f};
#pragma unroll
    for (int u = 0; u < S::KU; ++u) {
      if (u >= nu) break;
#pragma unroll
      for (int i = 0; i < S::U; ++i)
        if ((tid + nthr * u) * S::U + i < rows)
          n[0] = fmaf(X[u * S::U + i][j], X[u * S::U + i][j], n[0]);
    }
    reduce<SCOPE, 1>(n, 1, slots, buf);
    const float inv = inv_norm(n[0]);
#pragma unroll
    for (int kk = 0; kk < S::K; ++kk) {
      if (kk >= nu * S::U) break;
      X[kk][j] = __fmul_rn(X[kk][j], inv);
    }
  }

  // the cluster's last reads of this CTA's slots are done once every CTA
  // has arrived: arrive now, store, and wait before leaving
  if (SCOPE == S_CLUSTER) cluster_arrive();
  const bool vout = (reinterpret_cast<uintptr_t>(q) & 15) == 0;
#pragma unroll
  for (int u = 0; u < S::KU; ++u) {
    if (u >= nu) break;
    const int row0 = (tid + nthr * u) * S::U;
    if (vout && row0 + S::U <= rows) {
      float4* dst = reinterpret_cast<float4*>(q + (size_t)row0 * R);
#pragma unroll
      for (int m = 0; m < S::V4; ++m) {
        float e[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          e[c] = X[u * S::U + (4 * m + c) / R][(4 * m + c) % R];
        dst[m] = make_float4(e[0], e[1], e[2], e[3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < S::U; ++i)
        if (row0 + i < rows) {
#pragma unroll
          for (int c = 0; c < R; ++c)
            q[(size_t)(row0 + i) * R + c] = X[u * S::U + i][c];
        }
    }
  }
  if (SCOPE == S_CLUSTER) cluster_wait();
}

template <int SCOPE>
__device__ void reg_dispatch(int r, const float* x, float* q, int rows,
                             int tid, int nthr, Slots& slots) {
  switch (r) {
    case 1: reg_panel<1, SCOPE>(x, q, rows, tid, nthr, slots); break;
    case 2: reg_panel<2, SCOPE>(x, q, rows, tid, nthr, slots); break;
    case 3: reg_panel<3, SCOPE>(x, q, rows, tid, nthr, slots); break;
    case 4: reg_panel<4, SCOPE>(x, q, rows, tid, nthr, slots); break;
    case 5: reg_panel<5, SCOPE>(x, q, rows, tid, nthr, slots); break;
    case 6: reg_panel<6, SCOPE>(x, q, rows, tid, nthr, slots); break;
    case 7: reg_panel<7, SCOPE>(x, q, rows, tid, nthr, slots); break;
    default: reg_panel<8, SCOPE>(x, q, rows, tid, nthr, slots); break;
  }
}

// ---------------------------------------------------------------------- //
// r > 8 (in shared memory) and panels no cluster holds (in device memory):
// S [rows, ld] row-major, thread tid owning rows tid, tid + THREADS, ...

template <int SCOPE>
__device__ void mem_cgs2(float* S, int ld, int rows, int r, Slots& slots) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float c[RMAX];
  int buf = 0;
  for (int j = 0; j < r; ++j) {
    for (int pass = 0; pass < (j > 0 ? 2 : 0); ++pass) {
      for (int k = 0; k < j; ++k) {
        float acc = 0.0f;
        for (int i = tid; i < rows; i += THREADS)
          acc = fmaf(S[(size_t)i * ld + k], S[(size_t)i * ld + j], acc);
        acc = warp_sum(acc);
        if (lane == 0) slots[buf][warp][k] = acc;
      }
      scope_sync<SCOPE>();
      for (int k = 0; k < j; ++k) c[k] = gather<SCOPE>(slots[buf], k);
      buf ^= 1;
      for (int i = tid; i < rows; i += THREADS) {
        float s = 0.0f;
        for (int k = 0; k < j; ++k) s = fmaf(S[(size_t)i * ld + k], c[k], s);
        S[(size_t)i * ld + j] = __fsub_rn(S[(size_t)i * ld + j], s);
      }
    }
    float acc = 0.0f;
    for (int i = tid; i < rows; i += THREADS) {
      const float v = S[(size_t)i * ld + j];
      acc = fmaf(v, v, acc);
    }
    acc = warp_sum(acc);
    if (lane == 0) slots[buf][warp][0] = acc;
    scope_sync<SCOPE>();
    const float inv = inv_norm(gather<SCOPE>(slots[buf], 0));
    buf ^= 1;
    for (int i = tid; i < rows; i += THREADS)
      S[(size_t)i * ld + j] = __fmul_rn(S[(size_t)i * ld + j], inv);
  }
}

// 8 < r <= 32: the CTA's rows [rows, r] in shared memory at row stride
// r | 1, copied in and out as a flat range (16-byte vectors where aligned,
// every load in flight)
template <int SCOPE>
__device__ void smem_panel(const float* __restrict__ x, float* __restrict__ q,
                           int rows, int r, float* S, Slots& slots) {
  constexpr int CH = SMEM_FLOATS / 4 / THREADS;
  const int ld = smem_stride(r), n = rows * r, n4 = n / 4, tid = threadIdx.x;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const float4* src = reinterpret_cast<const float4*>(x);
    float4 t[CH];
#pragma unroll
    for (int m = 0; m < CH; ++m)
      if (tid + THREADS * m < n4) t[m] = __ldg(src + tid + THREADS * m);
#pragma unroll
    for (int m = 0; m < CH; ++m) {
      const int e = 4 * (tid + THREADS * m);
      if (e < 4 * n4) {
        const float v[4] = {t[m].x, t[m].y, t[m].z, t[m].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) S[((e + c) / r) * ld + (e + c) % r] = v[c];
      }
    }
    for (int e = 4 * n4 + tid; e < n; e += THREADS)
      S[(e / r) * ld + e % r] = __ldg(x + e);
  } else {
    for (int e = tid; e < n; e += THREADS) S[(e / r) * ld + e % r] = __ldg(x + e);
  }
  __syncthreads();
  mem_cgs2<SCOPE>(S, ld, rows, r, slots);
  __syncthreads();
  if (SCOPE == S_CLUSTER) cluster_arrive();
  if ((reinterpret_cast<uintptr_t>(q) & 15) == 0) {
    float4* dst = reinterpret_cast<float4*>(q);
    for (int e4 = tid; e4 < n4; e4 += THREADS) {
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = 4 * e4 + c;
        v[c] = S[(e / r) * ld + e % r];
      }
      dst[e4] = make_float4(v[0], v[1], v[2], v[3]);
    }
    for (int e = 4 * n4 + tid; e < n; e += THREADS) q[e] = S[(e / r) * ld + e % r];
  } else {
    for (int e = tid; e < n; e += THREADS) q[e] = S[(e / r) * ld + e % r];
  }
  if (SCOPE == S_CLUSTER) cluster_wait();
}

// a panel no cluster holds: its rows [rows, r] copied to q and worked
// there, each thread on its own rows
__device__ void device_panel(const float* __restrict__ x, float* q, int rows,
                             int r, Slots& slots) {
  for (int i = threadIdx.x; i < rows; i += THREADS)
    for (int c = 0; c < r; ++c) q[(size_t)i * r + c] = __ldg(x + (size_t)i * r + c);
  mem_cgs2<S_CLUSTER>(q, r, rows, r, slots);
  cluster_arrive();
  cluster_wait();
}

__global__ void __launch_bounds__(THREADS, 2)
batched_qr_kernel(const __grid_constant__ Params prm) {
  __shared__ Slots slots;
  extern __shared__ float4 dyn4[];
  const int o = prm.owner[blockIdx.x];
  if (o == IDLE) return;                   // padding to whole clusters
  const Seg& sg = prm.seg[o];
  const int local = (int)blockIdx.x - sg.cta0;
  const int a = sg.a, r = sg.r;
  const long long stride = (long long)a * r;
  if (sg.mode == M_WARP) {
    const long long pw = (long long)local * WARPS + (threadIdx.x >> 5);
    if (pw >= sg.batch) return;            // no CTA-wide barrier follows
    reg_dispatch<S_WARP>(r, sg.p + pw * stride, sg.q + pw * stride, a,
                         threadIdx.x & 31, 32, slots);
  } else if (sg.mode == M_CTA) {
    const long long off = (long long)local * stride;
    if (r <= 8)
      reg_dispatch<S_CTA>(r, sg.p + off, sg.q + off, a, threadIdx.x, THREADS,
                          slots);
    else
      smem_panel<S_CTA>(sg.p + off, sg.q + off, a, r,
                        reinterpret_cast<float*>(dyn4), slots);
  } else {
    // a cluster panel fills one whole cluster: its CTA's rank is its rank
    const int rank = (int)cg::this_cluster().block_rank();
    const int lo = min(rank * sg.span, a), rows = min(sg.span, a - lo);
    const long long off = (long long)(local / CLUSTER) * stride + (long long)lo * r;
    if (sg.mode == M_DEVICE)
      device_panel(sg.p + off, sg.q + off, rows, r, slots);
    else if (r <= 8)
      reg_dispatch<S_CLUSTER>(r, sg.p + off, sg.q + off, rows, threadIdx.x,
                              THREADS, slots);
    else
      smem_panel<S_CLUSTER>(sg.p + off, sg.q + off, rows, r,
                            reinterpret_cast<float*>(dyn4), slots);
  }
}

// CTAs a piece of `batch` panels takes
int piece_ctas(const Seg& s) {
  return s.mode == M_WARP ? (s.batch + WARPS - 1) / WARPS
         : s.mode == M_CTA ? s.batch : s.batch * CLUSTER;
}

// The parameter block against this file's limits: what the kernel would
// otherwise read out of bounds or hold past its registers.
bool params_ok(const Params& prm, int cluster, int smem) {
  const int nseg = prm.nseg, ncta = prm.ncta;
  if (nseg < 1 || nseg > MAX_SEGS || ncta < 1 || ncta > MAX_CTAS ||
      (cluster != 1 && cluster != CLUSTER) || ncta % cluster || smem < 0 ||
      smem > SMEM_FLOATS * 4)
    return false;
  for (int s = 0; s < nseg; ++s) {
    const Seg& e = prm.seg[s];
    const long long b = e.batch, a = e.a, r = e.r, span = e.span;
    if (b < 1 || r < 1 || r > RMAX || a < r || a * r >= (1LL << 31) ||
        span < 1 || !e.p || !e.q || e.cta0 < 0)
      return false;
    const int ri = (int)r;
    const long long need = r > 8 ? span * smem_stride(ri) * 4 : 0;
    switch (e.mode) {
      case M_WARP:
        if (r > 8 || a > WARP_ROWS) return false;
        break;
      case M_CTA:
        if (a > cta_rows(ri) || span != a || need > smem) return false;
        break;
      case M_CLUSTER:
        if (cluster != CLUSTER || e.cta0 % CLUSTER || span * CLUSTER < a ||
            span > cta_rows(ri) || span % unit_rows(ri) || need > smem)
          return false;
        break;
      case M_DEVICE:
        if (cluster != CLUSTER || e.cta0 % CLUSTER || span * CLUSTER < a)
          return false;
        break;
      default:
        return false;
    }
    if ((long long)e.cta0 + piece_ctas(e) > ncta) return false;
  }
  // each CTA names the piece whose range holds it, or is idle
  for (int c = 0; c < ncta; ++c) {
    const int o = prm.owner[c];
    if (o == IDLE) continue;
    if (o >= nseg || c < prm.seg[o].cta0 || c >= prm.seg[o].cta0 + piece_ctas(prm.seg[o]))
      return false;
  }
  return true;
}

}  // namespace

// params: the launch's parameter block (kernels/batched_qr.py packs it,
// PARAM_BYTES bytes); clusters of `cluster` CTAs (1 or 8), `smem` bytes of
// dynamic shared memory.  Returns the cudaError_t of the launch (0 =
// accepted); refuses a block outside this file's limits with
// cudaErrorInvalidValue.
extern "C" int batched_qr_run(const void* params, int cluster, int smem,
                              int device, void* stream) {
  // this library carries its own CUDA runtime: select the caller's device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params prm;
  memcpy(&prm, params, sizeof(Params));
  if (!params_ok(prm, cluster, smem)) return static_cast<int>(cudaErrorInvalidValue);
  // the shared-memory limit is set once per device (devices 0-63), not on
  // every launch: the call is host time in front of each launch
  static std::atomic<unsigned long long> set_on{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (!(set_on.load() & bit)) {
    err = cudaFuncSetAttribute(batched_qr_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_FLOATS * 4);
    if (err != cudaSuccess) return static_cast<int>(err);
    set_on |= bit;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster == 1) {
    batched_qr_kernel<<<prm.ncta, THREADS, smem, s>>>(prm);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)prm.ncta, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, batched_qr_kernel, prm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
