// RWKV-6 WKV recurrence for Hopper (sm_90a), forward and backward.
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_wkv.py::rwkv6_wkv
// (body _wkv_kernel), which has no backward, and computes what
// repro/kernels/ref.py::rwkv6_wkv_ref computes, per (batch b, head h), with
// an fp32 state S [D, D] indexed [j, i]:
//
//     y_t[i]  = sum_j r_t[j] (S[j,i] + u[j] k_t[j] v_t[i])
//     S'[j,i] = w_t[j] S[j,i] + k_t[j] v_t[i]
//
// r/k/v/w/y are [B, S, H, D] (fp32 or bf16, computed in fp32); u is
// [B*H, D] fp32, one row per (b, h), so that each learner of the trainer's
// vmap keeps its own u when learners are folded into B; states are fp32.
//
// Forward.  With q_t = r_t . (u * k_t), computed once per step:
//
//     y_t[i] = v_t[i] q_t + sum_j r_t[j] S[j,i]
//
// Bound: issuing fp32 operations, near the bytes.  A state entry costs
// three operations a step (k_j v_i, the update's FMA and y's FMA): at the
// training shape (B*H = 256, S = 512, D = 64) 256 x 512 x 4096 x 3 = 1.61 G
// lane operations, 0.048 ms at 128 lanes x 132 SMs x 1.98 GHz; the inputs,
// y and the two states take 176,226,304 B, 0.053 ms at 3.35 TB/s, and the
// checkpoints 33,554,432 B more.  A step's chain is one FMA per entry, so
// nothing but the issue of those operations, their shared loads and the
// warps' stalls bounds it: on an H100 it takes 0.111 ms, 2.1 times the
// bytes' bound (PERF.md).  The design:
//
//   * The state over the threads.  One CTA per (b, h), D^2 / (FWD_TR x
//     FWD_TC) threads (128 at D 64, 32 at D 32), each owning an FWD_TR x
//     FWD_TC = 8 x 4 tile of S in 32 registers: rows row0 .. row0 + 7,
//     columns col0 .. col0 + 3; the D / 4 threads of a row group run along
//     the columns.  Per step a thread reads its rows' r, k, w (two 16-byte
//     shared loads each, broadcast over the row group) and its columns' v
//     (one), and issues 32 + 32 + 32 fp32 operations.  Two CTAs of 4 warps
//     share an SM at the training shape (one alone leaves the SM half
//     idle: 132 CTAs take 0.074 ms, 264 0.111); the thread takes 184
//     registers (fp32, D 64; no spills), __launch_bounds__(128, 2).  4 x 4
//     tiles (8 warps a CTA, 16 an SM) took 0.152-0.155 ms, 4 x 8 tiles
//     0.204-0.209 (their 16 row groups' partials leave room for one CTA an
//     SM; PERF.md): a bigger tile spends fewer loads, stores and sums per
//     entry.
//   * Rows couple only through y's sum over j.  A thread sums its tile's
//     rows and writes the row group's partial [4] of the step to shared
//     memory; once per stage the CTA sums the D / FWD_TR row groups'
//     partials in order 0, 1, .. and adds v_t q_t.  No shuffles in the
//     steps and no atomics: a rerun gives the same bits.  (A warp's
//     butterfly over its row groups first, halving the partials and the
//     stage's sum, took the same time.)
//   * The bonus term once per step: q_t is summed while the stage's y is
//     combined, by the D / 4 threads of a step (4 products each, a
//     butterfly of log2(D / 4) shuffles), not by every thread.
//   * Asynchronous staging.  r, k, v, w arrive FWD_STAGE = 16 steps at a
//     time in a ring of FWD_RING = 3 stages, by 16-byte cp.async copies
//     issued one stage ahead, so stage n + 1's loads are in flight while
//     stage n runs (synchronous copies took 19-21% longer); bf16 stays
//     bf16 in the ring and is converted at use.  One barrier per stage:
//     stage n's steps write one of two partial buffers while stage n - 1
//     is combined from the other, which is why the ring holds three
//     stages (n's, n - 1's v, r, k for the combine, and the one being
//     filled).  Steps past S are padded with r = 0, k = -0, v = 0, w = 1,
//     which leave every bit of the state as it is, so a stage is
//     straight-line code.
//   * The state's arithmetic is the first port's, bit for bit: each entry
//     updates as st = fmaf(w_j, st, k_j * v_i) from the same fp32 values,
//     so sT and every checkpoint are unchanged (and the backward's
//     gradients with them).  Only y's order of summation is new:
//
//       y_t[i] = fmaf(v_t[i], q_t, P_0 + P_1 + .. + P_{D/8-1})  (in order)
//       P_g    = fmaf chain over rows 8g .. 8g + 7 in order
//                (r_{8g} S[8g,i] first, a product)
//       q_t    = butterfly (lane xor D/8 first) over the D / 4 lanes of
//                fmaf chains r_j (u_j k_j) over j = 4l .. 4l + 3
//
//     kernels/ref.py::rwkv6_wkv_forward_blocked_plain runs this schedule
//     and its arithmetic, each fmaf rounded once: the card's states and
//     checkpoints equal it to the bit (chip_smoke.py phase 10).
//
//   Shared memory per CTA, D 64 fp32 (bf16; D 32 fp32): the ring 48 KB
//   (24 KB; 24 KB), the row groups' y partials 2 x 16 x 8 x 64 x 4 B =
//   64 KB (64 KB; 16 KB): 114,688 B (90,112 B; 40,960 B), dynamic (its
//   limit set once per device by the launcher, not per launch).  The
//   state at the start of every CHUNK = 64 steps is written as a
//   checkpoint [B*H, NC, D, D] for the backward (33.5 MB a layer at the
//   training shape), the final state as sT.  Inputs are read once.
//
// Backward: the reverse recurrence of kernels/ref.py::
// rwkv6_wkv_backward_plain, with G the adjoint of the state:
//
//     dr_t[j] = sum_i dy_t[i] (S_t[j,i] + u[j] k_t[j] v_t[i])
//     du[j]  += r_t[j] k_t[j] (dy_t . v_t)
//     dk_t[j] = u[j] r_t[j] (dy_t . v_t) + sum_i G[j,i] v_t[i]
//     dv_t[i] = dy_t[i] (r_t . u k_t) + sum_j G[j,i] k_t[j]
//     dw_t[j] = sum_i G[j,i] S_t[j,i]
//     G[j,i]  = w_t[j] G[j,i] + r_t[j] dy_t[i]
//
// Rows j of S and G are independent: each updates with its own w_t[j],
// k_t[j], r_t[j] and the shared v_t, dy_t, and dr, dk, dw, du are sums
// along a row.  Only dv sums across rows.  Neither recurrence has a
// reduction in its chain (each element is one FMA per step), so the sums
// are throughput, not latency.  Bound: 0.094 ms for the bytes at the
// training shape; the work is about 10 fp32 operations per state element
// and step (6 for the gradients and G, 2 to recompute S_t, 2 for the
// sub-checkpoint walk) plus the sums' shuffles, and the kernel is bound by
// issuing them (PERF.md).  The design:
//
//   * Rows over a cluster.  A (b, h) is a thread-block cluster of
//     D / BWD_ROWS CTAs (4 at D 64, 2 at D 32), each owning BWD_ROWS = 16
//     rows of S and G with BWD_THREADS = 128 threads.  A thread owns
//     BWD_RPT = 2 adjacent rows and D / 16 adjacent columns (a 2 x 4
//     tile at D 64): the BWD_TPR = 16 lanes of a half-warp share a row
//     pair, so each float4 of v_t or dy_t read from shared memory serves
//     two rows (one row a thread, which costs twice the shared-memory
//     wavefronts, took 0.80-0.87 ms on an H100 against 0.71: PERF.md).
//     1024 CTAs at the training shape, 3 per SM (__launch_bounds__; the
//     thread takes 168 registers).
//   * States on chip, by a second level of recompute.  The states S_t are
//     recomputed from the forward's checkpoint every CHUNK steps (never
//     rebuilt as (S_{t+1} - k v^T) / w: w = exp(-exp(.)) may be near 0).
//     A chunk's 64 states are 1 MB per (b, h), 256 KB per CTA: too many.
//     So the chunk is walked forward from its checkpoint, keeping a
//     sub-checkpoint every BWD_SUB = 8 steps in shared memory (8 slots x
//     16 rows x 64 x 4 B = 32 KB per CTA); then, for each sub-chunk in
//     reverse, its 8 states are recomputed from the sub-checkpoint into
//     registers (8 x 8 entries a thread = 64 registers) and the reverse
//     steps run on them.  Each thread reads only the state entries it
//     wrote, so neither needs a barrier.  No state goes through device
//     memory: the scratch of the first port's backward (a [CHUNK, D, D]
//     per (b, h) round trip, 2.15 GB written and 2.15 GB read a call at
//     the training shape) is gone.
//   * The walk of chunk c - 1 runs inside chunk c, one sub-chunk of it per
//     sub-chunk of c, from inputs staged like the reverse steps'.  Chunk
//     c's sub-chunks read its slots 7, 6, .. 0 while the walk writes chunk
//     c - 1's slots 0, 1, .. 7; every other chunk numbers its slots
//     backwards, so each sub-chunk overwrites the slot it has just read
//     and one set of 8 slots serves both.  Chunk c - 1's checkpoint is
//     copied into its slot 0 with cp.async.  Only the first chunk, and the
//     one after a ragged last chunk, are walked on their own.
//   * Latency.  Each thread fetches its share of the next sub-chunk's
//     inputs into registers while the current one runs.  A short
//     sub-chunk (the end of a ragged sequence) is padded with w = 1 and
//     zeros, which leave S and G as they are, so the 8 reverse steps are
//     straight-line code.
//   * Sums.  Per step, dyv = dy_t . v_t and this row block's r_t . u k_t
//     are computed once, while the sub-chunk's inputs are staged (16
//     threads a step, a butterfly of 4 shuffles).  A thread keeps its
//     partial dr, dk and dw of its two rows for the sub-chunk's 8 steps
//     (48 values); the row pair's 16 lanes reduce them together after the
//     sub-chunk by a transposed butterfly (24 + 12 + 6 + 3 shuffles for
//     48 sums), after which lane c holds row c / 8's three of step c % 8
//     and writes them.  dv's partial products are summed over a thread's
//     two rows in registers, over the warp's two row pairs by one
//     transposed shuffle stage each step, over the CTA's 4 warps in order
//     through shared memory, plus dy_t times the block's r.u k, once per
//     sub-chunk.
//   * dv across the cluster, in a fixed order.  Each CTA keeps its block's
//     dv partial of a sub-chunk [BWD_SUB, D] in shared memory; after the
//     cluster's barrier each CTA sums the partials of block 0, 1, ... in
//     that order over distributed shared memory for its share of the
//     sub-chunk's steps (2 of 8 at D 64) and writes them.  The barrier's
//     arrival is a fence over all of the thread's earlier stores (a GPU
//     scope membar in the SASS), so its wait is taken one sub-chunk late:
//     sub-chunk n arrives after writing its partial, then sums sub-chunk
//     n - 1's; with three buffers a buffer is rewritten only after every
//     block has read it, and the fence finds only stores issued a
//     sub-chunk earlier.  No atomics anywhere: a rerun gives the same bits.
//
//   Shared memory per CTA, D 64 (D 32): sub-checkpoints 32 KB (16 KB),
//   staged v and dy 4 KB (2 KB), r, k, w and the two sums 1.6 KB, the
//   walk's v, k, w 3 KB (2 KB), the warps' dv partials 8 KB (4 KB), the
//   cluster's dv buffers 6 KB (3 KB): 55,872 B (29,248 B), dynamic, set
//   with cudaFuncSetAttribute.  Device-memory traffic beyond inputs,
//   outputs and checkpoints: no scratch (0 B).  Inputs are read more than
//   once: v and dy by every CTA of a cluster, and k, w and v again for the
//   walk (all but a chunk's last sub-chunk): 16.25 times the bytes of one
//   [B, S, H, D] input at D 64 against 5 once each, 11.25 x 33.5 MB =
//   0.377 GB of re-reads at the training shape, most of them L2 hits (the
//   cluster's CTAs run together).  du is written per (b, h) as [B*H, D];
//   the caller sums it over b in a fixed order.
//
// Built with nvcc into a plain-C shared library and loaded with ctypes
// (repro_torch/kernels/_build.py, repro_torch/kernels/rwkv6_wkv.py).

#include <atomic>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CHUNK = 64;         // steps between checkpoints
constexpr int FWD_TR = 8;         // state rows a thread owns, forward
constexpr int FWD_TC = 4;         // state columns a thread owns
constexpr int FWD_STAGE = 16;     // steps a stage of the forward's ring holds
constexpr int FWD_RING = 3;       // stages in the ring
static_assert(CHUNK % FWD_STAGE == 0, "checkpoints fall on stage starts");
static_assert(FWD_RING >= 3, "a stage is combined while the next one runs");
constexpr int BWD_ROWS = 16;      // state rows per CTA of the backward
constexpr int BWD_SUB = 8;        // steps between its sub-checkpoints
constexpr int BWD_RPT = 2;        // rows a thread owns
constexpr int BWD_TPR = 16;       // threads per row (pair)
constexpr int BWD_THREADS = BWD_ROWS / BWD_RPT * BWD_TPR;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_SLOTS = CHUNK / BWD_SUB;     // sub-checkpoints a chunk
constexpr long long BWD_GRID_X = 1 << 20;      // clusters per grid row
static_assert(BWD_SUB * 16 == BWD_THREADS, "staging: 16 threads a step");
static_assert(BWD_ROWS == 16, "staging: one row per thread of a step");
static_assert(CHUNK % BWD_SUB == 0, "sub-chunks tile a chunk");

// CTAs of the backward's cluster: one (b, h) split by rows
__host__ __device__ constexpr int bwd_cluster(int d) { return d / BWD_ROWS; }
// threads of the forward's CTA: one FWD_TR x FWD_TC tile of S each
__host__ __device__ constexpr int fwd_threads(int d) {
  return (d / FWD_TR) * (d / FWD_TC);
}

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, like astype
}

// element (b, t, h, lane) of a [B, S, H, D] tensor
__device__ __forceinline__ size_t seq_off(int b, int t, int h, int lane, int S,
                                          int H, int D) {
  return (((size_t)b * S + t) * H + h) * D + lane;
}

// N consecutive elements (N = 2, 4 or 8, aligned to min(N, 4) elements)
// of device or shared memory, as fp32
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* p, float (&out)[N]) {
  if constexpr (N == 8) {
    load_n<T, 4>(p, *reinterpret_cast<float(*)[4]>(out));
    load_n<T, 4>(p + 4, *reinterpret_cast<float(*)[4]>(out + 4));
  } else if constexpr (sizeof(T) == 4) {
    if constexpr (N == 4) {
      const float4 x = *reinterpret_cast<const float4*>(p);
      out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
    } else {
      const float2 x = *reinterpret_cast<const float2*>(p);
      out[0] = x.x; out[1] = x.y;
    }
  } else {
    if constexpr (N == 4) {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
      out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
    } else {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
      out[0] = a.x; out[1] = a.y;
    }
  }
}

// The cluster's barrier in two halves: arrive (releasing this thread's
// shared-memory writes to the cluster) and wait (acquiring the others').
// Every thread of the cluster's CTAs calls both, in turn.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// N floats (4: 16 bytes, 2: 8 bytes) from device to shared memory,
// asynchronously; the issuing thread waits for its own copies with
// cp_async_wait_all
template <int N>
__device__ __forceinline__ void cp_async_f(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (N == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Transposed butterfly: N values per lane, summed over the lanes that
// differ in bits OFF, OFF/2, ..., STOP of the lane index.  At each bit the
// lane keeps the half of its values that the bit selects (the upper half
// if set) and adds its partner's copy of that half, so the sums end in
// a[0 .. N / group) of each lane, the lane's position p in its group
// holding sums p * N / group + [0, N / group) of the original order.
template <int N, int OFF, int STOP>
__device__ __forceinline__ void xreduce(float* a, int lane) {
  if constexpr (OFF >= STOP) {
    constexpr int HALF = N / 2;
    const bool up = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float send = up ? a[i] : a[i + HALF];
      const float keep = up ? a[i + HALF] : a[i];
      a[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    xreduce<HALF, OFF / 2, STOP>(a, lane);
  }
}

template <int D>
constexpr size_t bwd_smem_floats() {
  return (size_t)BWD_SLOTS * BWD_THREADS * (BWD_RPT * D / BWD_TPR)  // slots
         + 2 * BWD_SUB * D                                 // v, dy
         + BWD_SUB * BWD_WARPS * D                         // warps' dv
         + 3 * BWD_SUB * D                                 // cluster dv x3
         + 3 * BWD_SUB * BWD_ROWS + 2 * BWD_SUB            // r k w, sums
         + BWD_SUB * D + 2 * BWD_SUB * BWD_ROWS;           // walk: v k w
}

// N (2, 4 or 8) consecutive floats to device or shared memory
template <int N>
__device__ __forceinline__ void st_f(float* p, const float (&x)[N]) {
  if constexpr (N == 8) {
    st_f<4>(p, *reinterpret_cast<const float(*)[4]>(x));
    st_f<4>(p + 4, *reinterpret_cast<const float(*)[4]>(x + 4));
  } else if constexpr (N == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 consecutive values to device memory in T (bf16: rounded to nearest
// even, as from_f32)
template <typename T>
__device__ __forceinline__ void store4(T* p, const float (&x)[4]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
    *reinterpret_cast<uint2*>(p) = make_uint2(
        *reinterpret_cast<const unsigned*>(&a), *reinterpret_cast<const unsigned*>(&b));
  }
}

template <typename T, int D>
constexpr size_t fwd_smem_bytes() {
  return (size_t)FWD_RING * 4 * FWD_STAGE * D * sizeof(T)           // r k v w
         + (size_t)2 * FWD_STAGE * (D / FWD_TR) * D * 4;          // y partials
}

template <typename T, int D>
__global__ void __launch_bounds__(fwd_threads(D), 2)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                T* __restrict__ y, float* __restrict__ sT,
                float* __restrict__ ckpt, int S, int H) {
  constexpr int TR = FWD_TR, TC = FWD_TC, ST = FWD_STAGE, RING = FWD_RING;
  constexpr int CG = D / TC;              // threads of a row group (its columns)
  constexpr int RG = D / TR;              // row groups
  constexpr int THREADS = fwd_threads(D);
  constexpr int EPC = 16 / sizeof(T);     // elements a 16-byte copy
  constexpr int NCOPY = 4 * ST * (D / EPC);   // copies a stage
  constexpr int LPS = D / 4;              // combine lanes a step, 4 columns each
  constexpr int GROUPS = ST * LPS;        // combine groups a stage
  constexpr int SLOT = 4 * ST * D;        // elements a ring slot: [r k v w][ST][D]
  static_assert(D % TR == 0 && D % TC == 0 && THREADS % 32 == 0, "tile");
  static_assert(GROUPS % 32 == 0 && THREADS % LPS == 0, "combine: whole warps");
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);                        // [RING][SLOT]
  float* ypart = reinterpret_cast<float*>(ring + RING * SLOT);  // [2][ST][RG][D]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, rg = tid / CG;
  const int row0 = rg * TR, col0 = (tid % CG) * TC;
  const int qc = (tid % LPS) * 4;              // its combine columns
  const int NC = (S + CHUNK - 1) / CHUNK;
  const int NS = (S + ST - 1) / ST;
  const size_t sbase = (size_t)bh * D * D;
  // element (b, t, h, 0) of a [B, S, H, D] tensor
  const size_t row_at0 = ((size_t)b * S * H + h) * D, HD = (size_t)H * D;
  auto at = [&](int t) { return row_at0 + (size_t)t * HD; };

  float st[TR][TC];                            // S[row0 + p, col0 + e]
#pragma unroll
  for (int p = 0; p < TR; ++p)
    load_n<float, TC>(s0 + sbase + (size_t)(row0 + p) * D + col0, st[p]);
  float uq[4];
  load_n<float, 4>(u + (size_t)bh * D + qc, uq);

  // stage n's r, k, v, w into ring slot n % RING by 16-byte copies, one
  // commit group per stage (empty past the end); a step past S is padded
  // with r = 0, k = -0, v = 0, w = 1, so that fmaf(1, st, -0 * 0) = st
  // to the bit and the stage's steps need no branch
  auto stage_in = [&](int n) {
    if (n < NS) {
      T* slot = ring + (n % RING) * SLOT;
      const int t0 = n * ST;
#pragma unroll
      for (int i = 0; i < (NCOPY + THREADS - 1) / THREADS; ++i) {
        const int c = tid + i * THREADS;
        if (NCOPY % THREADS == 0 || c < NCOPY) {
          const int a = c / (NCOPY / 4), m = (c / (D / EPC)) % ST;
          const int e0 = (c % (D / EPC)) * EPC;
          T* dst = slot + (a * ST + m) * D + e0;
          if (t0 + m < S) {
            const T* src = a == 0 ? r : a == 1 ? k : a == 2 ? v : w;
            cp_async_f<4>(reinterpret_cast<float*>(dst),
                          reinterpret_cast<const float*>(src + at(t0 + m) + e0));
          } else {
            const T pad = from_f32<T>(a == 3 ? 1.0f : a == 1 ? -0.0f : 0.0f);
#pragma unroll
            for (int e = 0; e < EPC; ++e) dst[e] = pad;
          }
        }
      }
    }
    cp_async_commit();
  };
  // y of stage n: per step, q_t by the step's D / 4 lanes, then the row
  // groups' partials in order plus v_t q_t
  auto combine = [&](int n) {
    const T* slot = ring + (n % RING) * SLOT;
    const float* yp = ypart + (n & 1) * ST * RG * D;
    const int t0 = n * ST;
#pragma unroll
    for (int i = 0; i < (GROUPS + THREADS - 1) / THREADS; ++i) {
      const int g = tid + i * THREADS;
      if (GROUPS % THREADS == 0 || g < GROUPS) {   // whole warps
        const int m = g / LPS;
        float rr[4], kk[4], vv[4], acc[4], x[4];
        load_n<T, 4>(slot + (0 * ST + m) * D + qc, rr);
        load_n<T, 4>(slot + (1 * ST + m) * D + qc, kk);
        load_n<T, 4>(slot + (2 * ST + m) * D + qc, vv);
        float q = rr[0] * (uq[0] * kk[0]);
#pragma unroll
        for (int e = 1; e < 4; ++e) q = fmaf(rr[e], uq[e] * kk[e], q);
#pragma unroll
        for (int o = LPS / 2; o >= 1; o >>= 1)
          q += __shfl_xor_sync(0xffffffffu, q, o);
        load_n<float, 4>(yp + (m * RG) * D + qc, acc);
#pragma unroll
        for (int g2 = 1; g2 < RG; ++g2) {
          load_n<float, 4>(yp + (m * RG + g2) * D + qc, x);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[e] += x[e];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] = fmaf(vv[e], q, acc[e]);
        if (t0 + m < S) store4<T>(y + at(t0 + m) + qc, acc);
      }
    }
  };

  for (int n = 0; n < RING - 2; ++n) stage_in(n);
  for (int n = 0; n < NS; ++n) {
    cp_async_wait<RING - 3>();
    // stage n has landed; stage n - 2's slot and partials are free again
    __syncthreads();
    stage_in(n + RING - 2);
    const int t0 = n * ST;
    if (t0 % CHUNK == 0) {
      float* c = ckpt + ((size_t)bh * NC + t0 / CHUNK) * D * D;
#pragma unroll
      for (int p = 0; p < TR; ++p)
        st_f<TC>(c + (size_t)(row0 + p) * D + col0, st[p]);
    }
    const T* slot = ring + (n % RING) * SLOT;
    float* yp = ypart + (n & 1) * ST * RG * D + rg * D + col0;
#pragma unroll
    for (int m = 0; m < ST; ++m) {
      float rr[TR], kk[TR], ww[TR], vv[TC], part[TC];
      load_n<T, TR>(slot + (0 * ST + m) * D + row0, rr);
      load_n<T, TR>(slot + (1 * ST + m) * D + row0, kk);
      load_n<T, TC>(slot + (2 * ST + m) * D + col0, vv);
      load_n<T, TR>(slot + (3 * ST + m) * D + row0, ww);
#pragma unroll
      for (int e = 0; e < TC; ++e) part[e] = rr[0] * st[0][e];
#pragma unroll
      for (int p = 1; p < TR; ++p)
#pragma unroll
        for (int e = 0; e < TC; ++e) part[e] = fmaf(rr[p], st[p][e], part[e]);
#pragma unroll
      for (int p = 0; p < TR; ++p)
#pragma unroll
        for (int e = 0; e < TC; ++e)
          st[p][e] = fmaf(ww[p], st[p][e], kk[p] * vv[e]);
      st_f<TC>(yp + m * RG * D, part);
    }
    if (n > 0) combine(n - 1);
  }
  __syncthreads();
  combine(NS - 1);
#pragma unroll
  for (int p = 0; p < TR; ++p)
    st_f<TC>(sT + sbase + (size_t)(row0 + p) * D + col0, st[p]);
}

template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS, 3)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ ckpt,
                const T* __restrict__ dy, const float* __restrict__ dsT,
                T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                T* __restrict__ dw, float* __restrict__ du,
                float* __restrict__ ds0, long long BH, int S, int H) {
  constexpr int R = bwd_cluster(D);
  constexpr int RPT = BWD_RPT;         // rows a thread owns
  constexpr int CPT = D / BWD_TPR;     // columns a thread owns
  constexpr int F4 = RPT * CPT / 4;    // its state entries, in float4s
  constexpr int EPT = D / 16;          // staged v, dy elements a thread
  constexpr int MS = BWD_SUB / R;      // steps of dv a CTA writes
  static_assert(MS * D == BWD_THREADS, "dv: one element a thread");
  static_assert(RPT * BWD_SUB == BWD_TPR, "lane c finishes one row-step");
  static_assert(RPT == 2, "rows come in pairs (float2 reads of r, k, w)");
  extern __shared__ float4 smem4[];
  float4* subck = smem4;                                   // [SLOT][F4][THREADS]
  float* v_s = reinterpret_cast<float*>(smem4 + BWD_SLOTS * F4 * BWD_THREADS);
  float* dy_s = v_s + BWD_SUB * D;                         // [SUB][D]
  float* wpart = dy_s + BWD_SUB * D;                       // [SUB][WARPS][D]
  float* dvb = wpart + BWD_SUB * BWD_WARPS * D;            // [3][SUB][D]
  float* r_s = dvb + 3 * BWD_SUB * D;                      // [SUB][ROWS]
  float* k_s = r_s + BWD_SUB * BWD_ROWS;
  float* w_s = k_s + BWD_SUB * BWD_ROWS;
  float* dyv_s = w_s + BWD_SUB * BWD_ROWS;                 // [SUB]
  float* ruk_s = dyv_s + BWD_SUB;                          // [SUB]
  float* wv_s = ruk_s + BWD_SUB;                           // walk [SUB][D]
  float* wk_s = wv_s + BWD_SUB * D;                        // walk [SUB][ROWS]
  float* ww_s = wk_s + BWD_SUB * BWD_ROWS;

  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();                 // row block
  const long long bh = (long long)blockIdx.y * BWD_GRID_X + blockIdx.x / R;
  if (bh >= BH) return;          // the whole cluster: it shares bh
  const int b = (int)(bh / H), h = (int)(bh - (long long)b * H);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = lane % BWD_TPR;                            // column group
  const int jr = RPT * (warp * (32 / BWD_TPR) + lane / BWD_TPR);  // rows jr, jr + 1
  const int j = q * BWD_ROWS + jr;
  const int col = c * CPT;
  const int sm = tid >> 4, se = tid & 15;                  // staging roles
  const int NC = (S + CHUNK - 1) / CHUNK;
  const size_t sbase = (size_t)bh * D * D;
  // element (b, t, h, 0) of a [B, S, H, D] tensor
  const size_t row0 = ((size_t)b * S * H + h) * D, HD = (size_t)H * D;
  auto at = [&](int t) { return row0 + (size_t)t * HD; };
  float u_row[RPT];
#pragma unroll
  for (int p = 0; p < RPT; ++p) u_row[p] = u[(size_t)bh * D + j + p];
  const float u_stage = u[(size_t)bh * D + q * BWD_ROWS + se];

  float g[RPT][CPT];                                       // G[j + p, col + e]
#pragma unroll
  for (int p = 0; p < RPT; ++p)
    load_n<float, CPT>(dsT + sbase + (size_t)(j + p) * D + col, g[p]);
  float du_acc[RPT] = {};

  // The sub-chunks run in reverse over the whole sequence; only the first
  // of them (the end of a ragged last chunk) can be short.  Each thread
  // fetches its share of the next sub-chunk's inputs into registers while
  // the current one is computed: step sm, elements se * EPT .. of v and
  // dy, row se of this block's r, k, w.  Steps past the end are padded
  // with w = 1 and zeros, which leave G and the states as they are, so
  // the reverse steps need no branch.
  float nv[EPT], nd[EPT], nr, nk, nw;
  auto fetch = [&](int ta, int n) {
    nr = nk = 0.0f;
    nw = 1.0f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) nv[e] = nd[e] = 0.0f;
    if (sm < n) {
      const size_t off = at(ta + sm);
      load_n<T, EPT>(v + off + se * EPT, nv);
      load_n<T, EPT>(dy + off + se * EPT, nd);
      nr = to_f32<T>(r[off + q * BWD_ROWS + se]);
      nk = to_f32<T>(k[off + q * BWD_ROWS + se]);
      nw = to_f32<T>(w[off + q * BWD_ROWS + se]);
    }
  };
  // dv of the sub-chunk at ta (n steps) whose partials lie in dvb[pbuf]:
  // the blocks' partials summed in rank order over distributed shared
  // memory; this CTA writes steps q MS .. q MS + MS - 1
  auto combine = [&](int ta, int n, int pbuf) {
    const int m = q * MS + tid / D, i = tid % D;
    float* mine = dvb + (pbuf * BWD_SUB + m) * D + i;
    float acc = *cluster.map_shared_rank(mine, 0);
#pragma unroll
    for (int rk = 1; rk < R; ++rk) acc += *cluster.map_shared_rank(mine, rk);
    if (m < n) dv[at(ta + m) + i] = from_f32<T>(acc);
  };
  int buf = 0, prev_buf = 0, prev_ta = -1, prev_n = 0;

  // Sub-checkpoint x of chunk cc lives in slot x, or 7 - x on every other
  // chunk: so while chunk cc's sub-chunks run in reverse (reading slots
  // 7, 6, .. 0 of it), the walk of chunk cc - 1 (writing its slots 0, 1,
  // .. 7) overwrites in each sub-chunk the slot that sub-chunk has just
  // read, and one set of slots serves both chunks.
  auto slot = [&](int cc, int x) {
    return ((NC - 1 - cc) & 1) ? BWD_SLOTS - 1 - x : x;
  };
  auto slot_at = [&](int x) { return reinterpret_cast<float*>(subck + x * F4 * BWD_THREADS); };
  // a thread's entries of a slot: float4 f of [RPT][CPT] at f * THREADS + tid
  auto put_slot = [&](int x, const float (&s)[RPT][CPT]) {
    float* base = slot_at(x);
#pragma unroll
    for (int f = 0; f < F4; ++f) {
      const float* e = &s[0][0] + 4 * f;
      *reinterpret_cast<float4*>(base + 4 * (f * BWD_THREADS + tid)) =
          make_float4(e[0], e[1], e[2], e[3]);
    }
  };
  auto get_slot = [&](int x, float (&s)[RPT][CPT]) {
    const float* base = slot_at(x);
#pragma unroll
    for (int f = 0; f < F4; ++f) {
      const float4 a = *reinterpret_cast<const float4*>(base + 4 * (f * BWD_THREADS + tid));
      float* e = &s[0][0] + 4 * f;
      e[0] = a.x; e[1] = a.y; e[2] = a.z; e[3] = a.w;
    }
  };
  // the walk of a chunk on its own, from its checkpoint in device memory
  // (the first chunk, and the one after a ragged last chunk)
  auto walk_alone = [&](int cc) {
    const int t0 = cc * CHUNK;
    const int nsub = (min(S, t0 + CHUNK) - t0 + BWD_SUB - 1) / BWD_SUB;
    float s[RPT][CPT];
    const float* cp = ckpt + ((size_t)bh * NC + cc) * D * D + (size_t)j * D + col;
#pragma unroll
    for (int p = 0; p < RPT; ++p) load_n<float, CPT>(cp + p * D, s[p]);
    for (int sb = 0; sb < nsub; ++sb) {
      put_slot(slot(cc, sb), s);
      if (sb == nsub - 1) break;   // every sub-chunk but the last is whole
      float km[BWD_SUB][RPT], wm[BWD_SUB][RPT], vm[BWD_SUB][CPT];
#pragma unroll
      for (int m = 0; m < BWD_SUB; ++m) {
        const size_t off = at(t0 + sb * BWD_SUB + m);
#pragma unroll
        for (int p = 0; p < RPT; ++p) {
          km[m][p] = to_f32<T>(k[off + j + p]);
          wm[m][p] = to_f32<T>(w[off + j + p]);
        }
        load_n<T, CPT>(v + off + col, vm[m]);
      }
#pragma unroll
      for (int m = 0; m < BWD_SUB; ++m)
#pragma unroll
        for (int p = 0; p < RPT; ++p)
#pragma unroll
          for (int e = 0; e < CPT; ++e)
            s[p][e] = fmaf(wm[m][p], s[p][e], km[m][p] * vm[m][e]);
    }
  };
  // the interleaved walk's inputs for one sub-chunk (steps ta ..), fetched
  // like the reverse steps' and staged in wv_s, wk_s, ww_s
  float fv[EPT], fk, fw;
  auto fetch_walk = [&](int ta) {
    const size_t off = at(ta + sm);
    load_n<T, EPT>(v + off + se * EPT, fv);
    fk = to_f32<T>(k[off + q * BWD_ROWS + se]);
    fw = to_f32<T>(w[off + q * BWD_ROWS + se]);
  };

  {
    const int t0 = (NC - 1) * CHUNK;
    const int ta = t0 + ((S - 1 - t0) / BWD_SUB) * BWD_SUB;
    fetch(ta, S - ta);
  }
  walk_alone(NC - 1);
  for (int cc = NC - 1; cc >= 0; --cc) {
    const int t0 = cc * CHUNK;
    const int t1 = min(S, t0 + CHUNK);
    const int nsub = (t1 - t0 + BWD_SUB - 1) / BWD_SUB;
    // a whole chunk walks chunk cc - 1 one sub-chunk per sub-chunk
    const bool walking = cc > 0 && nsub == BWD_SLOTS;
    for (int sb = nsub - 1; sb >= 0; --sb) {
      const int ta = t0 + sb * BWD_SUB;
      const int n = min(BWD_SUB, t1 - ta);
      const int it = nsub - 1 - sb;      // sub-chunks of cc done before
      // 1. stage the fetched inputs; dy.v and the block's r.u k once per
      //    step (16 lanes a step)
      {
        float pd = 0.0f;
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          v_s[sm * D + se * EPT + e] = nv[e];
          dy_s[sm * D + se * EPT + e] = nd[e];
          pd = fmaf(nd[e], nv[e], pd);
        }
        r_s[sm * BWD_ROWS + se] = nr;
        k_s[sm * BWD_ROWS + se] = nk;
        w_s[sm * BWD_ROWS + se] = nw;
        float pr = nr * u_stage * nk;
#pragma unroll
        for (int o = 8; o >= 1; o >>= 1) {
          pd += __shfl_xor_sync(0xffffffffu, pd, o);
          pr += __shfl_xor_sync(0xffffffffu, pr, o);
        }
        if (se == 0) {
          dyv_s[sm] = pd;
          ruk_s[sm] = pr;
        }
      }
      if (walking && it > 0) {
#pragma unroll
        for (int e = 0; e < EPT; ++e) wv_s[sm * D + se * EPT + e] = fv[e];
        wk_s[sm * BWD_ROWS + se] = fk;
        ww_s[sm * BWD_ROWS + se] = fw;
      }
      __syncthreads();
      // the next sub-chunk's inputs, in flight during this one
      if (sb > 0)
        fetch(ta - BWD_SUB, BWD_SUB);
      else if (cc > 0)
        fetch(t0 - BWD_SUB, BWD_SUB);
      if (walking && it < BWD_SLOTS - 1)
        fetch_walk(t0 - CHUNK + it * BWD_SUB);
      // 2. the sub-chunk's states S_ta .. S_ta+7, in registers
      float st[BWD_SUB][RPT][CPT];
      get_slot(slot(cc, sb), st[0]);
#pragma unroll
      for (int m = 0; m + 1 < BWD_SUB; ++m) {
        const float2 km = *reinterpret_cast<const float2*>(k_s + m * BWD_ROWS + jr);
        const float2 wm = *reinterpret_cast<const float2*>(w_s + m * BWD_ROWS + jr);
        float vx[CPT];
        load_n<float, CPT>(v_s + m * D + col, vx);
#pragma unroll
        for (int e = 0; e < CPT; ++e) {
          st[m + 1][0][e] = fmaf(wm.x, st[m][0][e], km.x * vx[e]);
          st[m + 1][1][e] = fmaf(wm.y, st[m][1][e], km.y * vx[e]);
        }
      }
      // 3. the reverse steps (straight-line: padded steps change nothing)
      float part[3 * RPT * BWD_SUB];   // this thread's columns of dr, dk, dw
#pragma unroll
      for (int m = BWD_SUB - 1; m >= 0; --m) {
        const float2 rm = *reinterpret_cast<const float2*>(r_s + m * BWD_ROWS + jr);
        const float2 km = *reinterpret_cast<const float2*>(k_s + m * BWD_ROWS + jr);
        const float2 wm = *reinterpret_cast<const float2*>(w_s + m * BWD_ROWS + jr);
        const float rr[RPT] = {rm.x, rm.y}, kk[RPT] = {km.x, km.y},
                    ww[RPT] = {wm.x, wm.y};
        float vx[CPT], dx[CPT], dvp[CPT];
        load_n<float, CPT>(v_s + m * D + col, vx);
        load_n<float, CPT>(dy_s + m * D + col, dx);
        const float dyv = dyv_s[m];
#pragma unroll
        for (int e = 0; e < CPT; ++e) dvp[e] = g[0][e] * kk[0];
#pragma unroll
        for (int p = 0; p < RPT; ++p) {
          float pr = 0.0f, pk = 0.0f, pw = 0.0f;
#pragma unroll
          for (int e = 0; e < CPT; ++e) {
            pr = fmaf(st[m][p][e], dx[e], pr);
            pk = fmaf(g[p][e], vx[e], pk);
            pw = fmaf(g[p][e], st[m][p][e], pw);
            if (p > 0) dvp[e] = fmaf(g[p][e], kk[p], dvp[e]);
            g[p][e] = fmaf(ww[p], g[p][e], rr[p] * dx[e]);
          }
          part[3 * (p * BWD_SUB + m)] = pr;
          part[3 * (p * BWD_SUB + m) + 1] = pk;
          part[3 * (p * BWD_SUB + m) + 2] = pw;
          du_acc[p] = fmaf(rr[p] * kk[p], dyv, du_acc[p]);
        }
        // dv over the warp's two row pairs: lane bit 16
        xreduce<CPT, 16, 16>(dvp, lane);
        const int i0 = ((lane >> 4) & 1) * (CPT / 2);
#pragma unroll
        for (int x = 0; x < CPT / 2; ++x)
          wpart[(m * BWD_WARPS + warp) * D + col + i0 + x] = dvp[x];
      }
      __syncthreads();
      // 4. this block's dv partial of the sub-chunk: the warps' partials
      //    in order, plus dy_t times the block's r.u k; then the cluster's
      //    barrier, whose wait is taken one sub-chunk late: the previous
      //    sub-chunk's dv is summed after this one's arrival (three
      //    buffers, so a buffer is rewritten only after every block has
      //    read it), and the fence of the arrival finds only stores issued
      //    a sub-chunk earlier
      if (prev_ta >= 0) cluster_wait();
      {
        float* out = dvb + (buf * BWD_SUB + sm) * D + se * EPT;
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          const int i = se * EPT + e;
          float acc = wpart[(sm * BWD_WARPS) * D + i];
#pragma unroll
          for (int wp = 1; wp < BWD_WARPS; ++wp)
            acc += wpart[(sm * BWD_WARPS + wp) * D + i];
          out[e] = fmaf(dy_s[sm * D + i], ruk_s[sm], acc);
        }
      }
      cluster_arrive();
      if (prev_ta >= 0) combine(prev_ta, prev_n, prev_buf);
      prev_ta = ta;
      prev_n = n;
      prev_buf = buf;
      buf = buf == 2 ? 0 : buf + 1;
      // 5. dr, dk, dw over the row pair's 16 lanes: lane c ends with the
      //    three of row jr + c / 8, step c % 8
      xreduce<3 * RPT * BWD_SUB, BWD_TPR / 2, 1>(part, lane);
      {
        const int p = c / BWD_SUB, m = c % BWD_SUB;
        if (m < n) {
          const size_t off = at(ta + m) + j + p;
          const float up = p ? u_row[1] : u_row[0];
          dr[off] = from_f32<T>(fmaf(up * k_s[m * BWD_ROWS + jr + p], dyv_s[m], part[0]));
          dk[off] = from_f32<T>(fmaf(up * r_s[m * BWD_ROWS + jr + p], dyv_s[m], part[1]));
          dw[off] = from_f32<T>(part[2]);
        }
      }
      // 6. the walk of chunk cc - 1, into the slot this sub-chunk has read:
      //    its sub-checkpoint 0 is its checkpoint, copied in while the next
      //    sub-chunk runs; sub-checkpoint it > 0 is 8 steps on from it - 1
      if (walking && it == 0) {
        const float* cp = ckpt + ((size_t)bh * NC + cc - 1) * D * D + (size_t)j * D + col;
        float* base = slot_at(slot(cc - 1, 0));
#pragma unroll
        for (int p = 0; p < RPT; ++p) {
          const int f = p * CPT;         // first entry of row p
          cp_async_f<CPT>(base + 4 * ((f / 4) * BWD_THREADS + tid) + f % 4, cp + p * D);
        }
      } else if (walking) {
        cp_async_wait_all();
        float s[RPT][CPT];
        get_slot(slot(cc - 1, it - 1), s);
#pragma unroll
        for (int m = 0; m < BWD_SUB; ++m) {
          const float2 km = *reinterpret_cast<const float2*>(wk_s + m * BWD_ROWS + jr);
          const float2 wm = *reinterpret_cast<const float2*>(ww_s + m * BWD_ROWS + jr);
          float vx[CPT];
          load_n<float, CPT>(wv_s + m * D + col, vx);
#pragma unroll
          for (int e = 0; e < CPT; ++e) {
            s[0][e] = fmaf(wm.x, s[0][e], km.x * vx[e]);
            s[1][e] = fmaf(wm.y, s[1][e], km.y * vx[e]);
          }
        }
        put_slot(slot(cc - 1, it), s);
      }
      __syncthreads();             // the stage and wpart are free again
    }
    if (cc > 0 && !walking) walk_alone(cc - 1);
  }
  cluster_wait();
  combine(prev_ta, prev_n, prev_buf);
#pragma unroll
  for (int p = 0; p < RPT; ++p) {
    st_f<CPT>(ds0 + sbase + (size_t)(j + p) * D + col, g[p]);
    if (c == 0) du[(size_t)bh * D + j + p] = du_acc[p];
  }
  cluster_arrive();                // no CTA leaves while its dv is read
  cluster_wait();
}

template <typename T, int D>
cudaError_t fwd(const void* r, const void* k, const void* v, const void* w,
                const float* u, const float* s0, void* y, float* sT,
                float* ckpt, int B, int S, int H, int device,
                cudaStream_t stream) {
  auto kern = wkv6_fwd_kernel<T, D>;
  const size_t smem = fwd_smem_bytes<T, D>();
  // the shared-memory size is set once per device (devices 0-63), not on
  // every launch: the call is host time in front of each launch
  static std::atomic<unsigned long long> set_on{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (!(set_on.load() & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    set_on |= bit;
  }
  kern<<<B * H, fwd_threads(D), smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, s0,
      static_cast<T*>(y), sT, ckpt, S, H);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd(const void* r, const void* k, const void* v, const void* w,
                const float* u, const float* ckpt, const void* dy,
                const float* dsT, void* dr, void* dk, void* dv, void* dw,
                float* du, float* ds0, int B, int S, int H,
                cudaStream_t stream) {
  auto kern = wkv6_bwd_kernel<T, D>;
  const size_t smem = bwd_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long BH = (long long)B * H;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(bwd_cluster(D) * (BH < BWD_GRID_X ? BH : BWD_GRID_X)),
                     (unsigned)((BH + BWD_GRID_X - 1) / BWD_GRID_X), 1);
  cfg.blockDim = dim3(BWD_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = bwd_cluster(D);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, ckpt,
      static_cast<const T*>(dy), dsT, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<T*>(dw), du, ds0,
      BH, S, H);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool shape_ok(int B, int S, int H, int D) {
  return B > 0 && S > 0 && H > 0 && (D == 32 || D == 64) &&
         (long long)B * H <= 2147483647LL;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (r, k, v, w, y and their
// gradients share it).  Each returns the cudaError_t of the launch
// (cudaGetLastError right after it, or the error of setting the kernel's
// shared-memory size); 0 means it was accepted.  D other than
// 32 or 64 is refused with cudaErrorInvalidValue.  Tensors are aligned to
// 16 bytes.
extern "C" int wkv6_forward_launch(const void* r, const void* k,
                                   const void* v, const void* w,
                                   const void* u, const void* s0, void* y,
                                   void* sT, void* ckpt, int dtype, int B,
                                   int S, int H, int D, int device,
                                   void* stream) {
  // this library carries its own CUDA runtime: select the caller's device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!shape_ok(B, S, H, D) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* sTf = static_cast<float*>(sT);
  float* cf = static_cast<float*>(ckpt);
  if (dtype == 0)
    err = D == 64
              ? fwd<float, 64>(r, k, v, w, uf, s0f, y, sTf, cf, B, S, H, device, s)
              : fwd<float, 32>(r, k, v, w, uf, s0f, y, sTf, cf, B, S, H, device, s);
  else
    err = D == 64 ? fwd<__nv_bfloat16, 64>(r, k, v, w, uf, s0f, y, sTf, cf, B,
                                           S, H, device, s)
                  : fwd<__nv_bfloat16, 32>(r, k, v, w, uf, s0f, y, sTf, cf, B,
                                           S, H, device, s);
  return (int)err;
}

extern "C" int wkv6_backward_launch(const void* r, const void* k,
                                    const void* v, const void* w,
                                    const void* u, const void* ckpt,
                                    const void* dy, const void* dsT, void* dr,
                                    void* dk, void* dv, void* dw, void* du,
                                    void* ds0, int dtype, int B, int S, int H,
                                    int D, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!shape_ok(B, S, H, D) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* cf = static_cast<const float*>(ckpt);
  const float* dsTf = static_cast<const float*>(dsT);
  float* duf = static_cast<float*>(du);
  float* ds0f = static_cast<float*>(ds0);
  if (dtype == 0)
    err = D == 64 ? bwd<float, 64>(r, k, v, w, uf, cf, dy, dsTf, dr, dk, dv,
                                   dw, duf, ds0f, B, S, H, s)
                  : bwd<float, 32>(r, k, v, w, uf, cf, dy, dsTf, dr, dk, dv,
                                   dw, duf, ds0f, B, S, H, s);
  else
    err = D == 64 ? bwd<__nv_bfloat16, 64>(r, k, v, w, uf, cf, dy, dsTf, dr,
                                           dk, dv, dw, duf, ds0f, B, S, H, s)
                  : bwd<__nv_bfloat16, 32>(r, k, v, w, uf, cf, dy, dsTf, dr,
                                           dk, dv, dw, duf, ds0f, B, S, H, s);
  return (int)err;
}
