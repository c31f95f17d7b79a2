// Paged flash-decode attention for Hopper (sm_90a): split-K over the visible
// keys, asynchronous page copies, scores and P.V on the tensor cores.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py::_decode_kernel
// and computes exactly what repro/kernels/ref.py::flash_decode_ref computes:
// one query token per sequence against a paged KV pool [Hkv, P, page, D],
// read through block_tables [B, maxp]; key j is visible iff j < len and
// (window == 0 or len-1-j < window); masked scores are -1e30; a sequence
// with len == 0 gives zeros and reads no page; the output is in q's type.
//
// Bound: bytes.  A call must read the visible K and V (2 * visible keys *
// Hkv * D * sizeof(pool type)) plus q, the lengths and the visible pages'
// table entries, and write out; it does about 4 flops per byte of bf16 K/V,
// far below the card's ~295 flop/byte ridge.  At the serving shape (B 8,
// Hq 48, Hkv 4, D 128, page 16, window 4096) that is 31.6 MB, 9.4 us at
// 3.35 TB/s.  To come near it the card needs many CTAs, each with many
// bytes in flight, and little work per byte.  The design:
//
//   * Split-K (flash-decoding).  The visible keys [lo, hi) of each
//     (b, kv head), lo = max(0, len - window), hi = min(len, maxp * page),
//     are cut into splits of split_keys keys counted from lo, so a window's
//     start makes no ragged first split.  The grid is (n_splits, Hkv, B),
//     n_splits = ceil(min(window or inf, maxp * page) / split_keys), from
//     shapes alone: no host synchronize, a grid that a CUDA graph can
//     capture.  A CTA whose split is empty writes m = -1e30, l = 0 and
//     exits.  At the serving shape and the smoke's lengths [0, 1, 16, 1000,
//     2047, 4096, 4150, 4200], split_keys 256 gives 248 busy CTAs of 512
//     (32 for the one-CTA-per-(b, kv head) design this replaces).
//   * Partials and a deterministic combine.  Each CTA writes its fp32
//     (m[G], l[G], acc[G, D]) to scratch that the wrapper allocates; a
//     second kernel, flash_decode_combine, folds the busy splits of each
//     (b, query head) in split order: M = max m_s, out = sum e^(m_s - M)
//     acc_s / sum e^(m_s - M) l_s, zeros where no key is visible.  No
//     atomics: a rerun gives the same bits.
//   * Asynchronous page copies.  K and V rows of a tile are copied with
//     16-byte cp.async (rows past the split zero-filled, reading nothing)
//     into a ring of 2-4 shared-memory stages; the next stages' copies are
//     in flight while the current one is computed.  A staged row is padded
//     by 16 bytes, so ldmatrix and the 16-byte reads of the CUDA-core path
//     are free of bank conflicts.  The pool's bytes are never converted in
//     a pass through shared memory.
//   * Tensor cores for a bf16 q and a bf16 pool (the serving path).  Four
//     warps per 16 query heads (the group padded to 16 rows; more groups
//     of 16 take more warps), each warp 16 keys of a 64-key tile: scores by
//     mma.sync m16n8k16 (bf16 in, fp32 accumulate: every product is exact
//     in fp32, only the order of the sum differs from the plain version),
//     an fp32 online softmax per row, and P.V by three mma.sync per 16
//     keys and 8 dims with P split into bf16 hi + mid + lo parts (exact to
//     about 2^-27 relative per weight).  Two parts (2^-18) were measured
//     too coarse: at the serving shape they turned 70 of 49,152 bf16
//     outputs away from the rounded fp64 result, where the plain version
//     turns 8 and three parts 2-17, and they moved the 40-layer decode
//     logits past chip_smoke.py's limit (scripts/flash_decode_variants.py
//     measures each variant; PERF.md has its readings).  Each mma sums
//     into a zeroed fragment and the sums are added to the running scores
//     and acc in fp32, since the tensor cores' own accumulation truncates.
//     The four warps' (m, l, acc) are folded in shared memory in warp
//     order before the partial is written.
//   * Other dtype pairs (an fp32 q, or an fp32 pool) keep fp32 CUDA-core
//     arithmetic in the same split, ring and partial structure: 512
//     threads, 32-key tiles (16 at D = 256), a score per (head, key)
//     thread, one warp per head for the softmax, an output element per
//     (thread, head) for P.V.  Rounding an fp32 q to bf16 would change
//     what the kernel computes.
//
// Cost of the design: the partials' round trip, G * D * 4 bytes written and
// read back per busy split plus 8 bytes per (split, head) of (m, l): about
// 3 MB at the serving shape, mostly in the 50 MB L2; the bound does not
// count it.  And a second launch.
//
// Later work: TMA (cp.async.bulk) copies of whole pages with an mbarrier
// per stage, which would free the copying threads; a persistent grid that
// balances uneven lengths without empty CTAs; fp8 pools.
//
// Built with nvcc into a plain-C shared library and loaded with ctypes
// (repro_torch/kernels/_build.py, repro_torch/kernels/flash_decode.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1.0e30f;
constexpr int MAX_GD = 4096;             // G * D the kernels take
constexpr int RING_BYTES = 110 * 1024;   // shared-memory budget of the K/V ring

struct Params {
  const void* q;          // [B, Hkv * G, D]
  const void* k;          // [Hkv, P, page, D]
  const void* v;
  const int* tables;      // [B, maxp]
  const int* lengths;     // [B]
  float* part_acc;        // [B, Hkv, n_splits, G, D]
  float2* part_ml;        // [B, Hkv, n_splits, G]: (m, l)
  void* out;              // [B, Hkv * G, D]
  int Hkv, G, P, page, maxp, window, split_keys, n_splits;
  float scale;
};

constexpr int clampi(int x, int a, int b) { return x < a ? a : (x > b ? b : x); }
constexpr size_t maxz(size_t a, size_t b) { return a > b ? a : b; }

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, like astype
}

// Unpack one 16-byte chunk (4 fp32 or 8 bf16 values) into fp32, exactly.
template <typename T> __device__ __forceinline__ void unpack16(const uint4& u, float* o);
template <> __device__ __forceinline__ void unpack16<float>(const uint4& u, float* o) {
  o[0] = __uint_as_float(u.x); o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z); o[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack16<bf16>(const uint4& u, float* o) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // a bf16 is the high half of an fp32
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the four lanes of a quad hold one accumulator row between them
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) -> bf16 pairs hi, mid and lo with x = hi + mid + lo to about
// 2^-27 relative (each remainder is exact in fp32); x0 in the low half, as
// mma reads an A fragment
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ------------------------------------------------------------- the split

// the visible keys [lo, hi) of sequence b (empty when lo >= hi)
__device__ __forceinline__ void visible_span(const Params& p, int b, int& lo, int& hi) {
  const int len = p.lengths[b];
  // the window starts from the length as given; keys past the table do not
  // exist, so only the end is clamped to it
  lo = (p.window > 0 && len > p.window) ? len - p.window : 0;
  hi = min(len, p.maxp * p.page);
}

// split s's keys [s0, s1); empty when s0 >= s1
__device__ __forceinline__ void split_range(const Params& p, int b, int s, int& s0, int& s1) {
  int lo, hi;
  visible_span(p, b, lo, hi);
  s0 = lo + s * p.split_keys;
  s1 = min(s0 + p.split_keys, hi);
}

__device__ __forceinline__ void write_empty(const Params& p, size_t prow, int tid, int nt) {
  for (int g = tid; g < p.G; g += nt) p.part_ml[prow + g] = make_float2(NEG_INF, 0.0f);
}

// Copy K and V rows [t0, t0 + ROWS) of one (b, kv head) into a stage
// (rows of RS bytes: D values and 16 bytes of padding); rows at or past
// `end` are zero-filled and read nothing.
template <typename KVT, int D, int ROWS, int NT>
__device__ __forceinline__ void stage_rows(unsigned char* ks, unsigned char* vs,
                                           const Params& p, const int* tbl,
                                           size_t head_base, int t0, int end, int tid) {
  constexpr int CPR = D * (int)sizeof(KVT) / 16;   // 16-byte chunks per row
  constexpr int RS = D * (int)sizeof(KVT) + 16;
  constexpr int EPC = 16 / (int)sizeof(KVT);
  const KVT* kp = static_cast<const KVT*>(p.k);
  const KVT* vp = static_cast<const KVT*>(p.v);
#pragma unroll
  for (int n = 0; n < (ROWS * CPR + NT - 1) / NT; ++n) {
    const int i = tid + n * NT;
    if (i >= ROWS * CPR) break;
    const int r = i / CPR, c = i - r * CPR;
    const int j = t0 + r;
    size_t off = 0;
    int bytes = 0;
    if (j < end) {
      const size_t pg = (size_t)tbl[j / p.page];
      off = ((head_base + pg) * p.page + (j % p.page)) * D + c * EPC;
      bytes = 16;
    }
    cp_async16(ks + r * RS + c * 16, kp + off, bytes);
    cp_async16(vs + r * RS + c * 16, vp + off, bytes);
  }
}

// --------------------------------------------- bf16 q, bf16 pool: mma.sync

template <int D> struct MmaCfg {
  static constexpr int KW = 4;                  // warps (key groups) per 16 heads
  static constexpr int TILE = 16 * KW;          // keys per stage
  static constexpr int RS = 2 * D + 16;         // staged row bytes
  static constexpr int STAGE = 2 * TILE * RS;   // K and V
  static constexpr int NSTAGE = clampi(RING_BYTES / STAGE, 2, 4);
};

template <int D, int MT>
constexpr size_t mma_smem_bytes() {
  using C = MmaCfg<D>;
  return (size_t)MT * 16 * C::RS                                        // q rows
         + maxz((size_t)C::NSTAGE * C::STAGE,                           // ring, or
                (size_t)MT * C::KW * 16 * (D * 4 + 8));                 // the warps' partials
}

// grid (n_splits, Hkv, B); 4 * MT warps: warp w takes heads 16 (w / 4) ..
// +15 of the group and keys 16 (w % 4) .. +15 of every 64-key tile
template <int D, int MT>
__global__ void __launch_bounds__(128 * MT)
flash_decode_split_mma(const Params p) {
  using C = MmaCfg<D>;
  constexpr int NT = 128 * MT, KW = C::KW, TILE = C::TILE, RS = C::RS;
  constexpr int STAGE = C::STAGE, NSTAGE = C::NSTAGE, NDT = D / 8;
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = warp / KW, kg = warp % KW;
  const int grp = lane >> 2, tig = lane & 3;
  const int G = p.G;
  const size_t prow = (((size_t)b * p.Hkv + h) * p.n_splits + s) * G;

  int s0, s1;
  split_range(p, b, s, s0, s1);
  if (s0 >= s1) { write_empty(p, prow, tid, NT); return; }

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* q_s = smem;                        // [MT * 16][RS]
  unsigned char* ring = smem + MT * 16 * RS;        // NSTAGE x {K, V} x [TILE][RS]
  const int* tbl = p.tables + (size_t)b * p.maxp;
  const size_t head_base = (size_t)h * p.P;
  const int n_tiles = (s1 - s0 + TILE - 1) / TILE;

  // the first NSTAGE - 1 tiles' copies go out before anything else
#pragma unroll
  for (int t = 0; t < NSTAGE - 1; ++t) {
    if (t < n_tiles)
      stage_rows<bf16, D, TILE, NT>(ring + t * STAGE, ring + t * STAGE + TILE * RS, p,
                                    tbl, head_base, s0 + t * TILE, s1, tid);
    cp_async_commit();
  }
  // the group's query heads, rows past G zero
  const bf16* qg = static_cast<const bf16*>(p.q) + ((size_t)b * p.Hkv + h) * G * D;
  for (int i = tid; i < MT * 16 * D; i += NT) {
    const int r = i / D, d = i - r * D;
    reinterpret_cast<bf16*>(q_s + r * RS)[d] =
        r < G ? qg[(size_t)r * D + d] : __float2bfloat16(0.0f);
  }

  float acc[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;   // rows grp, grp + 8

  // ldmatrix row addresses: A (q) rows by lane % 16, k half by lane / 16;
  // B (K) keys 0-7 / 8-15 by lane / 16, d half by (lane / 8) % 2; B (V,
  // transposed) keys by (lane / 8) % 2, d half by lane / 16
  const unsigned char* qa = q_s + (mt * 16 + (lane & 15)) * RS + (lane >> 4) * 16;
  const int krow = kg * 16 + (lane & 7) + ((lane >> 4) << 3);
  const int kcol = ((lane >> 3) & 1) * 16;
  const int vrow = kg * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int vcol = (lane >> 4) * 16;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();   // tile t landed for all; tile t - 1's stage is free
    {
      const int tn = t + NSTAGE - 1;
      if (tn < n_tiles) {
        unsigned char* st = ring + (tn % NSTAGE) * STAGE;
        stage_rows<bf16, D, TILE, NT>(st, st + TILE * RS, p, tbl, head_base,
                                      s0 + tn * TILE, s1, tid);
      }
      cp_async_commit();
    }
    const int kb = s0 + t * TILE + kg * 16;   // this warp's first key
    if (kb >= s1) continue;                   // warp-uniform
    const unsigned char* ks = ring + (t % NSTAGE) * STAGE;
    const unsigned char* vs = ks + TILE * RS;

    // scores: sc[n] is keys kb + 8n .. +7 (columns 2 tig, 2 tig + 1) of
    // rows grp (elements 0, 1) and grp + 8 (elements 2, 3).  Each mma sums
    // 16 dims into a zeroed fragment and the chunks are added in fp32: the
    // tensor cores' own fp32 accumulation truncates, and chained over all
    // of D it would drift further from the plain version's sums
    float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], bk[4];
      ldsm_x4(a, qa + kk * 32);
      ldsm_x4(bk, ks + krow * RS + kcol + kk * 32);
      float c0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_bf16(c0, a, bk[0], bk[1]);
      mma_bf16(c1, a, bk[2], bk[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) { sc[0][i] += c0[i]; sc[1][i] += c1[i]; }
    }
    bool vis[2][2];
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        vis[n][e] = kb + 8 * n + 2 * tig + e < s1;
        sc[n][e] = vis[n][e] ? sc[n][e] * p.scale : NEG_INF;
        sc[n][2 + e] = vis[n][e] ? sc[n][2 + e] * p.scale : NEG_INF;
        mx0 = fmaxf(mx0, sc[n][e]);
        mx1 = fmaxf(mx1, sc[n][2 + e]);
      }
    // key kb is visible, so both maxima are real scores
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float pr[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        pr[n][e] = vis[n][e] ? expf(sc[n][e] - mn0) : 0.0f;
        pr[n][2 + e] = vis[n][e] ? expf(sc[n][2 + e] - mn1) : 0.0f;
      }
    l0 = al0 * l0 + ((pr[0][0] + pr[0][1]) + (pr[1][0] + pr[1][1]));
    l1 = al1 * l1 + ((pr[0][2] + pr[0][3]) + (pr[1][2] + pr[1][3]));
    // P as the A fragment of P.V (keys are its k), in three bf16 parts
    uint32_t ph[4], pm[4], pl[4];
    split_bf16(pr[0][0], pr[0][1], ph[0], pm[0], pl[0]);
    split_bf16(pr[0][2], pr[0][3], ph[1], pm[1], pl[1]);
    split_bf16(pr[1][0], pr[1][1], ph[2], pm[2], pl[2]);
    split_bf16(pr[1][2], pr[1][3], ph[3], pm[3], pl[3]);
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      acc[n][0] *= al0; acc[n][1] *= al0;
      acc[n][2] *= al1; acc[n][3] *= al1;
    }
    // this tile's 16 keys into zeroed fragments (smallest parts first),
    // then added to acc in fp32, for the same reason as the scores
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      uint32_t bv[4];
      ldsm_x4_trans(bv, vs + vrow * RS + vcol + dd * 32);
      float c0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, c1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_bf16(c0, pl, bv[0], bv[1]);
      mma_bf16(c0, pm, bv[0], bv[1]);
      mma_bf16(c0, ph, bv[0], bv[1]);
      mma_bf16(c1, pl, bv[2], bv[3]);
      mma_bf16(c1, pm, bv[2], bv[3]);
      mma_bf16(c1, ph, bv[2], bv[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) { acc[2 * dd][i] += c0[i]; acc[2 * dd + 1][i] += c1[i]; }
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: it takes the warps' partials

  // fold the KW warps of each 16 heads in warp order; a warp that saw no
  // visible key has m = -1e30, l = 0, acc = 0 and weighs e^(-1e30 - M) = 0
  float* c_acc = reinterpret_cast<float*>(ring);                   // [MT][KW][16][D]
  float2* c_ml = reinterpret_cast<float2*>(c_acc + MT * KW * 16 * D);   // [MT][KW][16]
  {
    float* mine = c_acc + (size_t)(mt * KW + kg) * 16 * D;
#pragma unroll
    for (int n = 0; n < NDT; ++n) {
      const int d = n * 8 + 2 * tig;
      *reinterpret_cast<float2*>(mine + grp * D + d) = make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(mine + (grp + 8) * D + d) = make_float2(acc[n][2], acc[n][3]);
    }
    if (tig == 0) {
      c_ml[(mt * KW + kg) * 16 + grp] = make_float2(m0, l0);
      c_ml[(mt * KW + kg) * 16 + grp + 8] = make_float2(m1, l1);
    }
  }
  __syncthreads();
  for (int f = tid; f < G * D; f += NT) {
    const int g = f / D, d = f - g * D, gm = g >> 4, r = g & 15;
    float M = NEG_INF;
#pragma unroll
    for (int k = 0; k < KW; ++k) M = fmaxf(M, c_ml[(gm * KW + k) * 16 + r].x);
    float L = 0.0f, A = 0.0f;
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      const float2 ml = c_ml[(gm * KW + k) * 16 + r];
      const float w = expf(ml.x - M);
      L += w * ml.y;
      A += w * c_acc[((size_t)(gm * KW + k) * 16 + r) * D + d];
    }
    p.part_acc[(prow + g) * D + d] = A;
    if (d == 0) p.part_ml[prow + g] = make_float2(M, L);
  }
}

// --------------------------------------- other dtype pairs: fp32 CUDA cores

constexpr int FMA_NT = 512;      // 16 warps hide shared-memory latency
constexpr int FMA_MAXE = 8;      // acc elements per thread: G * D <= NT * MAXE

template <typename KVT, int D> struct FmaCfg {
  static constexpr int TILE = D >= 256 ? 16 : 32;        // one lane per key
  static constexpr int RS = D * (int)sizeof(KVT) + 16;
  static constexpr int STAGE = 2 * TILE * RS;
  static constexpr int NSTAGE = clampi(RING_BYTES / STAGE, 2, 4);
};

template <typename KVT, int D>
size_t fma_smem_bytes(int G) {
  using C = FmaCfg<KVT, D>;
  return (size_t)C::NSTAGE * C::STAGE
         + sizeof(float) * ((size_t)G * D + (size_t)G * C::TILE + 3 * (size_t)G);
}

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(FMA_NT)
flash_decode_split_fma(const Params p) {
  using C = FmaCfg<KVT, D>;
  constexpr int NT = FMA_NT, MAXE = FMA_MAXE, TILE = C::TILE, RS = C::RS;
  constexpr int STAGE = C::STAGE, NSTAGE = C::NSTAGE;
  constexpr int VEC = 16 / (int)sizeof(KVT), CPR = D / VEC;
  constexpr int GS = NT / TILE;                  // score pass: heads g0, g0+GS, ...
  constexpr int MAXGS = (NT * MAXE / D + GS - 1) / GS;
  constexpr int GSTEP = NT / D;                  // P.V pass: heads gb, gb+GSTEP, ...
  static_assert(NT % D == 0, "a thread's output dim must be fixed");
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.G, GD = G * D;
  const size_t prow = (((size_t)b * p.Hkv + h) * p.n_splits + s) * G;

  int s0, s1;
  split_range(p, b, s, s0, s1);
  if (s0 >= s1) { write_empty(p, prow, tid, NT); return; }

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;                                  // NSTAGE x {K, V} x [TILE][RS]
  float* q_s = reinterpret_cast<float*>(smem + NSTAGE * STAGE);   // [G, D]
  float* p_s = q_s + GD;                                       // [G, TILE]
  float* m_s = p_s + G * TILE;                                 // [G]
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  const int* tbl = p.tables + (size_t)b * p.maxp;
  const size_t head_base = (size_t)h * p.P;
  const int n_tiles = (s1 - s0 + TILE - 1) / TILE;

#pragma unroll
  for (int t = 0; t < NSTAGE - 1; ++t) {
    if (t < n_tiles)
      stage_rows<KVT, D, TILE, NT>(ring + t * STAGE, ring + t * STAGE + TILE * RS, p,
                                   tbl, head_base, s0 + t * TILE, s1, tid);
    cp_async_commit();
  }
  const QT* qg = static_cast<const QT*>(p.q) + ((size_t)b * p.Hkv + h) * GD;
  for (int i = tid; i < GD; i += NT) q_s[i] = to_f32<QT>(qg[i]);
  for (int g = tid; g < G; g += NT) { m_s[g] = NEG_INF; l_s[g] = 0.0f; }

  float acc[MAXE];
#pragma unroll
  for (int e = 0; e < MAXE; ++e) acc[e] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();   // tile t landed; tile t - 1's stage and p_s are free
    {
      const int tn = t + NSTAGE - 1;
      if (tn < n_tiles) {
        unsigned char* st = ring + (tn % NSTAGE) * STAGE;
        stage_rows<KVT, D, TILE, NT>(st, st + TILE * RS, p, tbl, head_base,
                                     s0 + tn * TILE, s1, tid);
      }
      cp_async_commit();
    }
    const unsigned char* ks = ring + (t % NSTAGE) * STAGE;
    const unsigned char* vs = ks + TILE * RS;
    const int t0 = s0 + t * TILE;

    // scores s[g, r] = scale * q[g] . k[r], masked to -1e30; thread (g0, r)
    // takes heads g0, g0 + GS, ... so each K chunk it reads is reused
    {
      const int r = tid % TILE, g0 = tid / TILE;
      const unsigned char* kr = ks + r * RS;
      float sacc[MAXGS];
#pragma unroll
      for (int k = 0; k < MAXGS; ++k) sacc[k] = 0.0f;
#pragma unroll 2
      for (int c = 0; c < CPR; ++c) {
        float kf[VEC];
        unpack16<KVT>(*reinterpret_cast<const uint4*>(kr + c * 16), kf);
#pragma unroll
        for (int k = 0; k < MAXGS; ++k) {
          const int g = g0 + k * GS;
          if (g < G) {
            const float* qq = q_s + g * D + c * VEC;
#pragma unroll
            for (int i = 0; i < VEC; ++i) sacc[k] = fmaf(qq[i], kf[i], sacc[k]);
          }
        }
      }
      const bool visible = t0 + r < s1;
#pragma unroll
      for (int k = 0; k < MAXGS; ++k) {
        const int g = g0 + k * GS;
        if (g < G) p_s[g * TILE + r] = visible ? sacc[k] * p.scale : NEG_INF;
      }
    }
    __syncthreads();
    // online softmax per query head: one warp per head, one lane per key
    for (int g = warp; g < G; g += NT / 32) {
      const bool visible = lane < TILE && t0 + lane < s1;
      const float sv = visible ? p_s[g * TILE + lane] : NEG_INF;
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(sv));   // key t0 is visible
      const float pv = visible ? expf(sv - m_new) : 0.0f;
      const float alpha = expf(m_prev - m_new);
      const float psum = warp_sum(pv);
      if (lane < TILE) p_s[g * TILE + lane] = pv;
      if (lane == 0) {
        l_s[g] = alpha * l_s[g] + psum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();
    // acc[g, d] = alpha[g] * acc[g, d] + sum_r p[g, r] * v[r, d]; thread t
    // owns dim t % D of heads t / D + e * GSTEP (rows past the split are
    // zero-filled and weigh 0)
    {
      const int d = tid % D, gb = tid / D;
#pragma unroll
      for (int e = 0; e < MAXE; ++e) {
        const int g = gb + e * GSTEP;
        if (g < G) acc[e] *= a_s[g];
      }
#pragma unroll 4
      for (int r = 0; r < TILE; ++r) {
        const float vv = to_f32<KVT>(reinterpret_cast<const KVT*>(vs + r * RS)[d]);
#pragma unroll
        for (int e = 0; e < MAXE; ++e) {
          const int g = gb + e * GSTEP;
          if (g < G) acc[e] = fmaf(p_s[g * TILE + r], vv, acc[e]);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    const int f = tid + e * NT;
    if (f < GD) p.part_acc[prow * D + f] = acc[e];
  }
  for (int g = tid; g < G; g += NT) p.part_ml[prow + g] = make_float2(m_s[g], l_s[g]);
}

// ------------------------------------------------------------- combine

// grid (G, Hkv, B), D threads: out[b, h, g] folds the busy splits of
// (b, h) in split order; zeros where no key is visible
template <typename QT>
__global__ void flash_decode_combine(const Params p, int D) {
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = p.G;
  int lo, hi;
  visible_span(p, b, lo, hi);
  const int busy = hi > lo ? min((hi - lo + p.split_keys - 1) / p.split_keys, p.n_splits) : 0;
  const size_t row0 = ((size_t)b * p.Hkv + h) * p.n_splits * G + g;   // split s: row0 + s * G
  float M = NEG_INF;
  for (int s = 0; s < busy; ++s) M = fmaxf(M, p.part_ml[row0 + (size_t)s * G].x);
  QT* out = static_cast<QT*>(p.out) + (((size_t)b * p.Hkv + h) * G + g) * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float L = 0.0f, A = 0.0f;
    for (int s = 0; s < busy; ++s) {
      const size_t row = row0 + (size_t)s * G;
      const float2 ml = p.part_ml[row];
      const float w = expf(ml.x - M);
      L += w * ml.y;
      A += w * p.part_acc[row * D + d];
    }
    out[d] = from_f32<QT>(L > 0.0f ? A / L : 0.0f);
  }
}

// ------------------------------------------------------------- launches

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D, int MT>
cudaError_t launch_mma(int mt, const Params& p, dim3 grid, cudaStream_t stream) {
  if constexpr (MT * D <= 256) {   // G * D <= 4096 needs no more warps than this
    if (mt > MT) return launch_mma<D, MT * 2>(mt, p, grid, stream);
    constexpr size_t smem = mma_smem_bytes<D, MT>();
    auto kern = flash_decode_split_mma<D, MT>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, 128 * MT, smem, stream>>>(p);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
}

template <typename QT, typename KVT, int D>
cudaError_t launch_split(const Params& p, dim3 grid, cudaStream_t stream) {
  if constexpr (sizeof(QT) == 2 && sizeof(KVT) == 2) {
    const int mt = (p.G + 15) / 16;
    return launch_mma<D, 1>(mt, p, grid, stream);
  } else {
    const size_t smem = fma_smem_bytes<KVT, D>(p.G);
    auto kern = flash_decode_split_fma<QT, KVT, D>;
    cudaError_t err = allow_smem(kern, smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, FMA_NT, smem, stream>>>(p);
    return cudaGetLastError();
  }
}

template <typename QT, typename KVT>
cudaError_t launch_pair(int D, int B, const Params& p, cudaStream_t stream) {
  const dim3 grid(p.n_splits, p.Hkv, B);
  cudaError_t err;
  switch (D) {
    case 32:  err = launch_split<QT, KVT, 32>(p, grid, stream); break;
    case 64:  err = launch_split<QT, KVT, 64>(p, grid, stream); break;
    case 128: err = launch_split<QT, KVT, 128>(p, grid, stream); break;
    case 256: err = launch_split<QT, KVT, 256>(p, grid, stream); break;
    default:  return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  flash_decode_combine<QT><<<dim3(p.G, p.Hkv, B), D, 0, stream>>>(p, D);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Launches the split kernel and
// the combine on `stream` and returns the first cudaError_t of the two
// launches (cudaGetLastError right after each); 0 means both were accepted.
// part_acc [B, Hkv, n_splits, G, D] and part_ml [B, Hkv, n_splits, G, 2] are
// fp32 scratch; n_splits * split_keys must cover min(window or inf,
// maxp * page) (the wrapper's split_plan).  Shapes the kernels do not take
// (D not in {32, 64, 128, 256}, G * D > 4096) are refused with
// cudaErrorInvalidValue.
extern "C" int flash_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const void* tables,
                                   const void* lengths, void* out, void* part_acc,
                                   void* part_ml, int q_dtype, int kv_dtype, int B,
                                   int Hkv, int G, int D, int P, int page, int maxp,
                                   int window, float scale, int split_keys,
                                   int n_splits, int device, void* stream) {
  // this library carries its own CUDA runtime: select the caller's device
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (B <= 0 || Hkv <= 0 || G <= 0 || G * D > MAX_GD || page <= 0 || maxp < 0
      || split_keys <= 0 || n_splits <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k_pages; p.v = v_pages;
  p.tables = static_cast<const int*>(tables);
  p.lengths = static_cast<const int*>(lengths);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float2*>(part_ml);
  p.out = out;
  p.Hkv = Hkv; p.G = G; p.P = P; p.page = page; p.maxp = maxp;
  p.window = window; p.split_keys = split_keys; p.n_splits = n_splits;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == 0 && kv_dtype == 0)
    err = launch_pair<float, float>(D, B, p, s);
  else if (q_dtype == 0 && kv_dtype == 1)
    err = launch_pair<float, bf16>(D, B, p, s);
  else if (q_dtype == 1 && kv_dtype == 0)
    err = launch_pair<bf16, float>(D, B, p, s);
  else if (q_dtype == 1 && kv_dtype == 1)
    err = launch_pair<bf16, bf16>(D, B, p, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
