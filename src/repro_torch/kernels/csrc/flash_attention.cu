// Causal / sliding-window GQA flash attention for Hopper (sm_90a), forward
// and backward, on the tensor cores.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (body _attn_kernel), which has no backward, and computes
// what repro/kernels/ref.py::flash_attention_ref computes with causal=True:
// q [B, S, Hq, D], k/v [B, T, Hkv, D], fp32 or bf16, D in {32, 64, 128};
// query head h attends kv head h / (Hq / Hkv), for any group size; key j is
// visible to query i iff j < T, j <= i and (window == 0 or i - j < window);
// masked scores are -1e30; the online softmax's (m, l, acc) are fp32 and the
// output is acc / l with an l == 0 guard, in q's type.  The forward also
// writes the fp32 log-sum-exp of each row [B, Hq, S], from which the
// backward recomputes P:
//   P = exp(scale Q K^T - lse); dV = P^T dO; dP = dO V^T;
//   dS = P (dP - rowsum(dO O)); dQ = scale dS K; dK = scale dS^T Q,
// dK and dV summed over the query heads of each kv head.
// kernels/ref.py::flash_attention_split_plain and
// flash_attention_split_backward_plain do this arithmetic in PyTorch, with
// the same tiles, operand splits and order of sums (the CPU tests hold them
// against the reference's oracle; chip_smoke.py holds the kernels to them).
//
// Bound: operations.  At the training shape (B 4, S 1024, Hq 48, Hkv 4,
// D 128) the causal half of Q K^T and P V is 51.6 GFLOP forward and of the
// backward's five products 129 GFLOP, against 80 MB of q, k, v and o: far
// above the card's ridge.  The Pallas body computes in fp32 (q, k, v cast
// to fp32, P kept in fp32), so the kernels must be as exact as fp32
// arithmetic in both input types; on the CUDA cores that caps them at
// 67 TFLOP/s.  The design:
//
//   * Tiles on the tensor cores.  mma.sync with ldmatrix operands: warps
//     of 16 rows each (Cfg: 8 for fp32, 4 for bf16) share a CTA per (query
//     block, query head, b) in the forward and in dQ and per (key block, kv
//     head, b) in dK/dV, and keep their products in fp32 fragments.  The
//     resident tile (Q; Q and dO; K and V) is copied once; the streamed
//     tiles with 16-byte cp.async into a two-stage ring (rows past the
//     sequence zero-filled, reading nothing), the next one in flight while
//     the current one is computed.  A staged row is padded by 16 bytes, so
//     ldmatrix and the fp32 fragment reads are free of bank conflicts.
//   * Exact in bf16.  Q K^T and dO V^T on bf16 inputs are one m16n8k16 each:
//     bf16 products are exact in fp32.  P and dS are fp32 values: against a
//     bf16 V, dO, K or Q they enter the product in three bf16 parts
//     (hi + mid + lo, right to about 2^-24), as flash_decode.cu feeds P;
//     two parts were measured too coarse there (PERF.md).
//   * Exact in fp32 ("3xTF32", the idea of CUTLASS's OpMultiplyAddFastF32).
//     Each fp32 operand x is cut into big = tf32(x) and small = tf32(x - big)
//     (round to nearest, x - big exact) and a product is big.big +
//     big.small + small.big on mma.sync m16n8k8 tf32, right to about 2^-21.
//     A streamed fp32 tile is split once, in shared memory, by the threads
//     that copied it (its small parts staged beside it), so the warps that
//     share it read both parts by ldmatrix; the resident operand and P or dS
//     are split in registers.  Three tf32 products cost what six bf16 ones
//     do: a ceiling of 989 / 6 = 165 TFLOP/s against the CUDA cores' 67.
//     TF32 alone (one part) keeps three decimal digits and is not used.
//     Three bf16 parts with six cross terms are as exact at the same cost on
//     the tensor cores but need two ldmatrix per 16 k; not taken (PERF.md).
//   * Each chunk of k (16 bf16 or 8 tf32 values) goes into a fresh fragment,
//     which is then added to the running fp32 sum, so no long sum is left to
//     the tensor cores' own accumulation, which truncates (measured for
//     flash_decode.cu, PERF.md).  The chunk's split terms (3xTF32's three, a
//     three-part P's three) are chained in that fragment, smallest first, so
//     the kernels are not bit for bit kernels/ref.py::split_matmul, which
//     adds them with round to nearest; the two agree to within 1e-6 of
//     max|output| (chip_smoke.py phase 11).
//   * Backward, deterministic, no atomics (a rerun gives the same bits):
//     rowsum(dO O) per row; dK/dV with one CTA per (b, kv head, key block)
//     looping over the group's query heads and the query blocks that see
//     the key block, computing S^T = K Q^T and dP^T = V dO^T so that P^T and
//     dS^T come out of the mma already in the layout of an A operand, and
//     accumulating dV += P^T dO and dK += dS^T Q in registers; dQ with one
//     CTA per (b, query head, query block) recomputing S and dP over the key
//     blocks it sees.  S and dP are thus computed twice, seven products
//     where five would do: the price of determinism without a
//     [key blocks x dQ] scratch and a second reduction.
//   * Key blocks that are fully masked (causal and window) are skipped, as
//     _attn_kernel does, and fully visible ones skip the mask.  The grids
//     launch the CTAs with the most blocks to visit first.
//
// Left for later: wgmma with TMA tile copies and a warp-specialised
// producer (the card's full tensor-core rate needs both; mma.sync reaches
// a fraction of it), more CTAs per SM for the fp32 D 128 tiles (203 KB of
// shared memory leave one), and a single-pass backward if one is found
// that keeps determinism.
//
// Built with nvcc into a plain-C shared library and loaded with ctypes
// (repro_torch/kernels/_build.py, repro_torch/kernels/flash_attention.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NSTAGE = 2;         // ring stages
constexpr float NEG_INF = -1.0e30f;

// Tile sizes, as measured best on an H100 among the variants that
// scripts/flash_attention_variants.py builds (PERF.md).  fp32 D 128 rows
// are 528 bytes and a streamed fp32 tile is staged twice (its big and small
// TF32 parts), so those tiles are cut to fit 8 warps in 227 KB.
template <typename T, int D> struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr bool BIG = F32 && D == 128;
  // forward: WQ warps of 16 query rows share a ring of KB-key K/V tiles
  static constexpr int WQ = F32 ? 8 : 4;
  static constexpr int KB = F32 && !BIG ? 64 : 32;
  // dQ: the same, with its own sizes
  static constexpr int DQ_WQ = F32 ? 8 : 4;
  static constexpr int DQ_KB = BIG ? 16 : (F32 ? 64 : 32);
  // dK/dV: WK warps of 16 keys share a ring of QB-row Q/dO tiles, taken
  // QC query columns at a time
  static constexpr int WK = 4;
  static constexpr int QB = BIG ? 32 : 64;
  static constexpr int QC = F32 && !BIG ? 32 : 16;
  static constexpr int BQ = 16 * WQ, DQ_BQ = 16 * DQ_WQ, BKV = 16 * WK;
  // a streamed fp32 tile is staged as its big and small TF32 parts
  static constexpr int PARTS = F32 ? 2 : 1;
  static_assert(KB % 16 == 0 && DQ_KB % 16 == 0 && QC % 16 == 0 && QB % QC == 0,
                "tile sizes");
};

struct Params {
  const void* q;        // [B, S, Hq, D]
  const void* k;        // [B, T, Hkv, D]
  const void* v;
  const void* o;        // backward: the forward's output
  const void* dout;     // backward: dO
  const float* lse;     // [B, Hq, S]
  float* lse_out;       // forward
  float* delta;         // backward scratch [B, Hq, S]
  void* out;            // forward: o; backward: dq
  void* dk;
  void* dv;
  int S, T, Hq, Hkv, window;
  float scale;
};

// bytes of one staged row (D values and 16 bytes of padding)
template <typename T, int D> __host__ __device__ constexpr int row_bytes() { return D * (int)sizeof(T) + 16; }

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 x) { return __bfloat162float(x); }

// two adjacent outputs (round to nearest even for bf16, like astype)
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the four lanes of a quad hold one fragment row between them
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int T, int window) {
  return kpos < T && kpos <= qpos && (window == 0 || qpos - kpos < window);
}

// every key of [k0, k0 + keys) is visible to every query of [q0, q0 + rows)
__device__ __forceinline__ bool all_visible(int q0, int rows, int k0, int keys, int T,
                                            int window) {
  return k0 + keys <= T && k0 + keys - 1 <= q0
         && (window == 0 || q0 + rows - 1 - k0 < window);
}

// key blocks of kb keys [lo, hi) that queries [q0, q0 + rows) can see
__device__ __forceinline__ void key_blocks(int q0, int rows, int kb, int T, int window,
                                           int& lo, int& hi) {
  hi = min((T + kb - 1) / kb, (q0 + rows - 1) / kb + 1);
  const int first = q0 - (window - 1);
  lo = (window > 0 && first > 0) ? first / kb : 0;
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

// c[16 x 8] += a[16 x 8] . b[8 x 8], tf32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b into a fresh fragment (the accumulator input is zero)
__device__ __forceinline__ void mma_bf16_z(float (&d)[4], const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}
__device__ __forceinline__ void mma_tf32_z(float (&d)[4], const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

// x -> big = tf32(x), small = tf32(x - big): round to nearest, ties away
// from zero, what cvt.rna.tf32.f32 does, by two integer operations on the
// bits (as kernels/ref.py::tf32_round does it), which the card runs faster
// than the conversion
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_bits(x);
  small = tf32_bits(x - __uint_as_float(big));
}

// (x0, x1) -> bf16 pairs hi, mid and lo with x = hi + mid + lo to about
// 2^-24 relative (each remainder is exact in fp32); x0 in the low half, as
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

// ------------------------------------------------------------ tiles

// rows [row0, row0 + ROWS) of head h of a [B, L, H, D] tensor -> a staged
// tile; rows at or past L are zero-filled and read nothing
template <typename T, int D, int ROWS, int NTH>
__device__ __forceinline__ void load_tile(unsigned char* dst, const void* src, int b,
                                          int row0, int h, int L, int H, int tid) {
  constexpr int CPR = D * (int)sizeof(T) / 16, RS = row_bytes<T, D>();
  constexpr int EPC = 16 / (int)sizeof(T);
  const T* base = static_cast<const T*>(src);
#pragma unroll
  for (int i = tid; i < ROWS * CPR; i += NTH) {
    const int r = i / CPR, c = i - r * CPR;
    const int row = row0 + r;
    const T* p = base;
    int bytes = 0;
    if (row < L) {
      p = base + (((size_t)b * L + row) * H + h) * D + c * EPC;
      bytes = 16;
    }
    cp_async16(dst + r * RS + c * 16, p, bytes);
  }
}

// a landed fp32 tile -> its big TF32 parts in place and its small ones in
// the tile after it; each thread converts the chunks it copied itself
// (load_tile's mapping), which cp.async.wait_group has made visible to it
template <int D, int ROWS, int NTH>
__device__ __forceinline__ void split_tile(unsigned char* tile, int tid) {
  constexpr int CPR = D * 4 / 16, RS = row_bytes<float, D>();
#pragma unroll
  for (int i = tid; i < ROWS * CPR; i += NTH) {
    const int r = i / CPR, c = i - r * CPR;
    uint4* big = reinterpret_cast<uint4*>(tile + r * RS + c * 16);
    uint4* small = reinterpret_cast<uint4*>(tile + ROWS * RS + r * RS + c * 16);
    const uint4 x = *big;
    uint4 hb, sb;
    split_tf32(__uint_as_float(x.x), hb.x, sb.x);
    split_tf32(__uint_as_float(x.y), hb.y, sb.y);
    split_tf32(__uint_as_float(x.z), hb.z, sb.z);
    split_tf32(__uint_as_float(x.w), hb.w, sb.w);
    *big = hb;
    *small = sb;
  }
}

// ---------------------------------------------------- warp products
//
// Fragments of mma.sync (grp = lane / 4, tig = lane % 4): an accumulator
// c[4] of a 16 x 8 tile holds rows grp (c[0], c[1]) and grp + 8 (c[2], c[3]),
// columns 2 tig and 2 tig + 1.

// A operand of one k chunk, ready for the mma: bf16 as loaded; fp32 as its
// big and small TF32 parts
template <typename T> struct AFrag;
template <> struct AFrag<bf16> {
  uint32_t r[4];
  __device__ __forceinline__ void set(const uint32_t (&raw)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = raw[i];
  }
  // c = a . b (a fresh fragment) for b's two registers (bf16 pairs)
  __device__ __forceinline__ void mma(float (&c)[4], uint32_t b0, uint32_t b1, uint32_t,
                                      uint32_t) const {
    mma_bf16_z(c, r, b0, b1);
  }
};
template <> struct AFrag<float> {
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(const uint32_t (&raw)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(raw[i]), big[i], small[i]);
  }
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split_tf32(a0, big[0], small[0]);
    split_tf32(a1, big[1], small[1]);
    split_tf32(a2, big[2], small[2]);
    split_tf32(a3, big[3], small[3]);
  }
  // c = a . b (a fresh fragment), b given as its big (bb) and small (bs)
  // TF32 parts: 3xTF32, smallest terms first
  __device__ __forceinline__ void mma(float (&c)[4], uint32_t bb0, uint32_t bb1,
                                      uint32_t bs0, uint32_t bs1) const {
    mma_tf32_z(c, small, bb0, bb1);
    mma_tf32(c, big, bs0, bs1);
    mma_tf32(c, big, bb0, bb1);
  }
};

// s[n] = A[arow0 .. +15] . B[brow0 + 8n .. +7]^T over D (tiles staged
// [rows][D]; an fp32 A split in registers, an fp32 B staged as its big
// parts with the small ones SOFF bytes on); every 32 bytes of k (16 bf16 or
// 8 fp32 values) go into a fresh fragment that is then added to s in fp32
template <typename T, int D, int NTL, int SOFF>
__device__ __forceinline__ void warp_abt(float (&s)[NTL][4], const unsigned char* a_s,
                                         int arow0, const unsigned char* b_s, int brow0,
                                         int lane) {
  constexpr int RS = row_bytes<T, D>();
  static_assert(NTL % 2 == 0, "B rows come in pairs of n-tiles");
#pragma unroll
  for (int n = 0; n < NTL; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
  // A rows by lane % 16, k half by lane / 16; B rows 0-7 / 8-15 of each
  // n-tile pair by lane / 16, k half by (lane / 8) % 2
  const unsigned char* pa = a_s + (arow0 + (lane & 15)) * RS + (lane >> 4) * 16;
  const unsigned char* pb =
      b_s + (brow0 + (lane & 7) + ((lane >> 4) << 3)) * RS + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int kk = 0; kk < D * (int)sizeof(T) / 32; ++kk) {
    uint32_t raw[4];
    ldsm_x4(raw, pa + kk * 32);
    AFrag<T> a;
    a.set(raw);
#pragma unroll
    for (int n2 = 0; n2 < NTL / 2; ++n2) {
      uint32_t bb[4], bs[4] = {0u, 0u, 0u, 0u};
      ldsm_x4(bb, pb + n2 * 16 * RS + kk * 32);
      if constexpr (sizeof(T) == 4) ldsm_x4(bs, pb + SOFF + n2 * 16 * RS + kk * 32);
      float c0[4], c1[4];
      a.mma(c0, bb[0], bb[1], bs[0], bs[1]);
      a.mma(c1, bb[2], bb[3], bs[2], bs[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i) { s[2 * n2][i] += c0[i]; s[2 * n2 + 1][i] += c1[i]; }
    }
  }
}

// acc[n] += P . X[xrow0 .. xrow0 + 8 KT) (dims 8n .. 8n + 7), P the warp's
// fp32 accumulator fragments p[KT] over 8 KT rows of X (keys, or query rows
// in dK/dV), X staged [rows][D].  bf16 X: 16 rows a chunk, P in three bf16
// parts, X by ldmatrix.trans.  fp32 X: 8 rows a chunk, the chunk's k order
// permuted (A column tig <-> row 2 tig, tig + 4 <-> 2 tig + 1) so that P's
// accumulator layout is already an A fragment; P split into TF32 parts in
// registers, X staged as its big parts with the small ones SOFF bytes on
template <typename T, int D, int KT, int SOFF>
__device__ __forceinline__ void warp_px(float (&acc)[D / 8][4], const float (&p)[KT][4],
                                        const unsigned char* x_s, int xrow0, int lane) {
  constexpr int RS = row_bytes<T, D>();
  if constexpr (sizeof(T) == 2) {
    const unsigned char* px =
        x_s + (xrow0 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 16;
#pragma unroll
    for (int ks = 0; ks < KT / 2; ++ks) {
      uint32_t ph[4], pm[4], pl[4];
      split_bf16(p[2 * ks][0], p[2 * ks][1], ph[0], pm[0], pl[0]);
      split_bf16(p[2 * ks][2], p[2 * ks][3], ph[1], pm[1], pl[1]);
      split_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1], ph[2], pm[2], pl[2]);
      split_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3], ph[3], pm[3], pl[3]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, px + ks * 16 * RS + dd * 32);
        float c0[4], c1[4];
        mma_bf16_z(c0, pl, bv[0], bv[1]);
        mma_bf16(c0, pm, bv[0], bv[1]);
        mma_bf16(c0, ph, bv[0], bv[1]);
        mma_bf16_z(c1, pl, bv[2], bv[3]);
        mma_bf16(c1, pm, bv[2], bv[3]);
        mma_bf16(c1, ph, bv[2], bv[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) { acc[2 * dd][i] += c0[i]; acc[2 * dd + 1][i] += c1[i]; }
      }
    }
  } else {
    const int grp = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      AFrag<float> a;
      a.set(p[j][0], p[j][2], p[j][1], p[j][3]);
      const float* x0 = reinterpret_cast<const float*>(x_s + (xrow0 + 8 * j + 2 * tig) * RS);
      const float* x1 = x0 + RS / 4;
      const float* s0 = x0 + SOFF / 4;
      const float* s1 = x1 + SOFF / 4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        float c[4];
        a.mma(c, __float_as_uint(x0[n * 8 + grp]), __float_as_uint(x1[n * 8 + grp]),
              __float_as_uint(s0[n * 8 + grp]), __float_as_uint(s1[n * 8 + grp]));
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] += c[i];
      }
    }
  }
}

// ------------------------------------------------------------------ //
// forward: grid (Hq, B, ceil(S / BQ)); warp w owns query rows 16 w .. +15

template <typename T, int D>
__global__ void __launch_bounds__(32 * Cfg<T, D>::WQ)
attn_fwd_kernel(const Params p) {
  using C = Cfg<T, D>;
  constexpr int NTH = 32 * C::WQ, BQ = C::BQ, KB = C::KB, RS = row_bytes<T, D>();
  constexpr int KTILE = KB * RS, OP = C::PARTS * KTILE, STAGE = 2 * OP;
  // grid (Hq, B, query blocks), the last query blocks (the most keys) first
  const int h = blockIdx.x, b = blockIdx.y, qb = gridDim.z - 1 - blockIdx.z;
  const int kvh = h / (p.Hq / p.Hkv);
  const int q0 = qb * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* q_s = smem;
  unsigned char* ring = smem + BQ * RS;          // NSTAGE x {K, V} x parts

  int lo, hi;
  key_blocks(q0, BQ, KB, p.T, p.window, lo, hi);
  const int n_blocks = hi - lo;
  load_tile<T, D, BQ, NTH>(q_s, p.q, b, q0, h, p.S, p.Hq, tid);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < NSTAGE - 1; ++t) {
    if (t < n_blocks) {
      load_tile<T, D, KB, NTH>(ring + t * STAGE, p.k, b, (lo + t) * KB, kvh, p.T, p.Hkv, tid);
      load_tile<T, D, KB, NTH>(ring + t * STAGE + OP, p.v, b, (lo + t) * KB, kvh, p.T,
                               p.Hkv, tid);
    }
    cp_async_commit();
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;   // rows grp, grp + 8
  const int qa = q0 + warp * 16 + grp, qc = qa + 8;

  for (int it = 0; it < n_blocks; ++it) {
    cp_async_wait<NSTAGE - 2>();
    unsigned char* ks = ring + (it % NSTAGE) * STAGE;
    unsigned char* vs = ks + OP;
    if constexpr (C::F32) {
      split_tile<D, KB, NTH>(ks, tid);
      split_tile<D, KB, NTH>(vs, tid);
    }
    __syncthreads();   // block it landed for all; block it - 1's stage is free
    {
      const int tn = it + NSTAGE - 1;
      if (tn < n_blocks) {
        unsigned char* st = ring + (tn % NSTAGE) * STAGE;
        load_tile<T, D, KB, NTH>(st, p.k, b, (lo + tn) * KB, kvh, p.T, p.Hkv, tid);
        load_tile<T, D, KB, NTH>(st + OP, p.v, b, (lo + tn) * KB, kvh, p.T, p.Hkv, tid);
      }
      cp_async_commit();
    }
    const int k0 = (lo + it) * KB;

    float s[KB / 8][4];
    warp_abt<T, D, KB / 8, KTILE>(s, q_s, warp * 16, ks, 0, lane);
    const bool full = all_visible(q0, BQ, k0, KB, p.T, p.window);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int n = 0; n < KB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + 8 * n + 2 * tig + e;
        s[n][e] = (full || visible(qa, kpos, p.T, p.window)) ? s[n][e] * p.scale : NEG_INF;
        s[n][2 + e] =
            (full || visible(qc, kpos, p.T, p.window)) ? s[n][2 + e] * p.scale : NEG_INF;
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][2 + e]);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int n = 0; n < KB / 8; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = al0 * l0 + ps0;
    l1 = al1 * l1 + ps1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= al0; acc[n][1] *= al0;
      acc[n][2] *= al1; acc[n][3] *= al1;
    }
    warp_px<T, D, KB / 8, KTILE>(acc, s, vs, 0, lane);
  }
  cp_async_wait<0>();
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  T* o = static_cast<T*>(p.out);
  const float inv0 = 1.0f / (l0 == 0.0f ? 1.0f : l0);
  const float inv1 = 1.0f / (l1 == 0.0f ? 1.0f : l1);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + 2 * tig;
    if (qa < p.S)
      store2(o + (((size_t)b * p.S + qa) * p.Hq + h) * D + d, acc[n][0] * inv0, acc[n][1] * inv0);
    if (qc < p.S)
      store2(o + (((size_t)b * p.S + qc) * p.Hq + h) * D + d, acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (tig == 0) {
    float* lse = p.lse_out + ((size_t)b * p.Hq + h) * p.S;
    if (qa < p.S) lse[qa] = l0 == 0.0f ? NEG_INF : m0 + logf(l0);
    if (qc < p.S) lse[qc] = l1 == 0.0f ? NEG_INF : m1 + logf(l1);
  }
}

// ------------------------------------------------------------------ //
// backward

// delta[b, h, s] = sum_d dO[b, s, h, d] O[b, s, h, d]; one warp per row
template <typename T>
__global__ void __launch_bounds__(256)
attn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, int B, int S, int Hq, int D) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B * S * Hq) return;
  const int h = (int)(row % Hq);
  const long long bs = row / Hq;
  const int s = (int)(bs % S), b = (int)(bs / S);
  const size_t base = (size_t)row * D;         // [B, S, Hq, D] row
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f32<T>(dout[base + d]), to_f32<T>(o[base + d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[((size_t)b * Hq + h) * S + s] = acc;
}

// dQ: grid (Hq, B, ceil(S / BQ)); warp w owns query rows 16 w .. +15 and
// recomputes S = Q K^T and dP = dO V^T for each key block it sees
template <typename T, int D>
__global__ void __launch_bounds__(32 * Cfg<T, D>::DQ_WQ)
attn_bwd_dq_kernel(const Params p) {
  using C = Cfg<T, D>;
  constexpr int NTH = 32 * C::DQ_WQ, BQ = C::DQ_BQ, KB = C::DQ_KB, RS = row_bytes<T, D>();
  constexpr int KTILE = KB * RS, OP = C::PARTS * KTILE, STAGE = 2 * OP;
  // grid (Hq, B, query blocks), the last query blocks (the most keys) first
  const int h = blockIdx.x, b = blockIdx.y, qb = gridDim.z - 1 - blockIdx.z;
  const int kvh = h / (p.Hq / p.Hkv);
  const int q0 = qb * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* q_s = smem;
  unsigned char* do_s = smem + BQ * RS;
  unsigned char* ring = smem + 2 * BQ * RS;      // NSTAGE x {K, V} x parts

  int lo, hi;
  key_blocks(q0, BQ, KB, p.T, p.window, lo, hi);
  const int n_blocks = hi - lo;
  load_tile<T, D, BQ, NTH>(q_s, p.q, b, q0, h, p.S, p.Hq, tid);
  load_tile<T, D, BQ, NTH>(do_s, p.dout, b, q0, h, p.S, p.Hq, tid);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < NSTAGE - 1; ++t) {
    if (t < n_blocks) {
      load_tile<T, D, KB, NTH>(ring + t * STAGE, p.k, b, (lo + t) * KB, kvh, p.T, p.Hkv, tid);
      load_tile<T, D, KB, NTH>(ring + t * STAGE + OP, p.v, b, (lo + t) * KB, kvh, p.T,
                               p.Hkv, tid);
    }
    cp_async_commit();
  }
  const int qa = q0 + warp * 16 + grp, qc = qa + 8;
  const size_t rbase = ((size_t)b * p.Hq + h) * p.S;
  const float lse0 = qa < p.S ? p.lse[rbase + qa] : 0.0f;
  const float lse1 = qc < p.S ? p.lse[rbase + qc] : 0.0f;
  const float dd0 = qa < p.S ? p.delta[rbase + qa] : 0.0f;
  const float dd1 = qc < p.S ? p.delta[rbase + qc] : 0.0f;

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.0f;

  for (int it = 0; it < n_blocks; ++it) {
    cp_async_wait<NSTAGE - 2>();
    unsigned char* ks = ring + (it % NSTAGE) * STAGE;
    unsigned char* vs = ks + OP;
    if constexpr (C::F32) {
      split_tile<D, KB, NTH>(ks, tid);
      split_tile<D, KB, NTH>(vs, tid);
    }
    __syncthreads();
    {
      const int tn = it + NSTAGE - 1;
      if (tn < n_blocks) {
        unsigned char* st = ring + (tn % NSTAGE) * STAGE;
        load_tile<T, D, KB, NTH>(st, p.k, b, (lo + tn) * KB, kvh, p.T, p.Hkv, tid);
        load_tile<T, D, KB, NTH>(st + OP, p.v, b, (lo + tn) * KB, kvh, p.T, p.Hkv, tid);
      }
      cp_async_commit();
    }
    const int k0 = (lo + it) * KB;

    float s[KB / 8][4], dp[KB / 8][4];
    warp_abt<T, D, KB / 8, KTILE>(s, q_s, warp * 16, ks, 0, lane);
    warp_abt<T, D, KB / 8, KTILE>(dp, do_s, warp * 16, vs, 0, lane);
    // dS = P (dP - delta), P = exp(scale S - lse) where visible, else 0
    const bool full = q0 + BQ <= p.S && all_visible(q0, BQ, k0, KB, p.T, p.window);
#pragma unroll
    for (int n = 0; n < KB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + 8 * n + 2 * tig + e;
        const float pa = (full || (qa < p.S && visible(qa, kpos, p.T, p.window)))
                             ? expf(s[n][e] * p.scale - lse0) : 0.0f;
        const float pc = (full || (qc < p.S && visible(qc, kpos, p.T, p.window)))
                             ? expf(s[n][2 + e] * p.scale - lse1) : 0.0f;
        s[n][e] = pa * (dp[n][e] - dd0);
        s[n][2 + e] = pc * (dp[n][2 + e] - dd1);
      }
    warp_px<T, D, KB / 8, KTILE>(dq, s, ks, 0, lane);   // dQ += dS K
  }
  cp_async_wait<0>();
  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + 2 * tig;
    if (qa < p.S)
      store2(out + (((size_t)b * p.S + qa) * p.Hq + h) * D + d, dq[n][0] * p.scale,
             dq[n][1] * p.scale);
    if (qc < p.S)
      store2(out + (((size_t)b * p.S + qc) * p.Hq + h) * D + d, dq[n][2] * p.scale,
             dq[n][3] * p.scale);
  }
}

// dK/dV: grid (Hkv, B, ceil(T / BKV)); warp w owns keys 16 w .. +15 of the
// block and, for each query head of the group and each QB-row query block
// that sees the key block, computes S^T = K Q^T and dP^T = V dO^T (QC query
// columns at a time), then dV += P^T dO and dK += dS^T Q
template <typename T, int D>
__global__ void __launch_bounds__(32 * Cfg<T, D>::WK)
attn_bwd_dkdv_kernel(const Params p) {
  using C = Cfg<T, D>;
  constexpr int NTH = 32 * C::WK, BKV = C::BKV, QB = C::QB, QC = C::QC;
  constexpr int RS = row_bytes<T, D>();
  constexpr int QTILE = QB * RS, OP = C::PARTS * QTILE;
  constexpr int STAGE = 2 * OP + 2 * QB * (int)sizeof(float);   // Q, dO, lse, delta
  // grid (Hkv, B, key blocks), the first key blocks (the most queries) first
  const int kvh = blockIdx.x, b = blockIdx.y, kb = blockIdx.z;
  const int group = p.Hq / p.Hkv;
  const int k0 = kb * BKV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 2, tig = lane & 3;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* k_s = smem;
  unsigned char* v_s = smem + BKV * RS;
  unsigned char* ring = smem + 2 * BKV * RS;

  // query blocks that see this key block: causal from k0 on; the window
  // ends where the oldest query of a block, q0 - (window - 1), passes the
  // block's last key
  const int nqb = (p.S + QB - 1) / QB;
  const int qlo = k0 / QB;
  const int qhi = p.window > 0 ? min(nqb, (k0 + BKV + p.window - 2) / QB + 1) : nqb;
  const int nq = max(qhi - qlo, 0);
  const int n_iter = group * nq;

  // stage `it`: Q and dO rows of query block qlo + it % nq of head
  // kvh * group + it / nq, and their lse and delta (plain stores, seen by
  // all after the __syncthreads that opens the iteration consuming them)
  auto stage = [&](int it) {
    unsigned char* st = ring + (it % NSTAGE) * STAGE;
    const int h = kvh * group + it / nq;
    const int q0 = (qlo + it % nq) * QB;
    load_tile<T, D, QB, NTH>(st, p.q, b, q0, h, p.S, p.Hq, tid);
    load_tile<T, D, QB, NTH>(st + OP, p.dout, b, q0, h, p.S, p.Hq, tid);
    float* rows = reinterpret_cast<float*>(st + 2 * OP);       // lse [QB], delta [QB]
    const size_t rbase = ((size_t)b * p.Hq + h) * p.S;
    for (int i = tid; i < 2 * QB; i += NTH) {
      const int row = q0 + (i % QB);
      rows[i] = row < p.S ? (i < QB ? p.lse : p.delta)[rbase + row] : 0.0f;
    }
  };

  load_tile<T, D, BKV, NTH>(k_s, p.k, b, k0, kvh, p.T, p.Hkv, tid);
  load_tile<T, D, BKV, NTH>(v_s, p.v, b, k0, kvh, p.T, p.Hkv, tid);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < NSTAGE - 1; ++t) {
    if (t < n_iter) stage(t);
    cp_async_commit();
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.0f;
  const int ka = k0 + warp * 16 + grp, kc = ka + 8;

  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<NSTAGE - 2>();
    unsigned char* qs = ring + (it % NSTAGE) * STAGE;
    unsigned char* dos = qs + OP;
    if constexpr (C::F32) {
      split_tile<D, QB, NTH>(qs, tid);
      split_tile<D, QB, NTH>(dos, tid);
    }
    __syncthreads();
    if (it + NSTAGE - 1 < n_iter) stage(it + NSTAGE - 1);
    cp_async_commit();
    const float* lse_s = reinterpret_cast<const float*>(qs + 2 * OP);
    const float* dd_s = lse_s + QB;
    const int q0 = (qlo + it % nq) * QB;
    const bool full = q0 + QB <= p.S && all_visible(q0, QB, k0, BKV, p.T, p.window);
#pragma unroll 1
    for (int c0 = 0; c0 < QB; c0 += QC) {         // first query column
      float st[QC / 8][4], dpt[QC / 8][4];
      warp_abt<T, D, QC / 8, QTILE>(st, k_s, warp * 16, qs, c0, lane);
      // P^T where visible, else 0 (query rows past S included)
#pragma unroll
      for (int n = 0; n < QC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * n + 2 * tig + e, qpos = q0 + col;
          const bool ok = full || qpos < p.S;
          st[n][e] = (ok && (full || visible(qpos, ka, p.T, p.window)))
                         ? expf(st[n][e] * p.scale - lse_s[col]) : 0.0f;
          st[n][2 + e] = (ok && (full || visible(qpos, kc, p.T, p.window)))
                             ? expf(st[n][2 + e] * p.scale - lse_s[col]) : 0.0f;
        }
      warp_px<T, D, QC / 8, QTILE>(dv, st, dos, c0, lane);   // dV += P^T dO
      warp_abt<T, D, QC / 8, QTILE>(dpt, v_s, warp * 16, dos, c0, lane);
#pragma unroll
      for (int n = 0; n < QC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dd = dd_s[c0 + 8 * n + 2 * tig + e];
          dpt[n][e] = st[n][e] * (dpt[n][e] - dd);
          dpt[n][2 + e] = st[n][2 + e] * (dpt[n][2 + e] - dd);
        }
      warp_px<T, D, QC / 8, QTILE>(dk, dpt, qs, c0, lane);   // dK += dS^T Q
    }
  }
  cp_async_wait<0>();
  T* dko = static_cast<T*>(p.dk);
  T* dvo = static_cast<T*>(p.dv);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + 2 * tig;
    if (ka < p.T) {
      const size_t off = (((size_t)b * p.T + ka) * p.Hkv + kvh) * D + d;
      store2(dko + off, dk[n][0] * p.scale, dk[n][1] * p.scale);
      store2(dvo + off, dv[n][0], dv[n][1]);
    }
    if (kc < p.T) {
      const size_t off = (((size_t)b * p.T + kc) * p.Hkv + kvh) * D + d;
      store2(dko + off, dk[n][2] * p.scale, dk[n][3] * p.scale);
      store2(dvo + off, dv[n][2], dv[n][3]);
    }
  }
}

// ------------------------------------------------------------------ //
// launchers

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
cudaError_t fwd(const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<T, D>;
  constexpr size_t RS = row_bytes<T, D>();
  const size_t smem = RS * (C::BQ + 2 * NSTAGE * C::PARTS * C::KB);
  auto kern = attn_fwd_kernel<T, D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(p.Hq, B, (p.S + C::BQ - 1) / C::BQ), 32 * C::WQ, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd(const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<T, D>;
  constexpr size_t RS = row_bytes<T, D>();
  const long long rows = (long long)B * p.S * p.Hq;
  attn_bwd_delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(p.o), static_cast<const T*>(p.dout), p.delta, B, p.S,
      p.Hq, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_kv = RS * (2 * C::BKV + 2 * NSTAGE * C::PARTS * C::QB)
                         + (size_t)NSTAGE * 2 * C::QB * sizeof(float);
  auto kv = attn_bwd_dkdv_kernel<T, D>;
  if ((err = allow_smem(kv, smem_kv)) != cudaSuccess) return err;
  kv<<<dim3(p.Hkv, B, (p.T + C::BKV - 1) / C::BKV), 32 * C::WK, smem_kv, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_q = RS * (2 * C::DQ_BQ + 2 * NSTAGE * C::PARTS * C::DQ_KB);
  auto qk = attn_bwd_dq_kernel<T, D>;
  if ((err = allow_smem(qk, smem_q)) != cudaSuccess) return err;
  qk<<<dim3(p.Hq, B, (p.S + C::DQ_BQ - 1) / C::DQ_BQ), 32 * C::DQ_WQ, smem_q, stream>>>(p);
  return cudaGetLastError();
}

bool shape_ok(int B, int S, int Tk, int Hq, int Hkv, int window) {
  return B > 0 && B <= 65535 && S > 0 && Tk > 0 && Hkv > 0 && Hq > 0 &&
         Hq <= 65535 && Hq % Hkv == 0 && window >= 0;
}

template <template <typename, int> class F>
struct Dispatch {
  static cudaError_t run(int dtype, int D, const Params& p, int B, cudaStream_t s) {
    if (dtype == 0) {
      if (D == 32) return F<float, 32>::go(p, B, s);
      if (D == 64) return F<float, 64>::go(p, B, s);
      if (D == 128) return F<float, 128>::go(p, B, s);
    } else if (dtype == 1) {
      if (D == 32) return F<bf16, 32>::go(p, B, s);
      if (D == 64) return F<bf16, 64>::go(p, B, s);
      if (D == 128) return F<bf16, 128>::go(p, B, s);
    }
    return cudaErrorInvalidValue;
  }
};
template <typename T, int D> struct Fwd {
  static cudaError_t go(const Params& p, int B, cudaStream_t s) { return fwd<T, D>(p, B, s); }
};
template <typename T, int D> struct Bwd {
  static cudaError_t go(const Params& p, int B, cudaStream_t s) { return bwd<T, D>(p, B, s); }
};

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, o and the gradients
// share it).  Every pointer must be 16-byte aligned (the wrapper checks).
// Each returns the cudaError_t of its launches (cudaGetLastError right
// after each); 0 means all were accepted.  D other than 32, 64 or 128 is
// refused with cudaErrorInvalidValue.
extern "C" int attn_forward_launch(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int dtype, int B, int S,
                                   int Tk, int Hq, int Hkv, int D, int window,
                                   float scale, int device, void* stream) {
  // this library carries its own CUDA runtime: select the caller's device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!shape_ok(B, S, Tk, Hq, Hkv, window)) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.q = q; p.k = k; p.v = v;
  p.out = o;
  p.lse_out = static_cast<float*>(lse);
  p.S = S; p.T = Tk; p.Hq = Hq; p.Hkv = Hkv; p.window = window; p.scale = scale;
  return (int)Dispatch<Fwd>::run(dtype, D, p, B, static_cast<cudaStream_t>(stream));
}

extern "C" int attn_backward_launch(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* lse, const void* dout,
                                    void* delta, void* dq, void* dk, void* dv,
                                    int dtype, int B, int S, int Tk, int Hq,
                                    int Hkv, int D, int window, float scale,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!shape_ok(B, S, Tk, Hq, Hkv, window)) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.out = dq; p.dk = dk; p.dv = dv;
  p.S = S; p.T = Tk; p.Hq = Hq; p.Hkv = Hkv; p.window = window; p.scale = scale;
  return (int)Dispatch<Bwd>::run(dtype, D, p, B, static_cast<cudaStream_t>(stream));
}
