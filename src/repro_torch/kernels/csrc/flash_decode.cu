// Paged flash-decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py::_decode_kernel
// and computes exactly what repro/kernels/ref.py::flash_decode_ref computes:
// one query token per sequence against a paged KV pool [Hkv, P, page, D],
// read through block_tables [B, maxp]; key j is visible iff j < len and
// (window == 0 or len-1-j < window); masked scores are -1e30; a sequence
// with len == 0 gives zeros and reads no page; the output is in q's type.
//
// Design (simple and right first):
//   * One CTA of NT = 512 threads per (b, kv head).  The CTA reads its own
//     page ids from block_tables (Hopper has no scalar prefetch).  The
//     G = Hq / Hkv query heads of the group share every K/V tile, so K/V
//     are read from device memory once.
//   * It walks only the keys that are visible, [max(0, len - window),
//     min(len, maxp * page)), in tiles of TILE tokens (32, or 16 for D = 256).  The Pallas grid walks
//     all of maxp and skips pages with pl.when.
//   * K and V tiles are read with 16-byte loads into registers one tile
//     ahead (the next tile's loads are in flight while the current one is
//     computed), then converted to fp32 in shared memory (K rows padded by
//     one float so the per-(g, key) dot products are free of bank
//     conflicts).  The G query heads live in shared memory in fp32.
//   * acc[G, D] is spread over the threads in fp32 registers (thread t owns
//     flat elements t, t + NT, ...); the running (m, l) of each query head
//     sit in shared memory.  Online softmax in fp32, as the Pallas kernel.
//
// Bound: bytes.  Per call the kernel must read the visible K and V (2 *
// visible keys * Hkv * D * sizeof(pool type)) plus q and write out; it does
// about 4 flops per byte of bf16 K/V, far below the card's ~295 flop/byte
// ridge.  What this design does about it: every visible K/V byte is read
// once, in 16-byte loads issued a tile ahead, and nothing else of the pool
// is touched.  What it does not
// do yet: at the serving shape (B = 8, Hkv = 4) there are 32 CTAs for 132
// SMs, so the card's bandwidth is far from saturated.  Split-K over pages
// (flash-decoding: partial (m, l, acc) per split plus a combine pass),
// cp.async/TMA staging and bf16 mma are later work.
//
// Built with nvcc into a plain-C shared library and loaded with ctypes
// (repro_torch/kernels/_build.py, repro_torch/kernels/flash_decode.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NT = 512;           // threads per CTA (16 warps hide shared-memory latency)
constexpr int MAXE = 8;           // acc elements per thread: G * D <= NT * MAXE
constexpr float NEG_INF = -1.0e30f;

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

// Unpack one 16-byte load (4 fp32 or 8 bf16 values) into fp32, exactly.
template <typename T> __device__ __forceinline__ void unpack16(const uint4& u, float* o);
template <> __device__ __forceinline__ void unpack16<float>(const uint4& u, float* o) {
  o[0] = __uint_as_float(u.x); o[1] = __uint_as_float(u.y);
  o[2] = __uint_as_float(u.z); o[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& u, float* o) {
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

template <int D> struct Tile { static constexpr int value = D >= 256 ? 16 : 32; };

template <int D>
__host__ __device__ constexpr int smem_floats(int G) {
  return G * D                                   // q_s
         + Tile<D>::value * (D + 1)              // k_s (padded rows)
         + Tile<D>::value * D                    // v_s
         + G * Tile<D>::value                    // p_s
         + 3 * G;                                // m_s, l_s, alpha_s
}

template <typename QT, typename KVT, int D>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const QT* __restrict__ q, const KVT* __restrict__ k_pages,
                    const KVT* __restrict__ v_pages, const int* __restrict__ tables,
                    const int* __restrict__ lengths, QT* __restrict__ out,
                    int Hkv, int G, int P, int page, int maxp, int window,
                    float scale) {
  constexpr int TILE = Tile<D>::value;
  constexpr int KS = D + 1;
  constexpr int VEC = 16 / sizeof(KVT);          // pool elements per 16-byte load
  constexpr int VPR = D / VEC;                   // 16-byte loads per K/V row
  constexpr int NV = (TILE * VPR + NT - 1) / NT; // loads per thread per tile
  constexpr int GS = NT / TILE;                  // score pass: heads g0, g0+GS, ...
  constexpr int MAXGS = (NT * MAXE / D + GS - 1) / GS;
  static_assert(NT % D == 0, "a thread's output dim must be fixed");
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int GD = G * D;

  const size_t q_off = ((size_t)b * Hkv + h) * (size_t)GD;   // [B, Hkv, G, D]
  const int len = lengths[b];
  if (len <= 0) {
    for (int i = tid; i < GD; i += NT) out[q_off + i] = from_f32<QT>(0.0f);
    return;
  }
  // the window starts from the length as given; keys past the table do not
  // exist, so only the loop's end is clamped to it
  const int lo = (window > 0 && len > window) ? len - window : 0;
  const int hi = min(len, maxp * page);

  extern __shared__ float smem[];
  float* q_s = smem;                     // [G, D]
  float* k_s = q_s + GD;                 // [TILE, D + 1]
  float* v_s = k_s + TILE * KS;          // [TILE, D]
  float* p_s = v_s + TILE * D;           // [G, TILE]
  float* m_s = p_s + G * TILE;           // [G]
  float* l_s = m_s + G;                  // [G]
  float* a_s = l_s + G;                  // [G]

  for (int i = tid; i < GD; i += NT) q_s[i] = to_f32<QT>(q[q_off + i]);
  for (int g = tid; g < G; g += NT) { m_s[g] = NEG_INF; l_s[g] = 0.0f; }

  float acc[MAXE];
#pragma unroll
  for (int e = 0; e < MAXE; ++e) acc[e] = 0.0f;

  const int* tbl = tables + (size_t)b * maxp;
  const size_t head_base = (size_t)h * P;

  // 16-byte loads of K/V rows [t0, t0 + TILE) into registers; rows past
  // hi read nothing and stay zero
  uint4 kreg[NV], vreg[NV];
  auto load_tile = [&](int t0) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int idx = tid + v * NT;
      const int r = idx / VPR, c = idx - r * VPR;
      const int j = t0 + r;
      kreg[v] = make_uint4(0u, 0u, 0u, 0u);
      vreg[v] = kreg[v];
      if (idx < TILE * VPR && j < hi) {
        const size_t pg = (size_t)tbl[j / page];
        const size_t off = ((head_base + pg) * page + (j % page)) * D + c * VEC;
        kreg[v] = *reinterpret_cast<const uint4*>(k_pages + off);
        vreg[v] = *reinterpret_cast<const uint4*>(v_pages + off);
      }
    }
  };

  load_tile(lo);
  for (int t0 = lo; t0 < hi; t0 += TILE) {
    __syncthreads();   // previous tile's k_s / v_s / p_s fully consumed
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int idx = tid + v * NT;
      const int r = idx / VPR, c = idx - r * VPR;
      if (idx >= TILE * VPR) break;
      float kf[VEC], vf[VEC];
      unpack16<KVT>(kreg[v], kf);
      unpack16<KVT>(vreg[v], vf);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        k_s[r * KS + c * VEC + i] = kf[i];
        v_s[r * D + c * VEC + i] = vf[i];
      }
    }
    __syncthreads();
    // the next tile's loads are in flight while this one is computed
    if (t0 + TILE < hi) load_tile(t0 + TILE);

    // scores s[g, r] = scale * q[g] . k[r], masked to -1e30; thread (g0, r)
    // takes heads g0, g0 + GS, ... so each k_s value it reads is reused
    {
      const int r = tid % TILE, g0 = tid / TILE;
      const float* kr = k_s + r * KS;
      float s[MAXGS];
#pragma unroll
      for (int k = 0; k < MAXGS; ++k) s[k] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kv = kr[d];
#pragma unroll
        for (int k = 0; k < MAXGS; ++k) {
          const int g = g0 + k * GS;
          if (g < G) s[k] = fmaf(q_s[g * D + d], kv, s[k]);
        }
      }
      const int j = t0 + r;
      const bool visible = j < hi;   // j >= lo from the loop's start
#pragma unroll
      for (int k = 0; k < MAXGS; ++k) {
        const int g = g0 + k * GS;
        if (g < G) p_s[g * TILE + r] = visible ? s[k] * scale : NEG_INF;
      }
    }
    __syncthreads();
    // online softmax per query head: one warp per head, one lane per key
    for (int g = warp; g < G; g += NT / 32) {
      const float s = lane < TILE ? p_s[g * TILE + lane] : NEG_INF;
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = lane < TILE ? expf(s - m_new) : 0.0f;
      const float alpha = expf(m_prev - m_new);
      const float psum = warp_sum(p);
      if (lane < TILE) p_s[g * TILE + lane] = p;
      if (lane == 0) {
        l_s[g] = alpha * l_s[g] + psum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();
    // acc[g, d] = alpha[g] * acc[g, d] + sum_r p[g, r] * v[r, d]; thread t
    // owns flat elements f = t + e * NT of [G, D]: dim t % D of heads
    // t / D + e * (NT / D), so each v_s value it reads serves all of them
    {
      const int d = tid % D, gb = tid / D;
      constexpr int GSTEP = NT / D;
#pragma unroll
      for (int e = 0; e < MAXE; ++e) {
        const int g = gb + e * GSTEP;
        if (g < G) acc[e] *= a_s[g];
      }
#pragma unroll 4
      for (int r = 0; r < TILE; ++r) {
        const float vv = v_s[r * D + d];
#pragma unroll
        for (int e = 0; e < MAXE; ++e) {
          const int g = gb + e * GSTEP;
          if (g < G) acc[e] = fmaf(p_s[g * TILE + r], vv, acc[e]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < MAXE; ++e) {
    const int f = tid + e * NT;
    if (f < GD) {
      const float l = l_s[f / D];
      out[q_off + f] = from_f32<QT>(acc[e] / (l == 0.0f ? 1.0f : l));
    }
  }
}

template <typename QT, typename KVT, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tables,
                   const int* lengths, void* out, int B, int Hkv, int G, int P,
                   int page, int maxp, int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)smem_floats<D>(G);
  auto kern = flash_decode_kernel<QT, KVT, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<dim3(Hkv, B), NT, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KVT*>(k),
      static_cast<const KVT*>(v), tables, lengths, static_cast<QT*>(out),
      Hkv, G, P, page, maxp, window, scale);
  return cudaGetLastError();
}

template <typename QT, typename KVT>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v,
                     const int* tables, const int* lengths, void* out, int B,
                     int Hkv, int G, int P, int page, int maxp, int window,
                     float scale, cudaStream_t s) {
  switch (D) {
    case 32:  return launch<QT, KVT, 32>(q, k, v, tables, lengths, out, B, Hkv, G, P, page, maxp, window, scale, s);
    case 64:  return launch<QT, KVT, 64>(q, k, v, tables, lengths, out, B, Hkv, G, P, page, maxp, window, scale, s);
    case 128: return launch<QT, KVT, 128>(q, k, v, tables, lengths, out, B, Hkv, G, P, page, maxp, window, scale, s);
    case 256: return launch<QT, KVT, 256>(q, k, v, tables, lengths, out, B, Hkv, G, P, page, maxp, window, scale, s);
    default:  return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launch (cudaGetLastError right after it); 0 means it was accepted.
// Shapes the kernel does not take (D not in {32, 64, 128, 256}, G * D >
// NT * MAXE = 4096) are refused with cudaErrorInvalidValue.
extern "C" int flash_decode_launch(const void* q, const void* k_pages,
                                   const void* v_pages, const void* tables,
                                   const void* lengths, void* out, int q_dtype,
                                   int kv_dtype, int B, int Hkv, int G, int D,
                                   int P, int page, int maxp, int window,
                                   float scale, int device, void* stream) {
  // this library carries its own CUDA runtime: select the caller's device
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  if (B <= 0 || Hkv <= 0 || G <= 0 || G * D > NT * MAXE) return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == 0 && kv_dtype == 0)
    err = launch_d<float, float>(D, q, k_pages, v_pages, t, l, out, B, Hkv, G, P, page, maxp, window, scale, s);
  else if (q_dtype == 0 && kv_dtype == 1)
    err = launch_d<float, __nv_bfloat16>(D, q, k_pages, v_pages, t, l, out, B, Hkv, G, P, page, maxp, window, scale, s);
  else if (q_dtype == 1 && kv_dtype == 0)
    err = launch_d<__nv_bfloat16, float>(D, q, k_pages, v_pages, t, l, out, B, Hkv, G, P, page, maxp, window, scale, s);
  else if (q_dtype == 1 && kv_dtype == 1)
    err = launch_d<__nv_bfloat16, __nv_bfloat16>(D, q, k_pages, v_pages, t, l, out, B, Hkv, G, P, page, maxp, window, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
