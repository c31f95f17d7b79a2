// Causal / sliding-window GQA flash attention for Hopper (sm_90a), forward
// and backward.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (body _attn_kernel), which has no backward, and computes
// what repro/kernels/ref.py::flash_attention_ref computes with causal=True:
// q [B, S, Hq, D], k/v [B, T, Hkv, D]; query head h attends kv head
// h / (Hq / Hkv); key j is visible to query i iff j < T, j <= i and
// (window == 0 or i - j < window); masked scores are -1e30; the running
// (m, l, acc) of the online softmax are fp32 and the output is divided by
// l with an l == 0 guard, in q's type.  The forward also writes the fp32
// log-sum-exp of each row [B, Hq, S], from which the backward recomputes P.
//
// Backward (kernels/ref.py::flash_attention_backward_plain):
//   P = exp(scale Q K^T - lse); dV = P^T dO; dP = dO V^T;
//   dS = P (dP - rowsum(dO O)); dQ = scale dS K; dK = scale dS^T Q,
// dK and dV summed over the query heads of each kv head, in three launches
// with no atomics (a rerun gives the same bits): rowsum(dO O) per row; dK/dV
// with one CTA per (b, kv head, key block) looping over the group's query
// heads and the query blocks that see the key block; dQ with one CTA per
// (b, query head, query block) looping over the key blocks it sees.
//
// Bound: operations.  At the training shape (B 4, S 1024, Hq 48, Hkv 4,
// D 128) the causal half of Q K^T and P V is some 51 GFLOP forward against
// 80 MB of q, k, v and o, far above the ridge; in fp32 the bound is the
// 67 TFLOP/s of the CUDA cores.  What the design does about it: 64 x 64
// tiles of Q, K, V (and dO) converted to fp32 in shared memory, rows padded
// by one float so the 16 x 16 threads' reads are free of bank conflicts;
// each thread owns a 4 x 4 block of the score tile (rows ty + 16 r, columns
// tx + 16 c) and a 4 x D/16 block of the output, so every shared value it
// loads feeds four FMAs; key blocks that are fully masked (causal and
// window) are skipped, as _attn_kernel does.  What it does not do yet:
// bf16 tiles on the tensor cores (wgmma), TMA and a pipeline of tiles: it
// runs on the CUDA cores and is limited by shared-memory bandwidth.
//
// Built with nvcc into a plain-C shared library and loaded with ctypes
// (repro_torch/kernels/_build.py, repro_torch/kernels/flash_attention.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;            // query rows per tile
constexpr int BK = 64;            // key rows per tile
constexpr int NT = 256;           // threads per CTA: 16 x 16
constexpr int LDP = BK + 1;       // padded row of a score tile
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

// rows [row0, row0 + 64) of head h of a [B, L, H, D] tensor -> fp32 tile
// [64][D + 1] in shared memory; rows past L read as zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int b, int row0, int h, int L, int H) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, c = idx - r * D;
    const int row = row0 + r;
    dst[r * (D + 1) + c] =
        row < L ? to_f32<T>(src[(((size_t)b * L + row) * H + h) * D + c]) : 0.0f;
  }
}

// s[r][c] = sum_d A[ty + 16 r][d] B[tx + 16 c][d]  (tiles [64][D + 1])
template <int D>
__device__ __forceinline__ void mm_abt(const float* A, const float* Bm,
                                       float s[4][4], int tx, int ty) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], bb[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[(ty + 16 * r) * (D + 1) + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) bb[c] = Bm[(tx + 16 * c) * (D + 1) + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], bb[c], s[r][c]);
  }
}

// acc[r][c] += sum_k P[ty + 16 r][k] X[k][tx + 16 c]  (P [64][LDP], X [64][D + 1])
template <int D>
__device__ __forceinline__ void mm_ab_acc(const float* P, const float* X,
                                          float acc[4][D / 16], int tx, int ty) {
#pragma unroll 4
  for (int k = 0; k < 64; ++k) {
    float p[4], x[D / 16];
#pragma unroll
    for (int r = 0; r < 4; ++r) p[r] = P[(ty + 16 * r) * LDP + k];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) x[c] = X[k * (D + 1) + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[r][c] = fmaf(p[r], x[c], acc[r][c]);
  }
}

// acc[r][c] += sum_q P[q][ty + 16 r] X[q][tx + 16 c]  (P [64][LDP], X [64][D + 1])
template <int D>
__device__ __forceinline__ void mm_atb_acc(const float* P, const float* X,
                                           float acc[4][D / 16], int tx, int ty) {
#pragma unroll 4
  for (int q = 0; q < 64; ++q) {
    float p[4], x[D / 16];
#pragma unroll
    for (int r = 0; r < 4; ++r) p[r] = P[q * LDP + ty + 16 * r];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) x[c] = X[q * (D + 1) + tx + 16 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[r][c] = fmaf(p[r], x[c], acc[r][c]);
  }
}

// the 16 threads of a row (one half-warp) combine their values
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int T, int window) {
  return kpos < T && kpos <= qpos && (window == 0 || qpos - kpos < window);
}

// key blocks [lo, hi) that queries [q0, q0 + BQ) can see
__device__ __forceinline__ void key_blocks(int q0, int T, int window, int& lo,
                                           int& hi) {
  hi = min((T + BK - 1) / BK, (q0 + BQ - 1) / BK + 1);
  const int first = q0 - (window - 1);
  lo = (window > 0 && first > 0) ? first / BK : 0;
}

template <int D>
__host__ __device__ constexpr int tile_floats() { return 64 * (D + 1); }

// ------------------------------------------------------------------ //
// forward

template <typename T, int D>
__global__ void __launch_bounds__(NT)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o,
                float* __restrict__ lse, int S, int Tk, int Hq, int Hkv,
                int window, float scale) {
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int q0 = qb * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + tile_floats<D>();
  float* v_s = k_s + tile_floats<D>();
  float* p_s = v_s + tile_floats<D>();     // [BQ][LDP]

  load_tile<T, D>(q_s, q, b, q0, h, S, Hq);
  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[r][c] = 0.0f;
  }
  int lo, hi;
  key_blocks(q0, Tk, window, lo, hi);
  for (int kb = lo; kb < hi; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();                // the previous tiles are consumed
    load_tile<T, D>(k_s, k, b, k0, kvh, Tk, Hkv);
    load_tile<T, D>(v_s, v, b, k0, kvh, Tk, Hkv);
    __syncthreads();
    float s[4][4];
    mm_abt<D>(q_s, k_s, s, tx, ty);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty + 16 * r;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = visible(qpos, k0 + tx + 16 * c, Tk, window) ? s[r][c] * scale
                                                               : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      const float alpha = expf(m[r] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        p_s[(ty + 16 * r) * LDP + tx + 16 * c] = p;
        psum += p;
      }
      l[r] = alpha * l[r] + row_sum(psum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();
    mm_ab_acc<D>(p_s, v_s, acc, tx, ty);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= S) continue;
    const float inv = 1.0f / (l[r] == 0.0f ? 1.0f : l[r]);
    T* orow = o + (((size_t)b * S + row) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) orow[tx + 16 * c] = from_f32<T>(acc[r][c] * inv);
    if (tx == 0)
      lse[((size_t)b * Hq + h) * S + row] =
          l[r] == 0.0f ? NEG_INF : m[r] + logf(l[r]);
  }
}

// ------------------------------------------------------------------ //
// backward

// delta[b, h, s] = sum_d dO[b, s, h, d] O[b, s, h, d]; one warp per row
template <typename T>
__global__ void __launch_bounds__(NT)
attn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, int B, int S, int Hq, int D) {
  const long long row = (long long)blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
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

// P (masked entries exactly 0) and dS of one (query tile, key tile) pair,
// written to p_s and ds_s ([BQ][LDP]) in shared memory
template <int D>
__device__ __forceinline__ void probs_and_dscores(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    const float* lse_s, const float* dd_s, float* p_s, float* ds_s, int q0,
    int k0, int Tk, int window, float scale, int tx, int ty) {
  float s[4][4], dp[4][4];
  mm_abt<D>(q_s, k_s, s, tx, ty);
  mm_abt<D>(do_s, v_s, dp, tx, ty);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int lr = ty + 16 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int lc = tx + 16 * c;
      const float p = visible(q0 + lr, k0 + lc, Tk, window)
                          ? expf(s[r][c] * scale - lse_s[lr]) : 0.0f;
      if (p_s) p_s[lr * LDP + lc] = p;
      ds_s[lr * LDP + lc] = p * (dp[r][c] - dd_s[lr]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int Tk, int Hq, int Hkv,
                     int window, float scale) {
  const int kb = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int k0 = kb * BK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + tile_floats<D>();
  float* q_s = v_s + tile_floats<D>();
  float* do_s = q_s + tile_floats<D>();
  float* p_s = do_s + tile_floats<D>();    // [BQ][LDP]
  float* ds_s = p_s + BQ * LDP;            // [BQ][LDP]
  float* lse_s = ds_s + BQ * LDP;          // [BQ]
  float* dd_s = lse_s + BQ;                // [BQ]

  load_tile<T, D>(k_s, k, b, k0, kvh, Tk, Hkv);
  load_tile<T, D>(v_s, v, b, k0, kvh, Tk, Hkv);
  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.0f;

  // query blocks that see this key block: causal from k0 on; the window
  // ends where the oldest query of a block, q0 - (window - 1), passes the
  // block's last key
  const int nqb = (S + BQ - 1) / BQ;
  const int qlo = k0 / BQ;
  const int qhi = window > 0 ? min(nqb, (k0 + BK + window - 2) / BQ + 1) : nqb;
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    for (int qb = qlo; qb < qhi; ++qb) {
      const int q0 = qb * BQ;
      __syncthreads();              // the previous tiles are consumed
      load_tile<T, D>(q_s, q, b, q0, h, S, Hq);
      load_tile<T, D>(do_s, dout, b, q0, h, S, Hq);
      if (threadIdx.x < BQ) {
        const int row = q0 + threadIdx.x;
        const size_t off = ((size_t)b * Hq + h) * S + row;
        lse_s[threadIdx.x] = row < S ? lse[off] : 0.0f;
        dd_s[threadIdx.x] = row < S ? delta[off] : 0.0f;
      }
      __syncthreads();
      probs_and_dscores<D>(q_s, do_s, k_s, v_s, lse_s, dd_s, p_s, ds_s, q0,
                           k0, Tk, window, scale, tx, ty);
      __syncthreads();
      mm_atb_acc<D>(p_s, do_s, dv_acc, tx, ty);    // dV += P^T dO
      mm_atb_acc<D>(ds_s, q_s, dk_acc, tx, ty);    // dK += dS^T Q
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = k0 + ty + 16 * r;
    if (row >= Tk) continue;
    const size_t base = (((size_t)b * Tk + row) * Hkv + kvh) * D;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      dk[base + tx + 16 * c] = from_f32<T>(dk_acc[r][c] * scale);
      dv[base + tx + 16 * c] = from_f32<T>(dv_acc[r][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq, int S,
                   int Tk, int Hq, int Hkv, int window, float scale) {
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int q0 = qb * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + tile_floats<D>();
  float* k_s = do_s + tile_floats<D>();
  float* v_s = k_s + tile_floats<D>();
  float* ds_s = v_s + tile_floats<D>();    // [BQ][LDP]
  float* lse_s = ds_s + BQ * LDP;
  float* dd_s = lse_s + BQ;

  load_tile<T, D>(q_s, q, b, q0, h, S, Hq);
  load_tile<T, D>(do_s, dout, b, q0, h, S, Hq);
  if (threadIdx.x < BQ) {
    const int row = q0 + threadIdx.x;
    const size_t off = ((size_t)b * Hq + h) * S + row;
    lse_s[threadIdx.x] = row < S ? lse[off] : 0.0f;
    dd_s[threadIdx.x] = row < S ? delta[off] : 0.0f;
  }
  float dq_acc[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dq_acc[r][c] = 0.0f;
  int lo, hi;
  key_blocks(q0, Tk, window, lo, hi);
  for (int kb = lo; kb < hi; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();                // the previous tiles are consumed
    load_tile<T, D>(k_s, k, b, k0, kvh, Tk, Hkv);
    load_tile<T, D>(v_s, v, b, k0, kvh, Tk, Hkv);
    __syncthreads();
    probs_and_dscores<D>(q_s, do_s, k_s, v_s, lse_s, dd_s, nullptr, ds_s, q0,
                         k0, Tk, window, scale, tx, ty);
    __syncthreads();
    mm_ab_acc<D>(ds_s, k_s, dq_acc, tx, ty);       // dQ += dS K
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= S) continue;
    T* qrow = dq + (((size_t)b * S + row) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) qrow[tx + 16 * c] = from_f32<T>(dq_acc[r][c] * scale);
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
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                int B, int S, int Tk, int Hq, int Hkv, int window, float scale,
                cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * tile_floats<D>() + BQ * LDP);
  auto kern = attn_fwd_kernel<T, D>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((S + BQ - 1) / BQ, Hq, B), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, S, Tk, Hq, Hkv,
      window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o,
                const float* lse, const void* dout, float* delta, void* dq,
                void* dk, void* dv, int B, int S, int Tk, int Hq, int Hkv,
                int window, float scale, cudaStream_t stream) {
  const long long rows = (long long)B * S * Hq;
  attn_bwd_delta_kernel<T><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0,
                             stream>>>(static_cast<const T*>(o),
                                       static_cast<const T*>(dout), delta, B,
                                       S, Hq, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_kv =
      sizeof(float) * (4 * tile_floats<D>() + 2 * BQ * LDP + 2 * BQ);
  auto kv = attn_bwd_dkdv_kernel<T, D>;
  if ((err = allow_smem(kv, smem_kv)) != cudaSuccess) return err;
  kv<<<dim3((Tk + BK - 1) / BK, Hkv, B), NT, smem_kv, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, Tk, Hq, Hkv, window, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_q = sizeof(float) * (4 * tile_floats<D>() + BQ * LDP + 2 * BQ);
  auto qk = attn_bwd_dq_kernel<T, D>;
  if ((err = allow_smem(qk, smem_q)) != cudaSuccess) return err;
  qk<<<dim3((S + BQ - 1) / BQ, Hq, B), NT, smem_q, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), S, Tk, Hq, Hkv, window, scale);
  return cudaGetLastError();
}

bool shape_ok(int B, int S, int Tk, int Hq, int Hkv, int window) {
  return B > 0 && B <= 65535 && S > 0 && Tk > 0 && Hkv > 0 && Hq > 0 &&
         Hq <= 65535 && Hq % Hkv == 0 && window >= 0;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, o and the gradients
// share it).  Each returns the cudaError_t of its launches (cudaGetLastError
// right after each); 0 means all were accepted.  D other than 32, 64 or 128
// is refused with cudaErrorInvalidValue.
extern "C" int attn_forward_launch(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int dtype, int B, int S,
                                   int Tk, int Hq, int Hkv, int D, int window,
                                   float scale, int device, void* stream) {
  // this library carries its own CUDA runtime: select the caller's device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!shape_ok(B, S, Tk, Hq, Hkv, window) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define FWD(TY, DD) fwd<TY, DD>(q, k, v, o, l, B, S, Tk, Hq, Hkv, window, scale, s)
  if (dtype == 0) {
    if (D == 32) err = FWD(float, 32);
    else if (D == 64) err = FWD(float, 64);
    else if (D == 128) err = FWD(float, 128);
    else err = cudaErrorInvalidValue;
  } else {
    if (D == 32) err = FWD(__nv_bfloat16, 32);
    else if (D == 64) err = FWD(__nv_bfloat16, 64);
    else if (D == 128) err = FWD(__nv_bfloat16, 128);
    else err = cudaErrorInvalidValue;
  }
#undef FWD
  return (int)err;
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
  if (!shape_ok(B, S, Tk, Hq, Hkv, window) || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dd = static_cast<float*>(delta);
#define BWD(TY, DD) bwd<TY, DD>(q, k, v, o, l, dout, dd, dq, dk, dv, B, S, Tk, Hq, Hkv, window, scale, s)
  if (dtype == 0) {
    if (D == 32) err = BWD(float, 32);
    else if (D == 64) err = BWD(float, 64);
    else if (D == 128) err = BWD(float, 128);
    else err = cudaErrorInvalidValue;
  } else {
    if (D == 32) err = BWD(__nv_bfloat16, 32);
    else if (D == 64) err = BWD(__nv_bfloat16, 64);
    else if (D == 128) err = BWD(__nv_bfloat16, 128);
    else err = cudaErrorInvalidValue;
  }
#undef BWD
  return (int)err;
}
