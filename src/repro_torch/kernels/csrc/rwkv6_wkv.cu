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
// Bound: latency.  The S steps of a (b, h) are a chain: each step reads
// the state it wrote.  The bytes (the four inputs and y, once each) take
// about 0.05 ms at the training shape (B*H = 256, S = 512, D = 64) and the
// flops (about 4 D^2 per step) less; a step costs a dependent pass over
// the D state entries a thread holds, so the time is S times the latency
// of one step.  What the design does about it:
//
//   * Forward: one CTA of D threads per (b, h) (256 CTAs at the training
//     shape); thread i keeps column S[:, i] in D registers, as the official
//     wkv6 CUDA kernel does, so a step needs no synchronisation.  r, k, w
//     and v are staged through shared memory STAGE steps at a time (every
//     thread reads all of r_t, k_t, w_t; reads are broadcasts); y's sum
//     over j runs in four independent partial sums.  The state at the
//     start of every CHUNK = 64 steps is written as a checkpoint
//     [B*H, NC, D, D] for the backward (33.5 MB a layer at the training
//     shape), the final state as sT.
//   * Backward: the reverse recurrence of kernels/ref.py::
//     rwkv6_wkv_backward_plain, with G the adjoint of the state:
//
//       dr_t[j] = sum_i dy_t[i] (S_t[j,i] + u[j] k_t[j] v_t[i])
//       du[j]  += r_t[j] k_t[j] (dy_t . v_t)
//       dk_t[j] = u[j] r_t[j] (dy_t . v_t) + sum_i G[j,i] v_t[i]
//       dv_t[i] = dy_t[i] (r_t . u k_t) + sum_j G[j,i] k_t[j]
//       dw_t[j] = sum_i G[j,i] S_t[j,i]
//       G[j,i]  = w_t[j] G[j,i] + r_t[j] dy_t[i]
//
//     One CTA of D threads per (b, h); thread j keeps ROW j of G (and of
//     S while recomputing), so dr, dk, dw and the update of G are sums a
//     thread does alone; only dv (a sum over rows) goes through shared
//     memory, one padded [D, D + 1] tile per step.  Chunks are walked in
//     reverse.  Each chunk's states S_t are recomputed forward from its
//     checkpoint into a per-CTA scratch [CHUNK, D, D] in device memory
//     (thread j writes and later reads back only its own row, so the
//     scratch needs no barrier) - never rebuilt as (S_{t+1} - k v^T) / w,
//     since w = exp(-exp(.)) may be near 0.  du is written per (b, h) as a
//     partial [B*H, D]; the caller sums it over b in a fixed order.  No
//     atomics anywhere: a rerun gives the same bits.
//
// Built with nvcc into a plain-C shared library and loaded with ctypes
// (repro_torch/kernels/_build.py, repro_torch/kernels/rwkv6_wkv.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int CHUNK = 64;         // steps between checkpoints
constexpr int STAGE_F = 32;       // steps staged in shared memory, forward
constexpr int STAGE_B = 16;       // steps staged in shared memory, backward

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

template <typename T, int D>
__global__ void __launch_bounds__(D)
wkv6_fwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ s0,
                T* __restrict__ y, float* __restrict__ sT,
                float* __restrict__ ckpt, int S, int H) {
  __shared__ float r_s[STAGE_F][D], k_s[STAGE_F][D], w_s[STAGE_F][D],
      v_s[STAGE_F][D], u_s[D];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int i = threadIdx.x;
  const int NC = (S + CHUNK - 1) / CHUNK;
  const size_t sbase = (size_t)bh * D * D;

  float st[D];                      // st[j] = S[j, i]
#pragma unroll
  for (int j = 0; j < D; ++j) st[j] = s0[sbase + (size_t)j * D + i];
  u_s[i] = u[(size_t)bh * D + i];

  for (int t0 = 0; t0 < S; t0 += STAGE_F) {
    const int n = min(STAGE_F, S - t0);
    __syncthreads();                // the previous stage is consumed
    for (int tt = 0; tt < n; ++tt) {
      const size_t off = seq_off(b, t0 + tt, h, i, S, H, D);
      r_s[tt][i] = to_f32<T>(r[off]);
      k_s[tt][i] = to_f32<T>(k[off]);
      w_s[tt][i] = to_f32<T>(w[off]);
      v_s[tt][i] = to_f32<T>(v[off]);
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const int t = t0 + tt;
      if (t % CHUNK == 0) {
        float* c = ckpt + ((size_t)bh * NC + t / CHUNK) * D * D;
#pragma unroll
        for (int j = 0; j < D; ++j) c[(size_t)j * D + i] = st[j];
      }
      const float vi = v_s[tt][i];
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float ruk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float rj = r_s[tt][j], kj = k_s[tt][j];
        acc[j & 3] = fmaf(rj, st[j], acc[j & 3]);
        ruk[j & 3] = fmaf(rj * u_s[j], kj, ruk[j & 3]);
        st[j] = fmaf(w_s[tt][j], st[j], kj * vi);
      }
      const float a = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      const float q = (ruk[0] + ruk[1]) + (ruk[2] + ruk[3]);
      y[seq_off(b, t, h, i, S, H, D)] = from_f32<T>(fmaf(vi, q, a));
    }
  }
#pragma unroll
  for (int j = 0; j < D; ++j) sT[sbase + (size_t)j * D + i] = st[j];
}

template <typename T, int D>
__global__ void __launch_bounds__(D)
wkv6_bwd_kernel(const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ ckpt,
                const T* __restrict__ dy, const float* __restrict__ dsT,
                T* __restrict__ dr, T* __restrict__ dk, T* __restrict__ dv,
                T* __restrict__ dw, float* __restrict__ du,
                float* __restrict__ ds0, float* __restrict__ scratch, int S,
                int H) {
  __shared__ float r_s[STAGE_B][D], k_s[STAGE_B][D], w_s[STAGE_B][D],
      v_s[STAGE_B][D], dy_s[STAGE_B][D], u_s[D];
  __shared__ float red[D * (D + 1)];   // [j][i], rows padded by one float
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int j = threadIdx.x;        // the row this thread owns; also the
                                    // column i it sums dv for
  const int NC = (S + CHUNK - 1) / CHUNK;
  const size_t sbase = (size_t)bh * D * D;
  float* scr = scratch + (size_t)bh * CHUNK * D * D;   // [CHUNK][i][j]

  u_s[j] = u[(size_t)bh * D + j];
  const float uj = u[(size_t)bh * D + j];
  float g[D];                       // g[i] = G[j, i]
#pragma unroll
  for (int i = 0; i < D; ++i) g[i] = dsT[sbase + (size_t)j * D + i];
  float du_acc = 0.0f;

  // stage steps [ta, ta + n) of r, k, w, v and (if dy) dy
  auto stage = [&](int ta, int n, bool with_dy) {
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const size_t off = seq_off(b, ta + tt, h, j, S, H, D);
      r_s[tt][j] = to_f32<T>(r[off]);
      k_s[tt][j] = to_f32<T>(k[off]);
      w_s[tt][j] = to_f32<T>(w[off]);
      v_s[tt][j] = to_f32<T>(v[off]);
      if (with_dy) dy_s[tt][j] = to_f32<T>(dy[off]);
    }
    __syncthreads();
  };

  for (int c = NC - 1; c >= 0; --c) {
    const int t0 = c * CHUNK;
    const int t1 = min(S, t0 + CHUNK);
    // 1. the chunk's states S_t, t in [t0, t1), from its checkpoint
    {
      float s[D];                   // s[i] = S[j, i]
      const float* cp = ckpt + ((size_t)bh * NC + c) * D * D + (size_t)j * D;
#pragma unroll
      for (int i = 0; i < D; ++i) s[i] = cp[i];
      for (int ta = t0; ta < t1; ta += STAGE_B) {
        const int n = min(STAGE_B, t1 - ta);
        stage(ta, n, false);
        for (int tt = 0; tt < n; ++tt) {
          float* out = scr + (size_t)(ta + tt - t0) * D * D + j;
          const float kj = k_s[tt][j], wj = w_s[tt][j];
#pragma unroll
          for (int i = 0; i < D; ++i) {
            out[(size_t)i * D] = s[i];
            s[i] = fmaf(wj, s[i], kj * v_s[tt][i]);
          }
        }
      }
    }
    // 2. the reverse recurrence over the chunk
    const int last = t0 + ((t1 - 1 - t0) / STAGE_B) * STAGE_B;
    for (int ta = last; ta >= t0; ta -= STAGE_B) {
      const int n = min(STAGE_B, t1 - ta);
      stage(ta, n, true);
      for (int tt = n - 1; tt >= 0; --tt) {
        const int t = ta + tt;
        const float rj = r_s[tt][j], kj = k_s[tt][j], wj = w_s[tt][j];
        float dyv = 0.0f, ruk = 0.0f;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          dyv = fmaf(dy_s[tt][i], v_s[tt][i], dyv);
          ruk = fmaf(r_s[tt][i] * u_s[i], k_s[tt][i], ruk);
        }
        const float* st = scr + (size_t)(t - t0) * D * D + j;
        float drj = 0.0f, dkj = 0.0f, dwj = 0.0f;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const float sji = st[(size_t)i * D];
          drj = fmaf(sji, dy_s[tt][i], drj);
          dkj = fmaf(g[i], v_s[tt][i], dkj);
          dwj = fmaf(g[i], sji, dwj);
          red[j * (D + 1) + i] = g[i] * kj;
        }
        __syncthreads();
        float dvi = 0.0f;             // column i = j of sum_j' G[j', i] k[j']
        for (int jj = 0; jj < D; ++jj) dvi += red[jj * (D + 1) + j];
        const size_t off = seq_off(b, t, h, j, S, H, D);
        dr[off] = from_f32<T>(fmaf(uj * kj, dyv, drj));
        dk[off] = from_f32<T>(fmaf(uj * rj, dyv, dkj));
        dw[off] = from_f32<T>(dwj);
        dv[off] = from_f32<T>(fmaf(dy_s[tt][j], ruk, dvi));
        du_acc = fmaf(rj * kj, dyv, du_acc);
#pragma unroll
        for (int i = 0; i < D; ++i) g[i] = fmaf(wj, g[i], rj * dy_s[tt][i]);
        __syncthreads();              // red is rewritten by the next step
      }
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) ds0[sbase + (size_t)j * D + i] = g[i];
  du[(size_t)bh * D + j] = du_acc;
}

template <typename T, int D>
cudaError_t fwd(const void* r, const void* k, const void* v, const void* w,
                const float* u, const float* s0, void* y, float* sT,
                float* ckpt, int B, int S, int H, cudaStream_t stream) {
  wkv6_fwd_kernel<T, D><<<B * H, D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, s0,
      static_cast<T*>(y), sT, ckpt, S, H);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd(const void* r, const void* k, const void* v, const void* w,
                const float* u, const float* ckpt, const void* dy,
                const float* dsT, void* dr, void* dk, void* dv, void* dw,
                float* du, float* ds0, float* scratch, int B, int S, int H,
                cudaStream_t stream) {
  wkv6_bwd_kernel<T, D><<<B * H, D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), u, ckpt,
      static_cast<const T*>(dy), dsT, static_cast<T*>(dr),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<T*>(dw), du, ds0,
      scratch, S, H);
  return cudaGetLastError();
}

bool shape_ok(int B, int S, int H, int D) {
  return B > 0 && S > 0 && H > 0 && (D == 32 || D == 64) &&
         (long long)B * H <= 2147483647LL;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (r, k, v, w, y and their
// gradients share it).  Each returns the cudaError_t of the launch
// (cudaGetLastError right after it); 0 means it was accepted.  D other than
// 32 or 64 is refused with cudaErrorInvalidValue.
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
    err = D == 64 ? fwd<float, 64>(r, k, v, w, uf, s0f, y, sTf, cf, B, S, H, s)
                  : fwd<float, 32>(r, k, v, w, uf, s0f, y, sTf, cf, B, S, H, s);
  else
    err = D == 64
              ? fwd<__nv_bfloat16, 64>(r, k, v, w, uf, s0f, y, sTf, cf, B, S, H, s)
              : fwd<__nv_bfloat16, 32>(r, k, v, w, uf, s0f, y, sTf, cf, B, S, H, s);
  return (int)err;
}

extern "C" int wkv6_backward_launch(const void* r, const void* k,
                                    const void* v, const void* w,
                                    const void* u, const void* ckpt,
                                    const void* dy, const void* dsT, void* dr,
                                    void* dk, void* dv, void* dw, void* du,
                                    void* ds0, void* scratch, int dtype,
                                    int B, int S, int H, int D, int device,
                                    void* stream) {
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
  float* scr = static_cast<float*>(scratch);
  if (dtype == 0)
    err = D == 64 ? bwd<float, 64>(r, k, v, w, uf, cf, dy, dsTf, dr, dk, dv,
                                   dw, duf, ds0f, scr, B, S, H, s)
                  : bwd<float, 32>(r, k, v, w, uf, cf, dy, dsTf, dr, dk, dv,
                                   dw, duf, ds0f, scr, B, S, H, s);
  else
    err = D == 64 ? bwd<__nv_bfloat16, 64>(r, k, v, w, uf, cf, dy, dsTf, dr,
                                           dk, dv, dw, duf, ds0f, scr, B, S,
                                           H, s)
                  : bwd<__nv_bfloat16, 32>(r, k, v, w, uf, cf, dy, dsTf, dr,
                                           dk, dv, dw, duf, ds0f, scr, B, S,
                                           H, s);
  return (int)err;
}
